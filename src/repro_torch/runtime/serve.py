"""Serving loop: batched prefill + decode with a shared KV/state cache
(the JAX package's ``runtime/serve.py``).

Requests arrive tagged with an application ID, as on the paper's AXI->WB
ingress; results come back in request order.

``ServeLoop`` is the fixed-wave engine: it serves one padded batch of
requests to completion before accepting the next wave.  The event-driven
path (admission queue, continuous batching, shell-routed multi-tenant
streams) is ``repro_torch.shell.server.ElasticServer``, which shares
``greedy_tokens`` and ``extra_decode_inputs`` with it.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    app_id: int
    prompt: np.ndarray                  # [S] int32
    max_new: int = 16


@dataclasses.dataclass
class Completion:
    app_id: int
    tokens: List[int]
    prefill_s: float
    decode_s: float


def greedy_tokens(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Greedy next-token over the true vocab (masks the padded tail)."""
    masked = torch.where(
        torch.arange(logits.shape[-1], device=logits.device) < vocab,
        logits, -torch.inf)
    return torch.argmax(masked, dim=-1).to(torch.int32)


def extra_decode_inputs(cfg: ModelConfig, batch_size: int, dtype,
                        device=None) -> Dict[str, torch.Tensor]:
    """Per-family auxiliary decode inputs on ``device`` (the card unless
    ``"cpu"`` is asked for): zero encoder frames for enc-dec (its
    ``decode_step`` does not read them, as in the JAX package); the other
    families need none."""
    extras: Dict[str, torch.Tensor] = {}
    if cfg.family == "encdec":
        extras["frames"] = torch.zeros(
            (batch_size, cfg.encoder_len, cfg.d_model), dtype=dtype,
            device=resolve_device(device))
    return extras


class ServeLoop:
    """Greedy batched serving for one model (one module chain), on
    ``device`` (the card unless ``"cpu"`` is asked for).

    Deprecated: the fixed-wave engine pads every request to the longest in
    its batch and blocks admissions until the wave drains.
    ``repro_torch.shell.server.ElasticServer`` (admission queue +
    continuous batching, shell-routed) is the maintained serving path.

    ``params`` takes parameters from elsewhere (the JAX package's,
    converted by ``repro_torch.ckpt.convert``: the port does not
    reimplement JAX's PRNG); without them ``seed`` seeds the
    ``torch.Generator`` of ``model.init``.

    ``shard`` (a ``models.parallel.ShardCtx`` of launched ranks) serves as
    one rank of a tensor-parallel ``DenseLM``: ``params`` are the rank's
    local shards, gathered once along their ``fsdp`` dim (a server keeps
    no optimizer state, and would otherwise gather every weight again for
    each token), the slots are split over the data axes as
    ``lm.batch_axes`` says, and the vocab-sharded logits (and each rank's
    rows of tokens) are gathered before a token is picked, so every rank
    returns the same completions.
    """

    def __init__(self, cfg: ModelConfig, *, batch: int = 4,
                 max_len: int = 256, seed: int = 0, device=None,
                 params=None, shard=None):
        warnings.warn(
            "DEPRECATED runtime.serve.ServeLoop — migrate to "
            "repro_torch.shell.server.ElasticServer (continuous batching, "
            "shell-gated routing; see docs/migration.md)",
            DeprecationWarning, stacklevel=2)
        from repro_torch.models.lm import build_model
        self.cfg = cfg
        self.model = build_model(cfg, device=device)
        self.device = self.model.device
        self.batch = batch
        self.max_len = max_len
        self.shard = None
        if shard is not None:
            from repro_torch.models.lm import batch_axes
            if params is None:
                raise ValueError("a tensor-parallel ServeLoop takes the "
                                 "rank's local shards as params")
            from repro_torch.models.parallel import layout_specs
            self.shard = shard.with_batch(batch_axes(
                batch, "pod" in shard.mesh.axis_names))
            self.model.shard_over(self.shard, fsdp=False)
            params = self.shard.whole_over_data(
                params, layout_specs(self.model))
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = self.model.init(gen)
        self.params = params

    def _tokens(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _warm_state(self, prompts: np.ndarray):
        """Replay the prompt through ``decode_step`` to build the cache.

        (A production server fuses this into prefill; replay keeps the
        path simple and exercises ``decode_step`` S times.)"""
        B, S = prompts.shape
        state = self.model.init_decode_state(B, self.max_len)
        logits = None
        extras = extra_decode_inputs(self.cfg, B, self.model.dtype,
                                     self.device)
        for t in range(S):
            batch = {"tokens": self._tokens(prompts[:, t:t + 1]), **extras}
            logits, state = self.model.decode_step(self.params, state, batch)
        return logits, state

    @torch.no_grad()
    def serve(self, requests: List[Request]) -> List[Completion]:
        """Serve a wave of requests (padded to the fixed batch)."""
        assert requests, "empty request wave"
        assert len(requests) <= self.batch
        S = max(len(r.prompt) for r in requests)
        prompts = np.zeros((self.batch, S), np.int32)
        for i, r in enumerate(requests):
            prompts[i, S - len(r.prompt):] = r.prompt   # left-pad

        sh = self.shard
        rows = slice(None) if sh is None else sh.batch_rows(self.batch)
        full = (lambda x: x) if sh is None else sh.gather_vocab
        every = (lambda x: x) if sh is None else sh.gather_batch
        t0 = time.monotonic()
        logits, state = self._warm_state(prompts[rows])
        t1 = time.monotonic()

        max_new = max(r.max_new for r in requests)
        out_tokens = np.zeros((self.batch, max_new), np.int32)
        # the first token over the padded vocab, as the JAX package takes it
        tok = torch.argmax(full(logits), dim=-1).to(torch.int32)
        extras = extra_decode_inputs(self.cfg, tok.shape[0],
                                     self.model.dtype, self.device)
        for j in range(max_new):
            out_tokens[:, j] = every(tok).cpu().numpy()
            batch = {"tokens": tok[:, None], **extras}
            logits, state = self.model.decode_step(self.params, state, batch)
            tok = greedy_tokens(full(logits), self.cfg.vocab)
        t2 = time.monotonic()

        return [Completion(app_id=r.app_id,
                           tokens=[int(t) for t in out_tokens[i, :r.max_new]],
                           prefill_s=t1 - t0, decode_s=t2 - t1)
                for i, r in enumerate(requests)]
