"""Decoder-only LM for the ``dense`` and ``moe`` families.

The contract of the JAX package's ``DenseLM``:

- ``init(gen)``                          parameters from a torch.Generator
- ``loss(params, batch)``                training objective (chunked vocab
                                         xent + 0.01 * MoE aux loss)
- ``prefill(params, batch)``             full-sequence forward -> last-token
                                         logits
- ``init_decode_state(batch, max_len)``  an empty KV cache
- ``decode_step(params, state, batch)``  one token with cached state

Layers are kept apart (``params["layers"]`` is a list of per-layer dicts)
and run in a Python loop; the JAX package stacks them [L, ...] and scans.
``ckpt.convert.params_from_numpy`` unstacks JAX parameters into this
layout.  Layer remat is not ported (every activation is kept for the
backward).  The other families (ssm, hybrid, encdec, vlm) are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch
import torch.utils.checkpoint

from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (ParamDef, dtype_of, init_params,
                                       ones_init, rms_norm)
from repro_torch.models.config import ModelConfig

Params = Any


def attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out = {
        "wq": ParamDef((d, H * hd)),
        "wk": ParamDef((d, Kv * hd)),
        "wv": ParamDef((d, Kv * hd)),
        "wo": ParamDef((H * hd, d)),
    }
    if cfg.qkv_bias:
        from repro_torch.models.common import zeros_init
        out.update({"bq": ParamDef((H * hd,), zeros_init),
                    "bk": ParamDef((Kv * hd,), zeros_init),
                    "bv": ParamDef((Kv * hd,), zeros_init)})
    return out


def qkv(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """Project + rope. Returns q [B,S,H,hd], k/v [B,S,Kv,hd] (k post-rope)."""
    B, S, _ = x.shape
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = attn.apply_rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = attn.apply_rope(k.reshape(B, S, Kv, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, Kv, hd)


def chunked_lm_loss(h: torch.Tensor, w_head: torch.Tensor,
                    labels: torch.Tensor, true_vocab: int,
                    chunk: int = 512) -> torch.Tensor:
    """Sequence-chunked vocab xent, mean over tokens.  Each chunk's logits
    are recomputed in the backward (``torch.utils.checkpoint``), so the
    [B, S, V] logits never exist at once."""
    B, S, _ = h.shape
    chunk = min(chunk, S)

    def body(hh, ll):
        return _xent_per_token(hh @ w_head, ll, true_vocab).sum()

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        tot = tot + torch.utils.checkpoint.checkpoint(
            body, h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
            use_reentrant=False)
    return tot / (B * S)


def _xent_per_token(logits: torch.Tensor, labels: torch.Tensor,
                    true_vocab: int) -> torch.Tensor:
    logits = logits.float()
    if logits.shape[-1] > true_vocab:
        valid = torch.arange(logits.shape[-1], device=logits.device) < true_vocab
        logits = torch.where(valid, logits, torch.finfo(torch.float32).min)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return logz - gold


@dataclasses.dataclass
class DecodeState:
    pos: int                                  # next position
    kv_k: List[torch.Tensor]                  # per layer [B, Sc, Kv, hd]
    kv_v: List[torch.Tensor]
    kv_pos: torch.Tensor                      # [B, Sc] int32, -1 = empty

    def split(self) -> List["DecodeState"]:
        """One B=1 state per batch row (copies: each slot owns its cache)."""
        B = self.kv_pos.shape[0]
        return [DecodeState(pos=self.pos,
                            kv_k=[c[i:i + 1].clone() for c in self.kv_k],
                            kv_v=[c[i:i + 1].clone() for c in self.kv_v],
                            kv_pos=self.kv_pos[i:i + 1].clone())
                for i in range(B)]


class DenseLM:
    """Decoder-only transformer: GQA (+ optional SWA window, qkv bias),
    with a per-layer MLP or a crossbar-dispatched MoE."""

    def __init__(self, cfg: ModelConfig, device=None):
        cfg.validate()
        if cfg.moe is not None:
            from repro_torch.fabric.backends import is_fabric_backend
            if not is_fabric_backend(cfg.moe.dispatch):
                raise NotImplementedError(
                    f"MoE dispatch {cfg.moe.dispatch!r} is not ported; "
                    f"set moe.dispatch to a fabric backend such as "
                    f"'cuda_kernel'")
        self.cfg = cfg
        self.dtype = dtype_of(cfg.dtype)
        self.device = resolve_device(device)

    # ---- parameters ---------------------------------------------------
    def _layer_defs(self) -> Dict[str, Any]:
        cfg = self.cfg
        d = {"norm1": ParamDef((cfg.d_model,), ones_init),
             "attn": attn_defs(cfg),
             "norm2": ParamDef((cfg.d_model,), ones_init)}
        if cfg.moe is not None:
            d["moe"] = moe_mod.moe_defs(cfg.d_model, cfg.d_ff, cfg.moe,
                                        cfg.mlp_act)
        else:
            d["mlp"] = mlp_mod.mlp_defs(cfg.d_model, cfg.d_ff, cfg.mlp_act)
        return d

    def param_defs(self) -> Dict[str, Any]:
        cfg = self.cfg
        out = {"embed": ParamDef((cfg.vocab_padded, cfg.d_model)),
               "final_norm": ParamDef((cfg.d_model,), ones_init)}
        if not cfg.tied_embeddings:
            out["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_padded))
        out["layers"] = [self._layer_defs() for _ in range(cfg.n_layers)]
        return out

    def init(self, gen: torch.Generator) -> Params:
        return init_params(self.param_defs(), gen, self.dtype, self.device)

    def _head_weight(self, params):
        if self.cfg.tied_embeddings:
            return params["embed"].T
        return params["lm_head"]

    # ---- forward ------------------------------------------------------
    def _block(self, lp, x: torch.Tensor, positions: torch.Tensor,
               moe_group: int):
        cfg = self.cfg
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        q, k, v = qkv(lp["attn"], h, cfg, positions)
        o = attn.attention_prefill(q, k, v, causal=True,
                                   window=cfg.attn_window,
                                   kernel_mode=cfg.kernel_mode)
        x = x + o.reshape(o.shape[0], o.shape[1], -1) @ lp["attn"]["wo"]
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        if cfg.moe is not None:
            y, stats = moe_mod.moe_apply(lp["moe"], h2, cfg.moe, cfg.mlp_act,
                                         group_size=moe_group,
                                         dispatch_impl=cfg.moe.dispatch,
                                         kernel_mode=cfg.kernel_mode)
            aux = stats["aux_loss"]
        else:
            y = mlp_mod.mlp_apply(lp["mlp"], h2, cfg.mlp_act)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + y, aux

    def _backbone(self, params, x: torch.Tensor, positions: torch.Tensor,
                  moe_group: int = 1024):
        """Every layer, then the final norm; returns (h, summed aux loss)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in params["layers"]:
            x, a = self._block(lp, x, positions, moe_group)
            aux = aux + a
        return rms_norm(x, params["final_norm"], self.cfg.norm_eps), aux

    def _inputs_embed(self, params, batch) -> torch.Tensor:
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        return params["embed"][tokens.long()]

    def loss(self, params, batch) -> torch.Tensor:
        """``batch["tokens"]``/``["labels"]`` [B, S] -> scalar float32."""
        x = self._inputs_embed(params, batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)[None, :]
        h, aux = self._backbone(params, x, positions,
                                moe_group=min(1024, B * S))
        labels = torch.as_tensor(batch["labels"], device=self.device)
        lm = chunked_lm_loss(h, self._head_weight(params), labels,
                             self.cfg.vocab)
        return lm + 0.01 * aux

    def prefill(self, params, batch) -> torch.Tensor:
        """``batch["tokens"]`` [B, S] -> last-token logits [B, V_padded]."""
        x = self._inputs_embed(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        h, _ = self._backbone(params, x, positions)
        return h[:, -1] @ self._head_weight(params)

    # ---- decode -------------------------------------------------------
    def init_decode_state(self, batch: int, max_len: int) -> DecodeState:
        cfg = self.cfg
        slots = min(cfg.attn_window, max_len) if cfg.attn_window else max_len
        shape = (batch, slots, cfg.n_kv_heads, cfg.hd)
        z = lambda: torch.zeros(shape, dtype=self.dtype, device=self.device)
        return DecodeState(
            pos=0,
            kv_k=[z() for _ in range(cfg.n_layers)],
            kv_v=[z() for _ in range(cfg.n_layers)],
            kv_pos=torch.full((batch, slots), -1, dtype=torch.int32,
                              device=self.device))

    def decode_step(self, params, state: DecodeState, batch):
        """One token for every row: ``batch["tokens"]`` [B, 1] ->
        (logits [B, V_padded], next state).  The caches are written in
        place (see ``attention.cache_write``)."""
        cfg = self.cfg
        tok = batch["tokens"]                         # [B, 1]
        x = params["embed"][tok.long()]               # [B, 1, d]
        pos = state.pos
        positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                               device=x.device)
        kv_pos = state.kv_pos
        for lp, ck, cv in zip(params["layers"], state.kv_k, state.kv_v):
            h = rms_norm(x, lp["norm1"], cfg.norm_eps)
            q, k, v = qkv(lp["attn"], h, cfg, positions)
            ck, cv, kv_pos = attn.cache_write(ck, cv, state.kv_pos, k, v, pos)
            o = attn.attention_decode(q, ck, cv, kv_pos, pos,
                                      window=cfg.attn_window)
            x = x + o.reshape(o.shape[0], 1, -1) @ lp["attn"]["wo"]
            h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
            if cfg.moe is not None:
                y, _ = moe_mod.moe_apply(lp["moe"], h2, cfg.moe, cfg.mlp_act,
                                         group_size=h2.shape[0],
                                         dispatch_impl=cfg.moe.dispatch,
                                         kernel_mode=cfg.kernel_mode)
            else:
                y = mlp_mod.mlp_apply(lp["mlp"], h2, cfg.mlp_act)
            x = x + y
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = h[:, -1] @ self._head_weight(params)
        return logits, DecodeState(pos=pos + 1, kv_k=state.kv_k,
                                   kv_v=state.kv_v, kv_pos=kv_pos)


def build_model(cfg: ModelConfig, device=None) -> DenseLM:
    """The model for ``cfg`` on ``device`` (the card unless ``"cpu"`` is
    asked for)."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (dense and moe "
            f"are)")
    return DenseLM(cfg, device=device)
