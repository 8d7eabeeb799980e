"""The LM families: ``DenseLM`` (``dense``, ``moe`` and ``vlm``), ``SSMLM``
(``ssm``, Mamba-2), ``HybridLM`` (``hybrid``, RecurrentGemma) and
``EncDecLM`` (``encdec``, Whisper).

The contract of the JAX package's models:

- ``init(gen)``                          parameters from a torch.Generator
- ``n_params()``                         the parameter count, from
                                         ``param_defs`` (nothing allocated)
- ``loss(params, batch)``                training objective (chunked vocab
                                         xent, + 0.01 * MoE aux loss)
- ``prefill(params, batch)``             full-sequence forward -> last-token
                                         logits
- ``init_decode_state(batch, max_len)``  an empty decode state
- ``decode_step(params, state, batch)``  one token with cached state
- ``param_shapes()``, ``input_shapes(shape, multi_pod)``,
  ``decode_state_shapes(shape, multi_pod)``
                                         what the launch tools cost: tensors
                                         on the ``meta`` device (JAX's
                                         ``ShapeDtypeStruct``), with their
                                         partition specs

Layers are kept apart (``params["layers"]`` is a list of per-layer dicts;
the hybrid's ``params["groups"]`` a list of groups, each with a list of
recurrent blocks, and ``params["trail"]`` a list; the encoder-decoder's
``params["enc_layers"]`` and ``params["dec_layers"]`` lists) and run in a
Python loop; the JAX package stacks them and scans.  ``ckpt.convert`` moves
parameters between the two layouts.

``cfg.remat`` (``remat_wrap``) applies on the training path (``loss``)
only, as in the JAX package: ``"nothing"`` keeps every activation,
``"full"`` recomputes each layer body in the backward (non-reentrant
``torch.utils.checkpoint``), and ``"dots"`` (the default) saves only the
outputs of plain 2-D products and recomputes the rest, the hand-written
kernels included.  Every ported family trains on the kernels: the SSD
and RG-LRU scans and the attention at each head dim have backward
kernels, and remat recomputes their forwards.

The ``vlm`` family is ``DenseLM`` whose batch may carry ``"patches"``
[B, Pn, d]: they replace the first ``cfg.n_vision_patches`` token
embeddings in ``loss`` and ``prefill`` (the vision tower is a stub, as in
the JAX package); ``decode_step`` embeds tokens only.  ``EncDecLM`` encodes
``batch["frames"]`` [B, F, d] (the audio front end is a stub) with
bidirectional attention; each decoder layer then runs causal
self-attention and cross-attention to the encoder output.  Its decode
state carries a cross-attention cache per layer (``cross_k``/``cross_v``)
that, as in the JAX package, nothing fills: ``init_decode_state`` leaves it
zero, so decoded tokens do not depend on the audio.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ParamDef, dtype_of, init_params,
                                       ones_init, rms_norm, shape_tree,
                                       spec_tree, tree_leaves)
from repro_torch.models.config import ModelConfig, ShapeConfig

Params = Any


def attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kv_ax = "tp" if cfg.kv_shard == "tp" else None
    out = {
        "wq": ParamDef((d, H * hd), ("fsdp", "tp")),
        "wk": ParamDef((d, Kv * hd), ("fsdp", kv_ax)),
        "wv": ParamDef((d, Kv * hd), ("fsdp", kv_ax)),
        "wo": ParamDef((H * hd, d), ("tp", "fsdp")),
    }
    if cfg.qkv_bias:
        from repro_torch.models.common import zeros_init
        out.update({"bq": ParamDef((H * hd,), ("tp",), zeros_init),
                    "bk": ParamDef((Kv * hd,), (kv_ax,), zeros_init),
                    "bv": ParamDef((Kv * hd,), (kv_ax,), zeros_init)})
    return out


def qkv(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
        heads=None):
    """Project + rope. Returns q [B,S,H,hd], k/v [B,S,Kv,hd] (k post-rope);
    ``heads`` = (H, Kv) where the weights hold other head counts than the
    config's (a tensor-parallel rank's, ``parallel.HeadLayout``)."""
    B, S, _ = x.shape
    H, Kv = heads or (cfg.n_heads, cfg.n_kv_heads)
    hd = cfg.hd
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
    return _chunked_xent_sum(
        h, w_head, labels,
        lambda logits, ll: _xent_per_token(logits, ll, true_vocab),
        chunk) / (B * S)


def _chunked_xent_sum(h, w_head, labels, xent, chunk: int = 512):
    """The sum of ``xent(logits, labels)`` over every token, the logits
    of each sequence chunk recomputed in the backward."""
    chunk = min(chunk, h.shape[1])

    def body(hh, ll):
        return xent(hh @ w_head, ll).sum()

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, h.shape[1], chunk):
        tot = tot + torch.utils.checkpoint.checkpoint(
            body, h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
            use_reentrant=False)
    return tot


def _xent_per_token(logits: torch.Tensor, labels: torch.Tensor,
                    true_vocab: int) -> torch.Tensor:
    logits = logits.float()
    if logits.shape[-1] > true_vocab:
        valid = torch.arange(logits.shape[-1], device=logits.device) < true_vocab
        logits = torch.where(valid, logits, torch.finfo(torch.float32).min)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return logz - gold


# The products ``dots_with_no_batch_dims_saveable`` saves in the JAX
# package: dots without batch dimensions, which reach aten as 2-D products
# (``x @ w`` on [B, S, d] folds to ``mm``).  ``bmm`` (the experts, the
# plain attention) has a batch dimension and is recomputed.
_SAVED_DOTS = frozenset({torch.ops.aten.mm.default,
                         torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def remat_wrap(fn, policy: str):
    """``fn`` with the activation policy ``policy`` for its backward:
    ``"nothing"`` keeps every activation (``fn`` itself), ``"dots"`` saves
    the 2-D products' outputs and recomputes the rest, anything else
    (``"full"``) saves only ``fn``'s inputs.  Recompute runs ``fn`` again,
    kernels and all, so ``fn`` must compute the same values twice; the
    layers draw no random numbers, so no RNG state is kept."""
    if policy == "nothing":
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if policy == "dots":
        kw["context_fn"] = _dots_context
    return functools.partial(torch.utils.checkpoint.checkpoint, fn, **kw)


def batch_axes(global_batch: int, multi_pod: bool) -> Optional[Any]:
    """Batch sharding that respects divisibility (B=1 long-decode stays
    replicated on the data axis)."""
    need = 32 if multi_pod else 16
    if global_batch % need == 0:
        return ("pod", "data") if multi_pod else "data"
    if global_batch % 16 == 0 and multi_pod:
        return "data"
    return None


def _chain(fns):
    """The blocks ``fns`` run one after the other, as one x -> x."""
    def run(x):
        for fn in fns:
            x = fn(x)
        return x
    return run


@dataclasses.dataclass
class DecodeState:
    """The decode state of every family; each family fills its fields and
    leaves the others None.  Per-layer tensors are lists."""

    pos: int                                          # next position
    kv_k: Optional[List[torch.Tensor]] = None         # [B, Sc, Kv, hd]
    kv_v: Optional[List[torch.Tensor]] = None
    kv_pos: Optional[torch.Tensor] = None             # [B, Sc] int32, -1 empty
    ssm_state: Optional[List[torch.Tensor]] = None    # [B, H, P, N] float32
    conv_tail: Optional[List[torch.Tensor]] = None    # [B, W-1, conv_dim]
    rec_h: Optional[List[torch.Tensor]] = None        # [B, lru] float32
    rec_tail: Optional[List[torch.Tensor]] = None     # [B, 3, lru]
    cross_k: Optional[List[torch.Tensor]] = None      # [B, F, Kv, hd]
    cross_v: Optional[List[torch.Tensor]] = None

    def split(self) -> List["DecodeState"]:
        """One B=1 state per batch row (copies: each slot owns its state)."""
        batched = {f.name: getattr(self, f.name)
                   for f in dataclasses.fields(self)
                   if f.name != "pos" and getattr(self, f.name) is not None}
        B = tree_leaves(list(batched.values()))[0].shape[0]

        def row(v, i):
            if torch.is_tensor(v):
                return v[i:i + 1].clone()
            return [c[i:i + 1].clone() for c in v]

        return [DecodeState(pos=self.pos,
                            **{k: row(v, i) for k, v in batched.items()})
                for i in range(B)]

    def leaves(self) -> List[torch.Tensor]:
        """The state's tensors, field by field (``pos`` only where it is
        a tensor: the meta scalar of ``decode_state_shapes``)."""
        return [t for f in dataclasses.fields(self)
                for t in tree_leaves(getattr(self, f.name))
                if torch.is_tensor(t)]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _kv_shapes(batch: int, slots: int, n_layers: int, cfg: ModelConfig,
               dtype, bspec, seq_axis, **more):
    """``_kv_state``'s (meta tensors, specs) with ``n_layers`` caches of
    ``slots``; ``more`` adds (structs, specs) pairs of other fields.  The
    position is JAX's int32 scalar (a host int in a live state)."""
    shape = (batch, slots, cfg.n_kv_heads, cfg.hd)
    spec = (bspec, seq_axis, None, None)
    structs = DecodeState(
        pos=_meta((), torch.int32),
        kv_k=[_meta(shape, dtype) for _ in range(n_layers)],
        kv_v=[_meta(shape, dtype) for _ in range(n_layers)],
        kv_pos=_meta((batch, slots), torch.int32),
        **{k: v[0] for k, v in more.items()})
    specs = DecodeState(pos=(), kv_k=[spec] * n_layers,
                        kv_v=[spec] * n_layers, kv_pos=(bspec, seq_axis),
                        **{k: v[1] for k, v in more.items()})
    return structs, specs


class LMBase:
    """What the families share: the config, the device, the embedding and
    the head, the parameter init, and the last-token logits."""

    def __init__(self, cfg: ModelConfig, device=None):
        cfg.validate()
        self.cfg = cfg
        self.dtype = dtype_of(cfg.dtype)
        self.device = resolve_device(device)
        # The mesh axes the batch is sharded over, for ``constrain``; set by
        # ``launch.steps.build_step``, None disables.
        self.batch_axis: Optional[Any] = None
        # This rank's view of a tensor-parallel mesh (``shard_over``).
        self.shard = None

    def shard_over(self, ctx) -> None:
        """Run as one rank of ``ctx`` (a ``parallel.ShardCtx``): the
        parameters are the rank's local shards.  Only ``DenseLM`` is
        tensor-parallel; the other families raise on a mesh of more than
        one device (on one, nothing is sharded and the model runs as
        it is)."""
        if ctx.mesh.size > 1:
            raise NotImplementedError(
                f"tensor parallelism for the {self.cfg.family} family over "
                f"a {ctx.mesh.size}-device mesh is not ported (ROADMAP A11)")

    def constrain(self, x: torch.Tensor) -> torch.Tensor:
        """Pin a [B, S, d] activation to batch sharding, as the JAX
        package's ``with_sharding_constraint`` does.  With ``batch_axis``
        None it returns ``x``.  Otherwise a plain tensor is returned as it
        is: each rank of a torch program already holds only its own batch
        rows.  A ``DTensor`` is redistributed to ``Shard(0)`` over the
        batch axes of its mesh and ``Replicate()`` over the others."""
        if self.batch_axis is None:
            return x
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if not isinstance(x, DTensor):
            return x
        axes = (self.batch_axis if isinstance(self.batch_axis, tuple)
                else (self.batch_axis,))
        mesh = x.device_mesh
        return x.redistribute(mesh, [Shard(0) if name in axes
                                     else Replicate()
                                     for name in mesh.mesh_dim_names])

    def _embed_defs(self) -> Dict[str, Any]:
        cfg = self.cfg
        out = {"embed": ParamDef((cfg.vocab_padded, cfg.d_model),
                                 ("tp", "fsdp")),
               "final_norm": ParamDef((cfg.d_model,), (None,), ones_init)}
        if not cfg.tied_embeddings:
            out["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_padded),
                                      ("fsdp", "tp"))
        return out

    def param_defs(self) -> Dict[str, Any]:
        raise NotImplementedError

    def param_specs(self, multi_pod: bool):
        """Each parameter's partition spec (a tuple of mesh-axis names per
        dim), in the port's tree: a per-layer leaf's spec is the JAX
        package's stacked one without its leading layer axis."""
        return spec_tree(self.param_defs(), multi_pod=multi_pod)

    def init(self, gen: torch.Generator) -> Params:
        return init_params(self.param_defs(), gen, self.dtype, self.device)

    def param_shapes(self) -> Params:
        """Each parameter as a tensor on the ``meta`` device, in the port's
        tree (per-layer lists where the JAX package stacks a layer axis,
        as ``param_specs`` maps them)."""
        return shape_tree(self.param_defs(), self.dtype)

    def input_shapes(self, shape: ShapeConfig, multi_pod: bool):
        """(meta tensors, specs) of the data batch of ``shape``, under the
        JAX package's keys (``tokens``, ``labels``, ``patches``,
        ``frames``)."""
        B, S = shape.global_batch, shape.seq_len
        bspec = batch_axes(B, multi_pod)
        tokens = (B, 1) if shape.kind == "decode" else (B, S)
        structs = {"tokens": _meta(tokens, torch.int32)}
        specs = {"tokens": (bspec, None)}
        if shape.kind == "train":
            structs["labels"] = _meta((B, S), torch.int32)
            specs["labels"] = (bspec, None)
        if self.cfg.n_vision_patches:
            structs["patches"] = _meta(
                (B, self.cfg.n_vision_patches, self.cfg.d_model), self.dtype)
            specs["patches"] = (bspec, None, None)
        if self.cfg.family == "encdec":
            structs["frames"] = _meta(
                (B, self.cfg.encoder_len, self.cfg.d_model), self.dtype)
            specs["frames"] = (bspec, None, None)
        return structs, specs

    def decode_state_shapes(self, shape: ShapeConfig, multi_pod: bool):
        """(a ``DecodeState`` of meta tensors, one of specs) for decoding
        ``shape``: the tensors ``init_decode_state(B, seq_len)`` allocates,
        plus ``pos``, JAX's int32 scalar (a host int in a live state)."""
        raise NotImplementedError

    # the families implement
    def loss(self, params, batch) -> torch.Tensor:
        raise NotImplementedError

    def prefill(self, params, batch) -> torch.Tensor:
        raise NotImplementedError

    def decode_step(self, params, state: DecodeState, batch):
        raise NotImplementedError

    def n_params(self) -> int:
        """The number of parameters, counted from ``param_defs`` without
        allocating them."""
        return sum(math.prod(d.shape) for d in tree_leaves(self.param_defs()))

    def _leaf(self, params, name: str) -> torch.Tensor:
        """A top-level leaf as the products take it (on a tensor-parallel
        rank: whole along ``d_model``, ``ShardCtx.weight``)."""
        if self.shard is None:
            return params[name]
        return self.shard.weight(params[name], self._specs[name])

    def _head_weight(self, params):
        if self.cfg.tied_embeddings:
            return self._leaf(params, "embed").T
        return self._leaf(params, "lm_head")

    def _embed(self, params, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=self.device)
        if self.shard is not None:
            from repro_torch.models.parallel import embed_vocab_parallel
            return embed_vocab_parallel(self._leaf(params, "embed"), tokens,
                                        self.shard)
        return params["embed"][tokens.long()]

    def _inputs_embed(self, params, batch) -> torch.Tensor:
        return self._embed(params, batch["tokens"])

    def _last_logits(self, params, h: torch.Tensor) -> torch.Tensor:
        """The final norm, then the head on the last position: [B, V]
        (on a tensor-parallel rank: its vocab block [B, V/M])."""
        h = rms_norm(h, self._leaf(params, "final_norm"),
                     self.cfg.norm_eps)[:, -1]
        if self.shard is not None:
            h = self.shard.tp_in(h)
        return h @ self._head_weight(params)

    def _lm_loss(self, params, h: torch.Tensor, batch) -> torch.Tensor:
        """The final norm, then the chunked vocab xent (on a
        tensor-parallel rank: vocab-parallel, the mean over the global
        batch)."""
        labels = torch.as_tensor(batch["labels"], device=self.device)
        h = rms_norm(h, self._leaf(params, "final_norm"), self.cfg.norm_eps)
        sh = self.shard
        if sh is None:
            return chunked_lm_loss(h, self._head_weight(params), labels,
                                   self.cfg.vocab)
        from repro_torch.models.parallel import xent_vocab_parallel
        tot = _chunked_xent_sum(
            sh.tp_in(h), self._head_weight(params), labels,
            lambda logits, ll: xent_vocab_parallel(logits, ll,
                                                   self.cfg.vocab, sh))
        return sh.batch_sum(tot) / (labels.numel() * sh.batch_shards)


class DenseLM(LMBase):
    """Decoder-only transformer: GQA (+ optional SWA window, qkv bias),
    with a per-layer MLP or a crossbar-dispatched MoE."""

    # ---- parameters ---------------------------------------------------
    def _layer_defs(self) -> Dict[str, Any]:
        cfg = self.cfg
        d = {"norm1": ParamDef((cfg.d_model,), (None,), ones_init),
             "attn": attn_defs(cfg),
             "norm2": ParamDef((cfg.d_model,), (None,), ones_init)}
        if cfg.moe is not None:
            d["moe"] = moe_mod.moe_defs(cfg.d_model, cfg.d_ff, cfg.moe,
                                        cfg.mlp_act)
        else:
            d["mlp"] = mlp_mod.mlp_defs(cfg.d_model, cfg.d_ff, cfg.mlp_act)
        return d

    def param_defs(self) -> Dict[str, Any]:
        out = self._embed_defs()
        out["layers"] = [self._layer_defs() for _ in range(self.cfg.n_layers)]
        return out

    def shard_over(self, ctx, fsdp: bool = True) -> None:
        """Run as one rank of ``ctx`` (a ``parallel.ShardCtx``, any mesh
        size): the parameters are the rank's local shards
        (``parallel.shard_params``), the batch its rows under the batch
        spec of ``ctx``, and ``prefill``/``decode_step`` return its vocab
        block of the logits.  ``fsdp=False``: the parameters are whole
        along ``d_model`` already (``ShardCtx.whole_over_data``), as a
        server holds them.  See ``models/parallel.py``."""
        from repro_torch.models.parallel import (DATA, POD, layout_specs,
                                                 without_axis)
        self.shard = ctx
        self._specs = layout_specs(self, POD in ctx.mesh.axis_names)
        if not fsdp:
            self._specs = without_axis(self._specs, DATA)
        self._heads = ctx.heads(self.cfg)

    # ---- tensor-parallel pieces (the plain products off a mesh) -------
    def _layer(self, lp):
        """A layer's leaves as the products take them: on a mesh, whole
        along ``d_model`` (gathered over ``data``)."""
        if self.shard is None:
            return lp
        return self.shard.weights(lp, self._specs["layers"][0])

    def _qkv(self, p, h: torch.Tensor, positions: torch.Tensor):
        if self.shard is None:
            return qkv(p, h, self.cfg, positions)
        hl = self._heads
        return qkv(hl.project(self.shard, p), self.shard.tp_in(h), self.cfg,
                   positions, heads=(hl.n_q, hl.n_kv))

    def _attn_out(self, o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
        if self.shard is None:
            return o.reshape(*o.shape[:2], -1) @ wo
        return self._heads.out(self.shard, o, wo)

    def _ffn(self, lp, h2: torch.Tensor, group_size: int):
        """The MLP or the MoE on the normed residual: (y, aux loss);
        ``group_size`` counts the MoE's token groups in the global
        batch."""
        cfg, sh = self.cfg, self.shard
        if cfg.moe is not None:
            y, stats = moe_mod.moe_apply(lp["moe"], h2, cfg.moe, cfg.mlp_act,
                                         group_size=group_size,
                                         dispatch_impl=cfg.moe.dispatch,
                                         kernel_mode=cfg.kernel_mode,
                                         shard=sh)
            return y, stats["aux_loss"]
        aux = torch.zeros((), dtype=torch.float32, device=h2.device)
        if sh is None:
            return mlp_mod.mlp_apply(lp["mlp"], h2, cfg.mlp_act), aux
        return sh.tp_out(mlp_mod.mlp_apply(lp["mlp"], sh.tp_in(h2),
                                           cfg.mlp_act)), aux

    # ---- forward ------------------------------------------------------
    def _inputs_embed(self, params, batch) -> torch.Tensor:
        """The token embeddings, the first ``cfg.n_vision_patches`` of them
        replaced by ``batch["patches"]`` (cast to the model's type) when the
        config has patches and the batch carries them."""
        x = self._embed(params, batch["tokens"])
        n = self.cfg.n_vision_patches
        if n and "patches" in batch:
            patches = torch.as_tensor(batch["patches"], device=self.device)
            x = torch.cat([patches.to(x.dtype), x[:, n:]], dim=1)
        return x

    def _block(self, lp, x: torch.Tensor, positions: torch.Tensor,
               moe_group: int):
        cfg = self.cfg
        lp = self._layer(lp)
        x = self.constrain(x)
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        q, k, v = self._qkv(lp["attn"], h, positions)
        o = attn.attention_prefill(q, k, v, causal=True,
                                   window=cfg.attn_window,
                                   kernel_mode=cfg.kernel_mode)
        x = x + self._attn_out(o, lp["attn"]["wo"])
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        y, aux = self._ffn(lp, h2, moe_group)
        return x + y, aux

    def _backbone(self, params, x: torch.Tensor, positions: torch.Tensor,
                  moe_group: int = 1024, *, train: bool = False):
        """Every layer (under ``cfg.remat`` when ``train``); returns (h
        before the final norm, summed aux loss)."""
        block = remat_wrap(self._block, self.cfg.remat if train else "nothing")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in params["layers"]:
            x, a = block(lp, x, positions, moe_group)
            aux = aux + a
        return self.constrain(x), aux

    def loss(self, params, batch) -> torch.Tensor:
        """``batch["tokens"]``/``["labels"]`` [B, S] -> scalar float32 (on
        a tensor-parallel rank: its rows, and the loss of the global
        batch)."""
        x = self._inputs_embed(params, batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)[None, :]
        n = 1 if self.shard is None else self.shard.batch_shards
        h, aux = self._backbone(params, x, positions,
                                moe_group=min(1024, B * S * n), train=True)
        loss = self._lm_loss(params, h, batch) + 0.01 * aux
        if self.shard is not None:
            from repro_torch.models.parallel import scale_grad
            loss = scale_grad(loss, self.shard.loss_scale())
        return loss

    def prefill(self, params, batch) -> torch.Tensor:
        """``batch["tokens"]`` [B, S] -> last-token logits [B, V_padded]."""
        x = self._inputs_embed(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        h, _ = self._backbone(params, x, positions)
        return self._last_logits(params, h)

    # ---- decode -------------------------------------------------------
    def decode_state_shapes(self, shape: ShapeConfig, multi_pod: bool):
        cfg = self.cfg
        slots = (min(cfg.attn_window, shape.seq_len) if cfg.attn_window
                 else shape.seq_len)
        return _kv_shapes(shape.global_batch, slots, cfg.n_layers, cfg,
                          self.dtype, batch_axes(shape.global_batch,
                                                 multi_pod), "model")

    def init_decode_state(self, batch: int, max_len: int) -> DecodeState:
        """An empty state for ``batch`` rows (on a tensor-parallel rank:
        its rows; the caches hold its local kv heads for every slot)."""
        cfg = self.cfg
        slots = min(cfg.attn_window, max_len) if cfg.attn_window else max_len
        n_kv = None if self.shard is None else self._heads.n_kv
        return _kv_state(batch, slots, cfg.n_layers, cfg, self.dtype,
                         self.device, n_kv=n_kv)

    def decode_step(self, params, state: DecodeState, batch):
        """One token for every row: ``batch["tokens"]`` [B, 1] ->
        (logits [B, V_padded], next state).  The caches are written in
        place (see ``attention.cache_write``).  Tokens only: patches feed
        ``loss`` and ``prefill``."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])      # [B, 1, d]
        pos = state.pos
        positions = _decode_positions(x, pos)
        kv_pos = state.kv_pos
        for lp, ck, cv in zip(params["layers"], state.kv_k, state.kv_v):
            lp = self._layer(lp)
            x, kv_pos = _attn_decode(lp, x, ck, cv, state.kv_pos, positions,
                                     pos, cfg, cfg.attn_window, model=self)
            h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
            y, _ = self._ffn(lp, h2, h2.shape[0] * (
                1 if self.shard is None else self.shard.batch_shards))
            x = x + y
        return self._last_logits(params, x), dataclasses.replace(
            state, pos=pos + 1, kv_pos=kv_pos)


def _kv_state(batch: int, slots: int, n_layers: int, cfg: ModelConfig,
              dtype, device, n_kv: Optional[int] = None,
              **more) -> DecodeState:
    """An empty decode state with ``n_layers`` KV caches of ``slots``
    (``n_kv`` kv heads: the config's unless given)."""
    shape = (batch, slots, n_kv or cfg.n_kv_heads, cfg.hd)
    z = lambda: torch.zeros(shape, dtype=dtype, device=device)
    return DecodeState(
        pos=0, kv_k=[z() for _ in range(n_layers)],
        kv_v=[z() for _ in range(n_layers)],
        kv_pos=torch.full((batch, slots), -1, dtype=torch.int32,
                          device=device), **more)


def _decode_positions(x: torch.Tensor, pos: int) -> torch.Tensor:
    return torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                      device=x.device)


def _attn_decode(lp, x, ck, cv, kv_pos, positions, pos: int,
                 cfg: ModelConfig, window, model=None):
    """The attention half of a decode block: norm, q/k/v, the cache write
    (in place) and attention over the cache.  Returns (x + attention,
    slot positions with this token).  ``model``, a ``DenseLM``, projects
    and sums its output (a tensor-parallel rank's heads)."""
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    if model is None:
        q, k, v = qkv(lp["attn"], h, cfg, positions)
    else:
        q, k, v = model._qkv(lp["attn"], h, positions)
    ck, cv, kv_pos = attn.cache_write(ck, cv, kv_pos, k, v, pos)
    o = attn.attention_decode(q, ck, cv, kv_pos, pos, window=window)
    if model is not None:
        return x + model._attn_out(o, lp["attn"]["wo"]), kv_pos
    return x + o.reshape(o.shape[0], 1, -1) @ lp["attn"]["wo"], kv_pos


class SSMLM(LMBase):
    """Mamba-2: attention-free, one SSD mixer per layer."""

    def param_defs(self) -> Dict[str, Any]:
        cfg = self.cfg
        layer = lambda: {"norm": ParamDef((cfg.d_model,), (None,),
                                          ones_init),
                         "mixer": ssm_mod.ssm_defs(cfg.d_model, cfg.ssm)}
        out = self._embed_defs()
        out["layers"] = [layer() for _ in range(cfg.n_layers)]
        return out

    def _block(self, lp, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.constrain(x)
        h = rms_norm(x, lp["norm"], cfg.norm_eps)
        y, _, _ = ssm_mod.ssm_apply(lp["mixer"], h, cfg.ssm,
                                    kernel_mode=cfg.kernel_mode)
        return x + y

    def blocks(self, params, seq_len: int) -> list:
        """The backbone's full-sequence blocks in order, each x -> x."""
        return [functools.partial(self._block, lp) for lp in params["layers"]]

    def _backbone(self, params, x: torch.Tensor, *,
                  train: bool = False) -> torch.Tensor:
        policy = self.cfg.remat if train else "nothing"
        for block in self.blocks(params, x.shape[1]):
            x = remat_wrap(block, policy)(x)
        return x

    def loss(self, params, batch) -> torch.Tensor:
        h = self._backbone(params, self._inputs_embed(params, batch),
                           train=True)
        return self._lm_loss(params, h, batch)

    def prefill(self, params, batch) -> torch.Tensor:
        h = self._backbone(params, self._inputs_embed(params, batch))
        return self._last_logits(params, h)

    def _state_dims(self):
        cfg, ssm = self.cfg, self.cfg.ssm
        conv_dim = ssm.expand * cfg.d_model + 2 * ssm.d_state
        return (ssm.n_heads(cfg.d_model), ssm.head_dim, ssm.d_state,
                conv_dim, ssm.conv_width)

    def decode_state_shapes(self, shape: ShapeConfig, multi_pod: bool):
        B, L = shape.global_batch, self.cfg.n_layers
        H, Pd, N, conv_dim, W = self._state_dims()
        bspec = batch_axes(B, multi_pod)
        structs = DecodeState(
            pos=_meta((), torch.int32),
            ssm_state=[_meta((B, H, Pd, N), torch.float32)
                       for _ in range(L)],
            conv_tail=[_meta((B, W - 1, conv_dim), self.dtype)
                       for _ in range(L)])
        specs = DecodeState(pos=(),
                            ssm_state=[(bspec, "model", None, None)] * L,
                            conv_tail=[(bspec, None, "model")] * L)
        return structs, specs

    def init_decode_state(self, batch: int, max_len: int) -> DecodeState:
        H, Pd, N, conv_dim, W = self._state_dims()
        L, dev = self.cfg.n_layers, self.device
        return DecodeState(
            pos=0,
            ssm_state=[torch.zeros((batch, H, Pd, N), dtype=torch.float32,
                                   device=dev) for _ in range(L)],
            conv_tail=[torch.zeros((batch, W - 1, conv_dim),
                                   dtype=self.dtype, device=dev)
                       for _ in range(L)])

    def decode_step(self, params, state: DecodeState, batch):
        cfg = self.cfg
        x = self._inputs_embed(params, batch)
        states, tails = [], []
        for lp, st, tail in zip(params["layers"], state.ssm_state,
                                state.conv_tail):
            h = rms_norm(x, lp["norm"], cfg.norm_eps)
            y, st, tail = ssm_mod.ssm_apply(lp["mixer"], h, cfg.ssm,
                                            state=st, conv_tail=tail,
                                            decode=True)
            x = x + y
            states.append(st)
            tails.append(tail)
        return self._last_logits(params, x), dataclasses.replace(
            state, pos=state.pos + 1, ssm_state=states, conv_tail=tails)


class HybridLM(LMBase):
    """RecurrentGemma: groups of ``pattern_rec`` RG-LRU blocks and one
    local-attention block; the layers left over after the last whole group
    are recurrent blocks (``trail``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        per = cfg.hybrid.pattern_rec + 1
        self.n_groups = cfg.n_layers // per
        self.n_trail = cfg.n_layers - self.n_groups * per
        self.lru = cfg.hybrid.lru_width or cfg.d_model

    def _rec_defs(self):
        cfg = self.cfg
        return {"norm1": ParamDef((cfg.d_model,), (None,), ones_init),
                "rec": rglru_mod.rglru_defs(cfg.d_model, self.lru),
                "norm2": ParamDef((cfg.d_model,), (None,), ones_init),
                "mlp": mlp_mod.mlp_defs(cfg.d_model, cfg.d_ff, cfg.mlp_act)}

    def _attn_block_defs(self):
        cfg = self.cfg
        return {"norm1": ParamDef((cfg.d_model,), (None,), ones_init),
                "attn": attn_defs(cfg),
                "norm2": ParamDef((cfg.d_model,), (None,), ones_init),
                "mlp": mlp_mod.mlp_defs(cfg.d_model, cfg.d_ff, cfg.mlp_act)}

    def param_defs(self) -> Dict[str, Any]:
        pr = self.cfg.hybrid.pattern_rec
        out = self._embed_defs()
        out["groups"] = [{"rec": [self._rec_defs() for _ in range(pr)],
                          "attn_blk": self._attn_block_defs()}
                         for _ in range(self.n_groups)]
        if self.n_trail:
            out["trail"] = [self._rec_defs() for _ in range(self.n_trail)]
        return out

    # ---- blocks -------------------------------------------------------
    def _rec_block(self, lp, x, h0=None, tail=None, decode=False):
        cfg = self.cfg
        if not decode:
            x = self.constrain(x)
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        y, h_last, tail = rglru_mod.rglru_block_apply(
            lp["rec"], h, h0=h0, conv_tail=tail, decode=decode,
            kernel_mode=cfg.kernel_mode)
        x = x + y
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        return x + mlp_mod.mlp_apply(lp["mlp"], h2, cfg.mlp_act), h_last, tail

    def _attn_block(self, lp, x, positions):
        cfg = self.cfg
        x = self.constrain(x)
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        q, k, v = qkv(lp["attn"], h, cfg, positions)
        o = attn.attention_prefill(q, k, v, causal=True,
                                   window=cfg.hybrid.attn_window,
                                   kernel_mode=cfg.kernel_mode)
        x = x + o.reshape(o.shape[0], o.shape[1], -1) @ lp["attn"]["wo"]
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        return x + mlp_mod.mlp_apply(lp["mlp"], h2, cfg.mlp_act)

    def blocks(self, params, seq_len: int) -> list:
        """The backbone's full-sequence blocks in order, each x -> x."""
        positions = torch.arange(seq_len, device=self.device)[None, :]
        rec = lambda lp: lambda x: self._rec_block(lp, x)[0]
        out = []
        for g in params["groups"]:
            out += [rec(lp) for lp in g["rec"]]
            out.append(functools.partial(self._attn_block, g["attn_blk"],
                                         positions=positions))
        return out + [rec(lp) for lp in params.get("trail", [])]

    def _backbone(self, params, x: torch.Tensor, *,
                  train: bool = False) -> torch.Tensor:
        """Every block; under ``cfg.remat`` when ``train``, each group (its
        recurrent blocks and its attention block) as one unit and the
        trailing blocks kept whole, as the JAX package does."""
        blocks = self.blocks(params, x.shape[1])
        policy = self.cfg.remat if train else "nothing"
        per = self.cfg.hybrid.pattern_rec + 1
        n = self.n_groups * per
        for fn in [remat_wrap(_chain(blocks[i:i + per]), policy)
                   for i in range(0, n, per)] + blocks[n:]:
            x = fn(x)
        return x

    def loss(self, params, batch) -> torch.Tensor:
        h = self._backbone(params, self._inputs_embed(params, batch),
                           train=True)
        return self._lm_loss(params, h, batch)

    def prefill(self, params, batch) -> torch.Tensor:
        h = self._backbone(params, self._inputs_embed(params, batch))
        return self._last_logits(params, h)

    # ---- decode -------------------------------------------------------
    def decode_state_shapes(self, shape: ShapeConfig, multi_pod: bool):
        cfg = self.cfg
        B = shape.global_batch
        n_rec = self.n_groups * cfg.hybrid.pattern_rec + self.n_trail
        bspec = batch_axes(B, multi_pod)
        return _kv_shapes(
            B, min(cfg.hybrid.attn_window, shape.seq_len), self.n_groups,
            cfg, self.dtype, bspec, "model" if cfg.n_kv_heads == 1 else None,
            rec_h=([_meta((B, self.lru), torch.float32)
                    for _ in range(n_rec)], [(bspec, "model")] * n_rec),
            rec_tail=([_meta((B, 3, self.lru), self.dtype)
                       for _ in range(n_rec)],
                      [(bspec, None, "model")] * n_rec))

    def init_decode_state(self, batch: int, max_len: int) -> DecodeState:
        cfg = self.cfg
        n_rec = self.n_groups * cfg.hybrid.pattern_rec + self.n_trail
        dev = self.device
        return _kv_state(
            batch, min(cfg.hybrid.attn_window, max_len), self.n_groups, cfg,
            self.dtype, dev,
            rec_h=[torch.zeros((batch, self.lru), dtype=torch.float32,
                               device=dev) for _ in range(n_rec)],
            rec_tail=[torch.zeros((batch, 3, self.lru), dtype=self.dtype,
                                  device=dev) for _ in range(n_rec)])

    def decode_step(self, params, state: DecodeState, batch):
        cfg = self.cfg
        x = self._inputs_embed(params, batch)
        pos = state.pos
        positions = _decode_positions(x, pos)
        rec_h, rec_tail = [], []

        def rec(lp, x):
            i = len(rec_h)
            x, h, tail = self._rec_block(lp, x, h0=state.rec_h[i],
                                         tail=state.rec_tail[i], decode=True)
            rec_h.append(h)
            rec_tail.append(tail)
            return x

        kv_pos = state.kv_pos
        for g, ck, cv in zip(params["groups"], state.kv_k, state.kv_v):
            for lp in g["rec"]:
                x = rec(lp, x)
            lp = g["attn_blk"]
            x, kv_pos = _attn_decode(lp, x, ck, cv, state.kv_pos, positions,
                                     pos, cfg, cfg.hybrid.attn_window)
            h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
            x = x + mlp_mod.mlp_apply(lp["mlp"], h2, cfg.mlp_act)
        for lp in params.get("trail", []):
            x = rec(lp, x)
        if not state.kv_k:              # no attention block: no cache write
            kv_pos = state.kv_pos.clone()
            kv_pos[:, pos % kv_pos.shape[1]] = pos
        return self._last_logits(params, x), dataclasses.replace(
            state, pos=pos + 1, kv_pos=kv_pos, rec_h=rec_h,
            rec_tail=rec_tail)


class EncDecLM(LMBase):
    """Whisper: an encoder of bidirectional attention blocks over
    ``batch["frames"]`` [B, F, d] (the audio front end is a stub), then
    decoder blocks of causal self-attention, cross-attention to the
    encoder output and an MLP.  The cross-attention's queries take RoPE at
    position 0 and its keys at the encoder positions, as in the JAX
    package."""

    # ---- parameters ---------------------------------------------------
    def _enc_layer_defs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {"norm1": ParamDef((cfg.d_model,), (None,), ones_init),
                "attn": attn_defs(cfg),
                "norm2": ParamDef((cfg.d_model,), (None,), ones_init),
                "mlp": mlp_mod.mlp_defs(cfg.d_model, cfg.d_ff, cfg.mlp_act)}

    def _dec_layer_defs(self) -> Dict[str, Any]:
        d = self._enc_layer_defs()
        d["norm_x"] = ParamDef((self.cfg.d_model,), (None,),
                               ones_init)
        d["xattn"] = attn_defs(self.cfg)
        return d

    def param_defs(self) -> Dict[str, Any]:
        cfg = self.cfg
        out = self._embed_defs()
        out["enc_layers"] = [self._enc_layer_defs()
                             for _ in range(cfg.n_encoder_layers)]
        out["enc_norm"] = ParamDef((cfg.d_model,), (None,), ones_init)
        out["dec_layers"] = [self._dec_layer_defs()
                             for _ in range(cfg.n_layers)]
        return out

    # ---- forward ------------------------------------------------------
    def _mlp(self, lp, x: torch.Tensor) -> torch.Tensor:
        h2 = rms_norm(x, lp["norm2"], self.cfg.norm_eps)
        return x + mlp_mod.mlp_apply(lp["mlp"], h2, self.cfg.mlp_act)

    def _enc_block(self, lp, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        q, k, v = qkv(lp["attn"], h, cfg, positions)
        o = attn.attention_prefill(q, k, v, causal=False,
                                   kernel_mode=cfg.kernel_mode)
        x = x + o.reshape(o.shape[0], o.shape[1], -1) @ lp["attn"]["wo"]
        return self._mlp(lp, x)

    def _encode(self, params, frames, *, train: bool = False):
        """The encoder output (after its final norm) [B, F, d]."""
        x = torch.as_tensor(frames, device=self.device).to(self.dtype)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        block = remat_wrap(self._enc_block,
                           self.cfg.remat if train else "nothing")
        for lp in params["enc_layers"]:
            x = block(lp, x, positions)
        return rms_norm(x, params["enc_norm"], self.cfg.norm_eps)

    def _cross_q(self, p, hx: torch.Tensor) -> torch.Tensor:
        """The cross-attention's queries [B, S, H, hd]: ``qkv``'s q, with
        RoPE at position 0 (the keys and values come from the encoder)."""
        cfg = self.cfg
        B, S, _ = hx.shape
        q = hx @ p["wq"]
        if cfg.qkv_bias:
            q = q + p["bq"]
        zeros = torch.zeros((B, S), dtype=torch.int32, device=hx.device)
        return attn.apply_rope(q.reshape(B, S, cfg.n_heads, cfg.hd), zeros,
                               cfg.rope_theta)

    def _cross_kv(self, p, enc: torch.Tensor):
        """The cross-attention's keys (RoPE at the encoder positions) and
        values from the encoder output: [B, F, Kv, hd] each."""
        cfg = self.cfg
        B, F, _ = enc.shape
        kx, vx = enc @ p["wk"], enc @ p["wv"]
        if cfg.qkv_bias:
            kx, vx = kx + p["bk"], vx + p["bv"]
        enc_pos = torch.arange(F, device=enc.device)[None, :]
        kx = attn.apply_rope(kx.reshape(B, F, cfg.n_kv_heads, cfg.hd),
                             enc_pos, cfg.rope_theta)
        return kx, vx.reshape(B, F, cfg.n_kv_heads, cfg.hd)

    def _dec_block(self, lp, x: torch.Tensor, enc: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        q, k, v = qkv(lp["attn"], h, cfg, positions)
        o = attn.attention_prefill(q, k, v, causal=True,
                                   kernel_mode=cfg.kernel_mode)
        x = x + o.reshape(o.shape[0], o.shape[1], -1) @ lp["attn"]["wo"]
        hx = rms_norm(x, lp["norm_x"], cfg.norm_eps)
        qx = self._cross_q(lp["xattn"], hx)
        kx, vx = self._cross_kv(lp["xattn"], enc)
        ox = attn.attention_prefill(qx, kx, vx, causal=False,
                                    kernel_mode=cfg.kernel_mode)
        x = x + ox.reshape(ox.shape[0], ox.shape[1], -1) @ lp["xattn"]["wo"]
        return self._mlp(lp, x)

    def _decode_stack(self, params, batch, *, train: bool = False):
        """The encoder, then every decoder layer (both stacks under
        ``cfg.remat`` when ``train``); h before the final norm."""
        enc = self._encode(params, batch["frames"], train=train)
        x = self._embed(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        block = remat_wrap(self._dec_block,
                           self.cfg.remat if train else "nothing")
        for lp in params["dec_layers"]:
            x = block(lp, x, enc, positions)
        return x

    def loss(self, params, batch) -> torch.Tensor:
        """``batch["frames"]`` [B, F, d], ``["tokens"]``/``["labels"]``
        [B, S] -> scalar float32."""
        h = self._decode_stack(params, batch, train=True)
        return self._lm_loss(params, h, batch)

    def prefill(self, params, batch) -> torch.Tensor:
        """-> last-token logits [B, V_padded]."""
        return self._last_logits(params, self._decode_stack(params, batch))

    # ---- decode -------------------------------------------------------
    def decode_state_shapes(self, shape: ShapeConfig, multi_pod: bool):
        cfg = self.cfg
        B, L = shape.global_batch, cfg.n_layers
        bspec = batch_axes(B, multi_pod)
        xkv = (B, cfg.encoder_len, cfg.n_kv_heads, cfg.hd)
        cross = lambda: ([_meta(xkv, self.dtype) for _ in range(L)],
                         [(bspec, None, None, None)] * L)
        return _kv_shapes(B, shape.seq_len, L, cfg, self.dtype, bspec,
                          "model", cross_k=cross(), cross_v=cross())

    def init_decode_state(self, batch: int, max_len: int) -> DecodeState:
        """Self-attention caches of ``max_len`` slots, and cross-attention
        caches of ``cfg.encoder_len`` left zero, as in the JAX package."""
        cfg = self.cfg
        shape = (batch, cfg.encoder_len, cfg.n_kv_heads, cfg.hd)
        z = lambda: [torch.zeros(shape, dtype=self.dtype, device=self.device)
                     for _ in range(cfg.n_layers)]
        return _kv_state(batch, max_len, cfg.n_layers, cfg, self.dtype,
                         self.device, cross_k=z(), cross_v=z())

    def decode_step(self, params, state: DecodeState, batch):
        """One token for every row: ``batch["tokens"]`` [B, 1] -> (logits
        [B, V_padded], next state); the cross-attention reads every slot
        of ``state.cross_k``/``cross_v`` (``batch["frames"]`` is not
        read)."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        pos = state.pos
        positions = _decode_positions(x, pos)
        F = state.cross_k[0].shape[1]
        xpos = torch.arange(F, dtype=torch.int32,
                            device=x.device).expand(x.shape[0], F)
        kv_pos = state.kv_pos
        for lp, ck, cv, xk, xv in zip(params["dec_layers"], state.kv_k,
                                      state.kv_v, state.cross_k,
                                      state.cross_v):
            x, kv_pos = _attn_decode(lp, x, ck, cv, state.kv_pos, positions,
                                     pos, cfg, None)
            hx = rms_norm(x, lp["norm_x"], cfg.norm_eps)
            ox = attn.attention_decode(self._cross_q(lp["xattn"], hx), xk,
                                       xv, xpos, F)
            x = x + ox.reshape(ox.shape[0], 1, -1) @ lp["xattn"]["wo"]
            x = self._mlp(lp, x)
        return self._last_logits(params, x), dataclasses.replace(
            state, pos=pos + 1, kv_pos=kv_pos)


FAMILIES = {"dense": DenseLM, "moe": DenseLM, "vlm": DenseLM, "ssm": SSMLM,
            "hybrid": HybridLM, "encdec": EncDecLM}


def build_model(cfg: ModelConfig, device=None) -> LMBase:
    """The model for ``cfg`` on ``device`` (the card unless ``"cpu"`` is
    asked for)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} (one of "
                         f"{', '.join(sorted(FAMILIES))})")
    return FAMILIES[cfg.family](cfg, device=device)
