"""Decoder-only LM for the ``dense`` and ``moe`` families.

The contract of the JAX package's ``DenseLM`` on its decode path:

- ``init(gen)``                          parameters from a torch.Generator
- ``init_decode_state(batch, max_len)``  an empty KV cache
- ``decode_step(params, state, batch)``  one token with cached state

Layers are kept apart (``params["layers"]`` is a list of per-layer dicts)
and run in a Python loop; the JAX package stacks them [L, ...] and scans.
``ckpt.convert.params_from_numpy`` unstacks JAX parameters into this
layout.  The other families (ssm, hybrid, encdec, vlm) are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

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
                                         kernel_mode=cfg.moe.kernel_mode)
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
