"""Mamba-2 block: chunked state-space duality (SSD), as the JAX package's
``repro.models.ssm`` (arXiv:2405.21060).

Shapes (per layer): d_inner = expand * d_model, H heads of dim P, state N.
The in-projection gives (z, x, B, C, dt); (x, B, C) pass through a causal
depthwise conv of width 4; the scan uses per-head scalar decay
``A = -exp(a_log)``.  Decode keeps an O(1) state, [B, H, P, N] and the
conv tail.

The full-sequence scan is ``repro_torch.kernels.ssd.ops.ssd_scan``, which
alone decides between the SSD CUDA kernel (CUDA tensors) and the plain
version, :func:`ssd_chunked` (CPU tensors, or ``KernelMode.TORCH``).  The
one-token decode update is plain PyTorch, as in JAX.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels.ssd.ops import ssd_scan
from repro_torch.models.common import (ParamDef, ones_init, rms_norm,
                                       zeros_init)
from repro_torch.models.config import SSMConfig


def ssm_defs(d_model: int, ssm: SSMConfig) -> Dict[str, ParamDef]:
    d_inner = ssm.expand * d_model
    H = ssm.n_heads(d_model)
    N = ssm.d_state
    conv_dim = d_inner + 2 * N
    d_in = 2 * d_inner + 2 * N + H
    return {
        "in_proj": ParamDef((d_model, d_in), ("fsdp", "tp")),
        "conv_w": ParamDef((ssm.conv_width, conv_dim), (None, "tp")),
        "conv_b": ParamDef((conv_dim,), ("tp",), zeros_init),
        "a_log": ParamDef((H,), (None,), ones_init),
        "dt_bias": ParamDef((H,), (None,), zeros_init),
        "d_skip": ParamDef((H,), (None,), ones_init),
        "norm_g": ParamDef((d_inner,), ("tp",), ones_init),
        "out_proj": ParamDef((d_inner, d_model), ("tp", "fsdp")),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv of width W, no activation: x [B, S, C], w
    [W, C]; ``tail`` holds the previous W-1 inputs [B, W-1, C] (decode
    continuation), zeros when None."""
    W = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def _causal_conv(x, w, b, tail=None) -> torch.Tensor:
    """The SSM's conv: :func:`causal_conv`, then SiLU in float32."""
    return F.silu(causal_conv(x, w, b, tail).float()).to(x.dtype)


def _split_proj(h: torch.Tensor, d_inner: int, N: int, H: int):
    return torch.split(h, [d_inner, d_inner + 2 * N, H], dim=-1)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, the plain version.

    x: [B, S, H, P]; dt: [B, S, H] (>= 0); A: [H] (< 0); Bm, Cm: [B, S, N]
    (single group).  Returns (y [B, S, H, P] in x.dtype, h_last [B, H, P,
    N] float32).  It is ``ssd_scan``'s plain branch: the algebra of the SSD
    kernel's plain version (``kernels/ssd/ref.py``), run head-major."""
    return ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0,
                    mode=KernelMode.TORCH)


def ssm_apply(params, x: torch.Tensor, ssm: SSMConfig,
              state: Optional[torch.Tensor] = None,
              conv_tail: Optional[torch.Tensor] = None, *,
              decode: bool = False, kernel_mode=None, shard=None):
    """The Mamba-2 mixer.  Returns (y, new_state, new_conv_tail).

    ``shard`` (a ``parallel.ShardCtx``) runs it as one model rank: the
    leaves are the rank's (``parallel.layout_specs``: its heads' z, x and
    dt, its block of B and C), B and C are gathered over ``model`` after
    the conv (every head reads the whole state width), the gated norm's
    sum of squares is summed over ``model``, and ``out_proj``'s partial
    sums end in a sum over ``model``.  ``state`` and ``conv_tail`` hold
    the rank's heads and channels."""
    B, S, d_model = x.shape
    d_inner = ssm.expand * d_model
    H, N, P = ssm.n_heads(d_model), ssm.d_state, ssm.head_dim
    M = 1 if shard is None else shard.size("model")
    d_loc, N_loc, H_loc = d_inner // M, N // M, H // M
    per_head = ((lambda w: w) if shard is None else shard.tp_slice)

    if shard is not None:
        x = shard.tp_in(x)
    h = x @ params["in_proj"]
    z, xBC, dt_raw = _split_proj(h, d_loc, N_loc, H_loc)
    new_tail = None
    if decode:
        new_tail = torch.cat([conv_tail, xBC], dim=1)[:, 1:]
        xBC = _causal_conv(xBC, params["conv_w"], params["conv_b"],
                           conv_tail)
    else:
        xBC = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    xs, Bm, Cm = torch.split(xBC, [d_loc, N_loc, N_loc], dim=-1)
    if shard is not None:
        Bm, Cm = shard.tp_gather(Bm, -1), shard.tp_gather(Cm, -1)
    xs = xs.reshape(B, S, H_loc, P)
    dt = F.softplus(dt_raw.float() + per_head(params["dt_bias"]).float())
    A = -torch.exp(per_head(params["a_log"]).float())

    if decode:
        # O(1) state update: h' = exp(dt A) h + dt x B^T ; y = h' C + D x
        assert S == 1 and state is not None
        dec = torch.exp(dt[:, 0] * A)                        # [B, H]
        upd = torch.einsum("bh,bhp,bn->bhpn", dt[:, 0], xs[:, 0].float(),
                           Bm[:, 0].float())
        new_state = state * dec[..., None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", new_state,
                         Cm[:, 0].float())[:, None]
    else:
        y, new_state = ssd_scan(xs, dt, A, Bm, Cm, chunk=ssm.chunk, h0=state,
                                mode=kernel_mode)

    y = y + per_head(params["d_skip"]).float()[:, None] * xs.float()
    y = y.reshape(B, S, d_loc).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    stat = None if M == 1 else (lambda ms: shard.tp_stat(ms / M))
    y = rms_norm(y, params["norm_g"], reduce=stat) @ params["out_proj"]
    return (y if shard is None else shard.tp_out(y)), new_state, new_tail
