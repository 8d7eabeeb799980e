"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427), as
the JAX package's ``repro.models.rglru``.

    r_t = sigmoid(W_r u_t + b_r)            (recurrence gate)
    i_t = sigmoid(W_i u_t + b_i)            (input gate)
    a_t = exp(-c * softplus(L) * r_t)       (c = 8, L learnable)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The gate projections are 16-block block-diagonal.  The block is Griffin's:
(gate branch: linear + GeLU) * (conv1d + RG-LRU branch), then a linear
out-projection.  The full-sequence recurrence is
``repro_torch.kernels.rglru.ops.rglru_scan_kernel``, which alone decides
between the RG-LRU CUDA kernel (CUDA tensors) and the plain version,
:func:`rglru_scan` (CPU tensors, or ``KernelMode.TORCH``: a doubling scan
within chunks of 2048 steps and a state carried across chunks).  The
one-token decode update is plain PyTorch, as in JAX.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels.rglru.ops import rglru_scan_kernel
from repro_torch.models.common import ParamDef, gelu_f32, ones_init, zeros_init
from repro_torch.models.ssm import causal_conv

RG_LRU_C = 8.0
N_GATE_BLOCKS = 16


def rglru_defs(d_model: int, lru_width: int) -> Dict[str, ParamDef]:
    blk = lru_width // N_GATE_BLOCKS
    return {
        "w_gate": ParamDef((d_model, lru_width), ("fsdp", "tp")),
        "w_branch": ParamDef((d_model, lru_width), ("fsdp", "tp")),
        "conv_w": ParamDef((4, lru_width), (None, "tp")),
        "conv_b": ParamDef((lru_width,), ("tp",), zeros_init),
        "w_r": ParamDef((N_GATE_BLOCKS, blk, blk), (None, None, "tp")),
        "b_r": ParamDef((lru_width,), ("tp",), zeros_init),
        "w_i": ParamDef((N_GATE_BLOCKS, blk, blk), (None, None, "tp")),
        "b_i": ParamDef((lru_width,), ("tp",), zeros_init),
        "lam": ParamDef((lru_width,), ("tp",), ones_init),
        "w_out": ParamDef((lru_width, d_model), ("tp", "fsdp")),
    }


def _block_diag(u: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """u: [B, S, lru]; w: [nb, blk, blk] block-diagonal projection."""
    B, S, L = u.shape
    nb, blk, _ = w.shape
    out = torch.einsum("bsnk,nkj->bsnj", u.reshape(B, S, nb, blk), w)
    return out.reshape(B, S, L) + b


def rglru_scan(u: torch.Tensor, a: torch.Tensor, h0: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + u_t (the gated input is prefolded), the plain
    version: ``rglru_scan_kernel``'s plain branch.  u: [B, S, L] gated
    inputs; a: [B, S, L] decays in (0, 1).  Returns (h [B, S, L] in
    u.dtype, h_last [B, L] float32)."""
    return rglru_scan_kernel(u, a, h0, mode=KernelMode.TORCH)


def rglru_block_apply(params, x: torch.Tensor,
                      h0: Optional[torch.Tensor] = None,
                      conv_tail: Optional[torch.Tensor] = None, *,
                      decode: bool = False, kernel_mode=None):
    """The Griffin recurrent block.  Returns (y, h_last, new_conv_tail)."""
    gate = gelu_f32(x @ params["w_gate"]).to(x.dtype)
    u_in = x @ params["w_branch"]
    new_tail = None
    if decode:
        u = causal_conv(u_in, params["conv_w"], params["conv_b"], conv_tail)
        new_tail = torch.cat([conv_tail, u_in], dim=1)[:, 1:]
    else:
        u = causal_conv(u_in, params["conv_w"], params["conv_b"])

    r = torch.sigmoid(_block_diag(u, params["w_r"], params["b_r"]).float())
    i = torch.sigmoid(_block_diag(u, params["w_i"], params["b_i"]).float())
    log_a = -RG_LRU_C * F.softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    gated = (torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
             * i * u.float()).to(x.dtype)

    if decode:
        assert x.shape[1] == 1 and h0 is not None
        h_last = h0.float() * a[:, 0] + gated[:, 0].float()
        h = h_last[:, None].to(x.dtype)
    else:
        h, h_last = rglru_scan_kernel(gated, a, h0, mode=kernel_mode)

    y = h * gate
    return y @ params["w_out"], h_last, new_tail
