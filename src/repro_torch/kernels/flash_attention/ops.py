"""Public entry point of the flash-attention kernels.

Takes the model layout ([B, S, H, D] / [B, S, Kv, D]) and returns
[B, Sq, H, D].  The TPU entry point padded both sequence lengths to the
block sizes, transposed to head-major and masked the padded keys with
``true_k``; the CUDA kernels read the model layout in place and mask
their ragged tiles themselves, so nothing is padded or transposed and
``true_k`` is ``Sk``.

``flash_attention`` is differentiable: a ``torch.autograd.Function``
whose backward is the backward kernel (on the CPU, the plain version of
each).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels.flash_attention import kernel as _k


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, mode):
        o, lse = _k.flash_fwd(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, mode=mode)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = dict(causal=causal, window=window, q_offset=q_offset,
                        mode=mode)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _k.flash_bwd(q, k, v, o, lse, do, **ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, mode=KernelMode.AUTO) -> torch.Tensor:
    """q: [B, Sq, H, D]; k, v: [B, Sk, Kv, D] -> [B, Sq, H, D] in q.dtype.

    ``window``: keys in (pos - window, pos]; ``q_offset``: absolute
    position of q[0] relative to k[0] (cross-chunk continuation)."""
    return _FlashAttention.apply(q, k, v, causal, window, q_offset, mode)
