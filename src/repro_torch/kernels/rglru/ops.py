"""Public entry point of the RG-LRU recurrence kernels.

``rglru_scan_kernel`` is the drop-in for
``repro_torch.models.rglru.rglru_scan`` (as
``repro/kernels/rglru/ops.py:rglru_scan_kernel`` is for the JAX model's).
It is a ``torch.autograd.Function`` on every device: the forward is
``kernel.rglru_scan``, which keeps each tile's float32 carry for the
backward when one can follow (grad mode on, an input that requires
grad), and the backward is ``kernel.rglru_scan_bwd``.  Each of the two
wrappers launches its kernel for CUDA tensors and runs its plain version
(``ref.rglru_call_ref``, ``ref.rglru_bwd_ref``) for CPU tensors or under
``KernelMode.TORCH``; neither gives way to the other.  The forward kernel
reads u in its own type, folds an initial state ``h0`` in as a virtual
first step, ``b_0 = a_0 * h0 + u_0``, exactly as the JAX entry point does,
and writes h in u's type: no conversion or concatenation runs around it.
The Function returns gradients for u, a and h0 (the JAX package's autodiff
through its doubling scan gives the same function).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels.rglru import kernel as _k


class _RGLRUScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, u, a, h0, mode, differentiable):
        h, h_last, *carries = _k.rglru_scan(u, a, h0, mode=mode,
                                            save_carries=differentiable)
        carries = carries[0] if carries else None
        ctx.save_for_backward(u, a, h0, carries)
        ctx.mode = mode
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        u, a, h0, carries = ctx.saved_tensors
        du, da, dh0 = _k.rglru_scan_bwd(u, a, h0, dh, dh_last, carries,
                                        mode=ctx.mode)
        return du, da, dh0, None, None


def rglru_scan_kernel(u: torch.Tensor, a: torch.Tensor,
                      h0: Optional[torch.Tensor] = None, *,
                      mode=KernelMode.AUTO
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: [B, S, L] gated inputs; a: [B, S, L] decays in (0, 1); ``h0``
    [B, L] or None.  Returns (h [B, S, L] in u.dtype, h_last [B, L]
    float32)."""
    if h0 is not None:
        h0 = h0.float()
    a = a.float()
    differentiable = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (u, a, h0))
    return _RGLRUScan.apply(u, a, h0, mode, differentiable)
