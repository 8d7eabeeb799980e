"""Public entry point of the SSD chunk-scan kernel, in the model's layout.

``ssd_scan`` is the drop-in for ``repro_torch.models.ssm.ssd_chunked``
(as ``repro/kernels/ssd/ops.py:ssd_scan`` is for the JAX model's): it
moves x and dt to head-major, forms ``dA = dt * A`` and calls
``kernel.ssd_call`` inside a ``torch.autograd.Function`` whose backward
is ``kernel.ssd_call_bwd``.  Each wrapper launches its kernel for CUDA
tensors and runs its plain version (``ref.ssd_call_ref``,
``ref.ssd_bwd_ref``) for CPU tensors or under ``KernelMode.TORCH``;
neither gives way to the other.  The Function returns gradients for x, dA,
dt, B, C and h0; autograd carries ``dA = dt * A`` back to dt and A and the
transposes back to the model layout.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels.ssd import kernel as _k


class _SSDScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dA, dt, Bm, Cm, h0, chunk, mode):
        ctx.save_for_backward(x, dA, dt, Bm, Cm, h0)
        ctx.chunk, ctx.mode = chunk, mode
        return _k.ssd_call(x, dA, dt, Bm, Cm, chunk=chunk, h0=h0, mode=mode)

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dA, dt, Bm, Cm, h0 = ctx.saved_tensors
        grads = _k.ssd_call_bwd(x, dA, dt, Bm, Cm, dy, chunk=ctx.chunk,
                                h0=h0, dh_last=dh_last, mode=ctx.mode)
        return (*grads, None, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256,
             h0: Optional[torch.Tensor] = None,
             mode=KernelMode.AUTO) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, H, P]; dt: [B, S, H]; A: [H] (< 0); Bm, Cm: [B, S, N];
    ``h0`` [B, H, P, N] or None.  ``chunk`` is cut to S when S is shorter;
    S must be a multiple of it.  Returns (y [B, S, H, P] in x.dtype,
    h_last [B, H, P, N] float32)."""
    S = x.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} must divide the SSD chunk {chunk}")
    xh = x.transpose(1, 2)                                  # [B, H, S, P]
    dth = dt.transpose(1, 2).float()                        # [B, H, S]
    dAh = dth * A.float()[None, :, None]
    h0 = None if h0 is None else h0.float()
    y, h_last = _SSDScan.apply(xh, dAh, dth, Bm, Cm, h0, chunk, mode)
    return y.transpose(1, 2), h_last
