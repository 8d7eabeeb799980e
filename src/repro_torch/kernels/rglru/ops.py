"""Public entry point of the RG-LRU recurrence kernel.

``rglru_scan_kernel`` is the drop-in for
``repro_torch.models.rglru.rglru_scan`` (as
``repro/kernels/rglru/ops.py:rglru_scan_kernel`` is for the JAX model's).
It is the one place that chooses between kernel and plain version.  On CUDA
tensors ``kernel.rglru_scan`` launches the kernel once, inside a
``torch.autograd.Function`` whose backward raises: the kernel has no
backward yet, as the TPU kernel had none (ROADMAP B8, the recurrent
families' backward kernels).  The kernel reads u in its own type, folds an
initial state ``h0`` in as a virtual first step, ``b_0 = a_0 * h0 + u_0``,
exactly as the JAX entry point does, and writes h in u's type: no
conversion or concatenation runs around it.  On CPU tensors, or under
``KernelMode.TORCH``, it is the model's plain version (``rglru_scan``):
the chunked doubling scan with ``h0`` as its carry, through which autograd
runs as usual.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.fabric.interface import KernelMode, use_kernel
from repro_torch.kernels.rglru import kernel as _k

BACKWARD_ITEM = ("the RG-LRU kernel has no backward yet (ROADMAP B8: the "
                 "recurrent families' backward kernels)")


class _RGLRUScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, u, a, h0, mode):
        return _k.rglru_scan(u, a, h0, mode=mode)

    @staticmethod
    def backward(ctx, dh, dh_last):
        raise NotImplementedError(BACKWARD_ITEM)


def rglru_scan_kernel(u: torch.Tensor, a: torch.Tensor,
                      h0: Optional[torch.Tensor] = None, *,
                      mode=KernelMode.AUTO
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: [B, S, L] gated inputs; a: [B, S, L] decays in (0, 1); ``h0``
    [B, L] or None.  Returns (h [B, S, L] in u.dtype, h_last [B, L]
    float32)."""
    tensors = (u, a) + (() if h0 is None else (h0,))
    if use_kernel(mode, *tensors):
        return _RGLRUScan.apply(u, a.float(), h0, mode)
    return _k.rglru_scan(u, a, h0, mode=KernelMode.TORCH)
