"""Entry points of the crossbar-dispatch kernels for the fabric's kernel
backend: the zero-packet case, dtype normalisation and the kernel mode.

The TPU entry points padded the token axis to the kernel block size with
``dst = -1`` rows and sliced the result back to ``T``.  The CUDA kernels
mask their ragged last block themselves, so nothing is padded here and
every output already has ``T`` rows; the plain versions are
block-invariant, so both give the same plan.
"""
from __future__ import annotations

import torch

from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels.crossbar_dispatch import kernel as _k

I32 = torch.int32


def _plan_multi(dst: torch.Tensor, src: torch.Tensor,
                allowed_sd: torch.Tensor, quota_sd: torch.Tensor, *,
                mode=KernelMode.AUTO):
    """Fused grant decisions for all source regions' packets in one launch.

    ``dst``/``src`` [T]; ``allowed_sd``/``quota_sd`` [S, S] indexed
    [src, dst] (reset folded into ``allowed_sd``).  Returns (keep, rank,
    err, granted [S, S]) with capacity not applied: the backend composes
    the WRR slots from ``granted`` and cuts at capacity."""
    n_ports = allowed_sd.shape[0]
    if dst.shape[0] == 0:              # zero-packet round: nothing granted
        z = torch.zeros((0,), dtype=I32, device=dst.device)
        return z, z, z, torch.zeros((n_ports, n_ports), dtype=I32,
                                    device=dst.device)
    return _k.plan_multi(dst, src, allowed_sd.to(I32), quota_sd.to(I32),
                         mode=mode)


def _dispatch(x: torch.Tensor, dst: torch.Tensor, keep: torch.Tensor,
              slot: torch.Tensor, *, n_ports: int, capacity: int,
              mode=KernelMode.AUTO) -> torch.Tensor:
    """Pack granted packets [T, D] into slabs [n_ports, capacity, D]."""
    if x.shape[0] == 0:
        return torch.zeros((n_ports, capacity, x.shape[1]), dtype=x.dtype,
                           device=x.device)
    return _k.scatter(x, dst, keep.to(I32), slot, n_ports=n_ports,
                      capacity=capacity, mode=mode)


def _combine(y: torch.Tensor, dst: torch.Tensor, keep: torch.Tensor,
             slot: torch.Tensor, weights: torch.Tensor, *,
             mode=KernelMode.AUTO) -> torch.Tensor:
    """Gather slabs [S, C, D] back to packets [T, D], weighted."""
    if dst.shape[0] == 0:
        return torch.zeros((0, y.shape[2]), dtype=y.dtype, device=y.device)
    return _k.combine(y, dst, keep.to(I32), slot, weights.to(torch.float32),
                      mode=mode)
