"""Entry points of the crossbar-dispatch kernels: the private ``_plan``,
``_plan_multi``, ``_dispatch`` and ``_combine`` (the zero-packet case,
dtype normalisation and the kernel mode), as the JAX package has them,
and the deprecated public shims ``crossbar_plan``, ``crossbar_dispatch``
and ``crossbar_combine`` over them, which warn as the JAX package's do.
The fabric's kernel backend moves its data through ``_dispatch`` and
``_combine`` and takes its whole plan from ``kernel.plan_fabric``; the
shims are the only callers of the single-source ``_plan``.

The TPU entry points padded the token axis to the kernel block size with
``dst = -1`` rows and sliced the result back to ``T``.  The CUDA kernels
mask their ragged last block themselves, so nothing is padded here and
every output already has ``T`` rows; the plain versions are
block-invariant, so both give the same plan.

The scatter and the combine carry their gradients as
``torch.autograd.Function``s that mirror the JAX package's
``_dispatch_core``/``_combine_core`` custom VJPs: each backward replays the
flat ``dst * C + slot`` route of its forward.  Where a backward is the
same pure row move as a forward kernel it launches that kernel (the
dispatch backward is the combine's unit-weight form, ``weights=None``; the
combine's ``d_y`` is a scatter of the weighted cotangent, and its gathered
rows for ``d_w`` are the unit-weight combine); the row dot of ``d_w`` is
plain PyTorch.  Oracles: ``ref.dispatch_bwd_ref`` and
``ref.combine_bwd_ref``.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels.crossbar_dispatch import kernel as _k

I32 = torch.int32


def _warn_deprecated(what: str) -> None:
    warnings.warn(
        f"DEPRECATED {what} — migrate to repro_torch.fabric.Fabric(regs, "
        f'backend="cuda") (multi-source WRR composition, epoch tracking, '
        f"oracle-equivalent plans; see docs/migration.md)",
        DeprecationWarning, stacklevel=3)


def _plan(dst: torch.Tensor, allowed_row: torch.Tensor,
          quota_row: torch.Tensor, capacity: torch.Tensor, *,
          mode=KernelMode.AUTO):
    """Grant decisions for one source region's packets.

    ``dst`` [T]; register rows [S].  Returns (keep, slot, err, counts)."""
    n_ports = allowed_row.shape[0]
    if dst.shape[0] == 0:              # zero-packet round: nothing granted
        z = torch.zeros((0,), dtype=I32, device=dst.device)
        return z, z, z, torch.zeros((n_ports,), dtype=I32, device=dst.device)
    return _k.plan(dst.to(I32), allowed_row.to(I32), quota_row.to(I32),
                   capacity.to(I32), mode=mode)


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


class _DispatchCore(torch.autograd.Function):
    """Scatter with the gather backward of ``_dispatch_core``: ``d_x[t]``
    reads the slab cotangent row packet ``t`` was written to, and dropped
    or masked packets get exactly zero."""

    @staticmethod
    def forward(ctx, x, dst, keep, slot, n_ports, capacity, mode):
        ctx.save_for_backward(dst, keep, slot)
        ctx.mode = mode
        return _k.scatter(x, dst, keep, slot, n_ports=n_ports,
                          capacity=capacity, mode=mode)

    @staticmethod
    def backward(ctx, g):
        dst, keep, slot = ctx.saved_tensors
        d_x = _k.combine(g, dst, keep, slot, None, mode=ctx.mode)
        return d_x, None, None, None, None, None, None


class _CombineCore(torch.autograd.Function):
    """Weighted gather with the backward of ``_combine_core``:
    ``d_y`` scatters ``g * w`` (rounded in ``g``'s dtype; ``g`` itself for
    ``weights=None``) back along the route, ``d_w`` is the row dot of ``g``
    with the gathered rows.  The scatter writes nothing for a dropped packet
    and the gather reads zeros for it, so both are exactly zero there."""

    @staticmethod
    def forward(ctx, y, dst, keep, slot, weights, mode):
        ctx.save_for_backward(y, dst, keep, slot, weights)
        ctx.mode = mode
        return _k.combine(y, dst, keep, slot, weights, mode=mode)

    @staticmethod
    def backward(ctx, g):
        y, dst, keep, slot, weights = ctx.saved_tensors
        S, C, _ = y.shape
        d_y = d_w = None
        if ctx.needs_input_grad[0]:
            gw = g if weights is None else g * weights.to(g.dtype)[:, None]
            d_y = _k.scatter(gw.to(y.dtype), dst, keep, slot, n_ports=S,
                             capacity=C, mode=ctx.mode)
        if ctx.needs_input_grad[4]:
            rows = _k.combine(y, dst, keep, slot, None, mode=ctx.mode)
            d_w = (g.float() * rows.float()).sum(-1).to(weights.dtype)
        return d_y, None, None, None, d_w, None


def _dispatch(x: torch.Tensor, dst: torch.Tensor, keep: torch.Tensor,
              slot: torch.Tensor, *, n_ports: int, capacity: int,
              mode=KernelMode.AUTO) -> torch.Tensor:
    """Pack granted packets [T, D] into slabs [n_ports, capacity, D];
    differentiable in ``x``."""
    if x.shape[0] == 0:
        return torch.zeros((n_ports, capacity, x.shape[1]), dtype=x.dtype,
                           device=x.device)
    return _DispatchCore.apply(x, dst.to(I32), keep.to(I32), slot.to(I32),
                               n_ports, capacity, mode)


def _combine(y: torch.Tensor, dst: torch.Tensor, keep: torch.Tensor,
             slot: torch.Tensor, weights: Optional[torch.Tensor], *,
             mode=KernelMode.AUTO) -> torch.Tensor:
    """Gather slabs [S, C, D] back to packets [T, D], weighted (copied
    where ``weights`` is None); differentiable in ``y`` and ``weights``."""
    if dst.shape[0] == 0:
        return torch.zeros((0, y.shape[2]), dtype=y.dtype, device=y.device)
    if weights is not None:
        weights = weights.to(torch.float32)
    return _CombineCore.apply(y, dst.to(I32), keep.to(I32), slot.to(I32),
                              weights, mode)


# ----------------------------------------------------------------------
# deprecated public entry points (thin warning shims over the impls)
# ----------------------------------------------------------------------
def crossbar_plan(dst, allowed_row, quota_row, capacity, *,
                  mode=KernelMode.AUTO):
    """Deprecated: single-source plan shim (see module docstring)."""
    _warn_deprecated("kernels.crossbar_dispatch.crossbar_plan")
    return _plan(dst, allowed_row, quota_row, capacity, mode=mode)


def crossbar_dispatch(x, dst, keep, slot, *, n_ports: int, capacity: int,
                      mode=KernelMode.AUTO):
    """Deprecated: raw scatter shim (see module docstring)."""
    _warn_deprecated("kernels.crossbar_dispatch.crossbar_dispatch")
    return _dispatch(x, dst, keep, slot, n_ports=n_ports, capacity=capacity,
                     mode=mode)


def crossbar_combine(y, dst, keep, slot, weights, *, mode=KernelMode.AUTO):
    """Deprecated: raw gather shim (see module docstring)."""
    _warn_deprecated("kernels.crossbar_dispatch.crossbar_combine")
    return _combine(y, dst, keep, slot, weights, mode=mode)
