"""Pluggable data-plane backends for :class:`repro_torch.fabric.Fabric`.

Every backend realises the same interconnect contract (plan grant
decisions from the live register file, dispatch packets into destination
slabs, combine results back to packet order) and all of them are
plan-equivalent: identical ``keep``/``slot``/``error``/``counts`` for the
same packets and registers.

- ``reference``: the plain plan (``arbiter.wrr_dispatch_plan``) and the
  shared flat-address scatter/gather of ``repro_torch.core.arbiter``.
- ``cuda`` (alias ``pallas``): ONE launch of the fabric's plan kernel
  (``kernel.plan_fabric``) computes the whole plan from the register file:
  every (src, dst) stream's ranks and iso/quota verdicts, the global WRR
  slots of the shared closed form ``arbiter.wrr_slots``, the capacity cut,
  counts and drops (its plain version, ``ref.plan_fabric_ref``, on the CPU
  and under ``KernelMode.TORCH``).  Data moves through the shared scatter
  by default; ``data_plane="kernel"`` moves it with the scatter and
  combine kernels instead.
- ``cuda_kernel``: ``CudaBackend(data_plane="kernel")``, all three kernels.

Registers are values (kernel arguments), so a register rewrite re-routes
traffic through the kernels already loaded.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.core import arbiter
from repro_torch.core.arbiter import DispatchPlan
from repro_torch.core.registers import CrossbarRegisters
from repro_torch.fabric.interface import KernelMode, parse_kernel_mode



class ReferenceBackend:
    """The plan-semantics ground truth, moving packets through the shared
    scatter/gather path."""

    name = "reference"
    uses_shared_scatter = True

    def plan(self, dst: torch.Tensor, src: torch.Tensor,
             regs: CrossbarRegisters) -> DispatchPlan:
        if dst.shape[0] == 0:
            return arbiter.empty_plan(dst, regs.n_ports)
        return arbiter.wrr_dispatch_plan(dst, src, regs)

    def dispatch(self, x: torch.Tensor, plan: DispatchPlan,
                 regs: CrossbarRegisters, capacity: int) -> torch.Tensor:
        return arbiter.dispatch(x, plan, regs.n_ports, capacity)

    def combine(self, y: torch.Tensor, plan: DispatchPlan,
                weights: torch.Tensor) -> torch.Tensor:
        return arbiter.combine(y, plan, weights)


class CudaBackend:
    """The fabric's plan kernel (the whole plan in one launch), and either
    the shared scatter or the scatter/combine kernels as data plane.

    ``kernel_mode`` is bound by ``Fabric`` from its device (``AUTO``:
    kernels on a CUDA device, plain versions on the CPU).  Under
    ``TORCH`` the data plane is the shared scatter, like the JAX
    backend's XLA lowering.
    """

    name = "cuda"

    def __init__(self, *, data_plane: str = "scatter",
                 kernel_mode=None):
        if data_plane not in ("scatter", "kernel"):
            raise ValueError(f"data_plane must be 'scatter' or 'kernel', "
                             f"got {data_plane!r}")
        self.data_plane = data_plane
        self.kernel_mode = parse_kernel_mode(kernel_mode)
        # bound here: an import in ``plan`` costs host time on every call
        from repro_torch.kernels.crossbar_dispatch.kernel import plan_fabric
        self._plan_fabric = plan_fabric

    def apply_kernel_mode(self, mode: KernelMode) -> None:
        """Bind a resolved :class:`KernelMode` (``Fabric.__init__``)."""
        self.kernel_mode = mode

    @property
    def uses_shared_scatter(self) -> bool:
        return (self.data_plane == "scatter"
                or self.kernel_mode is KernelMode.TORCH)

    def plan(self, dst: torch.Tensor, src: torch.Tensor,
             regs: CrossbarRegisters) -> DispatchPlan:
        if dst.shape[0] == 0:
            return arbiter.empty_plan(dst, regs.n_ports)
        return self._plan_fabric(dst, src, regs.allowed, regs.reset,
                                 regs.quota, regs.capacity,
                                 mode=self.kernel_mode)

    def dispatch(self, x: torch.Tensor, plan: DispatchPlan,
                 regs: CrossbarRegisters, capacity: int) -> torch.Tensor:
        if self.uses_shared_scatter:
            return arbiter.dispatch(x, plan, regs.n_ports, capacity)
        from repro_torch.kernels.crossbar_dispatch.ops import _dispatch
        return _dispatch(x, plan.dst, plan.keep, plan.slot,
                         n_ports=regs.n_ports, capacity=capacity,
                         mode=self.kernel_mode)

    def combine(self, y: torch.Tensor, plan: DispatchPlan,
                weights: torch.Tensor) -> torch.Tensor:
        if self.uses_shared_scatter:
            return arbiter.combine(y, plan, weights)
        from repro_torch.kernels.crossbar_dispatch.ops import _combine
        return _combine(y, plan.dst, plan.keep, plan.slot, weights,
                        mode=self.kernel_mode)


def _cuda_kernel_backend(**kw) -> CudaBackend:
    kw.setdefault("data_plane", "kernel")
    return CudaBackend(**kw)


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------
_BACKENDS: Dict[str, Callable[..., object]] = {
    "reference": ReferenceBackend,
    "cuda": CudaBackend,
    "pallas": CudaBackend,
    "cuda_kernel": _cuda_kernel_backend,
}


def register_fabric_backend(name: str, factory: Callable[..., object]
                            ) -> None:
    """Register a backend factory under ``name`` (duck-typed:
    ``plan``/``dispatch``/``combine`` with the signatures above); the name
    then works in ``Fabric(regs, backend=name)``, ``shell.fabric(name)``
    and ``moe_apply(dispatch_impl=name)``."""
    _BACKENDS[name] = factory


def get_backend(spec, **kwargs):
    """Resolve a backend: an instance passes through, a name constructs."""
    if not isinstance(spec, str):
        return spec
    try:
        factory = _BACKENDS[spec]
    except KeyError:
        raise ValueError(f"unknown fabric backend {spec!r}; "
                         f"registered: {sorted(_BACKENDS)}") from None
    return factory(**kwargs)


def is_fabric_backend(name: str) -> bool:
    return name in _BACKENDS
