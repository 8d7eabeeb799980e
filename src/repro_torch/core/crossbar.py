"""DEPRECATED compat shims — use ``repro_torch.fabric.Fabric`` instead.

This module predates the unified data-plane API.  New code constructs a
:class:`repro_torch.fabric.Fabric` (``backend="reference" | "cuda" |
"cuda_kernel"``) bound to a register file or a live ``Shell``; the
functions here remain as thin wrappers for existing callers, as in the JAX
package's ``repro/core/crossbar.py``:

- **local** (:func:`exchange_local` / :func:`combine_local`): one
  reference-backend dispatch round — identical to
  ``Fabric(regs, backend="reference").dispatch(...)``;
- :func:`pairwise_dispatch_plan`: the legacy pair-owned-slot plan of one
  source region, whose slot numbering differs from the fabric's shared
  WRR interleave.

The sharded shims (``exchange_sharded``/``combine_sharded``) wait for the
port's sharded backend.

The register file gates everything: isolation masks, quotas and resets are
*values*, so the Elastic Resource Manager re-routes traffic by rewriting
registers — never by rebuilding a kernel.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import torch

from repro_torch.core.arbiter import DispatchPlan, _error_codes
from repro_torch.core.registers import CrossbarRegisters

I32 = torch.int32
INT32_MIN = -(1 << 31)


def _warn_deprecated(what: str, use: str) -> None:
    warnings.warn(f"DEPRECATED {what} — migrate to {use} "
                  f"(see docs/migration.md, repro_torch.fabric)",
                  DeprecationWarning, stacklevel=3)


# ----------------------------------------------------------------------
# Local (single-shard) crossbar — shim over the fabric reference backend.
# ----------------------------------------------------------------------
def exchange_local(x: torch.Tensor, dst: torch.Tensor, src: torch.Tensor,
                   regs: CrossbarRegisters, capacity: int
                   ) -> Tuple[torch.Tensor, DispatchPlan]:
    """Route packets ``x`` [T, D] to per-destination slabs [S, capacity, D].

    Deprecated: ``Fabric(regs, backend="reference",
    capacity=capacity).dispatch(x, dst, src)`` is the maintained spelling.
    """
    _warn_deprecated("core.crossbar.exchange_local",
                     'Fabric(regs, backend="reference", capacity=C)'
                     '.dispatch(x, dst, src)')
    from repro_torch.fabric.backends import ReferenceBackend
    backend = ReferenceBackend()
    plan = backend.plan(dst, src, regs)
    return backend.dispatch(x, plan, regs, capacity), plan


def combine_local(y: torch.Tensor, plan: DispatchPlan,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deprecated: use ``Fabric.combine``."""
    _warn_deprecated("core.crossbar.combine_local", "Fabric.combine(y, plan)")
    from repro_torch.fabric.backends import ReferenceBackend
    if weights is None:
        weights = torch.ones_like(plan.keep, dtype=y.dtype)
    return ReferenceBackend().combine(y, plan, weights)


def _gather_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """Where a JAX gather reads index ``i`` of an axis of size ``n``: a
    negative index wraps once, and what is still outside ``[0, n)`` is
    clamped."""
    return torch.where(i < 0, i + n, i).clamp(0, n - 1).long()


def pairwise_dispatch_plan(dst: torch.Tensor, src_index,
                           regs: CrossbarRegisters, capacity: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Per-(src,dst)-pair slot assignment for the all_to_all send buffer.

    Returns (keep[T] bool, slot[T], error[T]). ``src_index`` is this
    region's id (scalar). Slots are ranks within the packet's (src, dst)
    stream — each pair owns its own `capacity` slots.

    A ``dst`` outside ``[0, S)`` gets what the JAX package's plan gives it
    (its register reads wrap a negative index once and clamp, and its
    legacy ``take_along_axis`` keeps the fill mode):

    - ``-S <= dst < 0`` reads the registers of port ``dst + S`` and takes
      the rank of the next packet to that port; it takes up no rank itself;
    - any other ``dst`` reads the registers of the nearest port and gets
      rank ``INT32_MIN``, so quota and capacity pass, and a kept packet's
      slot is ``INT32_MIN``.
    """
    n = regs.n_ports
    dst = dst.to(I32)
    src = _gather_index(torch.as_tensor(src_index, device=dst.device), n)
    d = _gather_index(dst, n)
    iso_ok = regs.allowed[src, d] & ~regs.reset[d] & ~regs.reset[src]
    in_range = (dst >= 0) & (dst < n)
    live = (torch.nn.functional.one_hot(dst.clamp(0, n - 1).long(), n).to(I32)
            * (in_range & iso_ok)[:, None])
    rank_all = torch.cumsum(live, 0, dtype=I32) - live
    wrapped = torch.where(dst < 0, dst + n, dst)
    readable = (wrapped >= 0) & (wrapped < n)
    rank = torch.where(readable, rank_all.gather(1, d[:, None])[:, 0],
                       INT32_MIN)
    quota = regs.quota[d, src]
    quota_ok = (quota == 0) | (rank < quota)
    cap_ok = rank < capacity
    keep = iso_ok & quota_ok & cap_ok
    return keep, torch.where(keep, rank, 0), _error_codes(iso_ok, quota_ok,
                                                          cap_ok)


@dataclasses.dataclass
class CrossbarInterconnect:
    """Deprecated wrapper binding a register file to exchange/combine ops.

    ``repro_torch.fabric.Fabric`` supersedes this: it adds backend
    selection, epoch tracking against a live ``Shell``, and the fused
    ``transfer`` round-trip.  ``as_fabric()`` converts in place."""

    regs: CrossbarRegisters
    capacity: int

    def exchange(self, x, dst, src):
        return exchange_local(x, dst, src, self.regs, self.capacity)

    def combine(self, y, plan, weights=None):
        return combine_local(y, plan, weights)

    def reconfigure(self, **updates) -> "CrossbarInterconnect":
        """ERM write: new register values, same kernels."""
        return dataclasses.replace(self, regs=self.regs.write(**updates))

    def as_fabric(self, backend: str = "reference", **kw):
        """The maintained replacement: a ``Fabric`` over the same file
        (on the card unless ``device="cpu"`` is passed)."""
        from repro_torch.fabric import Fabric
        return Fabric(self.regs, backend=backend, capacity=self.capacity,
                      **kw)
