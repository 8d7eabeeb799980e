"""Runtime invariant checks for the fabric data plane (the JAX package's
``fabric/sanitize.py``).

A fabric constructed with ``debug="sanitize"|"strict"|True`` (or under
``REPRO_FABRIC_DEBUG=1``) runs these checks on every host-level
``plan``/``dispatch``/``combine``/``transfer`` and raises
:class:`FabricCheckError` with the JAX package's messages.  The JAX package
threads ``checkify`` assertions through its traced programs; the port has
no traces, so each check reduces its conditions on the device and reads
them back in ONE host sync, then raises the first that failed in the JAX
package's order.

Two levels:

- ``"sanitize"``: structural invariants that hold on every correct plan,
  whatever the traffic: granted packets carry in-range destinations and
  slots under the *gated* capacity, per-port grant counts never exceed the
  gated capacity, granted packets respect the isolation/reset register
  masks, and no NaN enters a receive slab.  These fire only on a
  data-plane bug (or NaN traffic), never on hostile traffic, which the
  fabric's job is to mask.
- ``"strict"``: sanitize plus *fault surfacing*: a packet with a real (not
  ``dst = -1`` padding) out-of-range or isolation-blocked destination, or an
  over-capacity burst (ACK_TIMEOUT), raises instead of dropping silently.
  Quota drops (GRANT_TIMEOUT) stay silent at both levels: WRR quota cuts
  are policy, not faults.

With debug off nothing here runs: no launch and no host sync is added.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.core.arbiter import DispatchPlan
from repro_torch.core.registers import CrossbarRegisters, ErrorCode

LEVELS = ("sanitize", "strict")


class FabricCheckError(RuntimeError):
    """A fabric invariant failed under ``debug=`` (the JAX package raises
    ``checkify.JaxRuntimeError`` with the same message)."""


def _raise_first(checks: List[Tuple[torch.Tensor, object]]) -> None:
    """``checks``: (0-d bool tensor that must be True, message or a
    zero-arg callable making it).  One host sync for all of them."""
    if not checks:
        return
    flags = torch.stack([ok.reshape(()) for ok, _ in checks]).tolist()
    for ok, (_, msg) in zip(flags, checks):
        if not ok:
            raise FabricCheckError(msg() if callable(msg) else msg)


def check_plan(plan: DispatchPlan, regs: CrossbarRegisters,
               src: Optional[torch.Tensor], backend, level: str) -> None:
    """Plan invariants against the *gated* register file ``regs``.

    ``src`` is the caller's source-port vector; a backend that derives the
    effective source itself exposes ``effective_src`` and overrides it."""
    n = regs.n_ports
    keep, dst = plan.keep.bool(), plan.dst
    dstc = dst.clamp(0, n - 1).long()
    checks = [
        ((~keep | ((dst >= 0) & (dst < n))).all(),
         f"fabric sanitizer: granted packet with out-of-range destination "
         f"(n_ports={n})"),
        ((~keep | ((plan.slot >= 0)
                   & (plan.slot < regs.capacity[dstc]))).all(),
         "fabric sanitizer: granted slot outside the gated capacity of its "
         "destination port"),
        ((plan.counts <= regs.capacity).all(),
         lambda: "fabric sanitizer: per-port grant count exceeds the gated "
                 f"capacity (counts={plan.counts.tolist()})"),
    ]
    eff = getattr(backend, "effective_src", None)
    src_eff = src if eff is None else eff(src if src is not None else dst)
    if src_eff is not None:
        srcc = src_eff.to(torch.int64).clamp(0, n - 1)
        allowed = (regs.allowed[srcc, dstc] & ~regs.reset[srcc]
                   & ~regs.reset[dstc])
        checks.append(((~keep | allowed).all(),
                       "fabric sanitizer: granted packet violates the "
                       "isolation/reset register mask of its (src, dst) "
                       "pair"))
    if level == "strict":
        real = dst != -1            # -1 is the sanctioned padding sentinel
        checks.append((~(real & (plan.error == ErrorCode.INVALID_DEST)).any(),
                       "fabric strict: packet sprayed at an invalid "
                       "destination (out of range or isolation-masked); the "
                       "masked path would drop it silently"))
        checks.append((~(plan.error == ErrorCode.ACK_TIMEOUT).any(),
                       lambda: "fabric strict: over-capacity burst — packets "
                               "dropped with ACK_TIMEOUT "
                               f"(drops={plan.drops.tolist()})"))
    _raise_first(checks)


def check_slabs(slabs: torch.Tensor, level: str) -> None:
    """No NaN may enter a receive slab (it would propagate through the
    module and combine into packets that were never at fault)."""
    del level                       # checked at both levels
    if slabs.is_floating_point():
        _raise_first([(~torch.isnan(slabs).any(),
                       "fabric sanitizer: NaN entered a receive slab")])


def check_combine(plan: DispatchPlan, slab_capacity: int,
                  level: str) -> None:
    """Every granted packet must address a slot that exists in the slab
    actually handed to combine (a smaller slab is legal only for packets
    the plan already dropped)."""
    del level
    _raise_first([((~plan.keep.bool() | (plan.slot < slab_capacity)).all(),
                   f"fabric sanitizer: granted slot beyond the combine "
                   f"slab's capacity ({slab_capacity})")])
