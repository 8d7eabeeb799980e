"""Register-file synthesis: full rebuild + delta ("patch") path.

The seed ``ElasticResourceManager.build_registers`` re-derived the whole
crossbar register file from scratch after every reconfiguration.  That is
correct but scales with the pool, not with the change: a single promote
touches a handful of dest/allowed/reset entries, yet paid a full O(ports²)
re-synthesis (and a fresh trace of ``.at[].set`` chains).

This module splits synthesis in two:

- ``full_registers(state)``   — the pure, from-scratch build (numpy-composed,
  then lifted to int32/bool tensors once).  Used at shell construction and as the
  oracle the delta path is tested against.
- ``compute_delta(old, new, ...)`` / ``apply_delta(regs, delta)`` — the
  incremental path.  A plan knows which tenants and regions it touched; the
  union of their ports *before and after* the transition bounds every entry
  that can change (isolation cliques are per-tenant, dest chains are
  per-tenant, reset bits are per-region, and the host row/column is
  constant).  The delta re-derives only that submatrix and
  ``CrossbarRegisters.patch`` scatters it in, bumping the epoch once.

Invariant (enforced by tests): for any event sequence,
``apply_delta(regs, delta)`` is bit-identical to ``full_registers(new_state)``
in every array except the write-counting ``version``.
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, Iterable, Set, Tuple

import numpy as np
import torch

from repro_torch.core.registers import CrossbarRegisters
from repro_torch.shell.state import ON_SERVER, PoolState

CONTENT_FIELDS = ("dest", "allowed", "quota", "capacity", "reset", "error")


@dataclasses.dataclass(frozen=True)
class RegisterDelta:
    """The touched-entry set of one reconfiguration plan."""

    dest: Tuple[Tuple[int, int], ...] = ()          # (port, new_dest)
    allowed: Tuple[Tuple[int, int, bool], ...] = () # (src, dst, value)
    reset: Tuple[Tuple[int, bool], ...] = ()        # (port, value)
    touched_ports: FrozenSet[int] = frozenset()

    @property
    def empty(self) -> bool:
        return not (self.dest or self.allowed or self.reset)

    @property
    def n_entries(self) -> int:
        return len(self.dest) + len(self.allowed) + len(self.reset)


# ----------------------------------------------------------------------
# full synthesis (the oracle)
# ----------------------------------------------------------------------
def _dest_of_port(state: PoolState, port: int) -> int:
    """Destination register for one region port under the §IV-A chain rule:
    module i points at module i+1's port, or the host when the next module is
    on-server / the chain ends."""
    r = state.region(port - 1)
    if r.tenant is None:
        return state.host_port
    t = state.tenant(r.tenant)
    nxt_idx = r.module_idx + 1
    if nxt_idx >= len(t.placement) or t.placement[nxt_idx] == ON_SERVER:
        return state.host_port
    return t.placement[nxt_idx] + 1


def _same_tenant_ports(state: PoolState, a: int, b: int) -> bool:
    """allowed[a, b] for two region ports: both placed, same tenant."""
    ra, rb = state.region(a - 1), state.region(b - 1)
    return (ra.tenant is not None and ra.tenant == rb.tenant)


def full_registers(state: PoolState, *, capacity: int = 8,
                   version: int = 0) -> CrossbarRegisters:
    """Synthesise the whole register file for a placement (pure).

    Ports: 0 = host bridge, 1..N = regions.  Isolation: a region may talk
    only to the host port and to regions of the *same tenant* (§IV-E.2).
    Unhealthy regions are held in reset (§IV-C).
    """
    n = state.n_ports
    host = state.host_port
    allowed = np.zeros((n, n), dtype=bool)
    allowed[host, :] = True
    allowed[:, host] = True
    dest = np.full((n,), host, dtype=np.int32)
    reset = np.zeros((n,), dtype=bool)
    for t in state.tenants:
        ports = t.placed_ports
        for a in ports:
            for b in ports:
                allowed[a, b] = True
    for r in state.regions:
        if not r.healthy:
            reset[r.port] = True
        if r.tenant is not None:
            dest[r.port] = _dest_of_port(state, r.port)
    i32 = torch.int32
    return CrossbarRegisters(
        dest=torch.from_numpy(dest),
        allowed=torch.from_numpy(allowed),
        quota=torch.zeros((n, n), dtype=i32),
        capacity=torch.full((n,), capacity, dtype=i32),
        reset=torch.from_numpy(reset),
        error=torch.zeros((n,), dtype=i32),
        version=torch.tensor(version, dtype=i32),
    )


# ----------------------------------------------------------------------
# delta synthesis
# ----------------------------------------------------------------------
def compute_delta(old: PoolState, new: PoolState,
                  touched_tenants: Iterable[str],
                  touched_rids: Iterable[int]) -> RegisterDelta:
    """Re-derive only the entries a plan can have changed.

    ``touched_tenants`` are every tenant named in the plan's actions (their
    full port set, old and new, bounds all dest/isolation changes);
    ``touched_rids`` are regions whose health or occupancy the plan touched
    (bounding the reset-bit changes).
    """
    host = new.host_port
    ports: Set[int] = set()
    for name in touched_tenants:
        for s in (old, new):
            t = s.find_tenant(name)
            if t is not None:
                ports.update(t.placed_ports)
    for rid in touched_rids:
        ports.add(rid + 1)
    ports.discard(host)

    dest_updates = []
    for p in sorted(ports):
        r = new.region(p - 1)
        dest_updates.append(
            (p, _dest_of_port(new, p) if r.tenant is not None else host))

    allowed_updates = []
    for a in sorted(ports):
        for b in sorted(ports):
            allowed_updates.append((a, b, _same_tenant_ports(new, a, b)))

    reset_updates = []
    for rid in sorted(set(touched_rids)):
        reset_updates.append((rid + 1, not new.region(rid).healthy))

    return RegisterDelta(dest=tuple(dest_updates),
                         allowed=tuple(allowed_updates),
                         reset=tuple(reset_updates),
                         touched_ports=frozenset(ports))


def apply_delta(regs: CrossbarRegisters,
                delta: RegisterDelta) -> CrossbarRegisters:
    """Scatter a delta into an existing register file (one epoch bump)."""
    return regs.patch(dest=delta.dest, allowed=delta.allowed,
                      reset=delta.reset)


def registers_content_equal(a: CrossbarRegisters,
                            b: CrossbarRegisters) -> bool:
    """Bit-identical content comparison, ignoring the write-counting
    ``version`` (the delta path bumps it once per plan; the full build
    counts its own writes)."""
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in CONTENT_FIELDS)
