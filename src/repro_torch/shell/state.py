"""Immutable pool state — the value the shell's pure planner folds over.

The paper's shell tracks which PR regions exist, which are healthy, and which
tenant module occupies each one (§IV-A).  Here that bookkeeping is a frozen
pytree-of-plain-data: ``PoolState`` is never mutated, only replaced by
``plan(state, event) -> (new_state, Plan)``.  The stateful wrappers
(`repro_torch.shell.Shell`, the legacy ``ElasticResourceManager``) hold exactly one
reference to the current state and swap it atomically, which is what makes
placement decisions replayable, testable, and safe to speculate on.

Port convention (unchanged from the seed): port 0 is the host/AXI bridge,
region ``rid`` owns crossbar port ``rid + 1``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.module import ModuleFootprint

ON_SERVER = -1                   # placement value for host-executed modules


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """Per-tenant service-level objective the manager optimizes against.

    Budgets are per control window, in the same units ``Signals`` reports:
    ``admission_p99_ticks`` bounds the tail submit->admit latency
    (``TenantSignals.admission_p99``), ``drop_rate`` bounds the fabric's
    per-window drop fraction (``Signals.drop_rate`` — the fabric is shared,
    so every SLO'd tenant carries the pool's drop budget).  ``None`` means
    "no budget on this axis".  The target travels with the tenant: it
    arrives on ``Submit``, lives on ``TenantEntry``, and policies such as
    ``repro_torch.manager.PredictiveSLO`` read it straight off ``PoolState``.
    """

    admission_p99_ticks: Optional[float] = None
    drop_rate: Optional[float] = None

    def violations(self, *, admission_p99: float,
                   drop_rate: float) -> Tuple[str, ...]:
        """Which budgets the given window readings exceed (may be empty)."""
        out = []
        if (self.admission_p99_ticks is not None
                and admission_p99 > self.admission_p99_ticks):
            out.append("admission_p99")
        if self.drop_rate is not None and drop_rate > self.drop_rate:
            out.append("drop_rate")
        return tuple(out)

    def to_json(self) -> Dict[str, Optional[float]]:
        return {"admission_p99_ticks": self.admission_p99_ticks,
                "drop_rate": self.drop_rate}

    @staticmethod
    def from_json(d: Optional[Dict[str, Optional[float]]]
                  ) -> Optional["SLOTarget"]:
        if d is None:
            return None
        return SLOTarget(admission_p99_ticks=d.get("admission_p99_ticks"),
                         drop_rate=d.get("drop_rate"))


@dataclasses.dataclass(frozen=True)
class RegionState:
    """A fixed-size slice of the mesh — the PR-region analogue (immutable)."""

    rid: int
    n_chips: int
    hbm_bytes: int
    healthy: bool = True
    tenant: Optional[str] = None
    module_idx: Optional[int] = None

    @property
    def free(self) -> bool:
        return self.healthy and self.tenant is None

    @property
    def port(self) -> int:
        return self.rid + 1


@dataclasses.dataclass(frozen=True)
class TenantEntry:
    """One admitted application: its module footprints and their placement."""

    name: str
    footprints: Tuple[ModuleFootprint, ...]
    placement: Tuple[int, ...]          # region id or ON_SERVER per module
    app_id: int = 0
    max_regions: Optional[int] = None   # elasticity cap set by shrink/grow
    slo: Optional[SLOTarget] = None     # QoS budgets policies optimize for

    @property
    def on_server_modules(self) -> Tuple[int, ...]:
        return tuple(i for i, p in enumerate(self.placement) if p == ON_SERVER)

    @property
    def placed_count(self) -> int:
        return sum(1 for p in self.placement if p != ON_SERVER)

    @property
    def placed_ports(self) -> Tuple[int, ...]:
        return tuple(p + 1 for p in self.placement if p != ON_SERVER)

    def may_grow(self) -> bool:
        return self.max_regions is None or self.placed_count < self.max_regions


@dataclasses.dataclass(frozen=True)
class PoolState:
    """The whole control-plane state: regions (rid-sorted) + tenants."""

    regions: Tuple[RegionState, ...]
    tenants: Tuple[TenantEntry, ...]
    host_port: int = 0

    # ---- constructors -------------------------------------------------
    @staticmethod
    def create(regions: Iterable, host_port: int = 0) -> "PoolState":
        """Build from any region-like objects (``rid``/``n_chips``/
        ``hbm_bytes``/``healthy`` attributes), e.g. ``repro_torch.core.elastic``'s
        mutable ``Region``.

        Regions must be unoccupied: tenancy carries footprints and placement
        that a bare region back-pointer cannot reconstruct, so occupied pools
        are rebuilt by replaying ``Submit`` events, not by snapshot."""
        rs = []
        for r in regions:
            if getattr(r, "tenant", None) is not None:
                raise ValueError(
                    f"region {r.rid} is occupied by {r.tenant!r}; build the "
                    f"pool from free regions and admit tenants via Submit "
                    f"events")
            rs.append(RegionState(
                rid=r.rid, n_chips=r.n_chips, hbm_bytes=r.hbm_bytes,
                healthy=getattr(r, "healthy", True)))
        rs.sort(key=lambda r: r.rid)
        return PoolState(regions=tuple(rs), tenants=(), host_port=host_port)

    # ---- lookups ------------------------------------------------------
    def region(self, rid: int) -> RegionState:
        for r in self.regions:
            if r.rid == rid:
                return r
        raise KeyError(rid)

    def tenant(self, name: str) -> TenantEntry:
        for t in self.tenants:
            if t.name == name:
                return t
        raise KeyError(name)

    def find_tenant(self, name: str) -> Optional[TenantEntry]:
        return next((t for t in self.tenants if t.name == name), None)

    def tenant_by_app(self, app_id: int) -> Optional[TenantEntry]:
        return next((t for t in self.tenants if t.app_id == app_id), None)

    def free_regions(self) -> List[RegionState]:
        return [r for r in self.regions if r.free]

    @property
    def n_ports(self) -> int:
        return len(self.regions) + 1

    # ---- functional updates ------------------------------------------
    def with_region(self, new: RegionState) -> "PoolState":
        return dataclasses.replace(self, regions=tuple(
            new if r.rid == new.rid else r for r in self.regions))

    def with_tenant(self, new: TenantEntry) -> "PoolState":
        if self.find_tenant(new.name) is None:
            return dataclasses.replace(self, tenants=self.tenants + (new,))
        return dataclasses.replace(self, tenants=tuple(
            new if t.name == new.name else t for t in self.tenants))

    def without_tenant(self, name: str) -> "PoolState":
        return dataclasses.replace(self, tenants=tuple(
            t for t in self.tenants if t.name != name))

    # ---- derived metrics ---------------------------------------------
    def utilization(self) -> float:
        live = [r for r in self.regions if r.healthy]
        used = [r for r in live if r.tenant is not None]
        return len(used) / max(1, len(live))


def check_invariants(state: PoolState) -> None:
    """Global consistency: region<->tenant bookkeeping is a bijection, no
    double-booked region, placements only point at healthy regions."""
    placed: Dict[int, Tuple[str, int]] = {}
    for t in state.tenants:
        assert len(t.placement) == len(t.footprints)
        for i, p in enumerate(t.placement):
            if p == ON_SERVER:
                continue
            assert p not in placed, \
                f"region {p} double-booked: {placed[p]} and {(t.name, i)}"
            placed[p] = (t.name, i)
            assert state.region(p).healthy, \
                f"placement ({t.name}, {i}) points at unhealthy region {p}"
    for r in state.regions:
        if r.tenant is not None:
            assert placed.get(r.rid) == (r.tenant, r.module_idx), \
                f"region {r.rid} back-pointer mismatch"
        else:
            assert r.rid not in placed, f"region {r.rid} placement leak"
