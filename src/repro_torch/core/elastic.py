"""FPGA Elastic Resource Manager (§IV-A) — legacy wrapper over
``repro_torch.shell``.

.. deprecated::
    The decision logic that used to live here has moved into the unified
    shell API: pure planning in ``repro_torch.shell.planner``, pluggable
    placement policies in ``repro_torch.shell.policy``, delta register
    synthesis in ``repro_torch.shell.regfile``, and the event-driven facade
    in ``repro_torch.shell.Shell``.  This module keeps the original
    mutable-looking API importable — ``ElasticResourceManager``, ``Region``, ``TenantState``,
    ``ReconfigEvent``, ``ON_SERVER`` — as a thin stateful wrapper that posts
    events to the pure planner and materialises mutable views on demand.
    New code should use ``repro_torch.shell`` directly.

Semantics are unchanged from the seed, with one deliberate fix: a module
that cannot be placed *at admission* is logged as ``"spill"`` (it never held
a region), distinct from ``"demote"`` (it lost one).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core.module import ModuleFootprint
from repro_torch.core.registers import CrossbarRegisters
from repro_torch.shell.events import (FailRegion, Grow, HealRegion, Release,
                                      Shrink, Submit)
from repro_torch.shell.planner import reconfig_cost_s
from repro_torch.shell.regfile import full_registers
from repro_torch.shell.shell import Shell
from repro_torch.shell.state import ON_SERVER


@dataclasses.dataclass
class Region:
    """A fixed-size slice of the device pool — the PR-region analogue.

    (Mutable view kept for API compatibility; the source of truth is the
    shell's immutable ``PoolState``.)"""

    rid: int
    n_chips: int
    hbm_bytes: int
    healthy: bool = True
    tenant: Optional[str] = None
    module_idx: Optional[int] = None     # which of the tenant's modules

    @property
    def free(self) -> bool:
        return self.healthy and self.tenant is None


@dataclasses.dataclass
class TenantState:
    name: str
    footprints: List[ModuleFootprint]
    placement: List[int] = dataclasses.field(default_factory=list)
    app_id: int = 0
    max_regions: Optional[int] = None       # elasticity cap set by shrink/grow

    @property
    def on_server_modules(self) -> List[int]:
        return [i for i, p in enumerate(self.placement) if p == ON_SERVER]

    @property
    def placed_count(self) -> int:
        return sum(1 for p in self.placement if p != ON_SERVER)

    def may_grow(self) -> bool:
        return self.max_regions is None or self.placed_count < self.max_regions


@dataclasses.dataclass
class ReconfigEvent:
    kind: str    # "allocate" | "promote" | "demote" | "spill" | "release" | "fail" | "migrate"
    tenant: str
    module_idx: Optional[int]
    region: Optional[int]
    cost_s: float
    wall_time: float


class ElasticResourceManager:
    """Region pool + tenant bookkeeping + register-file synthesis.

    Thin stateful wrapper: every verb posts one event to an internal
    ``repro_torch.shell.Shell`` and flattens the resulting plan's actions
    into the legacy ``events`` log.  ``regions`` / ``tenants`` are materialised views
    over the shell's immutable state (read them, don't mutate them)."""

    def __init__(self, regions: Sequence[Region], host_port: int = 0,
                 policy: str = "first_fit"):
        self._shell = Shell(regions, policy=policy, host_port=host_port)
        self.host_port = host_port
        self.events: List[ReconfigEvent] = []
        self._clock = 0.0

    # ------------------------------------------------------------------
    def _post(self, event) -> None:
        plan = self._shell.post(event)
        for a in plan.actions:
            self._clock += a.cost_s
            self.events.append(ReconfigEvent(a.kind, a.tenant, a.module_idx,
                                             a.region, a.cost_s, self._clock))

    # ---- materialised legacy views -----------------------------------
    @property
    def regions(self) -> Dict[int, Region]:
        return {r.rid: Region(rid=r.rid, n_chips=r.n_chips,
                              hbm_bytes=r.hbm_bytes, healthy=r.healthy,
                              tenant=r.tenant, module_idx=r.module_idx)
                for r in self._shell.state.regions}

    @property
    def tenants(self) -> Dict[str, TenantState]:
        return {t.name: TenantState(name=t.name,
                                    footprints=list(t.footprints),
                                    placement=list(t.placement),
                                    app_id=t.app_id,
                                    max_regions=t.max_regions)
                for t in self._shell.state.tenants}

    @property
    def shell(self):
        """The underlying event-driven ``repro_torch.shell.Shell`` (migration
        escape hatch)."""
        return self._shell

    def reconfig_cost_s(self, fp: ModuleFootprint) -> float:
        return reconfig_cost_s(fp)

    def free_regions(self) -> List[Region]:
        return [r for r in self.regions.values() if r.free]

    # ---- legacy verbs -> shell events --------------------------------
    def submit(self, name: str, footprints: Sequence[ModuleFootprint],
               app_id: int = 0) -> List[int]:
        """Admit a tenant; place as many modules as regions allow, rest
        on-server. Returns the placement list."""
        self._post(Submit(tenant=name, footprints=tuple(footprints),
                          app_id=app_id))
        return self.placement_of(name)

    def release(self, name: str) -> None:
        """Tenant done: free its regions and promote waiters (§IV-A)."""
        self._post(Release(tenant=name))

    def shrink(self, name: str, n_regions: int) -> List[int]:
        """Reduce a tenant to ``n_regions`` regions (demote the tail modules)."""
        self._post(Shrink(tenant=name, n_regions=n_regions))
        return self.placement_of(name)

    def grow(self, name: str, n_regions: Optional[int] = None) -> List[int]:
        """Raise (or remove) a tenant's region cap and promote waiters."""
        self._post(Grow(tenant=name, n_regions=n_regions))
        return self.placement_of(name)

    def fail_region(self, rid: int) -> None:
        """Heartbeat lost: demote the hosted module, mark region unhealthy."""
        self._post(FailRegion(rid=rid))

    def heal_region(self, rid: int) -> None:
        self._post(HealRegion(rid=rid))

    # ------------------------------------------------------------------
    def build_registers(self, capacity: int = 8) -> CrossbarRegisters:
        """Synthesise the crossbar register file for the current placement.

        Full (from-scratch) synthesis for the legacy API; the shell itself
        maintains a live register file incrementally via delta patches."""
        return full_registers(self._shell.state, capacity=capacity)

    # ------------------------------------------------------------------
    def utilization(self) -> float:
        return self._shell.utilization()

    def placement_of(self, name: str) -> List[int]:
        return self._shell.placement_of(name)
