"""``Shell`` — the unified, event-driven facade over the elastic control plane.

One object owns the three things the paper's shell owns — the region pool,
the crossbar register file, and the reconfiguration log — and exposes exactly
one mutation entry point:

    shell = Shell(regions, policy="best_fit")
    plan = shell.post(Submit("tenant_a", footprints, app_id=0))

``post`` runs the pure planner, swaps the immutable ``PoolState``, patches
the live register file *incrementally* (delta synthesis; the epoch counts
applied plans), appends to the event log, and fans the plan out to
subscribers.  Everything else — the legacy ``ElasticResourceManager``, the
fault-tolerance monitors, the ``ElasticServer`` data plane — is a client of
this seam.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Union

from repro_torch.core.module import ModuleFootprint
from repro_torch.core.registers import CrossbarRegisters
from repro_torch.shell import events as ev
from repro_torch.shell.planner import Plan, plan as plan_event, reconfig_cost_s
from repro_torch.shell.policy import PlacementPolicy, get_policy
from repro_torch.shell.regfile import (apply_delta, full_registers,
                                 registers_content_equal)
from repro_torch.shell.state import ON_SERVER, PoolState, check_invariants

Subscriber = Callable[[ev.Event, Plan], None]


@dataclasses.dataclass(frozen=True)
class LogEntry:
    """One applied event: what was posted, what the planner did, when."""

    event: ev.Event
    plan: Plan
    wall_time: float            # cost-model clock after applying the plan
    epoch: int                  # register-file epoch after applying


class Shell:
    """Region pool + register file + event log behind one ``post`` seam."""

    def __init__(self, regions: Union[PoolState, Sequence], *,
                 policy: Union[str, PlacementPolicy] = "first_fit",
                 host_port: int = 0, capacity: int = 8):
        if isinstance(regions, PoolState):
            self._state = regions
        else:
            self._state = PoolState.create(regions, host_port=host_port)
        self.policy = get_policy(policy)
        self.capacity = capacity
        self._regs = full_registers(self._state, capacity=capacity, version=0)
        self._epoch = int(self._regs.version)
        self.log: List[LogEntry] = []
        self._clock = 0.0
        self._subscribers: List[Subscriber] = []

    # ---- the seam -----------------------------------------------------
    def post(self, event: ev.Event) -> Plan:
        """Apply one event: plan purely, swap state, patch registers.

        The only mutation entry point.  Returns the applied :class:`Plan`
        (ordered actions + the register delta); invalid events raise
        ``KeyError``/``ValueError`` *before* any state changes.

        >>> from repro_torch.core.elastic import Region
        >>> from repro_torch.core.module import ModuleFootprint
        >>> from repro_torch.shell import FailRegion, Shell, Submit
        >>> GB = 1 << 30
        >>> shell = Shell([Region(rid=i, n_chips=8, hbm_bytes=8 * GB)
        ...                for i in range(2)])
        >>> fp = ModuleFootprint(param_bytes=GB, flops_per_token=1e9,
        ...                      activation_bytes_per_token=4096)
        >>> plan = shell.post(Submit(tenant="a", footprints=(fp, fp),
        ...                          app_id=0))
        >>> [a.kind for a in plan.actions], shell.placement_of("a")
        (['allocate', 'allocate'], [0, 1])
        >>> plan = shell.post(FailRegion(rid=0))   # demotes module 0
        >>> shell.placement_of("a"), shell.epoch   # -1 == runs on-server
        ([-1, 1], 2)
        """
        new_state, p = plan_event(self._state, event, self.policy)
        self._state = new_state
        self._regs = apply_delta(self._regs, p.delta)
        self._epoch = int(self._regs.version)
        self._clock += p.cost_s
        self.log.append(LogEntry(event=event, plan=p,
                                 wall_time=self._clock, epoch=self.epoch))
        for fn in list(self._subscribers):
            fn(event, p)
        return p

    def subscribe(self, fn: Subscriber) -> Callable[[], None]:
        """Register a plan observer; returns an unsubscribe thunk."""
        self._subscribers.append(fn)
        return lambda: self._subscribers.remove(fn)

    # ---- views --------------------------------------------------------
    @property
    def state(self) -> PoolState:
        return self._state

    @property
    def registers(self) -> CrossbarRegisters:
        """The live, delta-maintained register file."""
        return self._regs

    @property
    def epoch(self) -> int:
        """Monotonic count of applied plans (== registers.version).

        Memoized at ``post`` time as a host int: the fabric's plan cache
        checks it on *every* call, and reading the on-device
        ``registers.version`` scalar would cost a device sync per tick.
        """
        return self._epoch

    @property
    def clock_s(self) -> float:
        """Cost-model wall clock (sum of applied reconfiguration costs)."""
        return self._clock

    def placement_of(self, name: str) -> List[int]:
        return list(self._state.tenant(name).placement)

    def utilization(self) -> float:
        return self._state.utilization()

    def reconfig_cost_s(self, fp: ModuleFootprint) -> float:
        return reconfig_cost_s(fp)

    # ---- data-plane routing ------------------------------------------
    def fabric(self, backend: str = "reference", *, device=None, **kw):
        """A ``repro_torch.fabric.Fabric`` bound to this shell's *live*
        register file: every call reads the current epoch's values, so a
        posted event re-routes the next call through the kernels already
        loaded.  ``device`` defaults to the card (``"cpu"`` must be asked
        for); the shell's own registers stay on the host and the fabric
        moves them to its device once per epoch."""
        from repro_torch.fabric import fabric_for_shell
        return fabric_for_shell(self, backend=backend, device=device, **kw)

    def route(self, app_id: int) -> Optional[int]:
        """Ingress port for an application id, read off the live placement:
        the first module's region port, or the host port when the chain
        starts on-server.  ``None`` when no tenant owns ``app_id`` (the
        server keeps such requests queued until a ``Submit`` lands)."""
        t = self._state.tenant_by_app(app_id)
        if t is None:
            return None
        if not t.placement or t.placement[0] == ON_SERVER:
            return self._state.host_port
        return t.placement[0] + 1

    # ---- convenience verbs (thin wrappers over post) ------------------
    def submit(self, name: str, footprints, app_id: int = 0,
               slo=None) -> List[int]:
        fps = getattr(footprints, "footprints", footprints)
        self.post(ev.Submit(tenant=name, footprints=tuple(fps),
                            app_id=app_id, slo=slo))
        return self.placement_of(name)

    def release(self, name: str) -> None:
        self.post(ev.Release(tenant=name))

    def shrink(self, name: str, n_regions: int) -> List[int]:
        self.post(ev.Shrink(tenant=name, n_regions=n_regions))
        return self.placement_of(name)

    def grow(self, name: str, n_regions: Optional[int] = None) -> List[int]:
        self.post(ev.Grow(tenant=name, n_regions=n_regions))
        return self.placement_of(name)

    def fail_region(self, rid: int) -> None:
        self.post(ev.FailRegion(rid=rid))

    def heal_region(self, rid: int) -> None:
        self.post(ev.HealRegion(rid=rid))

    # ---- self-checks --------------------------------------------------
    def verify(self) -> None:
        """Assert pool invariants and delta-vs-full register equivalence."""
        check_invariants(self._state)
        oracle = full_registers(self._state, capacity=self.capacity)
        assert registers_content_equal(self._regs, oracle), \
            "delta-synthesised registers diverged from full rebuild"
