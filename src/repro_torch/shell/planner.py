"""Pure placement planning: ``plan(state, event) -> (new_state, Plan)``.

This is the §IV-A decision procedure extracted out of the mutable
``ElasticResourceManager`` into a pure fold over ``PoolState``.  Nothing here
touches a register, a clock, or a lock: the planner returns the next state
plus a ``Plan`` describing *what happened* (ordered actions with
reconfiguration costs) and *what it touched* (a ``RegisterDelta`` for the
incremental register path).  The stateful shells — ``repro_torch.shell.Shell`` and
the legacy ``ElasticResourceManager`` wrapper — just apply plans.

Action kinds:

- ``allocate`` — module placed at admission
- ``spill``    — module unplaceable at admission, runs on-server
               (distinct from ``demote``: it never held a region)
- ``promote``  — on-server module moved onto a freed region
- ``demote``   — placed module pushed back on-server (shrink)
- ``migrate``  — placed module relocated (compaction policy or an explicit
               ``Migrate`` event from a controller)
- ``release``  — tenant departed
- ``fail``     — region loss demoted its module

Costs follow the seed's ICAP-analogue model: restoring a module's weights
streams bytes at HBM bandwidth plus a fixed dispatch/compile cost.
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, List, Optional, Sequence, Set, Tuple

from repro_torch.core.module import ModuleFootprint
from repro_torch.shell import events as ev
from repro_torch.shell.policy import FirstFit, PlacementPolicy
from repro_torch.shell.regfile import RegisterDelta, compute_delta
from repro_torch.shell.state import ON_SERVER, PoolState, TenantEntry

# Reconfiguration cost model (the ICAP analogue): restoring a module's weights
# onto a region streams bytes at HBM bandwidth + a recompile/dispatch cost.
HBM_BYTES_PER_S = 819e9
RECONFIG_FIXED_S = 0.5          # program dispatch + cache-hit compile


def reconfig_cost_s(fp: ModuleFootprint) -> float:
    return RECONFIG_FIXED_S + fp.param_bytes / HBM_BYTES_PER_S


@dataclasses.dataclass(frozen=True)
class Action:
    kind: str                   # see module docstring
    tenant: Optional[str]
    module_idx: Optional[int]
    region: Optional[int]
    cost_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class Plan:
    """One event's worth of reconfiguration: ordered actions + register delta."""

    event: ev.Event
    actions: Tuple[Action, ...]
    delta: RegisterDelta

    @property
    def cost_s(self) -> float:
        return sum(a.cost_s for a in self.actions)

    @property
    def touched_ports(self) -> FrozenSet[int]:
        return self.delta.touched_ports


# ----------------------------------------------------------------------
# internal pure helpers (each returns (state, actions))
# ----------------------------------------------------------------------
def _place(state: PoolState, name: str, module_idx: int,
           rid: int) -> PoolState:
    r = state.region(rid)
    t = state.tenant(name)
    state = state.with_region(dataclasses.replace(
        r, tenant=name, module_idx=module_idx))
    placement = list(t.placement)
    placement[module_idx] = rid
    return state.with_tenant(dataclasses.replace(
        t, placement=tuple(placement)))


def _unplace(state: PoolState, name: str, module_idx: int) -> PoolState:
    t = state.tenant(name)
    rid = t.placement[module_idx]
    assert rid != ON_SERVER
    r = state.region(rid)
    state = state.with_region(dataclasses.replace(
        r, tenant=None, module_idx=None))
    placement = list(t.placement)
    placement[module_idx] = ON_SERVER
    return state.with_tenant(dataclasses.replace(
        t, placement=tuple(placement)))


def _promote_waiters(state: PoolState, policy: PlacementPolicy,
                     actions: List[Action]) -> PoolState:
    """§IV-A: "the FPGA manager checks again if there are any PR regions
    released so that it can run the on-server module on the FPGA"."""
    for name in sorted(t.name for t in state.tenants):
        for i in state.tenant(name).on_server_modules:
            t = state.tenant(name)
            if not t.may_grow():
                break
            fp = t.footprints[i]
            rid = policy.choose(state, fp)
            if rid is None:
                continue
            state = _place(state, name, i, rid)
            actions.append(Action("promote", name, i, rid,
                                  reconfig_cost_s(fp)))
    return state


def _compact(state: PoolState, policy: PlacementPolicy,
             actions: List[Action]) -> PoolState:
    for (name, i, src, dst) in policy.compaction_moves(state):
        fp = state.tenant(name).footprints[i]
        state = _unplace(state, name, i)
        state = _place(state, name, i, dst)
        actions.append(Action("migrate", name, i, dst, reconfig_cost_s(fp)))
    return state


# ----------------------------------------------------------------------
# event handlers
# ----------------------------------------------------------------------
def _handle_submit(state: PoolState, e: ev.Submit,
                   policy: PlacementPolicy, actions: List[Action]
                   ) -> Tuple[PoolState, Set[int]]:
    if state.find_tenant(e.tenant) is not None:
        raise ValueError(f"tenant {e.tenant!r} already admitted")
    state = state.with_tenant(TenantEntry(
        name=e.tenant, footprints=tuple(e.footprints),
        placement=(ON_SERVER,) * len(e.footprints), app_id=e.app_id,
        slo=e.slo))
    for i, fp in enumerate(e.footprints):
        rid = policy.choose(state, fp)
        if rid is None:
            actions.append(Action("spill", e.tenant, i, None, 0.0))
        else:
            state = _place(state, e.tenant, i, rid)
            actions.append(Action("allocate", e.tenant, i, rid,
                                  reconfig_cost_s(fp)))
    return state, set()


def _handle_release(state: PoolState, e: ev.Release,
                    policy: PlacementPolicy, actions: List[Action]
                    ) -> Tuple[PoolState, Set[int]]:
    t = state.tenant(e.tenant)          # KeyError for unknown tenant
    for i, p in enumerate(t.placement):
        if p != ON_SERVER:
            state = _unplace(state, e.tenant, i)
    state = state.without_tenant(e.tenant)
    actions.append(Action("release", e.tenant, None, None, 0.0))
    state = _promote_waiters(state, policy, actions)
    return state, set()


def _handle_shrink(state: PoolState, e: ev.Shrink,
                   policy: PlacementPolicy, actions: List[Action]
                   ) -> Tuple[PoolState, Set[int]]:
    t = state.tenant(e.tenant)
    state = state.with_tenant(dataclasses.replace(
        t, max_regions=e.n_regions))
    t = state.tenant(e.tenant)
    placed = [i for i, p in enumerate(t.placement) if p != ON_SERVER]
    excess = len(placed) - e.n_regions
    if e.victims:
        # Victim regions demote first (controller-chosen, e.g. the coldest
        # ports under live traffic); any remaining excess comes off the
        # tail, exactly as in the victimless path.
        by_rid = {t.placement[i]: i for i in placed}
        chosen = [by_rid[rid] for rid in e.victims if rid in by_rid]
        rest = [i for i in placed if i not in chosen]
        demote = (chosen + rest[len(rest) - max(0, excess - len(chosen)):]
                  if excess > len(chosen) else chosen[:max(0, excess)])
    else:
        demote = placed[e.n_regions:]
    for i in demote:
        rid = state.tenant(e.tenant).placement[i]
        state = _unplace(state, e.tenant, i)
        actions.append(Action("demote", e.tenant, i, rid, 0.0))
    state = _promote_waiters(state, policy, actions)
    return state, set()


def _handle_migrate(state: PoolState, e: ev.Migrate,
                    policy: PlacementPolicy, actions: List[Action]
                    ) -> Tuple[PoolState, Set[int]]:
    t = state.tenant(e.tenant)
    if not 0 <= e.module_idx < len(t.placement):
        raise ValueError(f"{e.tenant!r} has no module {e.module_idx}")
    src = t.placement[e.module_idx]
    if src == ON_SERVER:
        raise ValueError(
            f"module ({e.tenant!r}, {e.module_idx}) is on-server; migrate "
            f"moves placed modules (use Grow to promote waiters)")
    if e.dst == src:
        return state, set()                 # no-op move, empty plan
    r = state.region(e.dst)                 # KeyError for unknown region
    if not r.free:
        raise ValueError(f"region {e.dst} is not free/healthy")
    fp = t.footprints[e.module_idx]
    if not fp.fits(r.hbm_bytes):
        raise ValueError(
            f"module ({e.tenant!r}, {e.module_idx}) does not fit region "
            f"{e.dst}")
    state = _unplace(state, e.tenant, e.module_idx)
    state = _place(state, e.tenant, e.module_idx, e.dst)
    actions.append(Action("migrate", e.tenant, e.module_idx, e.dst,
                          reconfig_cost_s(fp)))
    return state, {src, e.dst}


def _handle_grow(state: PoolState, e: ev.Grow,
                 policy: PlacementPolicy, actions: List[Action]
                 ) -> Tuple[PoolState, Set[int]]:
    t = state.tenant(e.tenant)
    state = state.with_tenant(dataclasses.replace(
        t, max_regions=e.n_regions))
    state = _promote_waiters(state, policy, actions)
    return state, set()


def _handle_fail(state: PoolState, rid: int,
                 policy: PlacementPolicy, actions: List[Action]
                 ) -> Tuple[PoolState, Set[int]]:
    r = state.region(rid)
    state = state.with_region(dataclasses.replace(r, healthy=False))
    if r.tenant is not None:
        actions.append(Action("fail", r.tenant, r.module_idx, rid, 0.0))
        state = _unplace(state, r.tenant, r.module_idx)
        # A failed tenant module may relocate to another free region now.
        state = _promote_waiters(state, policy, actions)
    return state, {rid}


def _handle_heal(state: PoolState, rid: int,
                 policy: PlacementPolicy, actions: List[Action]
                 ) -> Tuple[PoolState, Set[int]]:
    r = state.region(rid)
    state = state.with_region(dataclasses.replace(r, healthy=True))
    state = _promote_waiters(state, policy, actions)
    return state, {rid}


# ----------------------------------------------------------------------
# the fold
# ----------------------------------------------------------------------
def plan(state: PoolState, event: ev.Event,
         policy: Optional[PlacementPolicy] = None
         ) -> Tuple[PoolState, Plan]:
    """Fold one event over the pool state.  Pure: no clocks, no mutation.

    Returns the next state and a ``Plan`` whose delta, applied to the old
    state's register file, is content-identical to a full rebuild from the
    new state (property-tested in ``tests/test_shell.py``).
    """
    policy = policy or FirstFit()
    actions: List[Action] = []
    old = state

    if isinstance(event, ev.Submit):
        state, rids = _handle_submit(state, event, policy, actions)
    elif isinstance(event, ev.Release):
        state, rids = _handle_release(state, event, policy, actions)
    elif isinstance(event, ev.Shrink):
        state, rids = _handle_shrink(state, event, policy, actions)
    elif isinstance(event, ev.Grow):
        state, rids = _handle_grow(state, event, policy, actions)
    elif isinstance(event, ev.Migrate):
        state, rids = _handle_migrate(state, event, policy, actions)
    elif isinstance(event, (ev.FailRegion, ev.HeartbeatLost)):
        state, rids = _handle_fail(state, event.rid, policy, actions)
    elif isinstance(event, ev.HealRegion):
        state, rids = _handle_heal(state, event.rid, policy, actions)
    elif isinstance(event, ev.WatchdogTimeout):
        if event.region is not None:
            state, rids = _handle_fail(state, event.region, policy, actions)
        else:
            rids = set()
    else:
        raise TypeError(f"unknown shell event: {event!r}")

    state = _compact(state, policy, actions)

    touched_tenants = {a.tenant for a in actions if a.tenant is not None}
    touched_rids = rids | {a.region for a in actions if a.region is not None}
    delta = compute_delta(old, state, touched_tenants, touched_rids)
    return state, Plan(event=event, actions=tuple(actions), delta=delta)


def replay(state: PoolState, events: Sequence[ev.Event],
           policy: Optional[PlacementPolicy] = None
           ) -> Tuple[PoolState, List[Plan]]:
    """Fold a whole event sequence (useful for tests and speculation)."""
    plans = []
    for e in events:
        state, p = plan(state, e, policy)
        plans.append(p)
    return state, plans
