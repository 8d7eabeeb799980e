"""Pluggable elasticity policies — ``Signals`` in, shell events out.

The paper's resource manager "can increase or decrease the number of PR
regions allocated to an application based on its acceleration requirements
and PR regions' availability".  An :class:`ElasticityPolicy` is that
decision procedure behind a seam that mirrors ``repro_torch.shell.policy
.PlacementPolicy``: pure-ish ``decide(signals, state)`` returning a batch of
shell events, a ``name``, and a registry so ``Manager(policy="hysteresis")``
works by string.  Policies may keep *controller* state (streak counters,
cooldown stamps) — they never touch the pool; only the posted events do.

Built-ins:

- ``hysteresis``     — grow on sustained queue pressure, shrink on
  sustained idleness, with per-tenant cooldowns so one noisy window cannot
  flap a tenant between sizes.
- ``traffic_defrag`` — reads the per-port grant deltas to pick *which*
  region moves: cold placed modules migrate down to low rids (explicit
  ``Migrate`` events), and its ``coldest_regions`` doubles as a victim
  selector for ``Shrink`` (closing the ROADMAP item: feed
  ``port_traffic``/drops back into placement decisions).
- ``fair_share``     — weighted max-min over tenants' requested vs granted
  regions (the §IV-D WRR bandwidth weights, applied at region-allocation
  granularity): over-served tenants shrink to their share, under-served
  tenants grow to it, and no tenant starves while capacity suffices.
- ``chain``          — ``PolicyChain([...])`` concatenates decisions, e.g.
  ``Hysteresis`` for sizing + ``TrafficAwareDefrag`` for placement hygiene.
"""
from __future__ import annotations

from typing import (Callable, Dict, List, Mapping, Optional, Protocol,
                    Sequence, Tuple, runtime_checkable)

from repro_torch.manager.telemetry import Signals
from repro_torch.shell import events as ev
from repro_torch.shell.state import ON_SERVER, PoolState

# A victim selector: (signals, state, tenant, k) -> k region ids to demote.
VictimSelector = Callable[[Signals, PoolState, str, int], Tuple[int, ...]]


def abuse_scores(signals: Signals) -> Dict[str, int]:
    """Per-tenant isolation-abuse evidence: this window's masked
    (INVALID_DEST) packets attributed to each tenant's own source ports.
    Only offenders appear — a clean tenant is absent, not zero — so policy
    hooks can gate on membership cheaply."""
    return {ts.name: ts.masked_requests for ts in signals.tenants
            if ts.masked_requests > 0}


@runtime_checkable
class ElasticityPolicy(Protocol):
    """Strategy seam for the manager's control loop."""

    name: str

    def decide(self, signals: Signals,
               state: PoolState) -> Sequence[ev.Event]:
        """Events to post this tick (may be empty).  Decisions compose on
        the snapshot they were made from; the manager tolerates rejected
        posts, so policies should prefer conservative batches.

        A custom policy is any object with ``name`` and this method —
        register it and ``Manager(shell, policy="sla")`` resolves it by
        string:

        >>> from repro_torch.manager import register_elasticity_policy
        >>> from repro_torch.shell import events as ev
        >>> @register_elasticity_policy
        ... class GrowWhenStarved:
        ...     name = "sla"
        ...     def decide(self, signals, state):
        ...         return [ev.Grow(tenant=t.name)
        ...                 for t in signals.tenants if t.starved]
        >>> from repro_torch.manager import get_elasticity_policy
        >>> get_elasticity_policy("sla").name
        'sla'
        """
        ...


# ----------------------------------------------------------------------
# hysteresis — sustained pressure grows, sustained idleness shrinks
# ----------------------------------------------------------------------
class Hysteresis:
    """Queue-pressure autoscaler with streaks and cooldowns.

    Grow when a tenant's queue depth has been at least ``grow_queue`` for
    ``patience`` consecutive ticks (and a free region actually fits one of
    its waiting modules — a Grow that cannot place would burn the cooldown
    on an empty plan); shrink by one region when queue and active
    slots have been zero for ``idle_ticks`` consecutive ticks (down to
    ``min_regions``).  After either action the tenant is in cooldown for
    ``cooldown`` ticks — the no-flapping guarantee the property tests pin.

    ``victim_selector`` (e.g. ``TrafficAwareDefrag.coldest_regions``) makes
    shrinks traffic-aware: it names which region the tenant gives up.
    """

    name = "hysteresis"

    def __init__(self, *, grow_queue: int = 2, patience: int = 2,
                 idle_ticks: int = 4, cooldown: int = 5,
                 min_regions: int = 1,
                 victim_selector: Optional[VictimSelector] = None):
        self.grow_queue = grow_queue
        self.patience = patience
        self.idle_ticks = idle_ticks
        self.cooldown = cooldown
        self.min_regions = min_regions
        self.victim_selector = victim_selector
        self._pressure: Dict[str, int] = {}
        self._idle: Dict[str, int] = {}
        self._last_action: Dict[str, int] = {}

    def in_cooldown(self, name: str, tick: int) -> bool:
        last = self._last_action.get(name)
        return last is not None and tick - last < self.cooldown

    def decide(self, signals: Signals,
               state: PoolState) -> Sequence[ev.Event]:
        # Departed tenants take their streaks and cooldowns with them — a
        # re-submitted namesake is a new tenant, not a resumed controller.
        live = {ts.name for ts in signals.tenants}
        for d in (self._pressure, self._idle, self._last_action):
            for name in list(d):
                if name not in live:
                    del d[name]
        events: List[ev.Event] = []
        # Local free-region budget: one decide() must not promise the same
        # free region to two pressured tenants (the planner would accept
        # both Grows but only one would place, and the other tenant would
        # burn its cooldown on an empty plan).
        free_budget = list(state.free_regions())
        for ts in signals.tenants:
            t = state.find_tenant(ts.name)
            if t is None:
                continue
            if ts.queue_depth >= self.grow_queue:
                self._pressure[ts.name] = self._pressure.get(ts.name, 0) + 1
                self._idle[ts.name] = 0
            elif ts.queue_depth == 0 and ts.active == 0:
                self._idle[ts.name] = self._idle.get(ts.name, 0) + 1
                self._pressure[ts.name] = 0
            else:
                self._pressure[ts.name] = 0
                self._idle[ts.name] = 0
            if self.in_cooldown(ts.name, signals.tick):
                continue
            wants_more = ts.granted < ts.requested
            if (self._pressure.get(ts.name, 0) >= self.patience
                    and wants_more):
                # Act only when a Grow can actually place something: some
                # remaining free region fits one of the tenant's waiting
                # modules.  A vacuous Grow would stamp the cooldown while
                # changing nothing — the starvation-lock failure mode.
                waiting = [t.footprints[i] for i in t.on_server_modules]
                fit = next((r for r in free_budget
                            if any(fp.fits(r.hbm_bytes)
                                   for fp in waiting)), None)
                if fit is None:
                    continue
                free_budget.remove(fit)
                events.append(ev.Grow(tenant=ts.name,
                                      n_regions=ts.granted + 1))
                self._last_action[ts.name] = signals.tick
                self._pressure[ts.name] = 0
            elif (self._idle.get(ts.name, 0) >= self.idle_ticks
                    and ts.granted > self.min_regions):
                victims: Tuple[int, ...] = ()
                if self.victim_selector is not None:
                    victims = tuple(self.victim_selector(
                        signals, state, ts.name, 1))
                events.append(ev.Shrink(tenant=ts.name,
                                        n_regions=ts.granted - 1,
                                        victims=victims))
                self._last_action[ts.name] = signals.tick
                self._idle[ts.name] = 0
        return events


# ----------------------------------------------------------------------
# traffic-aware defrag — cold regions move first
# ----------------------------------------------------------------------
class TrafficAwareDefrag:
    """Placement hygiene from live traffic: migrate the *coldest* placed
    modules down to the lowest free rids (cheapest disruption first — a
    cold port is one nobody is streaming through), at most ``max_moves``
    per tick and only while fragmentation exceeds ``threshold``.

    ``coldest_regions`` ranks a tenant's own regions by this window's port
    grants — pluggable into ``Hysteresis(victim_selector=...)`` and
    ``FairShare(victim_selector=...)`` so *shrinks* also give up the least
    loaded region instead of the tail module's.

    ``min_remote_fraction`` gates compaction on the sharded fabric's
    per-axis split (``Signals.remote_fraction``): when a window's granted
    traffic stays on its source shards, moving modules buys no interconnect
    locality, so a non-zero gate keeps the defragger quiet until remote
    bytes actually flow.  0.0 (default) disables the gate.

    ``rank_by`` picks the move ordering: ``"cold"`` (default) migrates the
    least-trafficked modules first (cheapest disruption); ``"ici"`` ranks
    candidate ``Migrate`` moves by this window's *cross-axis* grants into
    their port (``Signals.region_remote_delta`` — the per-port remote/local
    split the sharded fabric accounts), so the moves with the largest ICI
    savings land inside the ``max_moves`` budget first.  When no per-port
    split was reported this window, ``"ici"`` falls back to cold-first.

    ``abuse_penalty`` > 0 subtracts ``penalty * masked_requests`` (the
    window's per-source INVALID_DEST attribution, ``abuse_scores``) from a
    module's ranking traffic, so an abuser's modules sort coldest and are
    the first disrupted — the manager-level response to a tenant probing
    the masking registers.
    """

    name = "traffic_defrag"

    def __init__(self, *, max_moves: int = 1, threshold: float = 0.0,
                 min_remote_fraction: float = 0.0, rank_by: str = "cold",
                 abuse_penalty: float = 0.0):
        if rank_by not in ("cold", "ici"):
            raise ValueError(
                f"rank_by must be 'cold' or 'ici', got {rank_by!r}")
        self.max_moves = max_moves
        self.threshold = threshold
        self.min_remote_fraction = min_remote_fraction
        self.rank_by = rank_by
        self.abuse_penalty = abuse_penalty

    @staticmethod
    def coldest_regions(signals: Signals, state: PoolState, tenant: str,
                        k: int) -> Tuple[int, ...]:
        t = state.find_tenant(tenant)
        if t is None:
            return ()
        rids = [p for p in t.placement if p != ON_SERVER]
        rids.sort(key=lambda rid: (signals.region_traffic_delta(rid), -rid))
        return tuple(rids[:k])

    def decide(self, signals: Signals,
               state: PoolState) -> Sequence[ev.Event]:
        if signals.fragmentation <= self.threshold:
            return []
        if (self.min_remote_fraction > 0.0
                and signals.remote_fraction < self.min_remote_fraction):
            return []
        free = sorted(r.rid for r in state.free_regions())
        hbm = {r.rid: r.hbm_bytes for r in state.regions}
        abuse = (abuse_scores(signals) if self.abuse_penalty > 0 else {})
        # Candidates: (traffic, src_rid, tenant, module_idx) — coldest
        # first; abusers' modules rank below genuinely cold ones.
        candidates = []
        for t in state.tenants:
            for i, p in enumerate(t.placement):
                if p == ON_SERVER:
                    continue
                score = (signals.region_traffic_delta(p)
                         - self.abuse_penalty * abuse.get(t.name, 0))
                candidates.append((score, p, t.name, i))
        if (self.rank_by == "ici"
                and any(signals.remote_port_traffic_delta)):
            # Largest ICI savings first; cold-first breaks ties so the
            # ordering degrades gracefully to the default.
            candidates.sort(key=lambda c: (
                -signals.region_remote_delta(c[1]), c[0], -c[1], c[2]))
        else:
            candidates.sort(key=lambda c: (c[0], -c[1], c[2]))
        events: List[ev.Event] = []
        for _, src, name, i in candidates:
            if len(events) >= self.max_moves:
                break
            fp = state.tenant(name).footprints[i]
            dst = next((rid for rid in free
                        if rid < src and fp.fits(hbm[rid])), None)
            if dst is None:
                continue
            free.remove(dst)
            free.append(src)
            free.sort()
            events.append(ev.Migrate(tenant=name, module_idx=i, dst=dst))
        return events


# ----------------------------------------------------------------------
# fair share — weighted max-min over requested vs granted
# ----------------------------------------------------------------------
class FairShare:
    """Weighted max-min region allocation (progressive filling).

    Healthy capacity is handed out one region at a time to the tenant with
    the smallest ``allocated / weight`` among those still under their
    request — the discrete water-filling that WRR bandwidth weights induce
    at region granularity.  Tenants above their share shrink to it; tenants
    below grow to it.  While capacity >= number of requesting tenants,
    every requesting tenant is allocated at least one region (the
    no-starvation property).

    ``abuse_penalty`` > 0 divides a tenant's WRR weight by
    ``1 + penalty * masked_requests`` for the window (``abuse_scores``
    evidence): a tenant caught probing the masking registers fills later
    and to a smaller share, without ever dropping a clean tenant below its
    own weight — abuse costs only the abuser's budget.
    """

    name = "fair_share"

    def __init__(self, weights: Optional[Mapping[str, float]] = None, *,
                 cooldown: int = 2,
                 victim_selector: Optional[VictimSelector] = None,
                 abuse_penalty: float = 0.0):
        self.weights = dict(weights or {})
        self.cooldown = cooldown
        self.victim_selector = victim_selector
        self.abuse_penalty = abuse_penalty
        self._last_action: Dict[str, int] = {}

    def _effective_weight(self, ts) -> float:
        w = self.weights.get(ts.name, 1.0)
        if self.abuse_penalty > 0 and ts.masked_requests > 0:
            w /= 1.0 + self.abuse_penalty * ts.masked_requests
        return w

    def share(self, signals: Signals,
              state: PoolState) -> Dict[str, int]:
        """The target allocation: max-min fill of healthy capacity.

        A non-positive weight means "never allocate": the tenant stays in
        the allocation at 0 (so ``decide`` shrinks it there) but takes no
        part in the fill."""
        alloc = {ts.name: 0 for ts in signals.tenants if ts.requested > 0}
        eff = {ts.name: self._effective_weight(ts)
               for ts in signals.tenants}
        requesting = [ts for ts in signals.tenants
                      if ts.requested > 0 and eff[ts.name] > 0]
        remaining = signals.healthy_regions
        while remaining > 0:
            under = [ts for ts in requesting
                     if alloc[ts.name] < ts.requested]
            if not under:
                break
            pick = min(under, key=lambda ts: (
                alloc[ts.name] / eff[ts.name], ts.name))
            alloc[pick.name] += 1
            remaining -= 1
        return alloc

    def decide(self, signals: Signals,
               state: PoolState) -> Sequence[ev.Event]:
        live = {ts.name for ts in signals.tenants}
        for name in list(self._last_action):
            if name not in live:                # no cooldown inheritance
                del self._last_action[name]
        alloc = self.share(signals, state)
        shrinks: List[ev.Event] = []
        grows: List[ev.Event] = []
        for ts in signals.tenants:
            target = alloc.get(ts.name)
            if target is None or target == ts.granted:
                continue
            last = self._last_action.get(ts.name)
            if last is not None and signals.tick - last < self.cooldown:
                continue
            self._last_action[ts.name] = signals.tick
            if ts.granted > target:
                victims: Tuple[int, ...] = ()
                if self.victim_selector is not None:
                    victims = tuple(self.victim_selector(
                        signals, state, ts.name, ts.granted - target))
                shrinks.append(ev.Shrink(tenant=ts.name, n_regions=target,
                                         victims=victims))
            else:
                grows.append(ev.Grow(tenant=ts.name, n_regions=target))
        # Shrinks first: they free the regions the grows promote into (the
        # planner's promote pass runs inside each shrink plan as well).
        return shrinks + grows


# ----------------------------------------------------------------------
# composition + registry
# ----------------------------------------------------------------------
class PolicyChain:
    """Concatenate several policies' decisions (applied in order).

    All members decide on the *same* snapshot; a later event invalidated by
    an earlier one (e.g. a migrate into a region a grow just filled) is
    rejected by the planner and recorded by the manager — the loop, not the
    chain, is the consistency boundary.
    """

    name = "chain"

    def __init__(self, policies: Sequence):
        self.policies = [get_elasticity_policy(p) for p in policies]

    def decide(self, signals: Signals,
               state: PoolState) -> Sequence[ev.Event]:
        events: List[ev.Event] = []
        for policy in self.policies:
            events.extend(policy.decide(signals, state))
        return events


_REGISTRY: Dict[str, type] = {
    Hysteresis.name: Hysteresis,
    TrafficAwareDefrag.name: TrafficAwareDefrag,
    FairShare.name: FairShare,
}


def get_elasticity_policy(policy) -> ElasticityPolicy:
    """Resolve a policy from a name or pass an instance through."""
    if isinstance(policy, str):
        try:
            return _REGISTRY[policy]()
        except KeyError:
            raise ValueError(
                f"unknown elasticity policy {policy!r}; "
                f"known: {sorted(_REGISTRY)}") from None
    return policy


def register_elasticity_policy(cls) -> type:
    """Register a custom elasticity policy under its ``name``
    (decorator-friendly); ``Manager(shell, policy=name)`` and
    ``PolicyChain([name, ...])`` then resolve it by string — see the
    worked example on :meth:`ElasticityPolicy.decide`.

    >>> from repro_torch.manager import (get_elasticity_policy,
    ...                            register_elasticity_policy)
    >>> @register_elasticity_policy
    ... class Freeze:
    ...     name = "freeze"
    ...     def decide(self, signals, state):
    ...         return []          # hold every allocation where it is
    >>> get_elasticity_policy("freeze").decide(None, None)
    []
    """
    _REGISTRY[cls.name] = cls
    return cls
