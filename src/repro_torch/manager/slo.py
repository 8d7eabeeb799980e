"""SLO-driven predictive autoscaling — grow *before* the queue does.

:class:`~repro_torch.shell.state.SLOTarget` (re-exported here) gives a
tenant QoS budgets: a p99 admission-latency ceiling and a drop-rate
ceiling.  This module turns those budgets into a control policy:

- :func:`slo_violations` — which ``(tenant, kind)`` budgets the current
  :class:`Signals` snapshot violates.
- :class:`PredictiveSLO` — a registered :class:`ElasticityPolicy` that
  forecasts each tenant's demand (``repro_torch.manager.forecast``) and Grows
  when *predicted* demand crosses the tenant's SLO-feasible capacity —
  before the violation, not after it — and Shrinks only when the forecast
  says the freed region won't be needed within the horizon.  Chains with
  the reactive policies via ``PolicyChain`` (e.g. predictive sizing +
  ``TrafficAwareDefrag`` placement hygiene).
- :func:`forecastable_violations` — the post-hoc audit of a scenario
  trace: of the violations a run *did* incur,
  which were predictable (history was warm) and actionable (a free region
  existed while the tenant was under-granted) at lead >= horizon?  A
  predictive policy's job is to make this set empty.

The capacity model is deliberately small: one granted region sustains
``service_per_region`` units of demand (demand = queued + active requests)
within the admission budget.  ``needed = ceil(peak_forecast /
service_per_region)`` is the SLO-feasible size.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.manager.forecast import (Forecaster, SignalsHistory,
                                          get_forecaster)
from repro_torch.manager.policies import (VictimSelector,
                                          register_elasticity_policy)
from repro_torch.manager.telemetry import Signals
from repro_torch.shell import events as ev
from repro_torch.shell.state import PoolState, SLOTarget

__all__ = ["SLOTarget", "slo_violations", "forecastable_violations",
           "PredictiveSLO"]


def slo_violations(signals: Signals, state: PoolState,
                   default_slo: Optional[SLOTarget] = None
                   ) -> Tuple[Tuple[str, str], ...]:
    """``(tenant, kind)`` budget violations in one snapshot.

    A tenant's own ``SLOTarget`` (attached at ``Submit``) wins; tenants
    without one fall back to ``default_slo``; with neither, no budget —
    no violation.  ``drop_rate`` is fabric-global, so it is charged to
    every tenant carrying a drop budget.
    """
    out: List[Tuple[str, str]] = []
    for ts in signals.tenants:
        t = state.find_tenant(ts.name)
        slo = (t.slo if t is not None and t.slo is not None
               else default_slo)
        if slo is None:
            continue
        for kind in slo.violations(admission_p99=ts.admission_p99,
                                   drop_rate=signals.drop_rate):
            out.append((ts.name, kind))
    return tuple(out)


def forecastable_violations(rows: Sequence[Mapping], *, horizon: int,
                            min_history: int = 3
                            ) -> Tuple[Tuple[int, str, str], ...]:
    """Audit a scenario trace: which violations were forecastable?

    ``rows`` are per-tick trace dicts carrying ``tick``, ``free_regions``,
    ``violations`` (``[(tenant, kind), ...]``) and ``tenants``
    (``{name: [granted, requested]}``, or the dict form
    ``{"granted": g, "requested": r}``) — the schema
    ``repro_torch.manager.scenarios`` emits.  A violation at tick ``T``
    counts as *forecastable* when a predictor acting ``horizon`` ticks
    earlier had both the information and the means to prevent it:

    - **warm history**: the tenant had been visible for at least
      ``min_history + horizon`` ticks by ``T``, and
    - **actionable**: at some tick in ``[T - horizon, T)`` the pool had a
      free region while the tenant was under-granted
      (``granted < requested``).

    Reactive policies leave these on the table; a predictive policy's
    property tests pin this set to empty.
    """
    by_tick = {int(r["tick"]): r for r in rows}
    first_seen: Dict[str, int] = {}
    for r in rows:
        for name in r.get("tenants", {}):
            first_seen.setdefault(name, int(r["tick"]))
    out: List[Tuple[int, str, str]] = []
    for r in rows:
        tick = int(r["tick"])
        for tenant, kind in r.get("violations", ()):
            seen = first_seen.get(tenant)
            if seen is None or tick - seen < min_history + horizon:
                continue
            actionable = False
            for back in range(1, horizon + 1):
                prev = by_tick.get(tick - back)
                if prev is None:
                    continue
                info = prev.get("tenants", {}).get(tenant)
                if info is None or int(prev["free_regions"]) == 0:
                    continue
                if isinstance(info, Mapping):
                    granted, requested = info["granted"], info["requested"]
                else:
                    granted, requested = info[0], info[1]
                if int(granted) < int(requested):
                    actionable = True
                    break
            if actionable:
                out.append((tick, tenant, kind))
    return tuple(out)


@register_elasticity_policy
class PredictiveSLO:
    """Forecast demand, size tenants to their SLO-feasible capacity.

    Each tick, per tenant: forecast the demand series ``horizon`` ticks
    out, convert the predicted peak into regions via the
    ``service_per_region`` capacity model, then

    - **Grow** (by one region per decision) when the SLO-feasible size
      exceeds the current grant and a free region actually fits one of
      the tenant's waiting modules.  Three triggers, most to least
      urgent: a budget already being violated; *observed* demand already
      past capacity (forecast at horizon zero — no ``Hysteresis``-style
      patience lag); and a confident forecast (``grow_confidence``) that
      demand will cross capacity within the horizon — growth *before*
      the demand arrives.
    - **Shrink** (by one region) only when a *confident* forecast
      (``shrink_confidence``) says the freed region won't be needed within
      the horizon: predicted peak fits in the remaining regions with
      ``shrink_margin`` headroom, and nothing is queued right now.

    The no-flapping guarantee is directional: after *any* action the
    tenant cannot Shrink for ``cooldown`` decisions, and after a Shrink
    it cannot Grow for ``cooldown`` decisions — so a grant never
    oscillates within a cooldown window.  Consecutive Grows are *not*
    throttled: ramping a tenant to its SLO-feasible size over successive
    decisions is the predictive policy's whole point, and a
    monotone ramp is not flap.  The manager binds its
    :class:`SignalsHistory` via :meth:`bind_history`; run standalone, the
    policy keeps its own ring (pushes are idempotent per tick, so the
    manager-bound case never double-records).
    """

    name = "predictive_slo"

    def __init__(self, *, forecaster="ewma", horizon: int = 6,
                 service_per_region: float = 2.0,
                 grow_confidence: float = 0.35,
                 shrink_confidence: float = 0.6,
                 shrink_margin: float = 0.8,
                 cooldown: int = 3, min_regions: int = 1,
                 min_history: int = 3,
                 default_slo: Optional[SLOTarget] = None,
                 victim_selector: Optional[VictimSelector] = None,
                 history_capacity: int = 256):
        if service_per_region <= 0:
            raise ValueError("service_per_region must be positive")
        self.forecaster: Forecaster = get_forecaster(forecaster)
        self.horizon = max(1, int(horizon))
        self.service_per_region = float(service_per_region)
        self.grow_confidence = float(grow_confidence)
        self.shrink_confidence = float(shrink_confidence)
        self.shrink_margin = float(shrink_margin)
        self.cooldown = int(cooldown)
        self.min_regions = int(min_regions)
        self.min_history = int(min_history)
        self.default_slo = default_slo
        self.victim_selector = victim_selector
        self._history = SignalsHistory(capacity=history_capacity)
        # tenant -> (tick, verb) of the last action; the cooldown is
        # directional (see class docstring).
        self._last_action: Dict[str, Tuple[int, str]] = {}

    # ---- wiring -------------------------------------------------------
    @property
    def history(self) -> SignalsHistory:
        return self._history

    def bind_history(self, history: SignalsHistory) -> None:
        """Adopt the manager's ring (one shared history per control loop)."""
        self._history = history

    def in_cooldown(self, name: str, tick: int, verb: str = "any") -> bool:
        """Is ``verb`` ("grow" | "shrink" | "any") throttled for this
        tenant?  Shrinks cool down after any action; grows only after a
        shrink (a monotone grow ramp is not flap)."""
        last = self._last_action.get(name)
        if last is None:
            return False
        last_tick, last_verb = last
        if tick - last_tick >= self.cooldown:
            return False
        if verb == "grow":
            return last_verb == "shrink"
        return True

    def needed_regions(self, demand: float) -> int:
        """SLO-feasible size for a demand level (capacity model)."""
        if demand <= 0:
            return 0
        return int(math.ceil(demand / self.service_per_region))

    # ---- the decision -------------------------------------------------
    def decide(self, signals: Signals,
               state: PoolState) -> Sequence[ev.Event]:
        self._history.push(signals)     # no-op when the manager already did
        live = {ts.name for ts in signals.tenants}
        for name in list(self._last_action):
            if name not in live:
                del self._last_action[name]
        violated = {t for t, _ in slo_violations(signals, state,
                                                 self.default_slo)}
        events: List[ev.Event] = []
        # Same free-region budget discipline as Hysteresis: one decide()
        # must not promise a region to two tenants.
        free_budget = list(state.free_regions())
        for ts in signals.tenants:
            t = state.find_tenant(ts.name)
            if t is None:
                continue
            series = self._history.series(ts.name, "demand")
            fc = self.forecaster.forecast(series, self.horizon)
            warm = self._history.length(ts.name) >= self.min_history
            demand_now = float(ts.queue_depth + ts.active)
            needed = self.needed_regions(fc.peak)
            needed_now = self.needed_regions(demand_now)
            wants_more = ts.granted < ts.requested
            grow = False
            if wants_more and not self.in_cooldown(
                    ts.name, signals.tick, "grow"):
                if ts.name in violated:
                    grow = True                  # already burning: act now
                elif needed_now > ts.granted and ts.queue_depth > 0:
                    grow = True                  # horizon-zero forecast
                elif (warm and fc.confidence >= self.grow_confidence
                        and needed > ts.granted):
                    grow = True                  # predicted to burn: lead it
            if grow:
                waiting = [t.footprints[i] for i in t.on_server_modules]
                fit = next((r for r in free_budget
                            if any(fp.fits(r.hbm_bytes)
                                   for fp in waiting)), None)
                if fit is None:
                    continue                     # nothing to grow into
                free_budget.remove(fit)
                events.append(ev.Grow(tenant=ts.name,
                                      n_regions=ts.granted + 1))
                self._last_action[ts.name] = (signals.tick, "grow")
                continue
            # Shrink: only on a confident forecast that the freed region
            # stays idle through the whole horizon.
            if (warm and ts.granted > self.min_regions
                    and not self.in_cooldown(ts.name, signals.tick,
                                             "shrink")
                    and ts.queue_depth == 0
                    and ts.name not in violated
                    and fc.confidence >= self.shrink_confidence
                    and max(fc.peak, demand_now) <= (
                        (ts.granted - 1) * self.service_per_region
                        * self.shrink_margin)):
                victims: Tuple[int, ...] = ()
                if self.victim_selector is not None:
                    victims = tuple(self.victim_selector(
                        signals, state, ts.name, 1))
                events.append(ev.Shrink(tenant=ts.name,
                                        n_regions=ts.granted - 1,
                                        victims=victims))
                self._last_action[ts.name] = (signals.tick, "shrink")
        return events
