"""``Manager`` — the closed loop over ``Shell.post``.

The shell makes reconfiguration event-driven and the fabric re-reads the
registers at call time; the manager does the *deciding*, which would
otherwise be a hand-posted ``Grow`` or ``Shrink``.  It closes the loop:

    manager = Manager(shell, policy="hysteresis",
                      probes=[server.probe(), stats.probe()])
    decision = manager.tick()       # sample -> decide -> post

Each ``tick`` assembles one :class:`~repro_torch.manager.telemetry.Signals`
snapshot from the registered probes, hands it to the
:class:`~repro_torch.manager.policies.ElasticityPolicy`, posts the
returned event batch through the shell, and appends a :class:`Decision`
record (signals, applied plans, rejected events) to ``manager.decisions``
— the machine-readable autoscaling trajectory the scenario harness
serializes.

Rejected events are part of the contract: policies decide on a snapshot, so
a chained batch can race itself (a migrate into a region an earlier grow
just filled).  The planner validates before any state swaps, the manager
catches and records, and the loop retries from fresher signals next tick —
actuation failure is telemetry, not a crash.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

from repro_torch.manager.forecast import SignalsHistory
from repro_torch.manager.policies import (ElasticityPolicy,
                                          get_elasticity_policy)
from repro_torch.manager.slo import slo_violations
from repro_torch.manager.telemetry import Probe, Signals, assemble_signals
from repro_torch.manager.trackers import Tracker, get_tracker
from repro_torch.shell import events as ev
from repro_torch.shell.planner import Plan
from repro_torch.shell.shell import Shell


@dataclasses.dataclass(frozen=True)
class Decision:
    """One control-loop tick: what was seen, decided, applied, rejected."""

    tick: int
    signals: Signals
    events: Tuple[ev.Event, ...]            # applied, in post order
    plans: Tuple[Plan, ...]                 # the shell's plan per event
    rejected: Tuple[Tuple[ev.Event, str], ...] = ()

    @property
    def acted(self) -> bool:
        return bool(self.events)

    def kinds(self) -> Tuple[str, ...]:
        return tuple(type(e).__name__ for e in self.events)


class Manager:
    """Tick-driven resource manager: probes -> policy -> ``shell.post``.

    Parameters
    ----------
    shell:
        The control plane to actuate.
    policy:
        An :class:`ElasticityPolicy` instance or registered name
        (``"hysteresis"`` / ``"traffic_defrag"`` / ``"fair_share"``).
    probes:
        Telemetry sources (``server.probe()``, ``stats.probe()``,
        ``fabric.probe()`` or anything matching the ``Probe`` protocol).
    interval:
        Control period in ticks: ``step()`` samples *and* decides only on
        every ``interval``-th call (skipped calls just advance the clock,
        so each snapshot's deltas span one whole control window).  A
        serving loop calls ``manager.step()`` per server tick while the
        controller runs at this slower cadence; ``tick()`` always decides.
    history:
        A :class:`~repro_torch.manager.forecast.SignalsHistory` demand ring
        (one is created when omitted).  Every ``tick()`` pushes the fresh
        snapshot, and any policy in the chain exposing ``bind_history``
        (e.g. ``PredictiveSLO``) is handed this ring at construction — one
        shared memory per control loop.
    trackers:
        Metric sinks (:class:`~repro_torch.manager.trackers.Tracker` instances
        or registered names): each ``tick()`` streams a flat per-tick
        metrics dict to every sink via ``log(metrics, step)``.
    """

    def __init__(self, shell: Shell,
                 policy: Union[str, ElasticityPolicy] = "hysteresis",
                 probes: Sequence[Probe] = (), *, interval: int = 1,
                 history: Optional[SignalsHistory] = None,
                 trackers: Sequence = ()):
        self.shell = shell
        self.policy = get_elasticity_policy(policy)
        self.probes: List[Probe] = list(probes)
        self.interval = max(1, interval)
        self.tick_count = 0
        self.decisions: List[Decision] = []
        self._last_signals: Optional[Signals] = None
        self.history = history if history is not None else SignalsHistory()
        self.trackers: List[Tracker] = [get_tracker(t) for t in trackers]
        for member in getattr(self.policy, "policies", None) or [self.policy]:
            bind = getattr(member, "bind_history", None)
            if callable(bind):
                bind(self.history)

    def add_probe(self, probe: Probe) -> None:
        self.probes.append(probe)

    # ---- the loop -----------------------------------------------------
    def signals(self) -> Signals:
        """Assemble one snapshot — this *consumes* the current window.

        Deltas and rates are measured since the previous ``signals()``
        call, and probes may advance internal cursors; calling this
        between control ticks therefore shortens the window the next
        ``tick()`` decides on.  Observers who just want to look should
        read :attr:`last_signals` (or ``Decision.signals``) instead.
        """
        sig = assemble_signals(self.shell, self.probes,
                               tick=self.tick_count,
                               prev=self._last_signals)
        self._last_signals = sig
        return sig

    @property
    def last_signals(self) -> Optional[Signals]:
        """The most recent snapshot, side-effect-free (``None`` before the
        first sample).  The observation surface for dashboards and tests —
        reading it never perturbs the controller's delta windows."""
        return self._last_signals

    def tick(self) -> Decision:
        """One full control iteration: sample, decide, post, record.

        >>> from repro_torch.core.elastic import Region
        >>> from repro_torch.core.module import ModuleFootprint
        >>> from repro_torch.manager import Manager
        >>> from repro_torch.shell import Shell
        >>> GB = 1 << 30
        >>> shell = Shell([Region(rid=i, n_chips=8, hbm_bytes=8 * GB)
        ...                for i in range(4)])
        >>> _ = shell.submit("a", [ModuleFootprint(GB, 1e9, 4096)] * 3,
        ...                  app_id=0)
        >>> _ = shell.submit("b", [ModuleFootprint(GB, 1e9, 4096)] * 3,
        ...                  app_id=1)
        >>> shell.placement_of("b")            # 'a' got 3 regions first
        [3, -1, -1]
        >>> manager = Manager(shell, policy="fair_share")
        >>> decision = manager.tick()          # rebalance toward 2 + 2
        >>> decision.kinds()
        ('Shrink', 'Grow')
        >>> shell.placement_of("b")            # -1 == runs on-server
        [3, 2, -1]
        """
        sig = self.signals()
        self.history.push(sig)
        applied: List[ev.Event] = []
        plans: List[Plan] = []
        rejected: List[Tuple[ev.Event, str]] = []
        for event in self.policy.decide(sig, self.shell.state):
            try:
                plans.append(self.shell.post(event))
                applied.append(event)
            except (KeyError, ValueError) as e:
                # Stale-snapshot races within a batch (see module docs).
                rejected.append((event, repr(e)))
        decision = Decision(tick=self.tick_count, signals=sig,
                            events=tuple(applied), plans=tuple(plans),
                            rejected=tuple(rejected))
        self.decisions.append(decision)
        if self.trackers:
            metrics = self.tick_metrics(decision)
            for tracker in self.trackers:
                tracker.log(metrics, decision.tick)
        self.tick_count += 1
        return decision

    def tick_metrics(self, decision: Decision) -> dict:
        """Flat per-tick scalars for tracker sinks (aggregates only — a
        thousand-tenant pool must not explode the metric namespace)."""
        sig = decision.signals
        default_slo = next(
            (m.default_slo
             for m in getattr(self.policy, "policies", None) or [self.policy]
             if getattr(m, "default_slo", None) is not None), None)
        return {
            "free_regions": float(sig.free_regions),
            "healthy_regions": float(sig.healthy_regions),
            "tenants": float(len(sig.tenants)),
            "queue_depth": float(sig.total_queue_depth),
            "active": float(sum(t.active for t in sig.tenants)),
            "granted": float(sum(t.granted for t in sig.tenants)),
            "drop_rate": float(sig.drop_rate),
            "fragmentation": float(sig.fragmentation),
            "fabric_traces": float(sig.fabric_traces),
            "events_applied": float(len(decision.events)),
            "events_rejected": float(len(decision.rejected)),
            "slo_violations": float(len(slo_violations(
                sig, self.shell.state, default_slo))),
        }

    def step(self) -> Optional[Decision]:
        """Interval-gated ``tick``: decide only every ``interval``-th call
        (still advances the clock, so signals stay per-window aligned)."""
        if self.tick_count % self.interval == 0:
            return self.tick()
        self.tick_count += 1
        return None

    # ---- views --------------------------------------------------------
    def event_counts(self) -> dict:
        """Histogram of applied event kinds over the manager's lifetime."""
        out: dict = {}
        for d in self.decisions:
            for kind in d.kinds():
                out[kind] = out.get(kind, 0) + 1
        return out
