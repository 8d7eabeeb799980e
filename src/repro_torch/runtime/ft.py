"""Fault tolerance: heartbeats, step watchdogs, straggler statistics (the
JAX package's ``runtime/ft.py``; host-side Python, no device work).

The paper's WB interfaces carry *watchdog timers*: a master that waits too
long for a grant or an ack raises GRANT_TIMEOUT / ACK_TIMEOUT and the error
code lands in the register file for the manager to read (§IV-F). The fleet
runtime keeps exactly that contract at step granularity:

- ``StepWatchdog``    — per-step deadline; a blown deadline is the ack-
  timeout analogue and marks the step's region as *suspect*;
- ``HeartbeatMonitor``— regions report liveness; a missed-heartbeat region is
  *failed* and handed to the ElasticResourceManager (demote-to-host path);
- ``StragglerStats``  — EWMA of per-region step times; persistent outliers
  (> ``threshold`` x fleet median for ``patience`` consecutive steps) trigger
  region reassignment, the paper's "switch the grant to the next master".

Event wiring: both monitors speak the unified shell vocabulary.  Attach
a ``repro_torch.shell.Shell`` (or pass ``on_timeout`` for the watchdog)
and a missed heartbeat posts ``HeartbeatLost``, a heal posts ``HealRegion``, and a blown
step deadline posts ``WatchdogTimeout`` — no example-level polling glue
needed.  The legacy ``erm=`` arguments remain for the wrapper API.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from repro_torch.core.registers import ErrorCode
from repro_torch.shell.events import (HealRegion, HeartbeatLost,
                                      WatchdogTimeout)


@dataclasses.dataclass
class WatchdogEvent:
    step: int
    region: Optional[int]
    elapsed_s: float
    deadline_s: float
    error: int = int(ErrorCode.ACK_TIMEOUT)


class StepWatchdog:
    """Per-step deadline — the WB watchdog at step granularity.

    ``on_timeout`` (or an attached ``shell``) receives every blown deadline;
    a shell gets it as a ``WatchdogTimeout`` event so demotion happens
    through the planner, not through caller-side polling of ``events``.
    """

    def __init__(self, deadline_s: float, *,
                 on_timeout: Optional[Callable[[WatchdogEvent], None]] = None,
                 shell=None):
        self.deadline_s = deadline_s
        self.events: List[WatchdogEvent] = []
        self.on_timeout = on_timeout
        self.shell = shell
        self._t0: Optional[float] = None
        self._step = -1

    def arm(self, step: int) -> None:
        self._t0 = time.monotonic()
        self._step = step

    def check(self, region: Optional[int] = None) -> bool:
        """True if the armed step beat its deadline."""
        assert self._t0 is not None, "watchdog not armed"
        elapsed = time.monotonic() - self._t0
        ok = elapsed <= self.deadline_s
        if not ok:
            event = WatchdogEvent(self._step, region, elapsed,
                                  self.deadline_s)
            self.events.append(event)
            if self.on_timeout is not None:
                self.on_timeout(event)
            if self.shell is not None:
                self.shell.post(WatchdogTimeout(
                    step=event.step, region=event.region,
                    elapsed_s=event.elapsed_s,
                    deadline_s=event.deadline_s))
        return ok


class HeartbeatMonitor:
    """Region liveness; emits shell events (or drives the legacy ERM).

    Attach a ``repro_torch.shell.Shell`` and every stale heartbeat posts a
    ``HeartbeatLost`` event (the planner demotes the region's module), every
    heal posts ``HealRegion`` (the planner promotes waiters).  The ``erm=``
    arguments keep the seed's polled integration working.
    """

    def __init__(self, region_ids: Optional[List[int]] = None,
                 timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic, *,
                 shell=None):
        if region_ids is None:
            if shell is None:
                raise ValueError(
                    "HeartbeatMonitor needs region_ids or a shell to "
                    "derive them from")
            region_ids = [r.rid for r in shell.state.regions]
        self.timeout_s = timeout_s
        self.shell = shell
        self._clock = clock
        now = clock()
        self.last_beat: Dict[int, float] = {r: now for r in region_ids}
        self.failed: Dict[int, float] = {}

    def monitored_ids(self) -> List[int]:
        """The regions this sweep watches.  With a shell attached this is
        the *live* pool (a statically passed list would go stale as the
        pool changes); standalone it is the constructor's list."""
        if self.shell is not None:
            return [r.rid for r in self.shell.state.regions]
        return list(self.last_beat)

    def beat(self, region: int) -> None:
        self.last_beat[region] = self._clock()
        if region in self.failed:
            del self.failed[region]

    def sweep(self, erm=None) -> List[int]:
        """Mark regions with stale heartbeats failed; emit events/demote."""
        now = self._clock()
        newly_failed = []
        for region in self.monitored_ids():
            # A region first seen by this sweep (joined the pool after
            # construction) baselines now rather than failing instantly.
            t = self.last_beat.setdefault(region, now)
            if region in self.failed:
                continue
            if now - t > self.timeout_s:
                self.failed[region] = now
                newly_failed.append(region)
                if erm is not None:
                    erm.fail_region(region)
                if self.shell is not None:
                    self.shell.post(HeartbeatLost(rid=region,
                                                  stale_s=now - t))
        return newly_failed

    def heal(self, region: int, erm=None) -> None:
        self.beat(region)
        if erm is not None:
            erm.heal_region(region)
        if self.shell is not None:
            self.shell.post(HealRegion(rid=region))


class StragglerStats:
    """EWMA step times per region; flags persistent stragglers.

    With a ``shell`` attached, :meth:`sweep` posts a ``WatchdogTimeout``
    event for every *newly* flagged straggler (once per streak — the
    planner demotes the region; re-posting while it is already failed
    would be noise), closing the poll-only gap: ``TrainLoop`` feeds its
    per-step times here and stragglers demote through the event bus with
    no example-level polling.
    """

    def __init__(self, region_ids: Optional[List[int]] = None,
                 alpha: float = 0.3,
                 threshold: float = 1.5, patience: int = 3, *,
                 shell=None):
        if region_ids is None:
            if shell is None:
                raise ValueError(
                    "StragglerStats needs region_ids or a shell to derive "
                    "them from")
            region_ids = [r.rid for r in shell.state.regions]
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.shell = shell
        self.ewma: Dict[int, Optional[float]] = {r: None for r in region_ids}
        self.strikes: Dict[int, int] = {r: 0 for r in region_ids}
        self._reported: set = set()
        self._dirty: set = set()

    def scores(self) -> Dict[int, float]:
        """EWMA-to-fleet-median ratio per recorded region (1.0 == typical;
        above ``threshold`` feeds a strike).  The manager's straggler
        signal."""
        med = self._median()
        if not med:
            return {}
        return {r: v / med for r, v in self.ewma.items() if v is not None}

    def probe(self):
        """A ``repro_torch.manager`` telemetry probe over these
        statistics."""
        from repro_torch.manager.telemetry import StragglerProbe
        return StragglerProbe(self)

    def record(self, region: int, step_s: float) -> None:
        prev = self.ewma.get(region)
        self.ewma[region] = (step_s if prev is None
                             else self.alpha * step_s
                             + (1 - self.alpha) * prev)
        self.strikes.setdefault(region, 0)    # regions may join the fleet late
        self._dirty.add(region)

    def _median(self) -> Optional[float]:
        vals = sorted(v for v in self.ewma.values() if v is not None)
        if not vals:
            return None
        return vals[len(vals) // 2]

    def stragglers(self) -> List[int]:
        """Regions whose EWMA exceeded threshold x median for ``patience``
        consecutive *recorded* steps.

        A region's strike count advances only when a new ``record`` for it
        arrived since the last call — so with stats shared fleet-wide,
        every loop sweeping on its own step advances its own region's
        streak once per step, not once per peer sweep (one transiently
        slow step cannot burn through ``patience``)."""
        med = self._median()
        out = []
        if med is None or med == 0:
            return out
        for region, v in self.ewma.items():
            if region in self._dirty:
                self._dirty.discard(region)
                if v is not None and v > self.threshold * med:
                    self.strikes[region] += 1
                else:
                    self.strikes[region] = 0
                    self._reported.discard(region)
            if self.strikes[region] >= self.patience:
                out.append(region)
        return out

    def sweep(self, step: int = -1) -> List[int]:
        """Flag stragglers and post ``WatchdogTimeout`` for new ones.

        Returns the currently flagged regions.  Emission is once per
        straggler streak and only while the region is still healthy in the
        shell's pool (the resulting demote makes a second post redundant).
        """
        out = self.stragglers()
        if self.shell is None:
            return out
        med = self._median() or 0.0
        for region in out:
            if region in self._reported:
                continue
            try:
                healthy = self.shell.state.region(region).healthy
            except (KeyError, IndexError):
                continue          # unknown to this pool: retry next sweep
            self._reported.add(region)
            if healthy:
                self.shell.post(WatchdogTimeout(
                    step=step, region=region,
                    elapsed_s=float(self.ewma[region] or 0.0),
                    deadline_s=self.threshold * med))
        return out
