"""Shell event taxonomy — the single vocabulary every layer speaks.

The paper's shell is event-driven: tenants arrive and leave, regions fail and
heal, watchdogs fire.  The seed repo spread those triggers across method
calls (``ElasticResourceManager.submit``), pollers (``HeartbeatMonitor.sweep``
called from examples) and hand-written glue.  This module gives them one
typed, immutable representation so that ``Shell.post(event)`` is the only
mutation entry point and the planner can be a pure fold.

Two event families:

- **tenant lifecycle** — ``Submit`` / ``Release`` / ``Shrink`` / ``Grow``:
  the §IV-A elasticity verbs.
- **fault tolerance** — ``FailRegion`` / ``HealRegion`` / ``HeartbeatLost`` /
  ``WatchdogTimeout``: the §IV-F watchdog and heartbeat outcomes.
  ``HeartbeatLost`` is semantically a ``FailRegion`` with provenance; the
  planner treats them identically.  ``WatchdogTimeout`` with a region demotes
  that region's module (the "switch the grant to the next master" path);
  without a region it is informational and produces an empty plan.

``Shrink`` optionally names *victim* regions so a controller (e.g. the
``repro_torch.manager`` traffic-aware policies) can decide **which** region a
tenant gives up, not just how many; ``Migrate`` relocates one placed module
to a named free region — the compaction verb the manager uses to defragment
the pool from telemetry instead of a per-event policy pass.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from repro_torch.core.module import ModuleFootprint
from repro_torch.shell.state import SLOTarget


@dataclasses.dataclass(frozen=True)
class Submit:
    """Admit a tenant: place what fits, spill the rest on-server.

    ``slo`` optionally attaches per-tenant QoS budgets
    (:class:`~repro_torch.shell.state.SLOTarget`); the planner carries it onto
    the tenant's ``TenantEntry`` where SLO-driven elasticity policies
    read it."""
    tenant: str
    footprints: Tuple[ModuleFootprint, ...]
    app_id: int = 0
    slo: Optional[SLOTarget] = None

    def __post_init__(self):
        object.__setattr__(self, "footprints", tuple(self.footprints))


@dataclasses.dataclass(frozen=True)
class Release:
    """Tenant done: free its regions and promote waiters."""
    tenant: str


@dataclasses.dataclass(frozen=True)
class Shrink:
    """Cap a tenant at ``n_regions`` regions.

    ``victims`` (region ids, in preference order, de-duplicated) select
    which placed modules demote first; remaining excess comes off the
    tail, which is the whole demotion set when ``victims`` is empty (the
    pre-manager behaviour).  Victim regions not held by the tenant are
    ignored."""
    tenant: str
    n_regions: int
    victims: Tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "victims",
                           tuple(dict.fromkeys(self.victims)))


@dataclasses.dataclass(frozen=True)
class Grow:
    """Raise (or with ``None`` remove) a tenant's region cap."""
    tenant: str
    n_regions: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Migrate:
    """Relocate one placed module to a named free, healthy region.

    The manager's defragmentation verb: unlike the per-event compaction
    pass of the ``defrag`` placement policy, a ``Migrate`` is an explicit,
    telemetry-driven decision (see ``repro_torch.manager.TrafficAwareDefrag``).
    Invalid moves (module on-server, target occupied/unhealthy/too small)
    raise ``ValueError`` at planning time and leave the pool untouched."""
    tenant: str
    module_idx: int
    dst: int


@dataclasses.dataclass(frozen=True)
class FailRegion:
    """Region lost: demote its module, hold its port in reset."""
    rid: int


@dataclasses.dataclass(frozen=True)
class HealRegion:
    """Region back: release the reset bit, promote waiters."""
    rid: int


@dataclasses.dataclass(frozen=True)
class HeartbeatLost:
    """§IV-F heartbeat miss — a FailRegion with provenance."""
    rid: int
    stale_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class WatchdogTimeout:
    """§IV-F ack-timeout at step granularity.  With a region: demote it.
    Without: informational (logged, empty plan)."""
    step: int
    region: Optional[int] = None
    elapsed_s: float = 0.0
    deadline_s: float = 0.0


Event = Union[Submit, Release, Shrink, Grow, Migrate,
              FailRegion, HealRegion, HeartbeatLost, WatchdogTimeout]

TENANT_EVENTS = (Submit, Release, Shrink, Grow, Migrate)
FT_EVENTS = (FailRegion, HealRegion, HeartbeatLost, WatchdogTimeout)
