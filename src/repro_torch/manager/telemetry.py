"""``repro_torch.manager.telemetry`` — one typed, normalized ``Signals``
snapshot (also importable as ``repro_torch.telemetry``).

Before this module, demand signals were scattered attribute reads:
``ElasticServer.port_traffic`` and its queue, ``StragglerStats`` EWMAs,
``Fabric.trace_count``, ``DispatchPlan`` drop histograms.  The manager's
control loop needs them as *one value*: a frozen :class:`Signals` snapshot
assembled each tick from pluggable :class:`Probe` sources plus the shell's
own pool state.

A probe is anything with a ``name`` and a ``sample() -> Mapping`` returning
**channels** — well-known keys the assembler understands:

======================  ================================================
channel                 value
======================  ================================================
``queue_depth``         ``{app_id: queued requests}``
``queue_wait``          ``{app_id: mean ticks the queued requests waited}``
``active``              ``{app_id: decode slots currently serving it}``
``admission_wait``      ``{app_id: mean submit->admit ticks, this window}``
``admission_p50``       ``{app_id: p50 submit->admit ticks, this window}``
``admission_p99``       ``{app_id: p99 submit->admit ticks, this window}``
                        (the percentiles serving SLO policies gate on)
``port_traffic``        cumulative per-port grant counts (int sequence)
``offered_packets``     cumulative packets offered to the fabric (int)
``granted_packets``     cumulative packets granted (int)
``remote_packets``      cumulative grants that crossed the mesh axis (int)
``local_packets``       cumulative grants on the source's own shard (int)
``remote_port_traffic`` cumulative cross-axis grants per destination port
                        (int sequence — ranks ports by ICI cost)
``local_port_traffic``  cumulative same-shard grants per destination port
                        (int sequence)
``masked_by_src``       cumulative INVALID_DEST packets per *originating*
                        source port (int sequence — the isolation
                        attribution abuse policies read)
``dropped_by_src``      cumulative non-granted offers per originating
                        source port (int sequence)
``straggler_score``     ``{region: EWMA / fleet median}``
``fabric_traces``       cumulative distinct fabric call signatures
                        (``Fabric.trace_count``; int)
``plan_cache_hits``     cumulative fabric plan-cache hits (int)
``plan_cache_misses``   cumulative fabric plan-cache misses (int)
``plan_cache_invalidations``  cumulative epoch flushes of live entries
======================  ================================================

Dict channels merge across probes (per-key update), scalar/array channels
accumulate — several servers over one shell sum their traffic.  Rates and
deltas are *normalized at assembly*: the assembler diffs cumulative
counters against the previous snapshot so policies see per-window values
(``port_traffic_delta``, ``drop_rate``) and never keep counter state
themselves.

The built-in probes wrap the existing subsystems (each also reachable as
``subsystem.probe()``): :class:`ServerProbe` (``ElasticServer``),
:class:`StragglerProbe` (``StragglerStats`` / ``TrainLoop``),
:class:`FabricProbe` (``Fabric``).
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Dict, List, Mapping, Optional, Protocol, Sequence,
                    Tuple, runtime_checkable)

from repro_torch.shell.state import ON_SERVER, PoolState
from repro_torch.stats import percentile

__all__ = [
    "Signals", "TenantSignals", "Probe", "ServerProbe", "StragglerProbe",
    "FabricProbe", "assemble_signals", "fragmentation",
]


@runtime_checkable
class Probe(Protocol):
    """Telemetry source seam (mirrors ``PlacementPolicy``'s shape)."""

    name: str

    def sample(self) -> Mapping[str, Any]:
        """Current channel values (see module docstring for channel keys)."""
        ...


# ----------------------------------------------------------------------
# the snapshot
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TenantSignals:
    """Demand vs grant for one admitted tenant, one tick."""

    name: str
    app_id: int
    requested: int              # modules the tenant wants placed
    granted: int                # modules currently on regions
    queue_depth: int = 0        # server requests waiting for this app
    active: int = 0             # decode slots currently serving this app
    queue_wait: float = 0.0     # mean ticks its queued requests have waited
    admission_wait: float = 0.0  # mean submit->admit ticks, this window
    admission_p50: float = 0.0   # median submit->admit ticks, this window
    admission_p99: float = 0.0   # tail submit->admit ticks, this window
    admission_p99_delta: float = 0.0  # p99 change vs the previous window
    # isolation / QoS attribution: this window's fabric traffic
    # keyed to the tenant's own crossbar ports
    granted_traffic: int = 0    # window grants INTO its placed ports
    masked_requests: int = 0    # window INVALID_DEST packets FROM its ports
    dropped_requests: int = 0   # window non-granted offers FROM its ports

    @property
    def starved(self) -> bool:
        """Wants acceleration, has none."""
        return self.requested > 0 and self.granted == 0

    @property
    def abusive(self) -> bool:
        """Originated masked (isolation-violating) traffic this window."""
        return self.masked_requests > 0


@dataclasses.dataclass(frozen=True)
class Signals:
    """One tick's normalized telemetry — everything a policy may read."""

    tick: int
    epoch: int                              # shell register epoch
    tenants: Tuple[TenantSignals, ...]
    # pool availability
    free_regions: int
    healthy_regions: int
    total_regions: int
    fragmentation: float        # placed modules with a free lower rid / placed
    # fabric traffic (cumulative and per-window)
    port_traffic: Tuple[int, ...] = ()
    port_traffic_delta: Tuple[int, ...] = ()
    offered_packets: int = 0
    granted_packets: int = 0
    drop_rate: float = 0.0      # per-window 1 - granted/offered
    fabric_traces: int = 0
    # isolation attribution: masked / non-granted packets charged to
    # the *originating* source port — cumulative plus per-window deltas
    masked_by_src: Tuple[int, ...] = ()
    dropped_by_src: Tuple[int, ...] = ()
    masked_by_src_delta: Tuple[int, ...] = ()
    dropped_by_src_delta: Tuple[int, ...] = ()
    # per-axis (sharded fabric) traffic: grants that crossed the mesh axis
    # vs. stayed on the source shard's own port block
    remote_traffic: int = 0
    local_traffic: int = 0
    remote_traffic_delta: int = 0
    local_traffic_delta: int = 0
    # ... and the same split per destination port, so policies can rank
    # individual Migrate moves by the ICI traffic they would relocate
    remote_port_traffic: Tuple[int, ...] = ()
    local_port_traffic: Tuple[int, ...] = ()
    remote_port_traffic_delta: Tuple[int, ...] = ()
    local_port_traffic_delta: Tuple[int, ...] = ()
    # fabric plan cache (the steady-state decode fast path): cumulative
    # counters plus per-window deltas — a policy can read hit-rate *and*
    # see reconfiguration churn as invalidation spikes
    plan_cache_hits: int = 0
    plan_cache_misses: int = 0
    plan_cache_invalidations: int = 0
    plan_cache_hits_delta: int = 0
    plan_cache_misses_delta: int = 0
    plan_cache_invalidations_delta: int = 0
    # fault-tolerance
    straggler_score: Mapping[int, float] = dataclasses.field(
        default_factory=dict)

    def tenant(self, name: str) -> Optional[TenantSignals]:
        return next((t for t in self.tenants if t.name == name), None)

    def by_app(self, app_id: int) -> Optional[TenantSignals]:
        return next((t for t in self.tenants if t.app_id == app_id), None)

    @property
    def total_queue_depth(self) -> int:
        return sum(t.queue_depth for t in self.tenants)

    def region_traffic_delta(self, rid: int) -> int:
        """This window's grants into a region's port (0 if unobserved)."""
        port = rid + 1
        if port < len(self.port_traffic_delta):
            return int(self.port_traffic_delta[port])
        return 0

    def region_remote_delta(self, rid: int) -> int:
        """This window's *cross-axis* grants into a region's port (0 if no
        sharded fabric reported a per-port split) — the ICI bytes a
        ``Migrate`` relocating that region's module would move with it."""
        port = rid + 1
        if port < len(self.remote_port_traffic_delta):
            return int(self.remote_port_traffic_delta[port])
        return 0

    @property
    def remote_fraction(self) -> float:
        """This window's cross-axis share of granted traffic (0.0 when no
        sharded fabric reported) — the signal ``TrafficAwareDefrag`` gates
        compaction on: moving modules only pays when traffic actually
        crosses the interconnect."""
        total = self.remote_traffic_delta + self.local_traffic_delta
        return self.remote_traffic_delta / total if total > 0 else 0.0

    def granted_share_ratio(self, name: str,
                            weights: Optional[Mapping[str, float]] = None,
                            ) -> float:
        """A tenant's share of this window's granted fabric traffic divided
        by its WRR weight share — 1.0 means it consumed exactly its
        allocation, > 1.0 means it is over-served, 0.0 when the window is
        quiet or the tenant is unknown.  Only tenants that moved traffic
        this window count toward the weight denominator (an idle tenant's
        unused share is legitimately redistributed by the arbiter)."""
        mover_traffic = {t.name: t.granted_traffic for t in self.tenants
                         if t.granted_traffic > 0}
        total = sum(mover_traffic.values())
        mine = mover_traffic.get(name, 0)
        if total <= 0 or mine <= 0:
            return 0.0
        weights = weights or {}
        wsum = sum(float(weights.get(n, 1.0)) for n in mover_traffic)
        wmine = float(weights.get(name, 1.0))
        if wsum <= 0 or wmine <= 0:
            return 0.0
        return (mine / total) / (wmine / wsum)

    @property
    def plan_cache_hit_rate(self) -> float:
        """This window's fabric plan-cache hit rate (0.0 when no cached
        fabric reported) — near 1.0 in steady state, dipping exactly when
        reconfigurations invalidate (the slow-path/fast-path split made
        visible to policies)."""
        total = self.plan_cache_hits_delta + self.plan_cache_misses_delta
        return self.plan_cache_hits_delta / total if total > 0 else 0.0


# ----------------------------------------------------------------------
# built-in probes
# ----------------------------------------------------------------------
class ServerProbe:
    """Queue/slot/traffic channels from one ``ElasticServer``.

    ``admission_wait`` covers the completions that landed since the last
    ``sample`` (a consumed-index window) — per-window like every other
    normalized signal, and O(new completions) per call no matter how long
    the server has been running.
    """

    name = "server"

    def __init__(self, server):
        self.server = server
        self._completions_seen = 0

    def sample(self) -> Mapping[str, Any]:
        srv = self.server
        depth: Dict[int, int] = {}
        wait: Dict[int, float] = {}
        for req in srv.queue:
            depth[req.app_id] = depth.get(req.app_id, 0) + 1
            wait[req.app_id] = (wait.get(req.app_id, 0.0)
                                + (srv.tick - req.submitted_tick))
        for app, total in wait.items():
            wait[app] = total / depth[app]
        active: Dict[int, int] = {}
        for slot in srv.slots:
            if slot is not None:
                app = slot.request.app_id
                active[app] = active.get(app, 0) + 1
        waits: Dict[int, List[int]] = {}
        fresh = srv.completions[self._completions_seen:]
        self._completions_seen = len(srv.completions)
        for c in fresh:
            if c.submitted_tick < 0:
                continue
            waits.setdefault(c.app_id, []).append(
                c.admitted_tick - c.submitted_tick)
        admission = {app: sum(w) / len(w) for app, w in waits.items()}
        adm_p50 = {app: percentile(w, 50) for app, w in waits.items()}
        adm_p99 = {app: percentile(w, 99) for app, w in waits.items()}
        ch: Dict[str, Any] = {
            "queue_depth": depth,
            "queue_wait": wait,
            "active": active,
            "admission_wait": admission,
            "admission_p50": adm_p50,
            "admission_p99": adm_p99,
            "port_traffic": tuple(int(v) for v in srv.port_traffic),
            "offered_packets": int(srv.offered_packets),
            "granted_packets": int(srv.granted_packets),
            "masked_by_src": tuple(int(v) for v in srv.masked_by_src),
            "dropped_by_src": tuple(int(v) for v in srv.dropped_by_src),
            "fabric_traces": int(srv.fabric.trace_count),
        }
        if getattr(srv.fabric, "plan_cache", None) is not None:
            ch.update(srv.fabric.plan_cache.stats())
        return ch


class StragglerProbe:
    """Straggler scores from ``StragglerStats`` (or via ``TrainLoop``)."""

    name = "straggler"

    def __init__(self, stats):
        self.stats = stats

    def sample(self) -> Mapping[str, Any]:
        return {"straggler_score": self.stats.scores()}


class FabricProbe:
    """Retrace + accounted-traffic channels from a bare ``Fabric``.

    Servers already fold their own fabric's counters in (``ServerProbe``);
    attach this to *directly-driven* fabrics — e.g. the sharded-MoE fabric
    a training loop feeds via ``fabric.account_stats(stats)`` — never to a
    fabric a ``ServerProbe`` is already reporting (the channels would
    double-count)."""

    name = "fabric"

    def __init__(self, fabric):
        self.fabric = fabric

    def sample(self) -> Mapping[str, Any]:
        f = self.fabric
        ch: Dict[str, Any] = {"fabric_traces": int(f.trace_count)}
        if f.offered_packets or f.granted_packets:
            ch["port_traffic"] = tuple(int(v) for v in f.port_traffic)
            ch["offered_packets"] = int(f.offered_packets)
            ch["granted_packets"] = int(f.granted_packets)
            ch["masked_by_src"] = tuple(int(v) for v in f.masked_by_src)
            ch["dropped_by_src"] = tuple(int(v) for v in f.dropped_by_src)
        if f.remote_packets or f.local_packets:
            ch["remote_packets"] = int(f.remote_packets)
            ch["local_packets"] = int(f.local_packets)
            ch["remote_port_traffic"] = tuple(
                int(v) for v in f.remote_port_traffic)
            ch["local_port_traffic"] = tuple(
                int(v) for v in f.local_port_traffic)
        if getattr(f, "plan_cache", None) is not None:
            ch.update(f.plan_cache.stats())
        return ch


# ----------------------------------------------------------------------
# assembly
# ----------------------------------------------------------------------
def _merge_channels(probes: Sequence[Probe]) -> Dict[str, Any]:
    merged: Dict[str, Any] = {}
    for probe in probes:
        for key, value in probe.sample().items():
            if key not in merged:
                merged[key] = (dict(value) if isinstance(value, Mapping)
                               else value)
            elif isinstance(value, Mapping):
                merged[key].update(value)
            elif isinstance(value, (int, float)):
                merged[key] += value
            else:                           # sequences: element-wise sum
                a, b = list(merged[key]), list(value)
                if len(b) > len(a):
                    a, b = b, a
                merged[key] = tuple(x + y for x, y
                                    in zip(a, b + [0] * (len(a) - len(b))))
    return merged


def fragmentation(state: PoolState) -> float:
    """Fraction of placed modules that could compact downward: a free,
    healthy region with a lower rid exists *that the module fits*.
    0.0 == fully packed (no move is actually possible)."""
    free = state.free_regions()
    placed = [(p, t.footprints[i]) for t in state.tenants
              for i, p in enumerate(t.placement) if p != ON_SERVER]
    if not placed or not free:
        return 0.0
    movable = sum(1 for p, fp in placed
                  if any(r.rid < p and fp.fits(r.hbm_bytes) for r in free))
    return movable / len(placed)


def assemble_signals(shell, probes: Sequence[Probe], *, tick: int,
                     prev: Optional[Signals] = None) -> Signals:
    """Fold probe channels + the shell's pool state into one snapshot.

    ``prev`` (the last snapshot) turns cumulative counters into per-window
    deltas and rates; pass ``None`` on the first tick.  The first window is
    the *baseline*: with no ``prev`` the cumulative counters are kept but
    every delta/rate reads 0, so a manager attached to a long-running
    server doesn't see its entire history as one tick-0 demand spike.
    """
    state = shell.state
    ch = _merge_channels(probes)
    depth = ch.get("queue_depth", {})
    wait = ch.get("queue_wait", {})
    active = ch.get("active", {})
    admission = ch.get("admission_wait", {})
    adm_p50 = ch.get("admission_p50", {})
    adm_p99 = ch.get("admission_p99", {})

    def vec_delta(cur, prev_vec):
        # First window (prev is None): the current sample IS the baseline,
        # so deltas are zero — not the whole cumulative history.
        if prev is None:
            return (0,) * len(cur)
        return tuple(v - (prev_vec[i] if i < len(prev_vec) else 0)
                     for i, v in enumerate(cur))

    def scalar_delta(cur, prev_val):
        return 0 if prev is None else cur - prev_val

    traffic = tuple(int(v) for v in ch.get("port_traffic", ()))
    delta = vec_delta(traffic, prev.port_traffic if prev is not None else ())
    masked_src = tuple(int(v) for v in ch.get("masked_by_src", ()))
    dropped_src = tuple(int(v) for v in ch.get("dropped_by_src", ()))
    masked_src_delta = vec_delta(
        masked_src, prev.masked_by_src if prev is not None else ())
    dropped_src_delta = vec_delta(
        dropped_src, prev.dropped_by_src if prev is not None else ())

    def over_ports(vec, ports):
        return int(sum(vec[p] for p in ports if p < len(vec)))

    def p99_delta(t, cur_p99):
        if prev is None:
            return 0.0
        before = prev.tenant(t.name)
        return cur_p99 - (before.admission_p99 if before is not None else 0.0)

    tenants = tuple(
        TenantSignals(
            name=t.name, app_id=t.app_id,
            requested=len(t.footprints), granted=t.placed_count,
            queue_depth=int(depth.get(t.app_id, 0)),
            active=int(active.get(t.app_id, 0)),
            queue_wait=float(wait.get(t.app_id, 0.0)),
            admission_wait=float(admission.get(t.app_id, 0.0)),
            admission_p50=float(adm_p50.get(t.app_id, 0.0)),
            admission_p99=float(adm_p99.get(t.app_id, 0.0)),
            admission_p99_delta=p99_delta(
                t, float(adm_p99.get(t.app_id, 0.0))),
            granted_traffic=over_ports(delta, t.placed_ports),
            masked_requests=over_ports(masked_src_delta, t.placed_ports),
            dropped_requests=over_ports(dropped_src_delta, t.placed_ports))
        for t in sorted(state.tenants, key=lambda t: t.name))
    remote_ports = tuple(int(v) for v in ch.get("remote_port_traffic", ()))
    local_ports = tuple(int(v) for v in ch.get("local_port_traffic", ()))
    remote_ports_delta = vec_delta(
        remote_ports, prev.remote_port_traffic if prev is not None else ())
    local_ports_delta = vec_delta(
        local_ports, prev.local_port_traffic if prev is not None else ())
    offered = int(ch.get("offered_packets", 0))
    granted = int(ch.get("granted_packets", 0))
    d_off = scalar_delta(offered, prev.offered_packets if prev else 0)
    d_grant = scalar_delta(granted, prev.granted_packets if prev else 0)
    drop_rate = 1.0 - d_grant / d_off if d_off > 0 else 0.0
    remote = int(ch.get("remote_packets", 0))
    local = int(ch.get("local_packets", 0))
    d_remote = scalar_delta(remote, prev.remote_traffic if prev else 0)
    d_local = scalar_delta(local, prev.local_traffic if prev else 0)
    pc_hits = int(ch.get("plan_cache_hits", 0))
    pc_misses = int(ch.get("plan_cache_misses", 0))
    pc_inval = int(ch.get("plan_cache_invalidations", 0))
    d_pc_hits = scalar_delta(pc_hits, prev.plan_cache_hits if prev else 0)
    d_pc_misses = scalar_delta(pc_misses,
                               prev.plan_cache_misses if prev else 0)
    d_pc_inval = scalar_delta(pc_inval,
                              prev.plan_cache_invalidations if prev else 0)

    healthy = [r for r in state.regions if r.healthy]
    return Signals(
        tick=tick, epoch=shell.epoch, tenants=tenants,
        free_regions=len(state.free_regions()),
        healthy_regions=len(healthy),
        total_regions=len(state.regions),
        fragmentation=fragmentation(state),
        port_traffic=traffic, port_traffic_delta=delta,
        offered_packets=offered, granted_packets=granted,
        drop_rate=drop_rate,
        fabric_traces=int(ch.get("fabric_traces", 0)),
        masked_by_src=masked_src, dropped_by_src=dropped_src,
        masked_by_src_delta=masked_src_delta,
        dropped_by_src_delta=dropped_src_delta,
        remote_traffic=remote, local_traffic=local,
        remote_traffic_delta=d_remote, local_traffic_delta=d_local,
        remote_port_traffic=remote_ports, local_port_traffic=local_ports,
        remote_port_traffic_delta=remote_ports_delta,
        local_port_traffic_delta=local_ports_delta,
        plan_cache_hits=pc_hits, plan_cache_misses=pc_misses,
        plan_cache_invalidations=pc_inval,
        plan_cache_hits_delta=d_pc_hits,
        plan_cache_misses_delta=d_pc_misses,
        plan_cache_invalidations_delta=d_pc_inval,
        straggler_score=dict(ch.get("straggler_score", {})))
