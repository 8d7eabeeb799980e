"""Deterministic scenario harness — workload + server(s) + manager, one
clock.

The acceptance story for a resource manager is a *trajectory*, not a unit
test: under a seeded workload, does the closed loop grow what is loaded,
shrink what is idle, defragment from traffic, and never flap?  This module
steps the three layers together on one tick clock:

    workload (seeded rng) --> ElasticServer.submit / Submit / Release /
                              FailRegion / HealRegion
    server.step()         --> decode + fabric traffic under live registers
    manager.step()        --> Signals -> policy -> Grow/Shrink/Migrate

and records a machine-readable per-tick trace.  Everything is derived from
``numpy.random.default_rng(seed)`` — same seed, same trace — which is what
makes the properties (no flapping, no starvation, bounded queues, zero
forecastable SLO violations) and the trajectory stable across runs, and
what lets the port's trace be held row for row against the JAX
package's.

The scenario layer never posts scaling events: ``Submit``/``Release`` are
tenant *arrivals and departures* (workload), ``FailRegion``/``HealRegion``
are *environment faults*; every ``Grow``/``Shrink``/``Migrate`` in the
resulting shell log was decided by the manager from telemetry alone.

Scenario kinds:

- ``bursty``        — stable roster, bursty request arrivals per tenant.
- ``diurnal``       — sinusoidal arrival rate (day/night ramps).
- ``churn``         — bursty arrivals plus tenants joining and leaving
  mid-run (the acceptance scenario).
- ``failure_storm`` — steady load while regions fail and heal randomly.
- ``production``    — hundreds of tenants, Pareto heavy-tailed request
  schedule (reusing ``repro_torch.serve.heavy_tailed_arrivals``), per-tenant
  SLOs, and optionally several servers sharing one shell
  (``n_servers > 1`` builds a ``ServerPool``).
- ``adversarial``   — honest tenants on a *pre-materialized* schedule
  plus hostile tenants driven by ``repro_torch.manager.adversary`` attackers
  acting through ordinary tenant entry points.  The honest schedule is
  drawn from its own rng stream, so ``attackers=()`` yields a quiet twin
  with a byte-identical honest workload — the paired baseline the
  isolation properties compare against.

Every applied workload action can be **recorded** (``record_path=`` writes
one JSONL row per action in exact applied order) and **replayed**
(``run_scenario(RecordedWorkload.load(path), policy=...)`` applies the
rows verbatim, bypassing the rng) — the replayed trace is bit-identical to
the recorded run's.

The fabric runs on ``fabric_backend`` on ``device`` (the card unless
``"cpu"`` is asked for): on ``"cuda"`` every uncached plan of every
server tick and every attacker spray is one launch of the crossbar's
plan kernel.  The trace is integer arithmetic on plans, so it is the
same on every backend and device.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from repro_torch.core.module import ModuleFootprint
from repro_torch.manager.adversary import (AttackView, FailAction,
                                           RequestAction, SprayAction,
                                           get_attacker)
from repro_torch.manager.manager import Decision, Manager
from repro_torch.manager.policies import (FairShare, Hysteresis, PolicyChain,
                                          TrafficAwareDefrag)
from repro_torch.manager.slo import (PredictiveSLO, SLOTarget,
                                     forecastable_violations, slo_violations)
from repro_torch.shell import events as ev
from repro_torch.shell.server import ElasticServer, ServerPool, StreamRequest
from repro_torch.shell.shell import Shell

GB = 1 << 30

# The scenario-wide QoS budget: p99 submit->admit within 4 ticks, at most
# half of a window's offered packets dropped.  Tenants can override via
# ``TenantSpec.slo`` (threaded through ``Submit`` onto ``TenantEntry``).
DEFAULT_SLO = SLOTarget(admission_p99_ticks=4.0, drop_rate=0.5)


class SyntheticEngine:
    """Deterministic token arithmetic (no model, no device): prefill returns
    ``prompt[-1] + 1``, decode increments.  Keeps scenario runs fast and
    reproducible while the *fabric* data plane stays real."""

    def prefill(self, prompt):
        return int(prompt[-1]) + 1, None

    def decode(self, tok, state):
        return tok + 1, state


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's lifecycle inside a scenario."""

    name: str
    app_id: int
    modules: int
    module_gb: int = 4
    arrive: int = 0
    depart: Optional[int] = None
    slo: Optional[SLOTarget] = None

    def footprints(self) -> Tuple[ModuleFootprint, ...]:
        return tuple(ModuleFootprint(param_bytes=self.module_gb * GB,
                                     flops_per_token=1e9,
                                     activation_bytes_per_token=4096)
                     for _ in range(self.modules))


# (tick, rng) -> requests per live app this tick
ArrivalFn = Callable[[int, np.random.Generator, Sequence[TenantSpec]],
                     Dict[int, int]]

# Pre-materialized request schedule: tick -> [(app_id, prompt_tokens,
# max_new), ...] in submission order.  Production scenarios build one from
# ``repro_torch.serve.heavy_tailed_arrivals`` instead of per-tick rng draws.
Schedule = Dict[int, List[Tuple[int, List[int], int]]]


@dataclasses.dataclass
class ScenarioSpec:
    kind: str
    tenants: Tuple[TenantSpec, ...]
    arrivals: Optional[ArrivalFn] = None
    fault_rate: float = 0.0         # per-tick P(fail a random healthy region)
    heal_after: int = 6             # ticks until a storm-failed region heals
    schedule: Optional[Schedule] = None   # overrides ``arrivals`` when set
    default_slo: Optional[SLOTarget] = None
    # Grant-coupled service rate (ElasticServer.slots_per_region): regions
    # buy concurrency, so Grow/Shrink change how fast a tenant drains its
    # queue — the coupling SLO scenarios need.  ``None`` keeps the original
    # uncoupled admission.
    slots_per_region: Optional[int] = None
    # Hostile tenants: (tenant_name, attacker_kind) pairs resolved through
    # ``repro_torch.manager.adversary.get_attacker`` and stepped every
    # generative tick.  The named tenants must appear in ``tenants`` —
    # attackers act only through the tenant entry points of a real roster
    # member.
    attackers: Tuple[Tuple[str, str], ...] = ()


def _bursty_arrivals(p: float = 0.25, lo: int = 2, hi: int = 6) -> ArrivalFn:
    def fn(tick, rng, live):
        out = {}
        for spec in live:
            if rng.random() < p:
                out[spec.app_id] = int(rng.integers(lo, hi))
        return out
    return fn


def _diurnal_arrivals(peak: float = 1.5, period: int = 32) -> ArrivalFn:
    """Half-wave rectified sine: a busy half-period that ramps to ``peak``
    arrivals/tick, then a genuinely silent half-period.  The quiet valley
    is what makes the shape interesting for elasticity — reactive policies
    shrink into it and then lag the next morning's ramp; predictive ones
    must re-grow *ahead* of it."""
    def fn(tick, rng, live):
        rate = peak * max(0.0, math.sin(2 * math.pi * tick / period))
        out = {}
        for spec in live:
            n = int(rng.poisson(rate))
            if n:
                out[spec.app_id] = n
        return out
    return fn


def _roster(churn: bool, ticks: int) -> Tuple[TenantSpec, ...]:
    base = (TenantSpec("alpha", app_id=0, modules=2, slo=DEFAULT_SLO),
            TenantSpec("beta", app_id=1, modules=3, slo=DEFAULT_SLO))
    if not churn:
        return base
    third = ticks // 3
    return base + (
        TenantSpec("gamma", app_id=2, modules=2, arrive=third,
                   depart=2 * third, slo=DEFAULT_SLO),
        TenantSpec("delta", app_id=3, modules=1, arrive=third + 4,
                   slo=DEFAULT_SLO))


def _production_roster(n_tenants: int, ticks: int) -> Tuple[TenantSpec, ...]:
    """Hundreds of small tenants: staggered arrivals over the first
    quarter, a departing tail, 1-2 modules each, all carrying the default
    SLO budget."""
    ramp = max(1, ticks // 4)
    out = []
    for i in range(n_tenants):
        depart = None
        if i % 7 == 6:                    # every 7th tenant leaves mid-run
            depart = (2 * ticks) // 3 + (i % 5)
        out.append(TenantSpec(
            name=f"t{i:04d}", app_id=i, modules=1 + (i % 2),
            module_gb=4, arrive=(i * ramp) // max(1, n_tenants),
            depart=depart, slo=DEFAULT_SLO))
    return tuple(out)


def _production_schedule(tenants: Sequence[TenantSpec], *, ticks: int,
                         seed: int) -> Schedule:
    """Heavy-tailed request schedule reusing the serving layer's Pareto
    arrival generator: a few giant bursts, long quiet stretches — bucketed
    per tick, clipped to the run length, and clipped to each tenant's
    live window (a request for a tenant that has not arrived yet — or has
    already departed — would have no engine to land on)."""
    from repro_torch.serve.harness import heavy_tailed_arrivals

    window = {t.app_id: (t.arrive, ticks if t.depart is None else t.depart)
              for t in tenants}
    apps = tuple(t.app_id for t in tenants)
    n_streams = max(len(apps) * 3, ticks * 4)
    streams = heavy_tailed_arrivals(
        n_streams, seed=seed, apps=apps,
        mean_gap_ticks=max(ticks / (n_streams * 1.25), 1e-3),
        prompt_len=(1, 4), max_new=(2, 6))
    schedule: Schedule = {}
    for s in streams:
        arrive, gone = window[int(s.app_id)]
        if not (arrive <= s.tick < min(int(ticks), gone)):
            continue
        schedule.setdefault(int(s.tick), []).append(
            (int(s.app_id), [int(t) for t in s.prompt], int(s.max_new)))
    return schedule


def _adversarial_schedule(tenants: Sequence[TenantSpec], *, ticks: int,
                          seed: int) -> Schedule:
    """Bursty honest workload, pre-materialized from its *own* rng stream.

    The adversarial scenario's honest traffic must not depend on whether
    attackers run (attackers consume the scenario rng), so the schedule is
    drawn up front from ``default_rng([seed, 0xAD])`` — the attack run and
    its quiet twin (``attackers=()``) submit byte-identical honest
    requests on identical ticks."""
    rng = np.random.default_rng([seed, 0xAD])
    schedule: Schedule = {}
    for tick in range(ticks):
        for t in tenants:
            if rng.random() < 0.3:
                for _ in range(int(rng.integers(1, 4))):
                    schedule.setdefault(tick, []).append(
                        (t.app_id, [int(rng.integers(0, 64))],
                         int(rng.integers(2, 6))))
    return schedule


# The default hostile mix: one bandwidth hog and one masked-request sprayer.
DEFAULT_ATTACK_MIX = ("noisy_neighbor", "dest_sprayer")


def build_spec(kind: str, *, ticks: int, seed: int = 0,
               n_tenants: int = 200,
               slots_per_region: Optional[int] = None,
               attackers: Optional[Sequence[str]] = None) -> ScenarioSpec:
    """Materialize a named scenario.  ``slots_per_region`` opts any kind
    into grant-coupled service rate (``production`` defaults to 2 — its
    SLO comparisons are only meaningful when grants buy throughput)."""
    if kind == "bursty":
        return ScenarioSpec(kind, _roster(False, ticks), _bursty_arrivals(),
                            default_slo=DEFAULT_SLO,
                            slots_per_region=slots_per_region)
    if kind == "diurnal":
        return ScenarioSpec(kind, _roster(False, ticks),
                            _diurnal_arrivals(), default_slo=DEFAULT_SLO,
                            slots_per_region=slots_per_region)
    if kind == "churn":
        return ScenarioSpec(kind, _roster(True, ticks), _bursty_arrivals(),
                            default_slo=DEFAULT_SLO,
                            slots_per_region=slots_per_region)
    if kind == "failure_storm":
        return ScenarioSpec(kind, _roster(False, ticks),
                            _bursty_arrivals(p=0.5, lo=1, hi=4),
                            fault_rate=0.08, default_slo=DEFAULT_SLO,
                            slots_per_region=slots_per_region)
    if kind == "production":
        tenants = _production_roster(n_tenants, ticks)
        return ScenarioSpec(kind, tenants,
                            schedule=_production_schedule(
                                tenants, ticks=ticks, seed=seed),
                            default_slo=DEFAULT_SLO,
                            slots_per_region=(2 if slots_per_region is None
                                              else slots_per_region))
    if kind == "adversarial":
        honest = _roster(False, ticks)
        mix = tuple(DEFAULT_ATTACK_MIX if attackers is None else attackers)
        mal = tuple(TenantSpec(f"mal{i}_{k}", app_id=10 + i, modules=1,
                               slo=DEFAULT_SLO)
                    for i, k in enumerate(mix))
        return ScenarioSpec(
            kind, honest + mal,
            schedule=_adversarial_schedule(honest, ticks=ticks, seed=seed),
            default_slo=DEFAULT_SLO,
            attackers=tuple((t.name, k) for t, k in zip(mal, mix)),
            slots_per_region=(2 if slots_per_region is None
                              else slots_per_region))
    raise ValueError(f"unknown scenario kind {kind!r}; "
                     f"known: {sorted(SCENARIO_KINDS)}")


SCENARIO_KINDS = ("bursty", "diurnal", "churn", "failure_storm",
                  "production", "adversarial")


# ----------------------------------------------------------------------
# record / replay
# ----------------------------------------------------------------------
class RecordedWorkload:
    """A scenario's applied workload actions, one JSONL row each.

    The first row is ``{"op": "meta", ...}`` carrying the run's shape
    (kind, seed, ticks, pool geometry, interval, n_servers); every later
    row is one applied action — ``submit`` / ``release`` / ``fail`` /
    ``heal`` / ``request`` — stamped with its tick, in the exact order the
    generative run applied it.  ``run_scenario(RecordedWorkload.load(p),
    policy=...)`` replays the rows verbatim (the rng is never consulted),
    so the replayed trace is bit-identical to the recorded one.
    """

    def __init__(self, meta: Mapping, rows: Sequence[Mapping]):
        self.meta = dict(meta)
        self.rows = [dict(r) for r in rows]
        self.by_tick: Dict[int, List[dict]] = {}
        for r in self.rows:
            self.by_tick.setdefault(int(r["tick"]), []).append(r)

    @property
    def kind(self) -> str:
        return self.meta.get("kind", "replay")

    @classmethod
    def load(cls, path) -> "RecordedWorkload":
        meta: Optional[dict] = None
        rows: List[dict] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                if d.get("op") == "meta":
                    meta = d
                else:
                    rows.append(d)
        if meta is None:
            raise ValueError(f"{path}: no meta row — not a recorded "
                             f"workload")
        return cls(meta, rows)

    def dump(self, path) -> None:
        with open(path, "w") as f:
            f.write(json.dumps(self.meta, sort_keys=True) + "\n")
            for r in self.rows:
                f.write(json.dumps(r, sort_keys=True) + "\n")


@dataclasses.dataclass
class ScenarioResult:
    """Machine-readable outcome of one seeded run."""

    kind: str
    seed: int
    ticks: int
    trace: List[dict]
    decisions: List[Decision]
    completions: int
    event_counts: Dict[str, int]            # manager-applied events
    rejected_events: int
    max_queue: int
    fabric_retraces: int
    final_utilization: float
    # live objects for post-run inspection (not serialized)
    shell: Shell = dataclasses.field(repr=False, default=None)
    server: Union[ElasticServer, ServerPool, None] = dataclasses.field(
        repr=False, default=None)
    n_servers: int = 1
    slo_violations: int = 0                 # (tenant, kind) pairs, summed
    slo_violation_ticks: int = 0            # decision ticks with >= 1
    forecastable: Tuple[Tuple[int, str, str], ...] = ()

    def summary(self) -> dict:
        return {
            "scenario": self.kind, "seed": self.seed, "ticks": self.ticks,
            "completions": self.completions,
            "max_queue": self.max_queue,
            "rejected_events": self.rejected_events,
            "fabric_retraces": self.fabric_retraces,
            "final_utilization": round(self.final_utilization, 3),
            "n_servers": self.n_servers,
            "slo_violations": self.slo_violations,
            "slo_violation_ticks": self.slo_violation_ticks,
            "forecastable_violations": len(self.forecastable),
            **{f"n_{k.lower()}": v
               for k, v in sorted(self.event_counts.items())},
        }

    def to_json(self) -> dict:
        return {"schema": 1, **self.summary(), "trace": self.trace}


def default_policy():
    """The acceptance loop: hysteresis sizing + traffic-aware placement,
    with shrink victims chosen by coldest-port traffic."""
    defrag = TrafficAwareDefrag(max_moves=1)
    return PolicyChain([
        Hysteresis(victim_selector=TrafficAwareDefrag.coldest_regions),
        defrag,
    ])


def predictive_policy(*, forecaster="ewma", horizon: int = 4,
                      service_per_region: float = 2.0,
                      default_slo: Optional[SLOTarget] = None):
    """The predictive loop: SLO-driven forecast sizing + the same
    traffic-aware placement hygiene the reactive chain carries."""
    return PolicyChain([
        PredictiveSLO(forecaster=forecaster, horizon=horizon,
                      service_per_region=service_per_region,
                      default_slo=(default_slo if default_slo is not None
                                   else DEFAULT_SLO),
                      victim_selector=TrafficAwareDefrag.coldest_regions),
        TrafficAwareDefrag(max_moves=1),
    ])


def adversarial_policy(*, abuse_penalty: float = 1.0):
    """The abuse-aware loop: weighted fair sharing that down-weights
    tenants originating masked traffic, plus placement hygiene that ranks
    abuser modules first for disruption — the manager-level response the
    isolation bench measures on top of the fabric's structural masking."""
    return PolicyChain([
        FairShare(abuse_penalty=abuse_penalty,
                  victim_selector=TrafficAwareDefrag.coldest_regions),
        TrafficAwareDefrag(max_moves=1, abuse_penalty=abuse_penalty),
    ])


def _audit_params(policy, interval: int) -> Tuple[int, int]:
    """(horizon, min_history) in *ticks* for the forecastable-violation
    audit, read off a PredictiveSLO in the chain when present (its units
    are decision samples, one per ``interval`` ticks)."""
    for member in getattr(policy, "policies", None) or [policy]:
        if hasattr(member, "horizon") and hasattr(member, "min_history"):
            return (int(member.horizon) * interval,
                    int(member.min_history) * interval)
    return 6 * interval, 3 * interval


def run_scenario(kind: Union[str, ScenarioSpec, RecordedWorkload], *,
                 seed: int = 0, ticks: int = 60, n_regions: int = 6,
                 n_slots: int = 4, hbm_gb: int = 16, policy=None,
                 interval: int = 2, trace_path: Optional[Path] = None,
                 n_servers: int = 1, trackers: Sequence = (),
                 record_path: Optional[Path] = None,
                 fabric_backend: str = "reference",
                 device=None) -> ScenarioResult:
    """Run one seeded closed-loop scenario; returns its trace + summary.

    ``kind`` is a scenario name, an explicit :class:`ScenarioSpec`, or a
    :class:`RecordedWorkload` — the latter *replays* the recorded actions
    verbatim (seed/ticks/geometry come from its meta row; only ``policy``,
    ``trackers`` and output paths apply) and reproduces the original trace
    bit-for-bit.  ``n_servers > 1`` runs a ``ServerPool``: several serving
    frontends over one shell, apps pinned ``app_id % n_servers``, their
    probes merged into one ``Signals``.  ``record_path`` writes the
    applied workload as JSONL for later replay.  ``fabric_backend`` and
    ``device`` (the card when ``None``) go to every server's fabric.
    """
    from repro_torch.core.elastic import Region

    workload: Optional[RecordedWorkload] = None
    if isinstance(kind, RecordedWorkload):
        workload = kind
        meta = workload.meta
        seed = int(meta["seed"])
        ticks = int(meta["ticks"])
        n_regions = int(meta["n_regions"])
        n_slots = int(meta["n_slots"])
        hbm_gb = int(meta["hbm_gb"])
        interval = int(meta["interval"])
        n_servers = int(meta["n_servers"])
        spr = meta.get("slots_per_region")
        spec = ScenarioSpec(workload.kind, (),
                            default_slo=SLOTarget.from_json(
                                meta.get("default_slo")),
                            slots_per_region=(None if spr is None
                                              else int(spr)))
    elif isinstance(kind, str):
        spec = build_spec(kind, ticks=ticks, seed=seed)
    else:
        spec = kind

    rng = np.random.default_rng(seed)
    shell = Shell([Region(rid=i, n_chips=16, hbm_bytes=hbm_gb * GB)
                   for i in range(n_regions)], policy="first_fit")
    if n_servers > 1:
        frontend: Union[ElasticServer, ServerPool] = ServerPool(
            shell, n_servers, n_slots=n_slots,
            slots_per_region=spec.slots_per_region,
            fabric_backend=fabric_backend, device=device)
        probes = frontend.probes()
    else:
        frontend = ElasticServer(shell, n_slots=n_slots,
                                 slots_per_region=spec.slots_per_region,
                                 fabric_backend=fabric_backend,
                                 device=device)
        probes = [frontend.probe()]
    policy = policy or default_policy()
    manager = Manager(shell, policy, probes=probes, interval=interval,
                      trackers=trackers)
    default_slo = spec.default_slo

    live: Dict[str, TenantSpec] = {}
    attackers = {name: get_attacker(k) for name, k in spec.attackers}
    storm_heal: Dict[int, int] = {}         # rid -> heal tick
    trace: List[dict] = []
    recorded: List[dict] = []

    def apply_submit(tick, name, app_id, modules, module_gb, slo):
        shell.post(ev.Submit(
            tenant=name,
            footprints=tuple(ModuleFootprint(
                param_bytes=module_gb * GB, flops_per_token=1e9,
                activation_bytes_per_token=4096)
                for _ in range(modules)),
            app_id=app_id, slo=slo))
        frontend.register_engine(app_id, SyntheticEngine())
        recorded.append({"op": "submit", "tick": tick, "tenant": name,
                         "app_id": app_id, "modules": modules,
                         "module_gb": module_gb,
                         "slo": slo.to_json() if slo is not None else None})

    def apply_release(tick, name, app_id):
        shell.post(ev.Release(tenant=name))
        frontend.drop_queued(app_id)
        recorded.append({"op": "release", "tick": tick, "tenant": name,
                         "app_id": app_id})

    def apply_fault(tick, op, rid):
        shell.post(ev.FailRegion(rid=rid) if op == "fail"
                   else ev.HealRegion(rid=rid))
        recorded.append({"op": op, "tick": tick, "rid": rid})

    def apply_request(tick, app_id, prompt, max_new):
        frontend.submit(StreamRequest(
            app_id=app_id, prompt=np.asarray(prompt, np.int32),
            max_new=max_new))
        recorded.append({"op": "request", "tick": tick, "app_id": app_id,
                         "prompt": list(prompt), "max_new": max_new})

    def apply_spray(tick, app_id, dsts):
        # Raw packets offered from the tenant's own placed port — the
        # attacker's data-plane entry point.  Unplaced tenants have no
        # port to offer from, so the spray silently evaporates (and is
        # not recorded: replay applies only what actually happened).
        # Offers are chunked to the server's ``n_slots`` shape (padded
        # with -1) so hostile traffic reuses the plan signature the
        # honest path runs — ``fabric_traces`` stays 1 under attack
        # because the attacker shares the victim's data path.
        t = shell.state.tenant_by_app(app_id)
        if t is None or not t.placed_ports:
            return
        fab = (frontend.servers[app_id % n_servers].fabric
               if n_servers > 1 else frontend.fabric)
        src_port = t.placed_ports[0]
        for i in range(0, len(dsts), n_slots):
            chunk = list(dsts[i:i + n_slots])
            chunk += [-1] * (n_slots - len(chunk))
            dst = np.asarray(chunk, np.int32)
            src = np.full(dst.shape, src_port, np.int32)
            plan = fab.plan(dst, src)
            fab.account(plan, src)
        recorded.append({"op": "spray", "tick": tick, "app_id": app_id,
                         "dsts": [int(d) for d in dsts]})

    for tick in range(ticks):
        if workload is not None:
            # -- replay: apply the recorded rows verbatim, in order ------
            for row in workload.by_tick.get(tick, ()):
                op = row["op"]
                if op == "submit":
                    apply_submit(tick, row["tenant"], int(row["app_id"]),
                                 int(row["modules"]), int(row["module_gb"]),
                                 SLOTarget.from_json(row.get("slo")))
                elif op == "release":
                    apply_release(tick, row["tenant"], int(row["app_id"]))
                elif op in ("fail", "heal"):
                    apply_fault(tick, op, int(row["rid"]))
                elif op == "request":
                    apply_request(tick, int(row["app_id"]),
                                  [int(t) for t in row["prompt"]],
                                  int(row["max_new"]))
                elif op == "spray":
                    apply_spray(tick, int(row["app_id"]),
                                [int(d) for d in row["dsts"]])
                else:
                    raise ValueError(f"unknown recorded op {op!r}")
        else:
            # -- workload: tenant lifecycle (arrivals/departures only) ---
            for t in spec.tenants:
                if t.arrive == tick:
                    apply_submit(tick, t.name, t.app_id, t.modules,
                                 t.module_gb, t.slo)
                    live[t.name] = t
                if t.depart == tick and t.name in live:
                    apply_release(tick, t.name, t.app_id)
                    del live[t.name]

            # -- environment: fault storm -------------------------------
            for rid, heal_at in list(storm_heal.items()):
                if tick >= heal_at:
                    apply_fault(tick, "heal", rid)
                    del storm_heal[rid]
            if spec.fault_rate and rng.random() < spec.fault_rate:
                healthy = [r.rid for r in shell.state.regions
                           if r.healthy and r.rid not in storm_heal]
                if healthy:
                    rid = int(rng.choice(healthy))
                    apply_fault(tick, "fail", rid)
                    storm_heal[rid] = tick + spec.heal_after + int(
                        rng.integers(0, 4))

            # -- workload: request arrivals -----------------------------
            if spec.schedule is not None:
                for app_id, prompt, max_new in spec.schedule.get(tick, ()):
                    apply_request(tick, app_id, prompt, max_new)
            else:
                due = spec.arrivals(tick, rng, list(live.values()))
                for app_id, n in sorted(due.items()):
                    for _ in range(n):
                        apply_request(
                            tick, app_id,
                            [int(rng.integers(0, 64))],
                            int(rng.integers(2, 6)))

            # -- adversaries: hostile tenants act through the ordinary
            # tenant entry points (requests, raw offers, region faults) —
            # whatever they break, a real tenant could have broken
            for name, attacker in attackers.items():
                t = shell.state.find_tenant(name)
                if t is None:
                    continue
                masked_vec = frontend.masked_by_src
                dropped_vec = frontend.dropped_by_src
                view = AttackView(
                    tick=tick, app_id=t.app_id, name=name,
                    host_port=shell.state.host_port,
                    my_ports=t.placed_ports,
                    n_ports=shell.state.n_ports,
                    capacity=int(shell.capacity),
                    healthy_rids=tuple(r.rid for r in shell.state.regions
                                       if r.healthy),
                    utilization=shell.utilization(),
                    my_masked=int(sum(masked_vec[p] for p in t.placed_ports
                                      if p < len(masked_vec))),
                    my_dropped=int(sum(dropped_vec[p] for p in t.placed_ports
                                       if p < len(dropped_vec))))
                for action in attacker.step(view, rng):
                    if isinstance(action, RequestAction):
                        apply_request(tick, t.app_id, [int(action.prompt)],
                                      int(action.max_new))
                    elif isinstance(action, SprayAction):
                        apply_spray(tick, t.app_id,
                                    [int(d) for d in action.dsts])
                    elif isinstance(action, FailAction):
                        rid = int(action.rid)
                        if (rid not in storm_heal
                                and any(r.rid == rid and r.healthy
                                        for r in shell.state.regions)):
                            apply_fault(tick, "fail", rid)
                            storm_heal[rid] = tick + spec.heal_after
                    else:
                        raise TypeError(
                            f"unknown attacker action {action!r}")

        # -- the two loops ---------------------------------------------
        frontend.step()
        decision = manager.step()

        violations: List[List[str]] = []
        if decision is not None:
            violations = [[t, k] for t, k in slo_violations(
                decision.signals, shell.state, default_slo)]
        retraces = (frontend.fabric_traces if n_servers > 1
                    else int(frontend.fabric.trace_count))
        trace.append({
            "tick": tick,
            "queued": frontend.queued_count,
            "active": frontend.active_count,
            "free_regions": len(shell.state.free_regions()),
            "utilization": round(shell.utilization(), 3),
            "events": list(decision.kinds()) if decision else [],
            "rejected": len(decision.rejected) if decision else 0,
            "port_traffic": [int(v) for v in frontend.port_traffic],
            "dropped": int(frontend.offered_packets
                           - frontend.granted_packets),
            "masked_by_src": [int(v) for v in frontend.masked_by_src],
            "dropped_by_src": [int(v) for v in frontend.dropped_by_src],
            "fabric_traces": retraces,
            "violations": violations,
            "tenants": {t.name: [t.placed_count, len(t.footprints)]
                        for t in sorted(shell.state.tenants,
                                        key=lambda t: t.name)},
        })

    audit_horizon, audit_history = _audit_params(manager.policy, interval)
    forecastable = forecastable_violations(
        trace, horizon=audit_horizon, min_history=audit_history)
    violation_rows = [r for r in trace if r["violations"]]
    result = ScenarioResult(
        kind=spec.kind, seed=seed, ticks=ticks, trace=trace,
        decisions=list(manager.decisions),
        completions=len(frontend.completions),
        event_counts=manager.event_counts(),
        rejected_events=sum(len(d.rejected) for d in manager.decisions),
        max_queue=max((row["queued"] for row in trace), default=0),
        fabric_retraces=(frontend.fabric_traces if n_servers > 1
                         else int(frontend.fabric.trace_count)),
        final_utilization=shell.utilization(),
        shell=shell, server=frontend, n_servers=n_servers,
        slo_violations=sum(len(r["violations"]) for r in trace),
        slo_violation_ticks=len(violation_rows),
        forecastable=forecastable)
    if record_path is not None:
        meta = {"op": "meta", "schema": 1, "kind": spec.kind, "seed": seed,
                "ticks": ticks, "n_regions": n_regions, "n_slots": n_slots,
                "hbm_gb": hbm_gb, "interval": interval,
                "n_servers": n_servers,
                "slots_per_region": spec.slots_per_region,
                "attackers": [list(pair) for pair in spec.attackers],
                "default_slo": (default_slo.to_json()
                                if default_slo is not None else None)}
        RecordedWorkload(meta, recorded).dump(record_path)
    if trace_path is not None:
        Path(trace_path).write_text(
            json.dumps(result.to_json(), indent=1, sort_keys=True))
    return result
