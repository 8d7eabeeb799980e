"""Elastic multi-tenant serving through the port's ``repro_torch.shell``
API (the JAX package's ``examples/elastic_serving.py`` on the port).

The paper's §IV-A lifecycle on the event-driven shell: one ``Shell`` owns
the region pool, the live (delta-patched) register file and the event
log; the heartbeat monitor posts fault events instead of being polled;
and an ``ElasticServer`` serves overlapping multi-tenant request streams
with continuous batching, admission routed by ``app_id`` through the
shell's register file.

Control-plane script: submit A and B -> the resource manager rebalances
them (a ``Manager`` tick reads telemetry and posts the events itself) ->
a region fails via stale heartbeat (module demoted, port held in reset)
-> heal (promoted back) -> A releases.  After every event the
delta-synthesised register file is checked equal to a full rebuild
(``shell.verify``).

    PYTHONPATH=src python -m repro_torch.examples.elastic_serving [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.elastic_serving --steady-state

``--steady-state`` runs the decode fast path instead: a thousand seeded
streams decode through the server's epoch-keyed fabric plan cache
(``repro_torch.fabric.cache``), a mid-run ``FailRegion`` invalidates it,
and the hit/miss/invalidation counters are read back through
``Fabric.probe()``.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.elastic import Region
from repro_torch.core.module import ModuleFootprint
from repro_torch.manager import FairShare, Manager
from repro_torch.runtime.ft import HeartbeatMonitor
from repro_torch.shell import ON_SERVER, Shell, Submit
from repro_torch.shell.server import ElasticServer, StreamRequest

GB = 1 << 30
#: the two tenants' models (app id -> smoke config), as the JAX script's
MODELS = {0: "tinyllama_1_1b", 1: "qwen2_5_3b"}


def show(shell, title, log):
    print(f"\n-- {title}")
    entry = {"title": title, "placements": {}}
    for t in sorted(shell.state.tenants, key=lambda t: t.name):
        pretty = ["host" if p == ON_SERVER else f"R{p}" for p in t.placement]
        entry["placements"][t.name] = pretty
        print(f"   {t.name}: {pretty}")
    regs = shell.registers
    last = shell.log[-1].plan if shell.log else None
    entry["delta"] = last.delta.n_entries if last else None
    delta = f", last delta: {entry['delta']} entries" if last else ""
    entry.update(utilization=shell.utilization(), epoch=shell.epoch,
                 dest=np.asarray(regs.dest).tolist(),
                 reset=np.asarray(regs.reset).astype(int).tolist())
    print(f"   utilization={entry['utilization']:.2f}  "
          f"epoch={entry['epoch']}{delta}")
    print(f"   registers: dest={entry['dest']} reset={entry['reset']}")
    shell.verify()          # delta-patched file == full rebuild, invariants
    log.append(entry)


def _completion(c) -> dict:
    return {"rid": c.rid, "app_id": c.app_id, "entry_port": c.entry_port,
            "admitted_tick": c.admitted_tick,
            "finished_tick": c.finished_tick, "tokens": list(c.tokens)}


def run(device=None, params: Optional[Dict[int, object]] = None) -> dict:
    """The lifecycle on ``device`` (the card unless ``"cpu"``); ``params``
    maps an app id to its model's parameters (the JAX script's, converted
    by ``repro_torch.ckpt.convert``), else each model's seeded ``init``.
    Returns what was printed as a record."""
    params = params or {}
    rec = {"shows": []}
    shell = Shell([Region(rid=i, n_chips=64, hbm_bytes=16 * GB)
                   for i in range(4)], policy="first_fit")
    # Region ids derive live from the shell's pool.
    monitor = HeartbeatMonitor(timeout_s=10.0, shell=shell)

    fp = lambda gb: ModuleFootprint(param_bytes=gb * GB,    # noqa: E731
                                    flops_per_token=2e9,
                                    activation_bytes_per_token=8192)

    shell.post(Submit(tenant="tenant_a", footprints=(fp(4), fp(4), fp(4)),
                      app_id=0))
    shell.post(Submit(tenant="tenant_b", footprints=(fp(2), fp(2)),
                      app_id=1))
    show(shell, "after admission (B partially on-server)", rec["shows"])

    # --- data plane: both tenants stream requests through one server.
    server = ElasticServer(shell, n_slots=2, device=device)
    for app, arch in MODELS.items():
        server.register_model(app, get_config(arch, smoke=True), max_len=64,
                              params=params.get(app))
    for start, max_new in ((2, 4), (5, 6)):
        server.submit(StreamRequest(app_id=1,
                                    prompt=np.arange(start, dtype=np.int32),
                                    max_new=max_new))
    server.step()           # both admitted, decoding begins
    rec["serving"] = (server.active_count, server.queued_count, server.tick)
    print(f"\n   serving: {server.active_count} active, "
          f"{server.queued_count} queued (tick {server.tick})")

    # Continuous batching: tenant A's stream arrives mid-decode and is
    # admitted as soon as a slot rotates, with no wave barrier.
    server.submit(StreamRequest(app_id=0,
                                prompt=np.arange(3, dtype=np.int32),
                                max_new=3))
    server.submit(StreamRequest(app_id=1,
                                prompt=np.arange(4, dtype=np.int32),
                                max_new=2))
    comps = server.run()
    print("   completions (rid, app, entry_port, admitted->finished tick):")
    rec["completions"] = []
    for c in sorted(comps, key=lambda c: c.rid):
        rec["completions"].append(_completion(c))
        print(f"     #{c.rid} app{c.app_id} port{c.entry_port} "
              f"t{c.admitted_tick}->t{c.finished_tick}  tokens={c.tokens}")
    rec["overlapped"] = len([c for c in comps if 0 < c.admitted_tick])
    print(f"   {rec['overlapped']} request(s) admitted while earlier "
          f"requests were still decoding")
    # Every tick's slot->port packets were planned through the server's
    # shell-bound fabric under the live register file.
    rec["port_traffic"] = server.port_traffic.tolist()
    rec["fabric_traces"] = server.fabric.trace_count
    print(f"   per-port fabric grants: {rec['port_traffic']}  "
          f"(fabric retraces: {rec['fabric_traces']})")

    # --- elasticity, closed-loop: the manager samples telemetry and
    # FairShare computes the weighted max-min allocation: 4 healthy
    # regions, A requests 3, B requests 2 -> 2 + 2, so the manager posts
    # Shrink(A, 2) and Grow(B, 2) itself.
    manager = Manager(shell, policy=FairShare(), probes=[server.probe()])
    decision = manager.tick()
    rec["decision"] = {
        "kinds": list(decision.kinds()),
        "free": decision.signals.free_regions,
        "tenants": [(t.name, t.requested, t.granted)
                    for t in decision.signals.tenants]}
    print(f"\n   manager decided: {rec['decision']['kinds']} from "
          f"free={rec['decision']['free']}, "
          f"requested/granted={rec['decision']['tenants']}")
    show(shell, "manager rebalanced: A -> 2 regions, B's waiter promoted",
         rec["shows"])

    # --- failure: region 2 misses heartbeats; the monitor posts the event.
    for healthy in (0, 1, 3):
        monitor.beat(healthy)
    monitor.last_beat[2] -= 100.0            # a stale heartbeat
    failed = monitor.sweep()
    rec["failed"] = failed
    show(shell, f"region {failed} failed -> demote to host, port reset",
         rec["shows"])

    # B still serves (degraded placement, same program).
    server.submit(StreamRequest(app_id=1, prompt=np.arange(3, dtype=np.int32),
                                max_new=3))
    (comp,) = server.run()
    rec["after_failure"] = _completion(comp)
    print(f"   B serves after failure: {comp.tokens} "
          f"(entry port {comp.entry_port})")

    # --- heal: the region returns, the waiter is promoted back.
    monitor.heal(2)
    show(shell, "region healed -> promoted back", rec["shows"])

    # --- release: A departs; the pool drains to B alone.
    shell.release("tenant_a")
    show(shell, "A released", rec["shows"])

    # --- reconfiguration cost model (the ICAP analogue).
    rec["reconfig_cost_s"] = shell.reconfig_cost_s(fp(4))
    print(f"\n   region reprogram cost for a 4 GB module: "
          f"{rec['reconfig_cost_s']:.2f} s (restore at HBM bw + dispatch)")
    rec["event_log"] = [(type(e.event).__name__,
                         [a.kind for a in e.plan.actions])
                        for e in shell.log]
    print(f"   event log: {rec['event_log']}")
    return rec


def steady_state(device=None) -> dict:
    """The serving fast path: cached decode ticks and the probe-read hit
    rate, on ``device``; returns what was printed as a record."""
    from repro_torch.serve import (ReconfigEvent, SeededEngine, ServeHarness,
                                   front_loaded_arrivals)

    shell = Shell([Region(rid=i, n_chips=64, hbm_bytes=16 * GB)
                   for i in range(4)], policy="first_fit")
    fp = ModuleFootprint(param_bytes=4 * GB, flops_per_token=2e9,
                         activation_bytes_per_token=8192)
    shell.post(Submit(tenant="svc", footprints=(fp, fp), app_id=0))

    # 1024 streams through 256 concurrent slots; the plan cache (on by
    # default) memoizes each steady tick's plan under the register epoch.
    server = ElasticServer(shell, n_slots=256, device=device)
    server.register_engine(0, SeededEngine(seed=42))
    probe = server.fabric.probe()           # Fabric.probe(): cache counters
    arrivals = front_loaded_arrivals(1024, seed=42, max_new=24)
    reconfigs = [ReconfigEvent(30, lambda sh: sh.fail_region(3),
                               "fail R3 mid-decode")]
    report = ServeHarness(server, arrivals, reconfigs=reconfigs).run()

    ch = probe.sample()
    print("-- steady-state decode fast path")
    print(f"   {report.n_streams} streams, {report.n_slots} slots, "
          f"{report.ticks} ticks ({report.steady_ticks} pure-decode), "
          f"{report.tokens} tokens @ {report.tokens_per_s:,.0f} tok/s")
    print(f"   decode tick p50/p99: {report.steady_tick_p50_us:.0f}/"
          f"{report.steady_tick_p99_us:.0f} us   admission p50/p99: "
          f"{report.admission_p50_ticks:.0f}/"
          f"{report.admission_p99_ticks:.0f} ticks")
    print(f"   plan cache via Fabric.probe(): "
          f"{ch['plan_cache_hits']} hits / "
          f"{ch['plan_cache_misses']} misses "
          f"(hit rate {report.plan_cache_hit_rate:.1%}), "
          f"{ch['plan_cache_invalidations']} invalidation(s) from the "
          f"mid-run FailRegion")
    print(f"   fabric retraces: {ch['fabric_traces']} — the epoch bump "
          f"invalidated cache entries, never the built kernels")
    return {"report": report, "probe": dict(ch)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--steady-state", action="store_true",
                    help="run the cached-decode fast-path demo instead of "
                         "the full lifecycle script")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is named")
    args = ap.parse_args(argv)
    if args.steady_state:
        steady_state(args.device)
    else:
        run(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
