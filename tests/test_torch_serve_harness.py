"""The seeded serve harness of the port (``repro_torch.serve``) against the
JAX package's (``repro.serve``) on the same schedules: the same
``SeededEngine`` tokens, arrival schedules, ``ServeReport`` integers and
sha256 ``token_digest`` with the plan cache on and off and under the
reconfiguration storm, on the port's ``reference`` and ``cuda`` fabric
backends (the latter on the CPU's plain versions).  Every comparison is
exact (``==`` or ``np.array_equal``): ``SeededEngine`` is pure integer
arithmetic and the plans are integer functions of the registers.
"""
import dataclasses

import numpy as np
import pytest

from repro import serve as jserve
from repro import shell as jshell
from repro import stats as jstats
from repro.core.elastic import Region as JRegion
from repro.core.module import ModuleFootprint as JFootprint
from repro.manager.trackers import InMemoryTracker as JTracker
from repro.shell.server import ElasticServer as JServer
from repro_torch import serve as tserve
from repro_torch import shell as tshell
from repro_torch import stats as tstats
from repro_torch.core.elastic import Region as TRegion
from repro_torch.core.module import ModuleFootprint as TFootprint
from repro_torch.manager.trackers import InMemoryTracker as TTracker
from repro_torch.shell.server import ElasticServer as TServer

GB = 1 << 30
SEED = 11
# Every field of ``ServeReport`` that is a pure function of the seed (the
# rest are wall-time readings).
INT_FIELDS = ("n_streams", "n_slots", "ticks", "steady_ticks", "completions",
              "tokens", "reconfigs", "admission_p50_ticks",
              "admission_p99_ticks", "fabric_retraces", "plan_cache_hits",
              "plan_cache_misses", "plan_cache_invalidations",
              "plan_cache_hit_rate", "token_digest")
BACKENDS = ("reference", "cuda")


def _server(side, n_slots, plan_cache, backend="reference"):
    """serve_bench's shell: 4 regions, one 2-module tenant ``svc``."""
    if side == "jax":
        pkg, Region, Fp, Server, serve, kw = (jshell, JRegion, JFootprint,
                                              JServer, jserve, {})
    else:
        pkg, Region, Fp, Server, serve, kw = (tshell, TRegion, TFootprint,
                                              TServer, tserve,
                                              {"device": "cpu"})
    shell = pkg.Shell([Region(rid=i, n_chips=8, hbm_bytes=8 * GB)
                       for i in range(4)])
    shell.submit("svc", [Fp(GB, 1e9, 4096)] * 2, app_id=0)
    server = Server(shell, n_slots=n_slots, plan_cache=plan_cache,
                    fabric_backend=backend, **kw)
    server.register_engine(0, serve.SeededEngine(seed=SEED))
    return server


def _storm(serve, at=(3, 6, 9, 12)):
    """serve_bench's FailRegion / heal / Shrink / Grow script."""
    return [serve.ReconfigEvent(at[0], lambda sh: sh.fail_region(2), "fail"),
            serve.ReconfigEvent(at[1], lambda sh: sh.heal_region(2), "heal"),
            serve.ReconfigEvent(at[2], lambda sh: sh.shrink("svc", 1), "shr"),
            serve.ReconfigEvent(at[3], lambda sh: sh.grow("svc", 1), "grow")]


def _run(side, arrivals_fn, n_slots, plan_cache, backend="reference",
         storm=False):
    """One harness run; the JAX side always plans on ``reference``."""
    serve = jserve if side == "jax" else tserve
    server = _server(side, n_slots, plan_cache, backend)
    tracker = (JTracker if side == "jax" else TTracker)()
    report = serve.ServeHarness(
        server, arrivals_fn(serve),
        reconfigs=_storm(serve) if storm else (),
        trackers=[tracker]).run()
    return report, server, tracker


def _same_run(j, t):
    (jr, js, jt), (tr, ts, tt) = j, t
    for f in INT_FIELDS:
        assert getattr(jr, f) == getattr(tr, f), f
    assert np.array_equal(js.port_traffic, ts.port_traffic)
    assert (js.offered_packets, js.granted_packets) == (
        ts.offered_packets, ts.granted_packets)
    assert np.array_equal(js.masked_by_src, ts.masked_by_src)
    assert np.array_equal(js.dropped_by_src, ts.dropped_by_src)
    jc = [dataclasses.astuple(c) for c in js.completions]
    tc = [dataclasses.astuple(c) for c in ts.completions]
    assert jc == tc
    # the tracker rows, but for the one wall-time reading
    strip = [(s, {k: v for k, v in m.items() if k != "tick_us"})
             for s, m in jt.rows]
    assert strip == [(s, {k: v for k, v in m.items() if k != "tick_us"})
                     for s, m in tt.rows]


def _steady(serve):
    return serve.front_loaded_arrivals(96, seed=SEED, max_new=6)


def _bursty(serve):
    return serve.heavy_tailed_arrivals(96, seed=SEED, mean_gap_ticks=0.3)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("plan_cache", [True, False], ids=["cache_on",
                                                         "cache_off"])
def test_steady_state_report_equals_jax(plan_cache, backend):
    j = _run("jax", _steady, 32, plan_cache)
    t = _run("torch", _steady, 32, plan_cache, backend)
    _same_run(j, t)
    assert t[0].completions == 96 and t[0].fabric_retraces == 1
    assert t[1].fabric.trace_counts["plan"] == 1


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("plan_cache", [True, False], ids=["cache_on",
                                                         "cache_off"])
def test_storm_report_equals_jax(plan_cache, backend):
    j = _run("jax", _bursty, 8, plan_cache, storm=True)
    t = _run("torch", _bursty, 8, plan_cache, backend, storm=True)
    _same_run(j, t)
    report = t[0]
    assert report.reconfigs == 4
    if plan_cache:                       # one flush per post
        assert report.plan_cache_invalidations == 4
    assert report.fabric_retraces == 1


def test_digest_is_the_same_with_the_cache_on_and_off():
    on = _run("torch", _steady, 32, True, "cuda")[0]
    off = _run("torch", _steady, 32, False, "cuda")[0]
    assert on.token_digest == off.token_digest
    assert on.plan_cache_hits > 0 and off.plan_cache_hits == 0
    storm_on = _run("torch", _bursty, 8, True, storm=True)[0]
    storm_off = _run("torch", _bursty, 8, False, storm=True)[0]
    assert storm_on.token_digest == storm_off.token_digest


@pytest.mark.parametrize("kind", ["front_loaded", "heavy_tailed"])
def test_arrival_schedules_equal_jax_and_cross_load(kind, tmp_path):
    def make(serve):
        if kind == "front_loaded":
            return serve.front_loaded_arrivals(40, seed=3, apps=(0, 1, 2),
                                               prompt_len=5, max_new=7)
        return serve.heavy_tailed_arrivals(40, seed=3, apps=(0, 1),
                                           mean_gap_ticks=0.4)
    ja, ta = make(jserve), make(tserve)
    assert [(s.tick, s.app_id, s.prompt.tolist(), s.max_new) for s in ja] \
        == [(s.tick, s.app_id, s.prompt.tolist(), s.max_new) for s in ta]
    jserve.dump_arrivals(ja, tmp_path / "jax.jsonl")
    tserve.dump_arrivals(ta, tmp_path / "torch.jsonl")
    assert (tmp_path / "jax.jsonl").read_bytes() == \
        (tmp_path / "torch.jsonl").read_bytes()
    back = tserve.load_arrivals(tmp_path / "jax.jsonl")
    assert all(s.prompt.dtype == np.int32 for s in back)
    assert [s.prompt.tolist() for s in back] == [s.prompt.tolist()
                                                 for s in ja]


def test_seeded_engine_tokens_equal_jax():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 1 << 15, n, dtype=np.int32)
               for n in (1, 4, 9, 16)]
    for seed, vocab in ((0, 32768), (11, 1000)):
        je = jserve.SeededEngine(vocab=vocab, seed=seed)
        te = tserve.SeededEngine(vocab=vocab, seed=seed)
        assert je.prefill_batch(prompts) == te.prefill_batch(prompts)
        toks = [te.prefill(p)[0] for p in prompts]
        assert je.decode_batch(toks, None) == te.decode_batch(toks, None)
        assert [je.decode(t, None) for t in toks] == [te.decode(t, None)
                                                      for t in toks]


@pytest.mark.parametrize("xs", [[], [3.0], [1, 5, 2, 9, 4, 4, 0, 11],
                                np.arange(101, dtype=np.float64) ** 1.5])
def test_percentiles_equal_jax(xs):
    for q in (0, 50, 90, 99, 100):
        assert jstats.percentile(xs, q) == tstats.percentile(xs, q)
    assert jstats.percentiles(xs, (50, 99)) == tstats.percentiles(
        xs, (50, 99))
