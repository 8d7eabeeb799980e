"""The port's control loop (``repro_torch.manager``, ``ServerPool``, the
fabric's probe and signature counters) against the JAX package's
(``repro.manager``) on the same seeded inputs.

Everything the manager reads and decides is integer arithmetic on queue
depths, slot counts and plans, so every comparison is exact: scenario
traces (``ScenarioResult.to_json()``) for every kind in
``SCENARIO_KINDS``, a JAX-recorded workload replayed by the port,
``Signals`` after each ``Shell.post``, ``account_stats`` folding,
``Fabric.trace_counts`` on the same calls, and the ``Decision`` list and
token streams of a smoke-Mixtral ``ElasticServer`` under a ``Manager``.
The port runs its ``reference`` and ``cuda`` fabric backends on the CPU
(``device="cpu"``: the plain versions of its kernels).  The Mixtral's
float32 logits agree within the 2e-4 that ``test_torch_serve.py`` states;
its greedy tokens are compared with ``==``.
"""
import dataclasses
import doctest
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import manager as jmanager
from repro import shell as jshell
from repro.configs import get_config as jax_get_config
from repro.core.elastic import Region as JRegion
from repro.core.module import ModuleFootprint as JFootprint
from repro.fabric import PallasBackend, register_fabric_backend
from repro.manager import scenarios as jscen
from repro.manager.telemetry import assemble_signals as jassemble
from repro.serve import SeededEngine as JSeeded
from repro.shell.server import ElasticServer as JServer
from repro.shell.server import ModelEngine as JEngine
from repro.shell.server import ServerPool as JPool
from repro.shell.server import StreamRequest as JRequest
from repro_torch import manager as tmanager
from repro_torch import shell as tshell
from repro_torch import telemetry as ttelemetry
from repro_torch.ckpt.convert import params_from_numpy
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.elastic import Region as TRegion
from repro_torch.core.module import ModuleFootprint as TFootprint
from repro_torch.manager import scenarios as tscen
from repro_torch.manager.telemetry import assemble_signals as tassemble
from repro_torch.serve import SeededEngine as TSeeded
from repro_torch.shell.server import ElasticServer as TServer
from repro_torch.shell.server import ModelEngine as TEngine
from repro_torch.shell.server import ServerPool as TPool
from repro_torch.shell.server import StreamRequest as TRequest

from _torch_port import smoke_mixtral

GB = 1 << 30
TICKS = 48
BACKENDS = ("reference", "cuda")
# (kind, run_scenario keywords, policy factory name or None)
SCENARIOS = {
    "bursty": ({}, None),
    "diurnal": ({}, "predictive_policy"),
    "churn": ({}, None),
    "failure_storm": ({}, None),
    "production": ({"n_regions": 12, "n_slots": 8, "n_servers": 3}, None),
    "adversarial": ({}, "adversarial_policy"),
}

JAX_BACKEND = "pallas_kernel_manager_test"
register_fabric_backend(
    JAX_BACKEND, lambda **kw: PallasBackend(data_plane="kernel", **kw))

SIDES = {
    "jax": dict(shell=jshell, Region=JRegion, Fp=JFootprint, Server=JServer,
                Pool=JPool, Request=JRequest, manager=jmanager,
                scen=jscen, Seeded=JSeeded, assemble=jassemble, kw={}),
    "torch": dict(shell=tshell, Region=TRegion, Fp=TFootprint,
                  Server=TServer, Pool=TPool, Request=TRequest,
                  manager=tmanager, scen=tscen, Seeded=TSeeded,
                  assemble=tassemble, kw={"device": "cpu"}),
}


def _scenario_kw(side, kind, backend="reference"):
    kw, policy = SCENARIOS[kind]
    s = SIDES[side]
    out = dict(kw, seed=0, ticks=TICKS)
    if policy is not None:
        out["policy"] = getattr(s["scen"], policy)()
    if side == "torch":
        out.update(fabric_backend=backend, device="cpu")
    return out


@functools.lru_cache(maxsize=None)
def _jax_scenario(kind):
    return jscen.run_scenario(kind, **_scenario_kw("jax", kind)).to_json()


def test_scenario_kinds_are_the_jax_kinds():
    assert tscen.SCENARIO_KINDS == jscen.SCENARIO_KINDS
    assert set(SCENARIOS) == set(jscen.SCENARIO_KINDS)
    assert sorted(tmanager.__all__) == sorted(jmanager.__all__)
    assert ttelemetry.__all__ == tmanager.telemetry.__all__
    assert tmanager.run_scenario is tscen.run_scenario     # lazy attribute


@pytest.mark.parametrize("module", [
    "repro_torch.manager.manager", "repro_torch.manager.policies",
    "repro_torch.manager.forecast", "repro_torch.manager.trackers",
    "repro_torch.manager.adversary", "repro_torch.shell.server"])
def test_docstring_examples_run(module):
    result = doctest.testmod(importlib.import_module(module), verbose=False)
    assert result.attempted > 0 and result.failed == 0, result


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", sorted(SCENARIOS))
def test_scenario_trace_equals_jax(kind, backend):
    res = tscen.run_scenario(kind, **_scenario_kw("torch", kind, backend))
    got, want = res.to_json(), _jax_scenario(kind)
    assert got.keys() == want.keys()
    for key in want:
        if key != "trace":
            assert got[key] == want[key], key
    assert len(got["trace"]) == len(want["trace"]) == TICKS
    for row_t, row_j in zip(got["trace"], want["trace"]):
        assert row_t == row_j, row_j["tick"]
    assert got["fabric_retraces"] == 1
    if kind == "production":
        assert isinstance(res.server, TPool) and len(res.server) == 3


@pytest.mark.parametrize("kind", ["churn", "production", "adversarial"])
def test_jax_recorded_workload_replays_in_the_port(kind, tmp_path):
    jpath, tpath = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    want = jscen.run_scenario(kind, record_path=jpath,
                              **_scenario_kw("jax", kind)).to_json()
    tscen.run_scenario(kind, record_path=tpath,
                       **_scenario_kw("torch", kind, "cuda"))
    assert jpath.read_bytes() == tpath.read_bytes()     # one file format
    _, policy = SCENARIOS[kind]
    kw = {} if policy is None else {"policy": getattr(tscen, policy)()}
    replay = tscen.run_scenario(tscen.RecordedWorkload.load(jpath),
                                fabric_backend="cuda", device="cpu", **kw)
    assert replay.to_json() == want


# ----------------------------------------------------------------------
# Signals after each post, account_stats, signature counters
# ----------------------------------------------------------------------
def _stats(rng, n):
    local = rng.integers(0, 5, n)
    remote = rng.integers(0, 5, n)
    return {"counts": local + remote,
            "offered_packets": int((local + remote).sum()) + 3,
            "granted_packets": int((local + remote).sum()),
            "local_packets": int(local.sum()),
            "remote_packets": int(remote.sum()),
            "local_counts": local, "remote_counts": remote}


def _signals_run(side):
    """Two tenants on 4 regions behind one server with grant-coupled
    slots, a bare fabric fed by ``account_stats`` and a hostile spray;
    one ``Signals`` after every post, and every probe's samples."""
    s = SIDES[side]
    sh = s["shell"]
    shell = sh.Shell([s["Region"](rid=i, n_chips=8, hbm_bytes=8 * GB)
                      for i in range(4)])
    shell.submit("a", [s["Fp"](GB, 1e9, 4096)] * 2, app_id=0)
    shell.submit("b", [s["Fp"](GB, 1e9, 4096)] * 2, app_id=1)
    server = s["Server"](shell, n_slots=4, slots_per_region=1, **s["kw"])
    for app in (0, 1):
        server.register_engine(app, s["Seeded"](seed=app))
    bare = shell.fabric(**s["kw"])
    probes = [server.probe(), bare.probe()]
    rng = np.random.default_rng(5)
    posts = [sh.Shrink("a", 1), sh.Migrate("b", 0, 1), sh.FailRegion(rid=2),
             sh.Grow("a"), sh.HealRegion(rid=2), sh.Shrink("b", 0),
             sh.Grow("b"), sh.Release("a")]
    out, prev = [], None
    for tick, event in enumerate(posts):
        shell.post(event)
        for app in (0, 1):
            for _ in range(int(rng.integers(0, 4))):
                server.submit(s["Request"](
                    app_id=app, prompt=rng.integers(0, 64, 3).astype(
                        np.int32), max_new=int(rng.integers(2, 5))))
        # a spray from region 0's port: foreign and out-of-range dsts
        dst = rng.integers(-1, shell.state.n_ports + 2, 4).astype(np.int32)
        src = np.full(4, 1, np.int32)
        server.fabric.account(server.fabric.plan(dst, src), src)
        bare.account_stats(_stats(rng, shell.state.n_ports))
        for _ in range(2):
            server.step()
        sig = s["assemble"](shell, probes, tick=tick, prev=prev)
        out.append((dataclasses.asdict(sig),
                    [p.sample() for p in probes]))
        prev = sig
    return out, server, bare


def _plain(v):
    """Probe samples hold numpy arrays; make them comparable."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (np.ndarray, tuple, list)):
        return [_plain(x) for x in v]
    return v


def test_signals_after_each_post_equal_jax():
    (jout, jsrv, jbare), (tout, tsrv, tbare) = (_signals_run("jax"),
                                                 _signals_run("torch"))
    assert len(jout) == len(tout) == 8
    for (jsig, jsamples), (tsig, tsamples) in zip(jout, tout):
        assert jsig == tsig, jsig["tick"]
        assert _plain(jsamples) == _plain(tsamples)
    assert any(sig["masked_by_src_delta"] and any(sig["masked_by_src_delta"])
               for sig, _ in tout)
    for f in ("port_traffic", "local_port_traffic", "remote_port_traffic",
              "masked_by_src", "dropped_by_src"):
        assert np.array_equal(getattr(jbare, f), getattr(tbare, f)), f
    for f in ("offered_packets", "granted_packets", "local_packets",
              "remote_packets"):
        assert getattr(jbare, f) == getattr(tbare, f), f
    assert jsrv.fabric.trace_counts == tsrv.fabric.trace_counts


@pytest.mark.parametrize("as_tensors", [False, True])
def test_account_stats_folds_like_jax(as_tensors):
    from repro.fabric import Fabric as JFabric
    from repro.core.registers import CrossbarRegisters as JRegs
    from repro_torch.core.registers import CrossbarRegisters as TRegs
    from repro_torch.fabric import Fabric as TFabric
    jf = JFabric(JRegs.create(6))
    tf = TFabric(TRegs.create(6), device="cpu")
    rng = np.random.default_rng(1)
    for n in (6, 6, 8):                  # a wider file grows the vectors
        st = _stats(rng, n)
        if n == 8:
            del st["remote_counts"]
        jf.account_stats(st)
        tf.account_stats({k: torch.as_tensor(v) if as_tensors
                          and isinstance(v, np.ndarray) else v
                          for k, v in st.items()})
    jf.account_stats({"offered_packets": 2})
    tf.account_stats({"offered_packets": 2})
    assert _plain(jf.probe().sample()) == _plain(tf.probe().sample())
    assert tf.probe().sample()["fabric_traces"] == 0


@pytest.mark.parametrize("plan_cache", [True, False], ids=["cache_on",
                                                         "cache_off"])
def test_trace_counts_equal_jax_on_the_same_calls(plan_cache):
    """One signature per (entry point, argument shapes, dtypes), 64-bit
    inputs counted as 32-bit, nothing on a cache hit, nothing across a
    ``Shell.post``, a new ``apply_fn`` a new signature."""
    fabrics = {}
    for side in ("jax", "torch"):
        s = SIDES[side]
        shell = s["shell"].Shell([s["Region"](rid=i, n_chips=8,
                                              hbm_bytes=8 * GB)
                                  for i in range(3)])
        shell.submit("a", [s["Fp"](GB, 1e9, 4096)] * 2, app_id=0)
        fabrics[side] = (shell, shell.fabric(plan_cache=plan_cache,
                                             **s["kw"]))
    rng = np.random.default_rng(2)
    x8 = rng.standard_normal((8, 4)).astype(np.float32)

    def arr(side, v, dtype=None):
        if side == "jax":
            return jnp.asarray(v, dtype)
        t = torch.from_numpy(np.asarray(v))
        return t if dtype is None else t.to(getattr(torch, dtype))

    def double(slabs):
        return slabs * 2

    dst8 = rng.integers(-1, 4, 8).astype(np.int32)
    src8 = np.zeros(8, np.int32)
    dst16 = rng.integers(-1, 4, 16).astype(np.int32)
    for side, (shell, fab) in fabrics.items():
        fab.plan(dst8, src8)
        fab.plan(dst8, src8)                          # a hit when cached
        fab.plan(dst8.astype(np.int64), src8)         # canonical int32
        fab.plan(dst16, np.zeros(16, np.int32))
        shell.post(SIDES[side]["shell"].Shrink("a", 1))
        fab.plan(dst8, src8)                          # new epoch, old shape
        slabs, plan = fab.dispatch(arr(side, x8), dst8, src8)
        fab.combine(slabs, plan)
        slabs, plan = fab.dispatch(arr(side, x8), dst16[:8] * 0, src8)
        fab.combine(slabs, plan)
        fab.dispatch(arr(side, x8, "bfloat16"), dst8, src8)
        for fn in (double, double, lambda s: s + 1):
            fab.transfer(arr(side, x8), dst8, src8, apply_fn=fn)
    (_, jf), (_, tf) = fabrics["jax"], fabrics["torch"]
    assert jf.trace_counts == tf.trace_counts
    assert jf.trace_count == tf.trace_count


# ----------------------------------------------------------------------
# the closed loop with a model: smoke Mixtral under a Manager
# ----------------------------------------------------------------------
N_REQUESTS = 8
PROMPT_LEN = 4
MAX_NEW = 4
LOOP_TICKS = 40


@pytest.fixture(scope="module")
def engines():
    cfg_j = smoke_mixtral(JAX_BACKEND, kernel_mode="xla")(jax_get_config)
    cfg_t = smoke_mixtral("cuda_kernel")(torch_get_config)
    max_len = PROMPT_LEN + MAX_NEW
    jeng = JEngine(cfg_j, max_len=max_len, seed=0)
    tree = jax.tree.map(np.asarray, jeng.params)
    teng = TEngine(cfg_t, max_len=max_len, device="cpu",
                   params=params_from_numpy(tree, cfg_t, "cpu"))
    return jeng, teng


def _closed_loop(side, engine, backend):
    """One tenant starting on 1 of its 4 regions, ``slots_per_region=1``:
    a burst of requests at tick 0 must make the manager grow it, and the
    quiet stretch after the burst must make it shrink again."""
    s = SIDES[side]
    sh = s["shell"]
    shell = sh.Shell([s["Region"](rid=i, n_chips=8, hbm_bytes=8 * GB)
                      for i in range(4)])
    shell.submit("mixtral", [s["Fp"](GB, 1e9, 4096)] * 4, app_id=0)
    shell.post(sh.Shrink("mixtral", 1))
    server = s["Server"](shell, n_slots=4, slots_per_region=1,
                         fabric_backend=backend, **s["kw"])
    server.register_engine(0, engine)
    manager = s["manager"].Manager(shell, s["manager"].Hysteresis(),
                                   probes=[server.probe()], interval=2)
    rng = np.random.default_rng(7)
    for _ in range(N_REQUESTS):
        server.submit(s["Request"](
            app_id=0, prompt=rng.integers(0, 512, PROMPT_LEN).astype(
                np.int32), max_new=MAX_NEW))
    placed = []
    for _ in range(LOOP_TICKS):
        server.step()
        manager.step()
        placed.append(shell.state.find_tenant("mixtral").placed_count)
    decisions = [(d.tick, d.kinds(),
                  [dataclasses.astuple(e) for e in d.events],
                  dataclasses.asdict(d.signals), len(d.rejected))
                 for d in manager.decisions]
    comps = [(c.rid, c.tokens, c.entry_port, c.admitted_tick,
              c.finished_tick) for c in sorted(server.completions,
                                                key=lambda c: c.rid)]
    return decisions, comps, placed, server


def test_manager_closed_loop_on_smoke_mixtral_equals_jax(engines):
    jeng, teng = engines
    jd, jc, jp, _ = _closed_loop("jax", jeng, "reference")
    td, tc, tp, server = _closed_loop("torch", teng, "cuda")
    assert tc == jc
    assert len(tc) == N_REQUESTS
    assert td == jd
    assert tp == jp
    kinds = [k for _, ks, _, _, _ in td for k in ks]
    assert "Grow" in kinds and "Shrink" in kinds[kinds.index("Grow"):]
    assert max(tp) > 1 and tp[-1] < max(tp)
    assert server.fabric.trace_count == 1
