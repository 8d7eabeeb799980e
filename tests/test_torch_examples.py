"""The port's examples (``repro_torch.examples``) against the JAX package's
``examples/*.py``, run in-process on the CPU (``--device cpu``).

- ``quickstart`` and ``paper_usecase``: what each prints equals what the
  JAX script prints, line for line, once the JAX names are the port's
  (the ``pallas`` backend is ``cuda``; the Pallas kernels are the Hamming
  kernels): every printed integer, boolean, register value and float (to
  its printed digits).  The records carry the same values.
- ``elastic_serving``: the lifecycle's printed lines likewise (placements,
  ``dest``/``reset``, epochs, delta sizes, the Manager's decision kinds,
  completions' ticks, ports and tokens, ``port_traffic``, the event log),
  with the two smoke models in float32 on the JAX script's parameters,
  converted by ``ckpt/convert.py``.  ``--steady-state``: the lines but for the two
  timed ones (tokens/s, tick percentiles), and the ``ServeReport``'s
  integers, ``token_digest`` and the plan cache's counters bit for bit.
- ``moe_training`` at ``--steps 3 --batch 2 --seq 32`` on the CPU, in a
  subprocess started when the file starts (a step of the ~100M-parameter
  model takes some 20 s here; the other tests run meanwhile): the losses
  are finite, the checkpoint it writes is restored by the JAX package's
  ``ckpt/checkpoint.py`` bit for bit equal to the loop's final
  parameters, and the shell's log holds the tenant's ``Submit``.
- ``moe_training --sharded`` on 4 gloo ranks: the grants, remote and
  local counts, per-port counts and drops after each event equal JAX's
  single-device ``moe_apply_sharded_reference`` on the same parameters,
  tokens and registers (JAX's own forced-4-device path fails on this
  jax, ROADMAP C); nothing is rebuilt.
"""
import contextlib
import dataclasses
import importlib.util
import io
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models.lm import build_model as jax_build_model
from repro_torch.ckpt.convert import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.examples import (elastic_serving, moe_training,
                                  paper_usecase, quickstart)

ROOT = Path(__file__).resolve().parents[1]
# the JAX names in what its scripts print, and the port's
RENAMES = (("pallas backend", "cuda backend"),
           ("Pallas kernels", "Hamming kernels"),
           ("never the compiled program", "never the built kernels"))
TRAIN = dict(steps=3, batch=2, seq=32)


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return buf.getvalue().splitlines(), out


def _renamed(lines):
    out = []
    for line in lines:
        for a, b in RENAMES:
            line = line.replace(a, b)
        out.append(line)
    return out


NUMBER = re.compile(r"-?\d[\d,]*(?:\.\d+)?|True|False")


def _assert_same_lines(got, want, skip=()):
    """Line for line equal (after the renames), the numbers and booleans
    of each line listed first so that a difference names them."""
    want = _renamed(want)
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        if any(s in w for s in skip):
            continue
        assert NUMBER.findall(g) == NUMBER.findall(w), (g, w)
        assert g == w


# ----------------------------------------------------------------------
# moe_training, started first: its subprocess runs beside the other tests
# ----------------------------------------------------------------------
_TRAIN_SCRIPT = """
import pickle, sys
from repro_torch.ckpt.convert import params_to_numpy
from repro_torch.examples import moe_training
rec = moe_training.run(device="cpu", ckpt=sys.argv[1], ckpt_every=3,
                       **{k: int(v) for k, v in (a.split("=") for a in
                                                 sys.argv[3:])})
loop = rec.pop("loop")
rec["params"] = params_to_numpy(loop.params)
with open(sys.argv[2], "wb") as f:
    pickle.dump(rec, f)
"""


@pytest.fixture(scope="module")
def training(tmp_path_factory):
    """The 3-step run in a subprocess: (its process, its checkpoint
    directory, the file of its record)."""
    tmp = tmp_path_factory.mktemp("moe_training")
    out = tmp / "record.pkl"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, "-c", _TRAIN_SCRIPT, str(tmp / "ckpt"), str(out),
         *(f"{k}={v}" for k, v in TRAIN.items())],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield proc, tmp / "ckpt", out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def test_moe_training_starts(training):
    """Starts the subprocess first (the module's tests run in file
    order); it must still be running or have succeeded."""
    proc, _, _ = training
    assert proc.poll() in (None, 0)


# ----------------------------------------------------------------------
# quickstart and paper_usecase
# ----------------------------------------------------------------------
def test_quickstart_prints_and_records_what_jax_prints():
    want, _ = _printed(_jax_example("quickstart").main)
    got, rec = _printed(quickstart.run, "cpu")
    _assert_same_lines(got, want)
    assert rec["version"] == 2 and rec["plan_identical"]
    assert (rec["granted"], rec["invalid_dest"], rec["grant_timeout"],
            rec["granted_after_lift"], rec["transfer_retraces"]) == \
        (20, 8, 4, 24, 0)
    assert rec["round_trip_exact"] and rec["chain_bit_exact"]
    assert rec["spurious_corrections"] == 0
    # the register file, bit for bit against the JAX package's
    from repro.core.registers import CrossbarRegisters as JRegs
    jr = JRegs.create(n_ports=4, capacity=16).with_isolation(
        src=1, allowed_dsts=[1, 2]).with_quota(dst=2, src=0, packages=4)
    for k, v in rec["registers"].items():
        assert np.array_equal(v, np.asarray(getattr(jr, k))), k


def test_paper_usecase_prints_and_records_what_jax_prints():
    want, _ = _printed(_jax_example("paper_usecase").main)
    got, rec = _printed(paper_usecase.run, "cpu")
    _assert_same_lines(got, want)
    assert rec["identical"]
    assert rec["cycles"]["sim_grants"][0] == 4
    assert rec["cycles"]["sim_completions"][-1] == 37


def test_examples_run_as_modules_with_the_device_flag():
    for mod in (quickstart, paper_usecase):
        lines, rc = _printed(mod.main, ["--device", "cpu"])
        assert rc == 0 and lines


# ----------------------------------------------------------------------
# elastic_serving
# ----------------------------------------------------------------------
def _f32(get):
    """``get_config`` giving float32 configs."""
    return lambda arch, **kw: dataclasses.replace(get(arch, **kw),
                                                  dtype="float32")


def _jax_engine_params():
    """The parameters the JAX script's ``register_model`` draws (its
    ``ModelEngine`` at seed 0), converted for the port (float32)."""
    out = {}
    for app, arch in elastic_serving.MODELS.items():
        tree = jax_build_model(_f32(jax_get_config)(arch, smoke=True)).init(
            jax.random.key(0))
        out[app] = params_from_numpy(jax.tree.map(np.asarray, tree),
                                     _f32(get_config)(arch, smoke=True),
                                     "cpu")
    return out


def test_elastic_serving_lifecycle_prints_what_jax_prints(monkeypatch):
    """Both scripts with their smoke models in float32 (the scripts' bf16
    rounds differently in the two packages: measured, 1 of the 18 tokens
    differs), so that the tokens are held too."""
    jmod = _jax_example("elastic_serving")
    monkeypatch.setattr(jmod, "get_config", _f32(jax_get_config))
    monkeypatch.setattr(elastic_serving, "get_config", _f32(get_config))
    want, _ = _printed(jmod.main)
    got, rec = _printed(elastic_serving.run, "cpu", _jax_engine_params())
    _assert_same_lines(got, want)
    kinds = rec["decision"]["kinds"]
    assert kinds and all(isinstance(k, str) for k in kinds)
    assert rec["overlapped"] >= 1 and rec["failed"] == [2]
    assert [s["epoch"] for s in rec["shows"]] == sorted(
        s["epoch"] for s in rec["shows"])
    assert sum(rec["port_traffic"]) > 0
    assert all(c["tokens"] for c in rec["completions"])


def test_elastic_serving_steady_state_digest_and_cache_counters():
    from repro.serve import ServeHarness as JHarness
    reports = []
    run = JHarness.run

    def recording(self, *a, **kw):
        reports.append(run(self, *a, **kw))
        return reports[-1]

    JHarness.run = recording
    try:
        want, _ = _printed(_jax_example("elastic_serving").steady_state)
    finally:
        JHarness.run = run
    got, rec = _printed(elastic_serving.steady_state, "cpu")
    _assert_same_lines(got, want, skip=("tok/s", "p50/p99"))
    (jrep,) = reports
    rep = rec["report"]
    assert rep.token_digest == jrep.token_digest
    for k in ("n_streams", "n_slots", "ticks", "steady_ticks", "tokens",
              "plan_cache_hits", "plan_cache_misses",
              "plan_cache_invalidations"):
        assert getattr(rep, k) == getattr(jrep, k), k
    assert rec["probe"]["plan_cache_invalidations"] == \
        jrep.plan_cache_invalidations


# ----------------------------------------------------------------------
# moe_training --sharded
# ----------------------------------------------------------------------
def test_moe_training_sharded_matches_jax_reference():
    from repro import shell as jshell
    from repro.core.elastic import Region as JRegion
    from repro.core.module import ModuleFootprint as JFootprint
    from repro.models.config import MoEConfig as JMoE
    from repro.models.moe import moe_apply_sharded_reference
    n = 4
    params, x = moe_training.sharded_inputs(n)
    lines, rec = _printed(moe_training.sharded_demo, n, "cpu",
                          params=params, x=x)
    assert rec["traces_after"] == rec["traces"]
    assert rec["epoch"] >= 3

    gb = 1 << 30
    shell = jshell.Shell([JRegion(rid=i, n_chips=8, hbm_bytes=8 * gb)
                          for i in range(n - 1)],
                         capacity=moe_training.SHARDED_CAP)
    shell.submit("moe", [JFootprint(gb, 1e9, 4096)] * (n - 1), app_id=0)
    moe = JMoE(n_experts=n, top_k=2, capacity_factor=2.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    def ref():
        _, st = moe_apply_sharded_reference(
            jp, jnp.asarray(x), moe, "swiglu", n_shards=n,
            registers=shell.registers, capacity=moe_training.SHARDED_CAP)
        return st

    wants = [ref()]
    shell.post(jshell.FailRegion(rid=0))
    wants.append(ref())
    shell.post(jshell.Grow(tenant="moe"))
    shell.heal_region(0)
    wants.append(ref())
    assert len(rec["events"]) == 3
    for i, (got, want) in enumerate(zip(rec["events"], wants)):
        for k in ("granted_packets", "remote_packets", "local_packets",
                  "counts", "dropped"):
            assert np.array_equal(np.asarray(got[k]),
                                  np.asarray(want[k])), (i, k)
    assert int(wants[1]["dropped"]) > 0 and int(wants[2]["dropped"]) == 0


# ----------------------------------------------------------------------
# moe_training: the subprocess's results
# ----------------------------------------------------------------------
def test_moe_training_short_run_checkpoint_restored_by_jax(training):
    """The loop's checkpoint of (parameters, AdamW state) after step 3,
    restored by the JAX package into the structure of JAX's own model and
    optimizer, holds the loop's final parameters (bf16 leaves compared as
    their exact float32 values)."""
    from repro.ckpt import checkpoint as jckpt
    from repro.optim.adamw import AdamW as JaxAdamW
    proc, ckpt, out = training
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log
    with open(out, "rb") as f:
        rec = pickle.load(f)
    losses = [h["loss"] for h in rec["history"]]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert rec["checkpoints"] == ["step_00000003"]
    assert ("Submit", "moe-train") in rec["shell_log"]
    assert rec["watchdog_timeouts"] == 0
    jm = jax_build_model(_jax_example("moe_training").MOE_100M)

    def init():
        p = jm.init(jax.random.key(0))
        return p, JaxAdamW().init(p)

    like = jax.eval_shape(init)
    assert jckpt.latest_step(ckpt) == 3
    params, _ = jckpt.restore_checkpoint(ckpt, like)
    paths = jax.tree_util.tree_leaves_with_path(params)
    assert len(paths) == len(jax.tree.leaves(rec["params"]))
    for path, leaf in paths:
        want = rec["params"]
        for k in path:
            want = want[k.key]
        got = np.asarray(leaf.astype(jnp.float32))
        assert np.array_equal(got, want), jax.tree_util.keystr(path)
