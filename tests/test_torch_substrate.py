"""The port's training substrate against the JAX package's: the prefetching
``DataPipeline``, checkpoints (and their interchange between the two
packages), the step watchdog, heartbeats, straggler statistics and int8
gradient compression.

Everything here is integer, byte or host-clock work, so the two packages
are held bit-equal: token streams, restored leaves (bf16 by their bits),
flagged regions, shell logs and the int8 codes and scales.  The
cross-package checkpoints are the smoke Mixtral's ``(params, OptState)``
tree in bf16 (float32 moments, an int32 step) and a nested tree with bf16,
float32 and int32 leaves, written by one package and restored by the other;
one case restores with ``ml_dtypes`` (and JAX) blocked in the reader's
process.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataPipeline as JPipeline
from repro.models.lm import build_model as jax_build_model
from repro.optim import compress as jcompress
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import OptState as JOptState
from repro.runtime import ft as jft
from repro_torch.ckpt.checkpoint import (CheckpointManager, latest_step,
                                        restore_checkpoint, save_checkpoint)
from repro_torch.ckpt.convert import (opt_state_from_numpy,
                                      opt_state_to_numpy, params_from_numpy,
                                      params_to_numpy)
from repro_torch.configs import get_config as torch_get_config
from repro_torch.data import DataPipeline, PipelineState, synthetic_batch
from repro_torch.models.common import tree_leaves
from repro_torch.models.lm import build_model
from repro_torch.optim import (compress_int8, decompress_int8,
                               error_feedback_update)
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime import ft

ROOT = pathlib.Path(__file__).resolve().parent.parent
GB = 1 << 30


# ----------------------------------------------------------------------
# data pipeline
# ----------------------------------------------------------------------
class TestPipeline:
    KW = dict(seed=4, global_batch=4, seq_len=16, vocab=100)

    def test_prefetch_matches_synchronous_and_jax(self):
        sync, pre, jpre = (DataPipeline(**self.KW), DataPipeline(**self.KW),
                           JPipeline(**self.KW))
        pre.start()
        jpre.start()
        try:
            for _ in range(5):
                a, b, c = next(sync), next(pre), next(jpre)
                for k in ("tokens", "labels"):
                    np.testing.assert_array_equal(a[k], b[k])
                    np.testing.assert_array_equal(a[k], c[k])
        finally:
            pre.stop()
            jpre.stop()
        assert pre._thread is None

    def test_restore_resumes_exact_stream(self):
        p = DataPipeline(**self.KW)
        for _ in range(3):
            next(p)
        st_ = p.state()
        assert st_ == PipelineState(seed=4, step=3)
        want = next(p)
        p2 = DataPipeline(**self.KW)
        p2.restore(st_)
        np.testing.assert_array_equal(next(p2)["tokens"], want["tokens"])

    def test_rebalance_preserves_coverage(self):
        kw = dict(self.KW, global_batch=8)
        p = DataPipeline(**kw, shard=0, n_shards=2)
        jp = JPipeline(**kw, shard=0, n_shards=2)
        next(p)
        next(jp)
        p.rebalance(shard=1, n_shards=4)          # elastic resize
        jp.rebalance(shard=1, n_shards=4)
        got = next(p)
        np.testing.assert_array_equal(
            got["tokens"], synthetic_batch(4, 1, 1, 4, 8, 16, 100)["tokens"])
        np.testing.assert_array_equal(got["tokens"], next(jp)["tokens"])

    def test_stop_after_restart_mid_stream(self):
        p = DataPipeline(**self.KW)
        p.start()
        next(p)
        p.restore(PipelineState(seed=4, step=7))  # stops the thread
        p.start()
        try:
            np.testing.assert_array_equal(
                next(p)["tokens"],
                synthetic_batch(4, 7, 0, 1, 4, 16, 100)["tokens"])
        finally:
            p.stop()


# ----------------------------------------------------------------------
# checkpoints in one package
# ----------------------------------------------------------------------
def _tree():
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.linspace(-2, 3, 5).to(torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _zeros_like(tree):
    return {k: (_zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v))
            for k, v in tree.items()}


class TestCheckpoint:
    def test_roundtrip_including_bf16(self, tmp_path):
        t = _tree()
        save_checkpoint(tmp_path, 3, t)
        like = _zeros_like(t)
        got = restore_checkpoint(tmp_path, like)
        assert got["w"] is like["w"]              # filled in place
        for a, b in zip(tree_leaves(t), tree_leaves(got)):
            assert a.dtype == b.dtype and torch.equal(a, b)

    def test_latest_step_ignores_uncommitted_tmp(self, tmp_path):
        save_checkpoint(tmp_path, 1, _tree())
        (tmp_path / "step_00000002.tmp").mkdir()      # simulated crash
        assert latest_step(tmp_path) == 1

    def test_structure_mismatch_raises(self, tmp_path):
        save_checkpoint(tmp_path, 1, _tree())
        with pytest.raises(ValueError, match="architecture mismatch"):
            restore_checkpoint(tmp_path, {"only": torch.zeros(3)})
        bad = _zeros_like(_tree())
        bad["w"] = torch.zeros(4, 3)
        with pytest.raises(ValueError, match="shape mismatch"):
            restore_checkpoint(tmp_path, bad)

    def test_async_manager_retention_and_gc(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2)
        t = _tree()
        for s in (10, 20, 30):
            mgr.save_async(s, t)
        mgr.wait()
        assert latest_step(tmp_path) == 30
        kept = sorted(d.name for d in tmp_path.iterdir())
        assert kept == ["step_00000020", "step_00000030"]
        assert mgr.last_snapshot_s >= 0 and mgr.last_write_s >= 0

    def test_async_save_snapshots_before_returning(self, tmp_path):
        """The tensors may change as soon as ``save_async`` returns."""
        mgr = CheckpointManager(tmp_path, keep=1)
        t = _tree()
        want = t["w"].clone()
        mgr.save_async(1, t)
        t["w"].add_(100.0)                        # the next step, in place
        mgr.wait()
        got = restore_checkpoint(tmp_path, _zeros_like(t))
        assert torch.equal(got["w"], want)

    def test_restore_latest_roundtrip(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2)
        t = _tree()
        mgr.save_async(5, t)
        mgr.wait()
        step, got = mgr.restore_latest(_zeros_like(t))
        assert step == 5 and torch.equal(got["w"], t["w"])
        assert mgr.last_restore_s >= 0
        assert CheckpointManager(tmp_path / "none").restore_latest(t) is None

    def test_restore_onto_another_device(self, tmp_path):
        """``device=`` re-places leaves (the JAX package's ``shardings=``):
        a tensor elsewhere becomes a new tensor on ``device``, in its own
        type; a Python scalar stays one."""
        w = torch.arange(8, dtype=torch.float32)
        save_checkpoint(tmp_path, 1, {"w": w, "n": 3})
        like = {"w": torch.empty(8, dtype=torch.float64, device="meta"),
                "n": 0}
        got = restore_checkpoint(tmp_path, like, device="cpu")
        assert got["w"].device.type == "cpu" and got["w"].dtype == torch.float64
        assert torch.equal(got["w"], w.double())
        assert got["n"] == 3 and isinstance(got["n"], int)

    def test_write_error_surfaces_on_wait(self, tmp_path):
        blocker = tmp_path / "file"
        blocker.write_text("not a directory")
        mgr = CheckpointManager(blocker, keep=1)
        mgr.save_async(1, _tree())
        with pytest.raises(OSError):
            mgr.wait()


# ----------------------------------------------------------------------
# checkpoints across the packages
# ----------------------------------------------------------------------
def _np_tree(seed=0):
    """The nested tree of the cross-package cases as numpy arrays (bf16
    leaves as float32 values that bf16 holds exactly)."""
    rng = np.random.default_rng(seed)
    bf = lambda *s: (rng.standard_normal(s).astype(np.float32)
                     .view(np.uint32) & 0xFFFF0000).view(np.float32)
    return {"bf": bf(3, 5), "f32": rng.standard_normal((4, 2)).astype(
        np.float32), "deep": {"i32": rng.integers(-9, 9, 6).astype(np.int32),
                              "z": {"bf2": bf(7)}}}


BF16 = ("bf", "bf2")


def _jax_tree(t):
    return {k: (_jax_tree(v) if isinstance(v, dict) else
                jnp.asarray(v, jnp.bfloat16 if k in BF16 else v.dtype))
            for k, v in t.items()}


def _torch_tree(t, zeros=False):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out[k] = _torch_tree(v, zeros)
            continue
        x = torch.from_numpy(v.copy())
        if k in BF16:
            x = x.to(torch.bfloat16)
        out[k] = torch.zeros_like(x) if zeros else x
    return out


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes, whichever package holds it."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _sorted_leaves(tree):
    """A port tree's leaves in the JAX package's order (keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _assert_bit_equal(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), _sorted_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert str(np.asarray(a).dtype) == str(b.dtype).replace("torch.", "")
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_jax_written_nested_tree_restores_bit_for_bit(tmp_path):
    t = _np_tree(0)
    jckpt.save_checkpoint(tmp_path, 4, _jax_tree(t))
    got = restore_checkpoint(tmp_path, _torch_tree(t, zeros=True))
    _assert_bit_equal(_jax_tree(t), got)


def test_port_written_nested_tree_restores_in_jax_bit_for_bit(tmp_path):
    t = _np_tree(1)
    save_checkpoint(tmp_path, 4, _torch_tree(t))
    like = jax.tree.map(jnp.zeros_like, _jax_tree(t))
    got = jckpt.restore_checkpoint(tmp_path, like)
    _assert_bit_equal(got, _torch_tree(t))
    jman = tmp_path / "jax"
    jckpt.save_checkpoint(jman, 4, _jax_tree(t))
    mine = json.loads((tmp_path / "step_00000004/manifest.json").read_text())
    theirs = json.loads((jman / "step_00000004/manifest.json").read_text())
    assert mine["paths"] == theirs["paths"]
    assert mine["leaves"] == theirs["leaves"]


_BLOCK = (
    "import sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('ml_dtypes', 'jax', 'jaxlib', 'repro'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, Block())\n")


def test_jax_written_bf16_restores_with_ml_dtypes_hidden(tmp_path):
    t = _np_tree(2)
    jckpt.save_checkpoint(tmp_path / "ck", 9, _jax_tree(t))
    code = _BLOCK + (
        "import numpy as np, torch\n"
        "from repro_torch.ckpt.checkpoint import restore_checkpoint\n"
        f"root = {str(tmp_path)!r}\n"
        "like = {'bf': torch.zeros(3, 5, dtype=torch.bfloat16),\n"
        "        'f32': torch.zeros(4, 2),\n"
        "        'deep': {'i32': torch.zeros(6, dtype=torch.int32),\n"
        "                 'z': {'bf2': torch.zeros(7, dtype=torch.bfloat16)}}}\n"
        "got = restore_checkpoint(root + '/ck', like)\n"
        "assert 'ml_dtypes' not in sys.modules\n"
        "np.save(root + '/bf.npy', got['bf'].view(torch.int16).numpy())\n"
        "np.save(root + '/bf2.npy',\n"
        "        got['deep']['z']['bf2'].view(torch.int16).numpy())\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    jt = _jax_tree(t)
    np.testing.assert_array_equal(np.load(tmp_path / "bf.npy"),
                                  np.asarray(jt["bf"]).view(np.int16))
    np.testing.assert_array_equal(np.load(tmp_path / "bf2.npy"),
                                  np.asarray(jt["deep"]["z"]["bf2"]).view(
                                      np.int16))


def _models(arch="mixtral_8x7b"):
    cfg_j = dataclasses.replace(jax_get_config(arch, smoke=True),
                                dtype="bfloat16")
    cfg_t = dataclasses.replace(torch_get_config(arch, smoke=True),
                                dtype="bfloat16")
    return cfg_j, cfg_t


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "recurrentgemma_9b"])
def test_jax_model_state_restores_into_the_port(tmp_path, arch):
    """JAX's (params, OptState) of a smoke model (bf16 parameters, float32
    moments, int32 step) into the port's own tree: every layer's leaf
    bit-equal to the JAX one, the step an int."""
    cfg_j, cfg_t = _models(arch)
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.key(3))
    rng = np.random.default_rng(3)
    noise = lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32)
    state_j = JOptState(step=jnp.int32(5), m=jax.tree.map(noise, params_j),
                        v=jax.tree.map(noise, params_j))
    jckpt.save_checkpoint(tmp_path, 5, (params_j, state_j))

    model_t = build_model(cfg_t, device="cpu")
    params_t = model_t.init(torch.Generator().manual_seed(0))
    state_t = AdamW().init(params_t)
    step, (params_r, state_r) = CheckpointManager(tmp_path).restore_latest(
        (params_t, state_t))
    assert step == 5 and state_r.step == 5 and isinstance(state_r.step, int)
    assert params_r["embed"] is params_t["embed"]
    want = params_from_numpy(jax.tree.map(
        lambda a: np.asarray(a, np.float32), params_j), cfg_t, device="cpu")
    for a, b in zip(_sorted_leaves(want), _sorted_leaves(params_r)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    _, m, v = opt_state_to_numpy(state_r)
    for ours, theirs in ((m, state_j.m), (v, state_j.v)):
        for a, b in zip(jax.tree.leaves(theirs), jax.tree.leaves(ours)):
            np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "recurrentgemma_9b"])
def test_port_model_state_restores_in_jax(tmp_path, arch):
    """The port's (params, OptState) restored by the JAX package into its
    own stacked tree, which matches leaves by position: the port must
    write the JAX package's paths in its order, bit for bit."""
    cfg_j, cfg_t = _models(arch)
    model_t = build_model(cfg_t, device="cpu")
    params_t = model_t.init(torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(5)
    state_t = AdamW().init(params_t)
    for leaf in tree_leaves(state_t.m) + tree_leaves(state_t.v):
        leaf.normal_(generator=gen)
    state_t = state_t._replace(step=6)
    save_checkpoint(tmp_path, 6, (params_t, state_t))

    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.key(0))
    like = (params_j, JAdamW().init(params_j))
    jckpt.save_checkpoint(tmp_path / "jax", 6, like)
    mine = json.loads((tmp_path / "step_00000006/manifest.json").read_text())
    theirs = json.loads(
        (tmp_path / "jax/step_00000006/manifest.json").read_text())
    assert mine["paths"] == theirs["paths"]
    assert mine["leaves"] == theirs["leaves"]
    params_r, state_r = jckpt.restore_checkpoint(tmp_path, like, step=6)
    assert int(state_r.step) == 6 and state_r.step.dtype == jnp.int32
    stacked = params_to_numpy(params_t)            # float32, bf16-exact
    for a, b in zip(jax.tree.leaves(stacked), jax.tree.leaves(params_r)):
        assert b.dtype == jnp.bfloat16
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    _, m, _ = opt_state_to_numpy(state_t)
    for a, b in zip(jax.tree.leaves(m), jax.tree.leaves(state_r.m)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_opt_state_roundtrip_through_convert(tmp_path):
    """The same state through ``ckpt.convert`` and through a checkpoint
    agree (the two routes between the layouts)."""
    cfg_t = _models()[1]
    params_t = build_model(cfg_t, device="cpu").init(
        torch.Generator().manual_seed(6))
    state_t = AdamW().init(params_t)._replace(step=2)
    save_checkpoint(tmp_path, 2, state_t)
    step, m, v = opt_state_to_numpy(state_t)
    via_convert = opt_state_from_numpy(step, m, v, cfg_t, device="cpu")
    got = restore_checkpoint(tmp_path, AdamW().init(params_t))
    assert got.step == via_convert.step == 2
    for a, b in zip(tree_leaves(via_convert.m), tree_leaves(got.m)):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# fault tolerance
# ----------------------------------------------------------------------
class TestWatchdog:
    def test_deadline_pass_and_fail(self):
        wd = ft.StepWatchdog(deadline_s=10.0)
        wd.arm(0)
        assert wd.check() is True
        seen = []
        wd2 = ft.StepWatchdog(deadline_s=0.0, on_timeout=seen.append)
        wd2.arm(1)
        time.sleep(0.01)
        assert wd2.check() is False
        assert wd2.events[0].step == 1 and seen == wd2.events
        assert wd2.events[0].error == jft.WatchdogEvent(0, None, 0, 0).error

    def test_posts_timeout_event_like_jax(self):
        logs = []
        for sh, region, fp, mod in _shell_pkgs():
            shell = sh.Shell([region(rid=i, n_chips=16, hbm_bytes=16 * GB)
                              for i in range(2)])
            shell.submit("a", [_fp(fp)] * 2)
            wd = mod.StepWatchdog(deadline_s=0.0, shell=shell)
            wd.arm(3)
            time.sleep(0.01)
            assert wd.check(region=1) is False
            logs.append(_log(shell))
        assert logs[0] == logs[1]
        assert logs[1][-1][0] == "WatchdogTimeout"


def _shell_pkgs():
    from repro import shell as jshell
    from repro.core.elastic import Region as JRegion
    from repro.core.module import ModuleFootprint as JFootprint
    from repro_torch import shell as tshell
    from repro_torch.core.elastic import Region as TRegion
    from repro_torch.core.module import ModuleFootprint as TFootprint
    return ((jshell, JRegion, JFootprint, jft),
            (tshell, TRegion, TFootprint, ft))


def _fp(fp):
    return fp(param_bytes=GB, flops_per_token=1e9,
              activation_bytes_per_token=4096)


def _log(shell):
    """A shell's log as comparable values: event type, its fields, and the
    placements after it."""
    out = []
    for e in shell.log:
        fields = {k: v for k, v in vars(e.event).items()
                  if k not in ("footprints", "elapsed_s", "stale_s")}
        out.append((type(e.event).__name__, sorted(fields.items()),
                    e.epoch))
    return out


class TestHeartbeat:
    def test_missed_heartbeat_demotes_via_erm(self):
        from repro_torch.core.elastic import (ON_SERVER,
                                              ElasticResourceManager, Region)
        from repro_torch.core.module import ModuleFootprint
        clock = [0.0]
        mon = ft.HeartbeatMonitor([0, 1], timeout_s=5.0,
                                  clock=lambda: clock[0])
        erm = ElasticResourceManager(
            [Region(rid=i, n_chips=8, hbm_bytes=1 << 34) for i in (0, 1)])
        erm.submit("a", [_fp(ModuleFootprint)] * 2)
        clock[0] = 3.0
        mon.beat(0)                     # region 0 stays alive
        clock[0] = 6.0
        assert mon.sweep(erm) == [1]
        assert erm.placement_of("a")[1] == ON_SERVER
        mon.heal(1, erm)
        assert erm.placement_of("a")[1] != ON_SERVER

    def test_beat_clears_failure(self):
        clock = [0.0]
        mon = ft.HeartbeatMonitor([0], timeout_s=1.0, clock=lambda: clock[0])
        clock[0] = 2.0
        assert mon.sweep() == [0]
        mon.beat(0)
        assert 0 not in mon.failed

    def test_shell_events_equal_jax(self):
        logs, placements = [], []
        for sh, region, fp, mod in _shell_pkgs():
            shell = sh.Shell([region(rid=i, n_chips=16, hbm_bytes=16 * GB)
                              for i in range(3)])
            shell.submit("a", [_fp(fp)] * 3)
            clock = [0.0]
            mon = mod.HeartbeatMonitor(timeout_s=5.0, clock=lambda: clock[0],
                                       shell=shell)
            clock[0] = 3.0
            mon.beat(0)
            clock[0] = 6.0
            assert sorted(mon.sweep()) == [1, 2]
            mon.heal(2)
            logs.append(_log(shell))
            placements.append(shell.placement_of("a"))
        assert logs[0] == logs[1] and placements[0] == placements[1]
        with pytest.raises(ValueError):
            ft.HeartbeatMonitor(timeout_s=1.0)


class TestStragglers:
    @pytest.mark.parametrize("blip", [False, True])
    def test_flags_equal_jax(self, blip):
        """A persistent outlier is flagged and a transient blip is not, in
        both packages, sweep by sweep."""
        flags = []
        for mod in (jft, ft):
            stats = mod.StragglerStats([0, 1, 2, 3], threshold=1.5,
                                       patience=3)
            seen = []
            for i in range(6):
                for r in (0, 1, 2):
                    stats.record(r, 1.0)
                stats.record(3, 3.0 if (i == 0 or not blip) else 1.0)
                seen.append(stats.stragglers())
            flags.append(seen)
        assert flags[0] == flags[1]
        assert flags[1][-1] == ([] if blip else [3])

    def test_sweep_posts_once_per_streak_like_jax(self):
        logs = []
        for sh, region, fp, mod in _shell_pkgs():
            shell = sh.Shell([region(rid=i, n_chips=16, hbm_bytes=16 * GB)
                              for i in range(3)])
            shell.submit("a", [_fp(fp)] * 3)
            stats = mod.StragglerStats([0, 1, 2], threshold=1.5, patience=2,
                                       shell=shell)
            for step in range(4):
                for r, t in ((0, 0.01), (1, 0.01), (2, 0.5)):
                    stats.record(r, t)
                stats.sweep(step=step)
            logs.append(_log(shell))
        assert logs[0] == logs[1]
        assert [e[0] for e in logs[1]].count("WatchdogTimeout") == 1

    def test_probe_reads_scores(self):
        from repro_torch.manager.telemetry import StragglerProbe
        stats = ft.StragglerStats([0, 1, 2], threshold=1.5, patience=1)
        for r, t in ((0, 0.01), (1, 0.01), (2, 0.09)):
            stats.record(r, t)
        probe = stats.probe()
        assert isinstance(probe, StragglerProbe)
        scores = probe.sample()["straggler_score"]
        assert scores[2] == pytest.approx(9.0) and scores[0] == 1.0


# ----------------------------------------------------------------------
# int8 gradient compression
# ----------------------------------------------------------------------
@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_compress_int8_bit_equal_to_jax(scale):
    g = (np.random.default_rng(7).standard_normal((33, 17)) * scale).astype(
        np.float32)
    q, s, err = compress_int8(torch.from_numpy(g))
    jq, js, jerr = jcompress.compress_int8(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
    np.testing.assert_array_equal(
        decompress_int8(q, s).numpy(),
        np.asarray(jcompress.decompress_int8(jq, js)))


def test_error_feedback_update_matches_jax():
    rng = np.random.default_rng(8)
    g = {"a": rng.standard_normal(4).astype(np.float32),
         "b": [rng.standard_normal((2, 3)).astype(np.float32)]}
    e = {"a": rng.standard_normal(4).astype(np.float32),
         "b": [rng.standard_normal((2, 3)).astype(np.float32)]}
    tt = lambda t: {"a": torch.from_numpy(t["a"]),
                    "b": [torch.from_numpy(t["b"][0])]}
    got = error_feedback_update(tt(g), tt(e))
    want = jcompress.error_feedback_update(jax.tree.map(jnp.asarray, g),
                                           jax.tree.map(jnp.asarray, e))
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert error_feedback_update(g, None) is g
