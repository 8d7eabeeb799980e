"""The port's ``TrainLoop`` and layer remat against the JAX package's.

- ``TrainLoop`` on the smoke TinyLlama (the JAX package's ``TestTrainLoop``):
  the loss falls over 40 steps, and a loop that crashes after its step-20
  checkpoint resumes at step 20 with the pipeline at step 20 and then
  logs the uninterrupted run's losses bit for bit.
- ``cfg.remat``: ``"nothing"``, ``"dots"`` and ``"full"`` give bit-equal
  losses and gradient leaves on every ported family (the MoE on its
  ``dense``, ``gather`` and ``cuda_kernel`` impls); ``"dots"`` recomputes
  no 2-D product in the backward and ``"full"`` recomputes them all;
  prefill never remats.
- Under remat the MoE's fabric counts the JAX package's trace counts on the
  same loss and gradient calls: recompute adds no signature.
- A checkpoint that the JAX package's ``TrainLoop`` writes at step 2 of 4
  is resumed by the port's ``TrainLoop`` and by the JAX package's, each
  from its own copy; the port's losses at steps 2 and 3 agree with JAX's
  within 1e-4 relative (float32 smoke Mixtral: the two packages' products
  sum in different orders, about 1e-6 a step).
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models.lm import build_model as jax_build_model
from repro.runtime.train import TrainLoop as JTrainLoop
from repro.runtime.train import TrainLoopConfig as JTrainLoopConfig
from repro_torch.ckpt.convert import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.models import moe as tmoe
from repro_torch.models.common import tree_leaves
from repro_torch.models.lm import build_model, remat_wrap
from repro_torch.runtime import StragglerStats, TrainLoop, TrainLoopConfig


class _Crash(Exception):
    pass


def test_loss_decreases_and_resume_is_exact(tmp_path):
    cfg = get_config("tinyllama_1_1b", smoke=True)
    run = TrainLoopConfig(steps=40, global_batch=8, seq_len=64,
                          ckpt_every=20, log_every=1, lr=3e-3, warmup=5,
                          seed=1)
    full = TrainLoop(cfg, run, ckpt_dir=tmp_path / "full", device="cpu")
    hist = full.run_loop()
    losses = [h["loss"] for h in hist]
    assert [h["step"] for h in hist] == list(range(40))
    assert all(np.isfinite(losses))
    assert min(losses[-3:]) < losses[0], "loss did not decrease"
    again = TrainLoop(cfg, run, ckpt_dir=tmp_path / "full", resume=True,
                      device="cpu")
    assert again.start_step == 40 and again.pipeline.state().step == 40

    def crash_at_20(rec):
        if rec["step"] == 20:
            raise _Crash

    crashed = TrainLoop(cfg, run, ckpt_dir=tmp_path / "crash",
                        on_log=crash_at_20, device="cpu")
    with pytest.raises(_Crash):
        crashed.run_loop()
    resumed = TrainLoop(cfg, run, ckpt_dir=tmp_path / "crash", resume=True,
                        device="cpu")
    assert resumed.start_step == 20 and resumed.pipeline.state().step == 20
    assert resumed.opt_state.step == 20
    assert [h["loss"] for h in resumed.run_loop()] == losses[20:]


def test_loop_reports_to_straggler_stats_and_probe():
    cfg = get_config("tinyllama_1_1b", smoke=True)
    run = TrainLoopConfig(steps=3, global_batch=2, seq_len=16, log_every=1)
    stats = StragglerStats([0, 1])
    loop = TrainLoop(cfg, run, region=1, straggler_stats=stats,
                     device="cpu")
    loop.run_loop()
    assert stats.ewma[1] is not None and stats.ewma[0] is None
    assert loop.probe().sample()["straggler_score"] == {1: 1.0}
    assert not loop.watchdog.events
    with pytest.raises(ValueError):
        TrainLoop(cfg, run, device="cpu").probe()


# ----------------------------------------------------------------------
# remat
# ----------------------------------------------------------------------
FAMILIES = [("mixtral_8x7b", "dense"), ("mixtral_8x7b", "gather"),
            ("mixtral_8x7b", "cuda_kernel"), ("tinyllama_1_1b", None),
            ("mamba2_780m", None), ("recurrentgemma_9b", None)]


def _model(arch, dispatch, remat):
    cfg = get_config(arch, smoke=True)
    kw = dict(dtype="float32", remat=remat)
    if dispatch is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, dispatch=dispatch)
    return build_model(dataclasses.replace(cfg, **kw), device="cpu")


class _MMCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch,dispatch", FAMILIES)
def test_remat_policies_give_bit_equal_loss_and_grads(arch, dispatch):
    out = {}
    for remat in ("nothing", "dots", "full"):
        model = _model(arch, dispatch, remat)
        params = model.init(torch.Generator().manual_seed(0))
        batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
            0, 0, 0, 1, 2, 32, model.cfg.vocab).items()}
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        loss = model.loss(params, batch)
        count = _MMCount()
        with count:
            grads = torch.autograd.grad(loss, leaves)
        out[remat] = (loss.detach(), grads, count.n)
    loss0, grads0, mm0 = out["nothing"]
    for remat in ("dots", "full"):
        loss, grads, _ = out[remat]
        assert torch.equal(loss, loss0), remat
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0)), remat
    # "dots" keeps every 2-D product's output; "full" recomputes them
    assert out["dots"][2] == mm0 < out["full"][2]


def test_remat_wrap_applies_to_training_only():
    """Prefill never remats: its products run once, whatever the policy."""
    counts = []
    for remat in ("nothing", "full"):
        model = _model("tinyllama_1_1b", None, remat)
        params = model.init(torch.Generator().manual_seed(0))
        count = _MMCount()
        with count, torch.no_grad():
            model.prefill(params, {"tokens": torch.zeros((1, 8),
                                                          dtype=torch.int32)})
        counts.append(count.n)
    assert counts[0] == counts[1]
    fn = lambda x: x * 2
    assert remat_wrap(fn, "nothing") is fn


def test_fabric_trace_counts_under_remat_equal_jax():
    """The smoke Mixtral's loss and gradient twice, under remat "dots", on
    the ``reference`` fabric in both packages: the MoE's group fabric
    counts the same signatures (recompute adds none)."""
    cfg_j = dataclasses.replace(jax_get_config("mixtral_8x7b", smoke=True),
                                dtype="float32", remat="dots")
    cfg_j = dataclasses.replace(
        cfg_j, moe=dataclasses.replace(cfg_j.moe, dispatch="reference"))
    cfg_t = dataclasses.replace(get_config("mixtral_8x7b", smoke=True),
                                dtype="float32", remat="dots")
    cfg_t = dataclasses.replace(
        cfg_t, moe=dataclasses.replace(cfg_t.moe, dispatch="reference"))
    jmoe._group_fabric_cached.cache_clear()
    tmoe._group_fabric.cache_clear()
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.key(0))
    model_t = build_model(cfg_t, device="cpu")
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg_t,
                                 device="cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params_t)]
    B, S = 2, 32
    for step in range(2):
        batch = synthetic_batch(0, step, 0, 1, B, S, cfg_t.vocab)
        lj, _ = jax.value_and_grad(model_j.loss)(
            params_j, {k: jnp.asarray(v) for k, v in batch.items()})
        lt = model_t.loss(params_t, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
        torch.autograd.grad(lt, leaves)
        assert abs(float(lt.detach()) - float(lj)) <= 1e-5 * abs(float(lj))
    cap = tmoe.expert_capacity(B * S, cfg_t.moe)
    jf = jmoe.moe_fabric(cfg_j.moe.n_experts, cap, "reference")
    tf = tmoe.moe_fabric(cfg_t.moe.n_experts, cap, "reference",
                         kernel_mode=cfg_t.kernel_mode, device="cpu")
    assert tf.trace_counts == jf.trace_counts
    assert tf.trace_counts["dispatch"] == 1


# ----------------------------------------------------------------------
# a JAX-written checkpoint resumed by both packages' loops
# ----------------------------------------------------------------------
def test_port_loop_resumes_a_jax_checkpoint(tmp_path):
    kw = dict(steps=4, global_batch=2, seq_len=32, ckpt_every=2, ckpt_keep=2,
              log_every=1, lr=3e-3, warmup=1, seed=1)
    cfg_j = dataclasses.replace(jax_get_config("mixtral_8x7b", smoke=True),
                                dtype="float32")
    cfg_t = dataclasses.replace(get_config("mixtral_8x7b", smoke=True),
                                dtype="float32")
    assert cfg_t.moe.dispatch == cfg_j.moe.dispatch == "dense"
    jfull = [h["loss"] for h in JTrainLoop(
        cfg_j, JTrainLoopConfig(**kw), ckpt_dir=tmp_path / "jax").run_loop()]
    for name in ("port", "jax_again"):
        (tmp_path / name).mkdir()
        shutil.copytree(tmp_path / "jax" / "step_00000002",
                        tmp_path / name / "step_00000002")
    port = TrainLoop(cfg_t, TrainLoopConfig(**kw), ckpt_dir=tmp_path / "port",
                     resume=True, device="cpu")
    jres = JTrainLoop(cfg_j, JTrainLoopConfig(**kw),
                      ckpt_dir=tmp_path / "jax_again", resume=True)
    assert port.start_step == jres.start_step == 2
    assert port.pipeline.state().step == 2
    tl = [h["loss"] for h in port.run_loop()]
    jl = [h["loss"] for h in jres.run_loop()]
    assert jl == jfull[2:]                        # JAX's own resume is exact
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)
