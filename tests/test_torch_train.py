"""The port's training path against the JAX package: ``DenseLM.loss`` and
its gradients, one ``make_train_step`` with ``AdamW`` (also with
microbatches), and ``DenseLM.prefill``, on the smoke Mixtral in float32.

Parameters are the JAX initialisation converted with
``repro_torch.ckpt.convert``; batches come from ``synthetic_batch`` (the
port's copy gives the JAX package's tokens).  The MoE runs on JAX's
``reference`` against the port's ``reference``, and on JAX's Pallas
kernel data plane (interpret mode) against the port's ``cuda_kernel``.

Tolerances.  The loss agrees within 1e-6 relative.  Every piece of the
model (attention, norms, rope, MoE) agrees with JAX within about 1e-7
relative, but the smoke model's gradients are ill-conditioned: the
embeddings have std 1/sqrt(2048) and pass through RMSNorm, which scales
the rounding differences of the deeper layers up by some 50x.  The
measured worst leaf is 5e-4 of the leaf's largest gradient, so gradients
and the AdamW moments are held within 2e-3 of their leaf's largest value.
The step itself is held by its update (new minus old parameter) against
JAX's, within 1e-3 of the learning rate (1e-6 absolute; measured worst
2.5e-7, the float32 rounding of the new parameter), on every element
whose first moment agrees with JAX's to 1e-3 of itself.  There the
normalised step ``m / (sqrt(v) + eps)`` agrees to about 1e-3 whatever
|g| is; on the others (about 2% of the elements, at most an eighth of any
leaf) a gradient near the rounding noise can flip the step's sign.  The
check sees a learning rate off by 0.2% and the weight-decay term
(``lr * 0.1 * p``: 1e-4 on the norm weights).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import smoke_mixtral
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.fabric import PallasBackend, register_fabric_backend
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models.lm import build_model as jax_build_model
from repro.optim.adamw import AdamW as JaxAdamW
from repro_torch.ckpt.convert import (opt_state_from_numpy,
                                      opt_state_to_numpy, params_from_numpy,
                                      params_to_numpy)
from repro_torch.configs import get_config as torch_get_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import DenseLM
from repro_torch.optim.adamw import AdamW, cosine_schedule

JAX_KERNEL_BACKEND = "pallas_kernel_test"
register_fabric_backend(
    JAX_KERNEL_BACKEND, lambda **kw: PallasBackend(data_plane="kernel", **kw))

# (JAX dispatch, JAX kernel mode, port dispatch)
PATHS = {"reference": ("reference", "auto", "reference"),
         "kernel": (JAX_KERNEL_BACKEND, "pallas_interpret", "cuda_kernel")}
B, S = 2, 64
LR = 1e-3
GRAD_REL = 2e-3
UPDATE_TOL = 1e-3 * LR
M_AGREE = 1e-3


def _setup(path):
    jd, jmode, td = PATHS[path]
    cfg_j = smoke_mixtral(jd, kernel_mode=jmode)(jax_get_config)
    cfg_t = smoke_mixtral(td)(torch_get_config)
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.key(0))
    model_t = DenseLM(cfg_t, device="cpu")
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg_t,
                                 device="cpu")
    batch = synthetic_batch(0, 0, 0, 1, B, S, cfg_t.vocab)
    return model_j, params_j, model_t, params_t, batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_trees_close(tree_j, tree_np, *, rel=None, atol=None):
    leaves = jax.tree_util.tree_leaves_with_path(tree_j)
    assert len(leaves) == len(jax.tree_util.tree_leaves(tree_np))
    for path, a in leaves:
        b = tree_np
        for k in path:
            b = b[k.key]
        a = np.asarray(a, np.float32)
        tol = atol if atol is not None else rel * float(np.abs(a).max())
        err = float(np.abs(a - b).max())
        assert err <= tol, (jax.tree_util.keystr(path), err, tol)


def _assert_updates_close(old, new_j, new_np, m_j, m_np):
    """Updates (new - old) equal to JAX's within ``UPDATE_TOL`` wherever
    the first moments agree to ``M_AGREE`` of JAX's; that covers at least
    half of every leaf."""
    leaves = lambda t: jax.tree_util.tree_leaves(t)
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_leaves_with_path(new_j)]
    for name, o, a, b, mj, mt in zip(paths, leaves(old), leaves(new_j),
                                     leaves(new_np), leaves(m_j),
                                     leaves(m_np)):
        o, a, mj = (np.asarray(t, np.float32) for t in (o, a, mj))
        agree = np.abs(mt - mj) <= M_AGREE * np.abs(mj)
        assert agree.mean() >= 0.5, (name, float(agree.mean()))
        err = float(np.abs((a - o) - (b - o))[agree].max())
        assert err <= UPDATE_TOL, (name, err, UPDATE_TOL)


def test_synthetic_batch_copy_gives_the_jax_tokens():
    for step in (0, 3):
        a = jax_synthetic_batch(7, step, 1, 2, 4, 33, 512)
        b = synthetic_batch(7, step, 1, 2, 4, 33, 512)
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("path", sorted(PATHS))
def test_loss_and_every_gradient_leaf_match_jax(path):
    model_j, params_j, model_t, params_t, batch = _setup(path)
    loss_j, grads_j = jax.value_and_grad(model_j.loss)(params_j,
                                                      _jax_batch(batch))
    leaves = [p.requires_grad_() for p in jax.tree_util.tree_leaves(params_t)]
    loss_t = model_t.loss(params_t, batch)
    grads = torch.autograd.grad(loss_t, leaves)
    assert all(float(g.abs().max()) > 0 for g in grads)
    it = iter(grads)
    grads_t = jax.tree.map(lambda _: next(it), params_t)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-6)
    _assert_trees_close(grads_j, params_to_numpy(grads_t), rel=GRAD_REL)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_adamw_train_step_matches_jax(path, microbatches):
    model_j, params_j, model_t, params_t, batch = _setup(path)
    old = jax.tree.map(np.asarray, params_j)
    opt_j, opt_t = JaxAdamW(lr=LR), AdamW(lr=LR)
    new_j, state_j, loss_j = jax_make_train_step(model_j, opt_j, microbatches)(
        params_j, opt_j.init(params_j), _jax_batch(batch))
    new_t, state_t, loss_t = make_train_step(model_t, opt_t, microbatches)(
        params_t, opt_t.init(params_t), batch)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    step, m, v = opt_state_to_numpy(state_t)
    assert step == int(state_j.step) == 1
    _assert_trees_close(state_j.m, m, rel=GRAD_REL)
    _assert_trees_close(state_j.v, v, rel=GRAD_REL)
    _assert_updates_close(old, new_j, params_to_numpy(new_t), state_j.m, m)


def test_optimizer_state_round_trips_through_the_jax_layout():
    _, params_j, _, params_t, _ = _setup("reference")
    rng = np.random.default_rng(0)
    noise = lambda a: rng.standard_normal(np.shape(a)).astype(np.float32)
    m = jax.tree.map(noise, params_j)
    v = jax.tree.map(noise, params_j)
    cfg_t = smoke_mixtral("reference")(torch_get_config)
    state = opt_state_from_numpy(5, m, v, cfg_t, device="cpu")
    assert state.step == 5
    assert all(t.dtype == torch.float32
               for t in jax.tree_util.tree_leaves(state.m))
    step, m2, v2 = opt_state_to_numpy(state)
    assert step == 5
    _assert_trees_close(m, m2, atol=0.0)
    _assert_trees_close(v, v2, atol=0.0)
    _assert_trees_close(params_j, params_to_numpy(params_t), atol=0.0)


def test_cosine_schedule_matches_jax():
    from repro.optim.adamw import cosine_schedule as jax_cosine_schedule
    lr_j, lr_t = jax_cosine_schedule(3e-4, 10, 100), cosine_schedule(3e-4, 10, 100)
    for step in (0, 1, 9, 10, 11, 55, 100, 150):
        np.testing.assert_allclose(lr_t(step), float(lr_j(step)), rtol=1e-6)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_prefill_logits_match_jax(path):
    model_j, params_j, model_t, params_t, batch = _setup(path)
    logits_j = model_j.prefill(params_j, {"tokens": jnp.asarray(batch["tokens"])})
    with torch.no_grad():
        logits_t = model_t.prefill(params_t, {"tokens": batch["tokens"]})
    assert logits_t.shape == (B, model_t.cfg.vocab_padded)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=2e-5, atol=2e-5)


def test_one_kernel_mode_switch_reaches_attention_and_moe():
    """``ModelConfig.kernel_mode`` is the model's one switch: ``"cuda"``
    on CPU tensors raises in the flash attention of ``loss`` and in the
    MoE's crossbar of ``decode_step``, and launches nothing."""
    import dataclasses
    from repro_torch.kernels.crossbar_dispatch import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK
    _, _, model_t, params_t, batch = _setup("kernel")
    model = DenseLM(dataclasses.replace(model_t.cfg, kernel_mode="cuda"),
                    device="cpu")
    before = {**K.launch_counts(), **FK.launch_counts()}
    with pytest.raises(ValueError, match="CUDA"):
        model.loss(params_t, batch)
    with pytest.raises(ValueError, match="CUDA"):
        model.decode_step(params_t, model.init_decode_state(B, 4),
                          {"tokens": torch.zeros((B, 1), dtype=torch.int32)})
    assert {**K.launch_counts(), **FK.launch_counts()} == before


def test_loss_seeds_runs_only_on_a_card():
    """``python -m repro_torch.launch.loss_seeds`` measures the card's train
    cell; without a CUDA device it stops instead of training on the CPU."""
    from repro_torch.launch import loss_seeds
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="CUDA"):
        loss_seeds.main(["--seeds", "0"])
    cfg = loss_seeds.train_config()
    assert (cfg.n_layers, cfg.dtype, cfg.moe.dispatch) == (
        2, "bfloat16", "cuda_kernel")


def test_smoke_widths_runs_only_on_a_card():
    """``python -m repro_torch.launch.smoke_widths`` holds the smoke configs
    on the card's kernels; without a CUDA device it stops at once, and its
    MoE configs dispatch through the crossbar kernels."""
    from repro_torch.launch import smoke_widths
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert smoke_widths.main([]) == 1
    cfg = smoke_widths.smoke_config("mixtral_8x7b", "float32")
    assert (cfg.dtype, cfg.kernel_mode, cfg.moe.dispatch) == (
        "float32", "auto", "cuda_kernel")
    assert set(smoke_widths.ARCHS) == {
        a for a in smoke_widths.ARCHS
        if smoke_widths.get_config(a, True).family
        in smoke_widths.FAMILY_KERNELS}
