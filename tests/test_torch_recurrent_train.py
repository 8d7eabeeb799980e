"""Training the recurrent families, against the JAX package, on the CPU:
the smoke Mamba-2 (``SSMLM``) and the smoke RecurrentGemma (``HybridLM``)
in float32, with the port's parameters converted from the JAX
initialisation by ``params_from_numpy`` and batches from
``synthetic_batch``.

- ``loss`` and every gradient leaf against ``jax.value_and_grad`` of the
  JAX model's ``loss``.  The port's scans are autograd Functions whose CPU
  backward is the backward kernels' plain version (``ssd_bwd_ref``,
  ``rglru_bwd_ref``, ``attention_bwd_ref``); JAX differentiates its jnp
  scans.
- One ``make_train_step`` with ``AdamW`` (microbatches 1 and 2) against
  ``repro.launch.steps.make_train_step``: the loss, both moments and the
  update, as ``tests/test_torch_train.py`` holds the Mixtral.
- On the port alone: remat ``"dots"`` gives the gradients of
  ``"nothing"`` bit for bit, and the Functions' explicit backward equals
  autograd through the plain forward of the same scans.

Tolerances.  The SSM's loss agrees within 1e-6 relative (measured 8e-8)
and every gradient leaf within 1e-4 of the leaf's largest value (measured
worst 3.3e-5, ``a_log``).  The hybrid's loss within 1e-5 (measured 7e-7),
but its gradients are ill-conditioned: the smoke model's recurrence gates
drive thousands of decays ``a = exp(-8 softplus(L) r)`` within 1e-5 of 1,
where the gated input's ``sqrt(max(1 - a^2, 1e-12))`` has a derivative of
up to 1e6 and the two packages' float32 ``exp`` differ by one ulp.  Moving
half of the port's own decays by one ulp moves its gradient leaves by up
to 7.4e-3 of their largest value; against JAX the worst leaf is 2.6e-2
(the first block's ``w_gate``) and the worst relative L2 distance 8.8e-3,
so the hybrid's leaves are held within 5e-2 of their largest value and
2e-2 in relative L2.  The explicit backward itself is held tighter, on the
port alone: within 1e-5 of autograd through the plain forward (measured
2e-6 for the hybrid).  The train step's update is held as in
``test_torch_train.py``: within 1e-3 of the learning rate wherever the
first moments agree to 1e-3 of themselves (the SSM), and for the hybrid,
whose moments agree to 1e-3 on as little as 9% of a leaf, within 1e-2 of
the learning rate (measured 2.5e-3: the step g / (|g| + eps) of a small g
moves with it) wherever they agree to 1e-2 (at least half of every leaf;
measured 56% of the worst).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models.lm import build_model as jax_build_model
from repro.optim.adamw import AdamW as JaxAdamW
from repro_torch.ckpt.convert import opt_state_to_numpy, params_from_numpy, \
    params_to_numpy
from repro_torch.configs import get_config as torch_get_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.kernels.rglru import ref as rglru_ref
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.launch.steps import make_train_step
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import tree_leaves
from repro_torch.models.lm import build_model
from repro_torch.optim.adamw import AdamW

ARCHS = ["mamba2_780m", "recurrentgemma_9b"]
B, S = 2, 64
LR = 1e-3
LOSS_REL = {"mamba2_780m": 1e-6, "recurrentgemma_9b": 1e-5}
GRAD_REL = {"mamba2_780m": 1e-4, "recurrentgemma_9b": 5e-2}
GRAD_L2 = 2e-2          # the hybrid's leaves, relative L2
SELF_REL = 1e-5         # explicit backward vs autograd of the plain forward
UPDATE_TOL = {"mamba2_780m": 1e-3 * LR, "recurrentgemma_9b": 1e-2 * LR}
M_AGREE = {"mamba2_780m": 1e-3, "recurrentgemma_9b": 1e-2}


def _setup(arch, **cfg_kw):
    f32 = lambda cfg: dataclasses.replace(cfg, dtype="float32",  # noqa: E731
                                          **cfg_kw)
    cfg_j = f32(jax_get_config(arch, smoke=True))
    cfg_t = f32(torch_get_config(arch, smoke=True))
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.key(0))
    model_t = build_model(cfg_t, device="cpu")
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg_t,
                                 device="cpu")
    batch = synthetic_batch(0, 0, 0, 1, B, S, cfg_t.vocab)
    return model_j, params_j, model_t, params_t, batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_grads(model, params, batch):
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return float(loss.detach()), jax.tree.map(lambda _: next(it), params)


def _pairs(tree_j, tree_np):
    """(path, JAX leaf, port leaf) in JAX's order, the port's tree in the
    JAX layout (``params_to_numpy``)."""
    out = []
    for path, a in jax.tree_util.tree_leaves_with_path(tree_j):
        b = tree_np
        for k in path:
            b = b[k.key]
        out.append((jax.tree_util.keystr(path), np.asarray(a, np.float64),
                    np.asarray(b, np.float64)))
    assert len(out) == len(jax.tree_util.tree_leaves(tree_np))
    return out


def _assert_leaves_close(arch, tree_j, tree_np):
    for name, a, b in _pairs(tree_j, tree_np):
        scale = float(np.abs(a).max())
        assert scale > 0, name
        err = float(np.abs(a - b).max())
        assert err <= GRAD_REL[arch] * scale, (name, err, scale)
        if arch == "recurrentgemma_9b":
            l2 = float(np.linalg.norm(a - b) / np.linalg.norm(a))
            assert l2 <= GRAD_L2, (name, l2)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(arch):
    model_j, params_j, model_t, params_t, batch = _setup(arch)
    loss_j, grads_j = jax.value_and_grad(model_j.loss)(params_j,
                                                      _jax_batch(batch))
    loss_t, grads_t = _port_grads(model_t, params_t, batch)
    np.testing.assert_allclose(loss_t, float(loss_j), rtol=LOSS_REL[arch])
    _assert_leaves_close(arch, grads_j, params_to_numpy(grads_t))


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_train_step_matches_jax(arch, microbatches):
    model_j, params_j, model_t, params_t, batch = _setup(arch)
    old = jax.tree.map(np.asarray, params_j)
    opt_j, opt_t = JaxAdamW(lr=LR), AdamW(lr=LR)
    new_j, state_j, loss_j = jax_make_train_step(model_j, opt_j, microbatches)(
        params_j, opt_j.init(params_j), _jax_batch(batch))
    new_t, state_t, loss_t = make_train_step(model_t, opt_t, microbatches)(
        params_t, opt_t.init(params_t), batch)
    np.testing.assert_allclose(float(loss_t), float(loss_j),
                               rtol=LOSS_REL[arch])
    step, m, v = opt_state_to_numpy(state_t)
    assert step == int(state_j.step) == 1
    # m is (1 - b1) g: the gradients' tolerance; v is (1 - b2) g^2, twice
    # the relative error
    _assert_leaves_close(arch, state_j.m, m)
    for name, a, b in _pairs(state_j.v, v):
        scale = float(np.abs(a).max())
        assert float(np.abs(a - b).max()) <= 2 * GRAD_REL[arch] * scale, name
    new_np = params_to_numpy(new_t)
    for (name, a, b), (_, mj, mt), (_, o, _) in zip(
            _pairs(new_j, new_np), _pairs(state_j.m, m), _pairs(old, old)):
        agree = np.abs(mt - mj) <= M_AGREE[arch] * np.abs(mj)
        assert agree.mean() >= 0.5, (name, float(agree.mean()))
        err = float(np.abs((a - o) - (b - o))[agree].max())
        assert err <= UPDATE_TOL[arch], (name, err, UPDATE_TOL[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_dots_gives_the_gradients_of_nothing(arch):
    """Recompute runs the same deterministic scans and their explicit
    backward again: bit for bit."""
    grads = {}
    for policy in ("nothing", "dots"):
        _, _, model_t, params_t, batch = _setup(arch, remat=policy)
        grads[policy] = _port_grads(model_t, params_t, batch)
    (ln, gn), (ld, gd) = grads["nothing"], grads["dots"]
    assert ln == ld
    for a, b in zip(tree_leaves(gn), tree_leaves(gd)):
        assert torch.equal(a, b)


def _plain_ssd_scan(x, dt, A, Bm, Cm, *, chunk, h0=None, mode=None):
    """``ssd_scan`` with autograd through the plain forward."""
    chunk = min(chunk, x.shape[1])
    dth = dt.transpose(1, 2).float()
    y, h_last = ssd_ref.ssd_call_ref(x.transpose(1, 2),
                                     dth * A.float()[None, :, None], dth,
                                     Bm, Cm, chunk, h0)
    return y.transpose(1, 2), h_last


def _plain_rglru_scan(u, a, h0=None, *, mode=None):
    h, h_last = rglru_ref.rglru_call_ref(a.float(), u.float(), h0)
    return h.to(u.dtype), h_last


@pytest.mark.parametrize("arch", ARCHS)
def test_explicit_backward_equals_autograd_through_the_plain_forward(
        arch, monkeypatch):
    """The scans' Functions (explicit backward formulas, the kernels'
    algebra) against autograd through the plain chunked forward of the same
    scans, in the whole smoke model: within 1e-5 of each leaf's largest
    value (measured 2e-6)."""
    _, _, model_t, params_t, batch = _setup(arch)
    loss_fn, g_fn = _port_grads(model_t, params_t, batch)
    monkeypatch.setattr(ssm_mod, "ssd_scan", _plain_ssd_scan)
    monkeypatch.setattr(rglru_mod, "rglru_scan_kernel", _plain_rglru_scan)
    _, _, model_t, params_t, batch = _setup(arch)
    loss_ag, g_ag = _port_grads(model_t, params_t, batch)
    np.testing.assert_allclose(loss_fn, loss_ag, rtol=1e-6)
    for a, b in zip(tree_leaves(g_fn), tree_leaves(g_ag)):
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= SELF_REL * scale
