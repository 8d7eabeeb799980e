"""The port's ``"dense"`` and ``"gather"`` MoE impls against the JAX
package's same impls and against the port's fabric impl.

T = 512 tokens (B=4, S=128), E = 8 experts, top-2, groups of 128, float32,
parameters from the JAX init, input from a numpy seed.  A capacity factor
of 0.5 makes capacity drops, and an expert mask that forbids 4 of the 8
experts with top-k = 5 makes isolation drops.

- Outputs agree with the JAX package's same impl within 1e-5 relative
  (absolute 1e-5; the expert matmuls of XLA and PyTorch sum in different
  orders); ``dropped``, ``iso_dropped`` and ``capacity`` are bit-equal,
  the aux loss within 1e-6 relative.
- Against the port's fabric impl (``reference`` and ``cuda_kernel``, the
  plain versions of the kernels on the CPU) the same grants give equal
  ``counts``, ``dropped`` and ``iso_dropped`` and outputs within 1e-6:
  dispatch and combine are exact in all three, only the one-hot einsums
  of the dense impl add zeros.
- The gradients of every MoE parameter and of the input agree with the
  fabric impl's within 1e-5 of the leaf's largest value.
- ``DenseLM`` builds from the smoke Mixtral config as it is (its MoE on the
  config's own ``"dense"``), and its loss equals the JAX package's within
  1e-6 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models.common import init_params
from repro.models.config import MoEConfig as JMoEConfig
from repro.models.lm import build_model as jax_build_model
from repro_torch.ckpt.convert import params_from_numpy
from repro_torch.configs import get_config as torch_get_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.models import moe as tmoe
from repro_torch.models.config import MoEConfig as TMoEConfig
from repro_torch.models.lm import DenseLM, build_model

B, S, D, F, E = 4, 128, 32, 48, 8
GROUP = 128
# (top-k, expert mask): capacity drops; and isolation drops (top-5 of 4
# allowed experts forces a masked choice)
ROUTINGS = {"capacity": (2, None),
            "isolation": (5, (True, False, True, False) * 2)}


def _inputs(seed, routing):
    k, mask = ROUTINGS[routing]
    moe_j = JMoEConfig(n_experts=E, top_k=k, capacity_factor=0.5)
    moe_t = TMoEConfig(n_experts=E, top_k=k, capacity_factor=0.5)
    params_j = init_params(jmoe.moe_defs(D, F, moe_j, "swiglu"),
                           jax.random.key(seed), jnp.float32)
    params_t = {n: torch.from_numpy(np.array(v)) for n, v in params_j.items()}
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)
    mask_j = None if mask is None else jnp.asarray(mask)
    mask_t = None if mask is None else torch.tensor(mask)
    return moe_j, params_j, mask_j, moe_t, params_t, mask_t, x


def _stats_equal(a, b, keys=("dropped", "iso_dropped", "capacity")):
    for f in keys:
        assert int(a[f]) == int(b[f]), (f, a[f], b[f])


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
@pytest.mark.parametrize("impl", ["dense", "gather"])
@pytest.mark.parametrize("seed", [0, 1])
def test_impl_matches_jax(impl, seed, routing):
    moe_j, params_j, mask_j, moe_t, params_t, mask_t, x = _inputs(seed,
                                                                  routing)
    yj, sj = jmoe.moe_apply(params_j, jnp.asarray(x), moe_j, "swiglu",
                            group_size=GROUP, expert_mask=mask_j,
                            dispatch_impl=impl)
    yt, st = tmoe.moe_apply(params_t, torch.from_numpy(x), moe_t, "swiglu",
                            group_size=GROUP, expert_mask=mask_t,
                            dispatch_impl=impl)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    _stats_equal(sj, st)
    assert int(st["dropped"]) > 0
    if routing == "isolation":
        assert int(st["iso_dropped"]) > 0
    np.testing.assert_allclose(float(st["aux_loss"]), float(sj["aux_loss"]),
                               rtol=1e-6)


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
@pytest.mark.parametrize("fabric", ["reference", "cuda_kernel"])
@pytest.mark.parametrize("seed", [0, 1])
def test_impls_match_the_fabric_impl(fabric, seed, routing):
    *_, moe_t, params_t, mask_t, x = _inputs(seed, routing)
    xt = torch.from_numpy(x)
    outs = {impl: tmoe.moe_apply(params_t, xt, moe_t, "swiglu",
                                 group_size=GROUP, expert_mask=mask_t,
                                 dispatch_impl=impl)
            for impl in ("dense", "gather", fabric)}
    yf, sf = outs[fabric]
    for impl in ("dense", "gather"):
        y, s = outs[impl]
        torch.testing.assert_close(y, yf, rtol=1e-6, atol=1e-6)
        _stats_equal(s, sf)
        assert torch.equal(s["counts"].long(), sf["counts"].long())
        torch.testing.assert_close(s["aux_loss"], sf["aux_loss"],
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("impl", ["dense", "gather"])
def test_impl_gradients_match_the_fabric_impl(impl):
    *_, moe_t, params_t, mask_t, x = _inputs(0, "capacity")

    def grads(dispatch_impl):
        p = {n: v.clone().requires_grad_() for n, v in params_t.items()}
        xt = torch.from_numpy(x).requires_grad_()
        y, s = tmoe.moe_apply(p, xt, moe_t, "swiglu", group_size=GROUP,
                              dispatch_impl=dispatch_impl)
        loss = (y * torch.linspace(-1, 1, D)).sum() + s["aux_loss"]
        return torch.autograd.grad(loss, [xt, *p.values()])

    for a, b in zip(grads(impl), grads("cuda_kernel")):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_dense_is_the_default_and_sharded_is_refused():
    *_, moe_t, params_t, _, x = _inputs(0, "capacity")
    xt = torch.from_numpy(x)
    y_default, _ = tmoe.moe_apply(params_t, xt, moe_t, "swiglu",
                                  group_size=GROUP)
    y_dense, _ = tmoe.moe_apply(params_t, xt, moe_t, "swiglu",
                                group_size=GROUP, dispatch_impl="dense")
    assert torch.equal(y_default, y_dense)
    block = dict(params_t, w_in=params_t["w_in"][:3],
                 w_out=params_t["w_out"][:3])
    with pytest.raises(ValueError, match="must divide n_experts"):
        tmoe.moe_apply(block, xt, moe_t, "swiglu", dispatch_impl="sharded")
    with pytest.raises(ValueError, match="unknown fabric backend"):
        tmoe.moe_apply(params_t, xt, moe_t, "swiglu", dispatch_impl="nope")


def test_moe_fabric_is_the_cached_group_fabric():
    *_, moe_t, params_t, _, x = _inputs(0, "capacity")
    cap = tmoe.expert_capacity(GROUP, moe_t)
    fab = tmoe.moe_fabric(E, cap, "reference", device="cpu")
    before = fab.trace_count
    tmoe.moe_apply(params_t, torch.from_numpy(x), moe_t, "swiglu",
                   group_size=GROUP, dispatch_impl="reference")
    assert fab is tmoe.moe_fabric(E, cap, "reference", kernel_mode="auto",
                                  device="cpu")
    assert fab.trace_count >= max(before, 2)     # dispatch and combine ran
    assert fab.debug is False


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "mixtral_8x22b"])
def test_published_moe_config_builds_and_matches_jax(arch):
    """The port's normal entry point on a published MoE config, unchanged:
    ``build_model(get_config(arch, smoke=True))`` with the config's own
    ``"dense"`` dispatch (float32 for the comparison)."""
    cfg_t = torch_get_config(arch, smoke=True)
    assert cfg_t.moe.dispatch == "dense"
    DenseLM(cfg_t, device="cpu")                  # builds as published
    cfg_t = dataclasses.replace(cfg_t, dtype="float32")
    cfg_j = dataclasses.replace(jax_get_config(arch, smoke=True),
                                dtype="float32")
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.key(0))
    model_t = build_model(cfg_t, device="cpu")
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg_t,
                                 device="cpu")
    batch = synthetic_batch(0, 0, 0, 1, 2, 64, cfg_t.vocab)
    lj = float(model_j.loss(params_j, {k: jnp.asarray(v)
                                       for k, v in batch.items()}))
    lt = float(model_t.loss(params_t, {k: torch.from_numpy(v)
                                       for k, v in batch.items()}))
    assert abs(lt - lj) <= 1e-6 * abs(lj), (lt, lj)
