"""The port's ``moe_apply_fabric`` on ``cuda_kernel`` (CPU: the plain
versions of the three kernels) against the JAX package's through a
``PallasBackend(data_plane="kernel")`` registered for the test, run with
``kernel_mode="pallas_interpret"``.  Same numpy-seeded input, parameters
converted from the JAX init.

Plans (routing, keep, slot, error codes, counts) and drop statistics are
bit-equal.  Outputs match within 1e-5 (absolute and relative, float32):
the expert matmuls of XLA and PyTorch sum in different orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_same_plan
from repro.fabric import PallasBackend, register_fabric_backend
from repro.models import moe as jmoe
from repro.models.common import init_params
from repro.models.config import MoEConfig as JMoEConfig
from repro_torch.models import moe as tmoe
from repro_torch.models.config import MoEConfig as TMoEConfig

JAX_BACKEND = "pallas_kernel_test"
register_fabric_backend(
    JAX_BACKEND, lambda **kw: PallasBackend(data_plane="kernel", **kw))

B, S, D, F, E, K = 4, 16, 32, 48, 4, 2
GROUP = 16


def _inputs(seed):
    key = jax.random.key(seed)
    moe_j = JMoEConfig(n_experts=E, top_k=K, capacity_factor=0.5)
    params_j = init_params(jmoe.moe_defs(D, F, moe_j, "swiglu"), key,
                           jnp.float32)
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)
    params_t = {k: torch.from_numpy(np.array(v)) for k, v in params_j.items()}
    moe_t = TMoEConfig(n_experts=E, top_k=K, capacity_factor=0.5)
    return moe_j, params_j, moe_t, params_t, x


@pytest.mark.parametrize("mask", [None, (True, False, True, True)])
@pytest.mark.parametrize("seed", [0, 1])
def test_moe_fabric_kernel_path_matches_jax(seed, mask):
    moe_j, params_j, moe_t, params_t, x = _inputs(seed)
    mask_j = None if mask is None else jnp.asarray(mask)
    mask_t = None if mask is None else torch.tensor(mask)
    yj, sj = jmoe.moe_apply_fabric(params_j, jnp.asarray(x), moe_j, "swiglu",
                                   group_size=GROUP, expert_mask=mask_j,
                                   backend=JAX_BACKEND,
                                   kernel_mode="pallas_interpret")
    yt, st = tmoe.moe_apply_fabric(params_t, torch.from_numpy(x), moe_t,
                                   "swiglu", group_size=GROUP,
                                   expert_mask=mask_t, backend="cuda_kernel")
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    for f in ("dropped", "iso_dropped", "capacity"):
        assert int(sj[f]) == int(st[f]), f
    assert int(st["dropped"]) > 0                 # capacity cuts something
    np.testing.assert_allclose(float(st["aux_loss"]), float(sj["aux_loss"]),
                               rtol=1e-6)

    # plan by plan: the JAX group fabric replanned on the same routing
    cap = jmoe.expert_capacity(GROUP, moe_j)
    jfab = jmoe.moe_fabric(E, cap, JAX_BACKEND,
                           kernel_mode="pallas_interpret")
    dst_j, _, _ = jmoe._moe_router(params_j, jnp.asarray(x).reshape(-1, D),
                                   moe_j, mask_j)
    dst_t, _, _ = tmoe._moe_router(params_t, torch.from_numpy(x).reshape(-1, D),
                                   moe_t, mask_t)
    assert np.array_equal(np.asarray(dst_j), dst_t.numpy())
    src = jnp.zeros((GROUP * K,), jnp.int32)
    allowed = (jnp.broadcast_to(mask_j[None, :], (E, E)) if mask is not None
               else jnp.ones((E, E), bool))
    regs = dataclasses.replace(jfab.registers, allowed=allowed)
    for g, tplan in enumerate(st["plans"]):
        dg = jnp.asarray(dst_j).reshape(-1, GROUP * K)[g]
        assert_same_plan(jfab.plan(dg, src, registers=regs), tplan)


def test_moe_apply_names_fabric_backends_only():
    """Besides the "dense", "gather" and "sharded" impls, ``moe_apply``
    routes only through fabric backends: the sharded impl refuses an
    expert block that does not divide the experts, unknown names raise;
    the fabric backends are plan-equivalent."""
    _, _, moe_t, params_t, x = _inputs(0)
    block = dict(params_t, w_in=params_t["w_in"][:3],
                 w_out=params_t["w_out"][:3])
    with pytest.raises(ValueError, match="divide"):
        tmoe.moe_apply(block, torch.from_numpy(x), moe_t, "swiglu",
                       dispatch_impl="sharded")
    with pytest.raises(ValueError):
        tmoe.moe_apply(params_t, torch.from_numpy(x), moe_t, "swiglu",
                       dispatch_impl="no_such_backend")
    y, _ = tmoe.moe_apply(params_t, torch.from_numpy(x), moe_t, "swiglu",
                          group_size=GROUP, dispatch_impl="reference")
    y2, _ = tmoe.moe_apply(params_t, torch.from_numpy(x), moe_t, "swiglu",
                           group_size=GROUP, dispatch_impl="cuda_kernel")
    assert torch.equal(y, y2)                     # plan-equivalent backends
