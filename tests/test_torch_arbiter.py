"""The port's WRR arbiter against ``repro.core.arbiter``: plans, slots and
the scatter/gather data plane are bit-equal on the same seeded inputs
(isolation holes, quotas, resets, capacities, ``dst = -1`` padding)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (assert_same_plan, jax_registers, np_packets,
                         np_registers, to_np, torch_registers)
from repro.core import arbiter as jarb
from repro_torch.core import arbiter as tarb

jax_plan = jax.jit(jarb.wrr_dispatch_plan)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("T", [1, 7, 300])
@pytest.mark.parametrize("holes", [False, True])
def test_wrr_dispatch_plan_bit_equal(n, T, holes):
    rng = np.random.default_rng(1000 * n + T + holes)
    regs = np_registers(rng, n, capacity=6, holes=holes)
    dst, src = np_packets(rng, T, n)
    jplan = jax_plan(jnp.asarray(dst), jnp.asarray(src), jax_registers(regs))
    tplan = tarb.wrr_dispatch_plan(torch.from_numpy(dst),
                                   torch.from_numpy(src),
                                   torch_registers(regs))
    assert_same_plan(jplan, tplan)
    assert tplan.keep.dtype == torch.bool
    for f in ("slot", "dst", "error", "counts", "drops"):
        assert getattr(tplan, f).dtype == torch.int32, f


@pytest.mark.parametrize("seed", range(4))
def test_wrr_slots_bit_equal(seed):
    rng = np.random.default_rng(seed)
    n, T = 5, 200
    granted = rng.integers(0, 9, (n, n)).astype(np.int32)
    dstc = rng.integers(0, n, T).astype(np.int32)
    srcc = rng.integers(0, n, T).astype(np.int32)
    rank = rng.integers(0, 9, T).astype(np.int32)
    j = jarb.wrr_slots(jnp.asarray(rank), jnp.asarray(granted),
                       jnp.asarray(dstc), jnp.asarray(srcc)[None, :])
    t = tarb.wrr_slots(torch.from_numpy(rank), torch.from_numpy(granted),
                       torch.from_numpy(dstc), torch.from_numpy(srcc)[None, :])
    assert t.dtype == torch.int32
    assert np.array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity", [3, 8])
def test_dispatch_and_combine_bit_equal(dtype, capacity):
    rng = np.random.default_rng(7 + capacity)
    n, T, D = 4, 96, 16
    regs = np_registers(rng, n, capacity=8)
    dst, src = np_packets(rng, T, n)
    jplan = jax_plan(jnp.asarray(dst), jnp.asarray(src), jax_registers(regs))
    tplan = tarb.wrr_dispatch_plan(torch.from_numpy(dst),
                                   torch.from_numpy(src),
                                   torch_registers(regs))
    x = rng.standard_normal((T, D)).astype(np.float32)
    y = rng.standard_normal((n, capacity, D)).astype(np.float32)
    w = rng.random(T).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    # capacity 3 is a smaller slab than the plan granted into: the flat
    # address must trash those rows, never alias the next destination.
    j_slab = jarb.dispatch(jnp.asarray(x, jd), jplan, n, capacity)
    t_slab = tarb.dispatch(torch.from_numpy(x).to(td), tplan, n, capacity)
    assert np.array_equal(to_np(j_slab), to_np(t_slab))
    j_out = jarb.combine(jnp.asarray(y, jd), jplan, jnp.asarray(w, jd))
    t_out = tarb.combine(torch.from_numpy(y).to(td), tplan,
                         torch.from_numpy(w).to(td))
    assert np.array_equal(to_np(j_out), to_np(t_out))
    # the dense one-hot oracles agree with the port's scatter path
    assert np.array_equal(
        to_np(tarb.dispatch_dense(torch.from_numpy(x).to(td), tplan, n,
                                  capacity)), to_np(t_slab))
    assert np.array_equal(
        to_np(tarb.combine_dense(torch.from_numpy(y).to(td), tplan,
                                 torch.from_numpy(w).to(td))), to_np(t_out))


def test_stream_ranks_are_int32_and_stable():
    pair = torch.tensor([3, 1, 3, 3, 0, 1], dtype=torch.int32)
    alive = torch.tensor([True, True, False, True, True, True])
    r = tarb._stream_ranks(pair, alive, 4)
    assert r.dtype == torch.int32
    assert r.tolist() == [0, 0, 0, 1, 0, 1]
