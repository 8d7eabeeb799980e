"""The single-source plan and the deprecated crossbar shims of the port
against the JAX package, on the CPU.

The port's ``plan_ref`` and ``crossbar_plan`` (its plain version on CPU
tensors) are held bit-equal to the JAX package's ``crossbar_plan`` (the
Pallas ``plan_call`` in interpret mode) and ``ref.plan_ref`` at the four
shapes of ``tests/test_kernels.py``, with the zero-packet case and ``dst``
outside ``[0, S)``; the scatter and combine shims likewise.  The legacy
``core.crossbar`` shims (``pairwise_dispatch_plan``, ``exchange_local``,
``combine_local``, ``CrossbarInterconnect``) are held against
``repro.core.crossbar``, including what its register gathers and
``take_along_axis`` return for ``dst`` outside ``[0, S)``.  Inputs are
seeded numpy arrays.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (assert_same_plan, assert_same_registers,
                         jax_registers, np_registers, to_np, torch_registers)
from repro.core import crossbar as jxb
from repro.kernels.crossbar_dispatch import ref as xref
from repro.kernels.crossbar_dispatch.ops import (
    crossbar_combine as jcombine, crossbar_dispatch as jdispatch,
    crossbar_plan as jplan)
from repro_torch.core import crossbar as txb
from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels import (crossbar_combine, crossbar_dispatch,
                                 crossbar_plan)
from repro_torch.kernels.crossbar_dispatch import kernel as K
from repro_torch.kernels.crossbar_dispatch import ref

SHAPES = [(512, 4, 64, 128, 128), (300, 8, 32, 64, 128),
          (1024, 16, 128, 256, 256), (64, 4, 8, 128, 64)]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _inputs(T, S, C, D, seed, out_of_range=False):
    """test_kernels.py's inputs, drawn with numpy: dst, x, w and one
    source's register rows (isolation holes, at least one, and at least
    one open port; quota 0 = unlimited on every third port, C // 2
    elsewhere)."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, S, T).astype(np.int32)
    if out_of_range:
        bad = rng.random(T) < 0.15
        dst[bad] = rng.choice(np.array([-1, -2, S, S + 3, -S - 1], np.int32),
                              bad.sum())
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = rng.random(T).astype(np.float32)
    allowed = (rng.random(S) > 0.25).astype(np.int32)
    hole = rng.integers(0, S)
    allowed[hole], allowed[(hole + 1) % S] = 0, 1
    quota = np.where(np.arange(S) % 3 == 0, 0, C // 2).astype(np.int32)
    cap = np.full((S,), C, np.int32)
    return dst, x, w, allowed, quota, cap


def _assert_equal(jax_out, torch_out):
    for a, b in zip(jax_out, torch_out):
        np.testing.assert_array_equal(np.asarray(a), to_np(b))


@pytest.mark.parametrize("out_of_range", [False, True])
@pytest.mark.parametrize("T,S,C,D,block_t", SHAPES)
def test_plan_matches_jax_kernel_and_ref(T, S, C, D, block_t, out_of_range):
    dst, _, _, allowed, quota, cap = _inputs(T, S, C, D, T + S, out_of_range)
    j_kernel = jplan(*map(jnp.asarray, (dst, allowed, quota, cap)),
                     block_t=block_t)
    j_ref = xref.plan_ref(*map(jnp.asarray, (dst, allowed, quota, cap)), S)
    t_ref = ref.plan_ref(*_t(dst, allowed, quota, cap))
    t_shim = crossbar_plan(*_t(dst, allowed, quota, cap))
    _assert_equal(j_kernel, t_ref)
    _assert_equal(j_ref, t_ref)
    _assert_equal(j_kernel, t_shim)
    keep, slot, err, counts = t_ref
    assert int(keep.sum()) > 0 and int((err == 1).sum()) > 0
    if out_of_range:
        assert int((err[(dst < 0) | (dst >= S)] != 1).sum()) == 0


def test_quota_and_capacity_drops_take_up_a_rank():
    """One port, quota 2 and capacity 3, every packet allowed: ranks run
    0, 1, 2, ... over all packets; 0-1 kept, the rest GRANT_TIMEOUT (quota
    is checked first), and capacity alone cuts at rank 3."""
    dst = np.zeros(6, np.int32)
    one = np.ones(1, np.int32)
    keep, slot, err, counts = ref.plan_ref(*_t(dst, one, 2 * one, 3 * one))
    assert keep.tolist() == [1, 1, 0, 0, 0, 0]
    assert slot.tolist() == [0, 1, 0, 0, 0, 0]
    assert err.tolist() == [0, 0, 2, 2, 2, 2] and counts.tolist() == [2]
    keep, slot, err, counts = ref.plan_ref(*_t(dst, one, 0 * one, 3 * one))
    assert slot.tolist() == [0, 1, 2, 0, 0, 0]
    assert err.tolist() == [0, 0, 0, 3, 3, 3] and counts.tolist() == [3]
    j = jplan(*map(jnp.asarray, (dst, one, 0 * one, 3 * one)), block_t=8)
    _assert_equal(j, (keep, slot, err, counts))


def test_zero_packet_plan():
    S = 4
    rows = [np.ones(S, np.int32)] * 3
    keep, slot, err, counts = crossbar_plan(torch.zeros(0, dtype=torch.int32),
                                            *_t(*rows))
    assert keep.shape == slot.shape == err.shape == (0,)
    assert counts.tolist() == [0] * S and counts.dtype == torch.int32
    j = jplan(jnp.zeros((0,), jnp.int32), *map(jnp.asarray, rows))
    _assert_equal(j, (keep, slot, err, counts))


@pytest.mark.parametrize("T,S,C,D,block_t", SHAPES)
def test_dispatch_and_combine_shims_match_jax(T, S, C, D, block_t):
    dst, x, w, allowed, quota, cap = _inputs(T, S, C, D, T * S)
    keep, slot, _, _ = crossbar_plan(*_t(dst, allowed, quota, cap))
    jkeep, jslot, _, _ = jplan(*map(jnp.asarray, (dst, allowed, quota, cap)),
                               block_t=block_t)
    slab = crossbar_dispatch(torch.from_numpy(x), torch.from_numpy(dst), keep,
                             slot, n_ports=S, capacity=C)
    jslab = jdispatch(jnp.asarray(x), jnp.asarray(dst), jkeep, jslot,
                      n_ports=S, capacity=C, block_t=block_t)
    np.testing.assert_array_equal(np.asarray(jslab), slab.numpy())
    y = slab * 1.5
    back = crossbar_combine(y, torch.from_numpy(dst), keep, slot,
                            torch.from_numpy(w))
    jback = jcombine(jnp.asarray(y.numpy()), jnp.asarray(dst), jkeep, jslot,
                     jnp.asarray(w), block_t=block_t)
    # one float32 product per element in both: equal to the last bit
    np.testing.assert_array_equal(np.asarray(jback), back.numpy())


def test_public_shims_warn_deprecated():
    dst, x, w, allowed, quota, cap = _inputs(16, 4, 8, 8, 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        keep, slot, _, _ = crossbar_plan(*_t(dst, allowed, quota, cap))
        slab = crossbar_dispatch(*_t(x, dst), keep, slot, n_ports=4,
                                 capacity=8)
        crossbar_combine(slab, torch.from_numpy(dst), keep, slot,
                         torch.from_numpy(w))
    msgs = [str(c.message) for c in caught
            if issubclass(c.category, DeprecationWarning)]
    assert len(msgs) == 3 and all(m.startswith("DEPRECATED") for m in msgs)


def test_plan_kernel_refuses_cpu_tensors_under_cuda_mode():
    dst = torch.zeros(4, dtype=torch.int32)
    row = torch.ones(2, dtype=torch.int32)
    before = K.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        K.plan(dst, row, row, row, mode=KernelMode.CUDA)
    with pytest.raises(ValueError, match="CUDA"):
        crossbar_plan(dst, row, row, row, mode="pallas")
    assert K.launch_counts() == before and "plan" in before


# ----------------------------------------------------------------------
# core.crossbar: the legacy local shims
# ----------------------------------------------------------------------
def _legacy_inputs(seed, T=200, S=6):
    rng = np.random.default_rng(seed)
    regs = np_registers(rng, S, capacity=8)
    dst = rng.integers(0, S, T).astype(np.int32)
    src = rng.integers(0, S, T).astype(np.int32)
    return rng, regs, dst, src


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pairwise_dispatch_plan_matches_jax(seed):
    rng, regs, dst, _ = _legacy_inputs(seed)
    S = regs["allowed"].shape[0]
    jr, tr = jax_registers(regs), torch_registers(regs)
    for src in range(S):
        j = jxb.pairwise_dispatch_plan(jnp.asarray(dst), jnp.int32(src), jr,
                                       capacity=5)
        t = txb.pairwise_dispatch_plan(torch.from_numpy(dst), src, tr,
                                       capacity=5)
        _assert_equal(j, t)


def test_pairwise_dispatch_plan_out_of_range_dst_as_jax():
    """What JAX returns for ``dst`` outside ``[0, S)``, pinned: a ``dst`` in
    ``[-S, 0)`` reads port ``dst + S``'s registers and the rank of the next
    packet to it, and takes up no rank; any other reads the nearest port's
    registers and gets rank INT32_MIN (quota and capacity pass, a kept
    packet's slot is INT32_MIN)."""
    S = 4
    d = dict(np_registers(np.random.default_rng(0), S, holes=False))
    d["allowed"][3, 3] = False
    d["quota"][3, 0] = 2                     # quota[dst, src]
    jr, tr = jax_registers(d), torch_registers(d)
    dst = np.array([3, -1, 3, -1, 4, -5, -4, 0, 9], np.int32)
    keep, slot, err = txb.pairwise_dispatch_plan(torch.from_numpy(dst), 0, tr,
                                                 capacity=8)
    imin = -(1 << 31)
    assert keep.tolist() == [True, True, True, False, True, True, True, True,
                             True]
    assert slot.tolist() == [0, 1, 1, 0, imin, imin, 0, 0, imin]
    assert err.tolist() == [0, 0, 0, 2, 0, 0, 0, 0, 0]
    _assert_equal(jxb.pairwise_dispatch_plan(jnp.asarray(dst), jnp.int32(0),
                                             jr, capacity=8),
                  (keep, slot, err))
    for src in (-1, 3, 5):                   # src wraps and clamps alike
        _assert_equal(
            jxb.pairwise_dispatch_plan(jnp.asarray(dst), jnp.int32(src), jr,
                                       capacity=2),
            txb.pairwise_dispatch_plan(torch.from_numpy(dst), src, tr,
                                       capacity=2))


@pytest.mark.parametrize("seed", [0, 1])
def test_exchange_and_combine_local_match_jax(seed):
    rng, regs, dst, src = _legacy_inputs(seed)
    dst[rng.random(dst.size) < 0.1] = -1
    x = rng.standard_normal((dst.size, 8)).astype(np.float32)
    w = rng.random(dst.size).astype(np.float32)
    jr, tr = jax_registers(regs), torch_registers(regs)
    jslab, jp = jxb.exchange_local(jnp.asarray(x), jnp.asarray(dst),
                                   jnp.asarray(src), jr, 8)
    tslab, tp = txb.exchange_local(*_t(x, dst, src), tr, 8)
    assert_same_plan(jp, tp)
    np.testing.assert_array_equal(np.asarray(jslab), tslab.numpy())
    y = rng.standard_normal(tslab.shape).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jxb.combine_local(jnp.asarray(y), jp)),
        txb.combine_local(torch.from_numpy(y), tp).numpy())
    np.testing.assert_array_equal(
        np.asarray(jxb.combine_local(jnp.asarray(y), jp, jnp.asarray(w))),
        txb.combine_local(torch.from_numpy(y), tp, torch.from_numpy(w)
                          ).numpy())


def test_crossbar_interconnect_reconfigure_matches_jax():
    rng, regs, dst, src = _legacy_inputs(3)
    x = rng.standard_normal((dst.size, 8)).astype(np.float32)
    jx = jxb.CrossbarInterconnect(jax_registers(regs), capacity=8)
    tx = txb.CrossbarInterconnect(torch_registers(regs), capacity=8)
    quota = np.full_like(regs["quota"], 2)
    jx2 = jx.reconfigure(quota=jnp.asarray(quota))
    tx2 = tx.reconfigure(quota=torch.from_numpy(quota))
    assert_same_registers(jx2.regs, tx2.regs)
    assert int(tx2.regs.version) == int(tx.regs.version) + 1
    for j, t in ((jx, tx), (jx2, tx2)):
        jslab, jp = j.exchange(jnp.asarray(x), jnp.asarray(dst),
                               jnp.asarray(src))
        tslab, tp = t.exchange(*_t(x, dst, src))
        assert_same_plan(jp, tp)
        np.testing.assert_array_equal(np.asarray(jslab), tslab.numpy())
        np.testing.assert_array_equal(np.asarray(j.combine(jslab, jp)),
                                      t.combine(tslab, tp).numpy())
    fabric = tx2.as_fabric(device="cpu")
    fslab, fp = fabric.dispatch(*_t(x, dst, src))
    assert_same_plan(tp, fp)
    np.testing.assert_array_equal(fslab.numpy(), tslab.numpy())
