"""The port's crossbar-dispatch entry points (``ops._plan_multi``,
``_dispatch``, ``_combine``) on the CPU, where they run the plain versions,
against the JAX package's Pallas kernels run in interpret mode: bit-equal
on the same seeded inputs.  The CUDA kernels themselves are held against
the plain versions in ``test_torch_kernels_cuda.py`` (on the card) and by
``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import np_packets, to_np
from repro.kernels.crossbar_dispatch import ops as jops
from repro_torch.kernels.crossbar_dispatch import ops as tops
from repro_torch.kernels.crossbar_dispatch import ref as tref


def _registers(rng, S):
    allowed = (rng.random((S, S)) > 0.2).astype(np.int32)
    quota = np.where(rng.random((S, S)) > 0.5,
                     rng.integers(1, 40, (S, S)), 0).astype(np.int32)
    return allowed, quota


def _both_plans(T, S, seed):
    rng = np.random.default_rng(seed)
    dst, src = np_packets(rng, T, S)
    allowed, quota = _registers(rng, S)
    j = jops._plan_multi(jnp.asarray(dst), jnp.asarray(src),
                         jnp.asarray(allowed), jnp.asarray(quota),
                         interpret=True)
    t = tops._plan_multi(torch.from_numpy(dst), torch.from_numpy(src),
                         torch.from_numpy(allowed), torch.from_numpy(quota))
    return rng, dst, j, t


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("T", [0, 1, 7, 256, 1000, 5000])
def test_plan_multi_bit_equal(T, S):
    _, _, j, t = _both_plans(T, S, seed=T * 10 + S)
    for name, a, b in zip(("keep", "rank", "err", "granted"), j, t):
        assert b.dtype == torch.int32, name
        assert np.array_equal(np.asarray(a), b.numpy()), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,S,C", [(0, 4, 8), (7, 2, 8), (300, 4, 16),
                                   (1000, 8, 32)])
def test_scatter_and_combine_bit_equal(T, S, C, dtype):
    rng, dst, (jk, _, _, _), _ = _both_plans(T, S, seed=T + S)
    D = 24
    x = rng.standard_normal((T, D)).astype(np.float32)
    y = rng.standard_normal((S, C, D)).astype(np.float32)
    w = rng.random(T).astype(np.float32)
    keep = np.array(jk)
    slot = np.zeros(T, np.int32)
    for d in range(S):                       # unique slot per destination
        rows = np.nonzero((dst == d) & (keep > 0))[0]
        slot[rows] = np.arange(rows.size)    # some land at >= C: dropped
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j_slab = jops._dispatch(jnp.asarray(x, jd), jnp.asarray(dst),
                            jnp.asarray(keep), jnp.asarray(slot), n_ports=S,
                            capacity=C, interpret=True)
    t_slab = tops._dispatch(torch.from_numpy(x).to(td), torch.from_numpy(dst),
                            torch.from_numpy(keep), torch.from_numpy(slot),
                            n_ports=S, capacity=C)
    assert t_slab.dtype == td and tuple(t_slab.shape) == (S, C, D)
    assert np.array_equal(to_np(j_slab), to_np(t_slab))
    j_out = jops._combine(jnp.asarray(y, jd), jnp.asarray(dst),
                          jnp.asarray(keep), jnp.asarray(slot),
                          jnp.asarray(w), interpret=True)
    t_out = tops._combine(torch.from_numpy(y).to(td), torch.from_numpy(dst),
                          torch.from_numpy(keep), torch.from_numpy(slot),
                          torch.from_numpy(w))
    assert t_out.dtype == td and tuple(t_out.shape) == (T, D)
    assert np.array_equal(to_np(j_out), to_np(t_out))


def test_plain_versions_drop_out_of_range_rows():
    """A kept packet with ``slot >= C`` or ``dst`` outside ``[0, S)`` writes
    and reads nothing (the TPU one-hot dropped it silently; the CUDA copy
    bounds-checks it)."""
    x = torch.ones((4, 3))
    dst = torch.tensor([0, -1, 2, 1], dtype=torch.int32)
    keep = torch.ones(4, dtype=torch.int32)
    slot = torch.tensor([0, 0, 0, 5], dtype=torch.int32)
    slabs = tref.scatter_ref(x, dst, keep, slot, 2, 4)
    assert slabs.sum().item() == 3.0 and slabs[0, 0].sum().item() == 3.0
    out = tref.combine_ref(slabs + 1, dst, keep, slot, torch.full((4,), 2.0))
    assert out.tolist() == [[4.0] * 3, [0.0] * 3, [0.0] * 3, [0.0] * 3]
