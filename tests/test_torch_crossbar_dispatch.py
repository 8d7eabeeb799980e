"""The port's crossbar-dispatch entry points (``ops._plan_multi``,
``_dispatch``, ``_combine``) on the CPU, where they run the plain versions,
against the JAX package's Pallas kernels run in interpret mode: bit-equal
on the same seeded inputs, with the combine's unit-weight form
(``weights=None``) and index tensors in any dtype and layout.  The CUDA kernels themselves are held against
the plain versions in ``test_torch_kernels_cuda.py`` (on the card) and by
``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import np_packets, to_np
from repro.kernels.crossbar_dispatch import ops as jops
from repro_torch.kernels.crossbar_dispatch import kernel as K
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


def _routed(T, S, C, D, dtype, seed):
    """Seeded slabs, weights and a plan with unique slots per destination,
    some past capacity, as numpy and as the port's tensors."""
    rng, dst, (jk, _, _, _), _ = _both_plans(T, S, seed=seed)
    keep = np.array(jk)
    slot = np.zeros(T, np.int32)
    for d in range(S):
        rows = np.nonzero((dst == d) & (keep > 0))[0]
        slot[rows] = np.arange(rows.size)
    y = rng.standard_normal((S, C, D)).astype(np.float32)
    td = getattr(torch, dtype)
    return (dst, keep, slot, y, torch.from_numpy(y).to(td),
            torch.from_numpy(dst), torch.from_numpy(keep),
            torch.from_numpy(slot))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,S,C", [(1, 2, 4), (300, 4, 16), (1000, 8, 32)])
def test_combine_unit_weight_form_equals_ones(T, S, C, dtype):
    """``_combine(..., weights=None)`` copies the rows: equal to weights of
    one through the plain path and through the JAX package's ``_combine``
    (interpret mode), and its ``d_y`` equals the one of unit weights."""
    dst, keep, slot, y, ty, tdst, tkeep, tslot = _routed(T, S, C, 24, dtype,
                                                         seed=T + C)
    ones = np.ones(T, np.float32)
    got = tops._combine(ty, tdst, tkeep, tslot, None)
    assert got.dtype == ty.dtype and tuple(got.shape) == (T, 24)
    assert torch.equal(got, tops._combine(ty, tdst, tkeep, tslot,
                                          torch.from_numpy(ones)))
    assert torch.equal(got, tref.combine_ref(ty, tdst, tkeep, tslot, None))
    jd = getattr(jnp, dtype)
    j_out = jops._combine(jnp.asarray(y, jd), jnp.asarray(dst),
                          jnp.asarray(keep), jnp.asarray(slot),
                          jnp.asarray(ones), interpret=True)
    assert np.array_equal(to_np(j_out), to_np(got))
    g = torch.from_numpy(np.random.default_rng(T).standard_normal(
        (T, 24)).astype(np.float32)).to(ty.dtype)
    grads = []
    for w in (None, torch.from_numpy(ones)):
        leaf = ty.clone().requires_grad_()
        (d_y,) = torch.autograd.grad(
            tops._combine(leaf, tdst, tkeep, tslot, w), leaf, g)
        grads.append(d_y)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("layout", ["int32", "int64", "strided", "bool_keep"])
def test_index_tensors_in_any_layout_route_alike(layout):
    """The wrappers pass contiguous int32 index tensors on as they are and
    convert any other: int64, strided views or a bool ``keep`` route the
    scatter and the combine exactly as contiguous int32 does, and as the
    JAX package's kernels (interpret mode)."""
    T, S, C, D = 300, 4, 16, 24
    dst, keep, slot, y, ty, tdst, tkeep, tslot = _routed(T, S, C, D,
                                                         "float32", seed=7)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (T, D)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(9).random(T).astype(
        np.float32))

    def strided(t):
        return torch.stack([t, torch.zeros_like(t)], 1)[:, 0]

    idx = {"int32": lambda t: t, "int64": lambda t: t.long(),
           "strided": strided, "bool_keep": lambda t: t}[layout]
    args = [idx(tdst), idx(tkeep), idx(tslot)]
    if layout == "bool_keep":
        args[1] = tkeep > 0
    for t, v in zip(args, (tdst, tkeep, tslot)):
        conv = K._i32(t)
        assert conv.dtype == torch.int32 and conv.is_contiguous()
        assert torch.equal(conv, v)
        assert (conv is t) == (t.dtype == torch.int32 and t.is_contiguous())
    slabs = tops._dispatch(x, *args, n_ports=S, capacity=C)
    assert torch.equal(slabs, tops._dispatch(x, tdst, tkeep, tslot,
                                             n_ports=S, capacity=C))
    j_slab = jops._dispatch(jnp.asarray(x.numpy()), jnp.asarray(dst),
                            jnp.asarray(keep), jnp.asarray(slot), n_ports=S,
                            capacity=C, interpret=True)
    assert np.array_equal(to_np(j_slab), slabs.numpy())
    out = tops._combine(ty, *args, w)
    assert torch.equal(out, tops._combine(ty, tdst, tkeep, tslot, w))
    assert torch.equal(out, K.combine(ty, *args, w))
    j_out = jops._combine(jnp.asarray(y), jnp.asarray(dst),
                          jnp.asarray(keep), jnp.asarray(slot),
                          jnp.asarray(w.numpy()), interpret=True)
    assert np.array_equal(to_np(j_out), out.numpy())
