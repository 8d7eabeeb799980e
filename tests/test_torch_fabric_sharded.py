"""The port's sharded fabric backend (``Fabric(regs, backend="sharded",
group=...)``) against the JAX package's single-device reference.

Four ranks run over gloo on the CPU, spawned once for the file
(``_torch_sharded_worker.spawn``, a ``file://`` store under the test's
temporary directory); every case runs inside that one spawn.  The JAX side
runs here, on the concatenated packets with ``src`` set to the owning rank,
which is the plan the JAX package's own forced-4-device test holds its
sharded backend to:

- each rank's ``keep``/``slot``/``error`` are its slice of JAX's
  ``ReferenceBackend.plan`` and ``counts``/``drops`` the whole plan's, bit
  for bit, at 4 ports (one a rank) and 8 (two a rank), over seeded
  registers with isolation holes, quotas, a reset port and per-port
  capacities, and destinations that include ``-1`` and out-of-range ports;
- each rank's receive slabs are its port block of JAX's reference
  ``dispatch``, and its combine its slice of JAX's ``combine``, bit for
  bit; the combine through a persisted ``CombineRoute`` is bit-identical;
- in float32 the dispatch gradient and the combine's gradients (slabs and
  weights) agree with the one-hot backward oracles
  (``sharded_*_at_bwd_ref``) and with ``jax.vjp`` of the reference data
  plane within 1e-6;
- the sanitizer re-checks isolation with the rank as the source (it
  passes on hostile traffic under ``"sanitize"``, and ``"strict"`` raises
  exactly on the ranks that sprayed an invalid destination or burst over
  capacity), and a port count the ranks cannot split is refused.

Without a spawn: ``account(src_shard=, n_shards=)`` against JAX's
counters, the ``registers=`` override on ``plan``/``dispatch``/
``combine``/``transfer`` against JAX's (outputs and signature counts),
``backend_names()``, and in this process the sharded plan at world size
1 and the port split (an in-process fake group of 4 for the refusal).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_port import (assert_same_plan, jax_registers, np_registers,
                         to_np, torch_registers)
from _torch_sharded_worker import spawn
from repro.core import arbiter as jarbiter
from repro.core.registers import ErrorCode
from repro.fabric import Fabric as JFabric
from repro.fabric import ReferenceBackend as JReference
from repro.fabric import backend_names as jax_backend_names
from repro_torch.fabric import (CombineRoute, Fabric, ShardedBackend,
                                backend_names)

N = 4                   # ranks
T = 12                  # packets a rank
D = 8
CAP = 8
CASES = [(4, 0), (4, 1), (8, 2), (8, 3)]          # (n_ports, seed)


def _case(n_ports, seed):
    rng = np.random.default_rng(seed)
    regs = np_registers(rng, n_ports, capacity=CAP)
    dst = rng.integers(0, n_ports, N * T).astype(np.int32)
    dst[rng.random(N * T) < 0.1] = -1
    dst[rng.random(N * T) < 0.05] = n_ports       # out of range
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(regs=regs, cap=CAP, dst=dst, x=f(N * T, D),
                Y=f(n_ports, CAP, D), G=f(n_ports, CAP, D),
                w=f(N * T), ct=f(N * T, D))


def _src():
    return np.repeat(np.arange(N, dtype=np.int32), T)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = [_case(*c) for c in CASES]
    rng = np.random.default_rng(9)
    payload = {"cases": cases, "regs6": np_registers(rng, 6, capacity=4)}
    res = spawn("fabric_cases", N, tmp_path_factory.mktemp("sharded"),
                payload)
    return cases, res


def _jax_reference(case):
    regs = jax_registers(case["regs"])
    dst, src = jnp.asarray(case["dst"]), jnp.asarray(_src())
    plan = JReference().plan(dst, src, regs)
    return regs, plan


def _block(a, r, per):
    return a[r * per:(r + 1) * per]


@pytest.mark.parametrize("i", range(len(CASES)))
def test_sharded_plan_is_the_reference_plan(ranks, i):
    cases, res = ranks
    _, plan = _jax_reference(cases[i])
    for r in range(N):
        got = res[r]["cases"][i]["plan"]
        for f in ("keep", "slot", "dst", "error"):
            assert np.array_equal(got[f], _block(to_np(getattr(plan, f)),
                                                 r, T)), (r, f)
        for f in ("counts", "drops"):
            assert np.array_equal(got[f], to_np(getattr(plan, f))), (r, f)
    assert to_np(plan.keep).any() and not to_np(plan.keep).all()


@pytest.mark.parametrize("i", range(len(CASES)))
def test_sharded_slabs_are_the_reference_blocks(ranks, i):
    cases, res = ranks
    case = cases[i]
    _, plan = _jax_reference(case)
    S = case["Y"].shape[0]
    slabs = to_np(jarbiter.dispatch(jnp.asarray(case["x"]), plan, S, CAP))
    for r in range(N):
        assert np.array_equal(res[r]["cases"][i]["slabs"],
                              _block(slabs, r, S // N)), r


@pytest.mark.parametrize("i", range(len(CASES)))
def test_sharded_combine_with_and_without_a_route(ranks, i):
    cases, res = ranks
    case = cases[i]
    _, plan = _jax_reference(case)
    out = to_np(jarbiter.combine(jnp.asarray(case["Y"]), plan,
                                 jnp.asarray(case["w"])))
    for r in range(N):
        got = res[r]["cases"][i]
        assert np.array_equal(got["comb"], got["comb_route"]), r
        assert np.array_equal(got["comb"], _block(out, r, T)), r


@pytest.mark.parametrize("i", range(len(CASES)))
def test_sharded_dispatch_gradient(ranks, i):
    cases, res = ranks
    case = cases[i]
    _, plan = _jax_reference(case)
    S = case["Y"].shape[0]
    _, vjp = jax.vjp(lambda x: jarbiter.dispatch(x, plan, S, CAP),
                     jnp.asarray(case["x"]))
    (d_x,) = vjp(jnp.asarray(case["G"]))
    for r in range(N):
        got = res[r]["cases"][i]
        np.testing.assert_allclose(got["d_x"], got["d_x_ref"], atol=1e-6)
        np.testing.assert_allclose(got["d_x"], _block(to_np(d_x), r, T),
                                   atol=1e-6)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_sharded_combine_gradient(ranks, i):
    cases, res = ranks
    case = cases[i]
    _, plan = _jax_reference(case)
    S = case["Y"].shape[0]
    _, vjp = jax.vjp(lambda y, w: jarbiter.combine(y, plan, w),
                     jnp.asarray(case["Y"]), jnp.asarray(case["w"]))
    d_y, d_w = vjp(jnp.asarray(case["ct"]))
    for r in range(N):
        got = res[r]["cases"][i]
        assert got["d_w"].dtype == np.float32
        np.testing.assert_allclose(got["d_y"], got["d_y_ref"], atol=1e-6)
        np.testing.assert_allclose(got["d_w"], got["d_w_ref"], atol=1e-6)
        np.testing.assert_allclose(got["d_y"], _block(to_np(d_y), r, S // N),
                                   atol=1e-6)
        np.testing.assert_allclose(got["d_w"], _block(to_np(d_w), r, T),
                                   atol=1e-6)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_sharded_sanitizer_rechecks_with_the_rank(ranks, i):
    """Under "sanitize" the isolation re-check uses the rank as the source
    (the callers' ``src`` is all zeros, which the holes would fail), so
    hostile traffic passes; "strict" raises exactly on the ranks whose
    packets sprayed a real invalid destination or burst over capacity."""
    cases, res = ranks
    _, plan = _jax_reference(cases[i])
    err, dst = to_np(plan.error), cases[i]["dst"]
    for r in range(N):
        e, d = _block(err, r, T), _block(dst, r, T)
        want = bool(((e == ErrorCode.INVALID_DEST) & (d != -1)).any()
                    or (e == ErrorCode.ACK_TIMEOUT).any())
        assert res[r]["cases"][i]["strict_raised"] == want, r


def test_sharded_backend_refuses_an_indivisible_port_count(ranks):
    _, res = ranks
    for r in range(N):
        assert "divisible" in res[r]["refused"], res[r]["refused"]


# ----------------------------------------------------------------------
# no spawn
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n_shards,src_shard", [(4, 0), (4, 3), (2, 1)])
def test_account_splits_local_and_remote_as_jax(n_shards, src_shard):
    rng = np.random.default_rng(n_shards * 10 + src_shard)
    regs = np_registers(rng, 8, capacity=CAP)
    dst = rng.integers(-1, 8, 64).astype(np.int32)
    src = rng.integers(0, 8, 64).astype(np.int32)
    jf = JFabric(jax_registers(regs), backend="reference", capacity=CAP)
    tf = Fabric(torch_registers(regs), backend="reference", capacity=CAP,
                device="cpu")
    for _ in range(2):                       # the counters accumulate
        jp = jf.plan(jnp.asarray(dst), jnp.asarray(src))
        tp = tf.plan(torch.from_numpy(dst), torch.from_numpy(src))
        assert_same_plan(jp, tp)
        jf.account(jp, jnp.asarray(src), src_shard=src_shard,
                   n_shards=n_shards)
        tf.account(tp, torch.from_numpy(src), src_shard=src_shard,
                   n_shards=n_shards)
    for f in ("offered_packets", "granted_packets", "local_packets",
              "remote_packets"):
        assert getattr(tf, f) == getattr(jf, f), f
    for f in ("port_traffic", "local_port_traffic", "remote_port_traffic",
              "masked_by_src", "dropped_by_src"):
        assert np.array_equal(getattr(tf, f), getattr(jf, f)), f
    assert tf.local_packets > 0 and tf.remote_packets > 0


def test_registers_override_on_every_entry_matches_jax():
    """``registers=`` steers each entry by value: the same outputs as JAX's,
    no new signature, and the bound file untouched."""
    rng = np.random.default_rng(5)
    base = np_registers(rng, 4, capacity=CAP, holes=False)
    other = np_registers(rng, 4, capacity=CAP)
    dst = rng.integers(-1, 4, 32).astype(np.int32)
    src = rng.integers(0, 4, 32).astype(np.int32)
    x = rng.standard_normal((32, D)).astype(np.float32)
    jf = JFabric(jax_registers(base), backend="reference", capacity=CAP)
    tf = Fabric(torch_registers(base), backend="reference", capacity=CAP,
                device="cpu", plan_cache=True)
    jr, tr = jax_registers(other), torch_registers(other)
    jd, js, jx = jnp.asarray(dst), jnp.asarray(src), jnp.asarray(x)
    td, ts, tx = map(torch.from_numpy, (dst, src, x))
    apply_fn = lambda s: s * 2.0
    for regs_j, regs_t in ((None, None), (jr, tr), (jr, tr), (None, None)):
        assert_same_plan(jf.plan(jd, js, registers=regs_j),
                         tf.plan(td, ts, registers=regs_t))
        js_, jp = jf.dispatch(jx, jd, js, registers=regs_j)
        ts_, tp = tf.dispatch(tx, td, ts, registers=regs_t)
        assert_same_plan(jp, tp)
        assert np.array_equal(to_np(js_), to_np(ts_))
        assert np.array_equal(
            to_np(jf.combine(js_, jp, registers=regs_j)),
            to_np(tf.combine(ts_, tp, registers=regs_t)))
        jy, jp2 = jf.transfer(jx, jd, js, apply_fn=apply_fn,
                              registers=regs_j)
        ty, tp2 = tf.transfer(tx, td, ts, apply_fn=apply_fn,
                              registers=regs_t)
        assert_same_plan(jp2, tp2)
        assert np.array_equal(to_np(jy), to_np(ty))
    with_override = to_np(tf.plan(td, ts, registers=tr).keep)
    assert not np.array_equal(with_override, to_np(tf.plan(td, ts).keep))
    for entry in ("plan", "dispatch", "combine", "transfer"):
        assert tf.trace_counts[entry] == 1, tf.trace_counts


def test_backend_names_cover_jax():
    """Every backend the JAX package registers itself (tests in the same
    process may register more) has a name in the port's registry."""
    from repro.fabric import backends as jbackends
    own = {name for name in jax_backend_names()
           if getattr(jbackends._BACKENDS[name], "__module__", "")
           == jbackends.__name__}
    assert own == {"reference", "pallas", "sharded"}
    assert own <= set(backend_names())
    assert "sharded" in backend_names()
    assert ShardedBackend.uses_shared_scatter is False
    assert {"addr_recv", "keep", "pos", "dshard"} == set(
        CombineRoute.__dataclass_fields__)


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", rank=0, world_size=1,
                            init_method="file://" + os.path.join(
                                str(tmp_path), "store"))
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n_ports", [1, 3, 6, 8])
def test_ports_per_shard_at_world_size_one(world_of_one, n_ports):
    """One rank owns every port, whatever their count."""
    regs = torch_registers(np_registers(np.random.default_rng(0), n_ports))
    assert ShardedBackend().ports_per_shard(regs) == n_ports


def test_ports_per_shard_refuses_in_process():
    """In a group of 4 (torch's in-process fake backend: the refusal comes
    before any collective), 6 ports are refused and 8 give 2 a rank."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        backend = ShardedBackend()
        rng = np.random.default_rng(1)
        with pytest.raises(ValueError, match="divisible"):
            backend.ports_per_shard(torch_registers(np_registers(rng, 6)))
        assert backend.ports_per_shard(
            torch_registers(np_registers(rng, 8))) == 2
    finally:
        dist.destroy_process_group()


def test_sharded_plan_at_world_size_one(world_of_one):
    """One rank owns every port: the sharded plan is JAX's reference plan
    with every packet from source 0, and the data plane its dispatch and
    combine."""
    rng = np.random.default_rng(11)
    regs = np_registers(rng, 4, capacity=CAP)
    dst = rng.integers(-1, 5, 40).astype(np.int32)
    x = rng.standard_normal((40, D)).astype(np.float32)
    zeros = np.zeros(40, np.int32)
    jplan = JReference().plan(jnp.asarray(dst), jnp.asarray(zeros),
                              jax_registers(regs))
    fab = Fabric(torch_registers(regs), backend="sharded", capacity=CAP,
                 device="cpu")
    tplan = fab.plan(torch.from_numpy(dst), torch.from_numpy(zeros))
    assert_same_plan(jplan, tplan)
    y, _ = fab.transfer(torch.from_numpy(x), torch.from_numpy(dst),
                        torch.from_numpy(zeros), apply_fn=lambda s: s * 3.0)
    jy = jarbiter.combine(jarbiter.dispatch(jnp.asarray(x), jplan, 4, CAP)
                          * 3.0, jplan, jnp.ones((40,), jnp.float32))
    assert np.array_equal(to_np(y), to_np(jy))
