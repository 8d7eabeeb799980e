"""The port's ``Fabric`` and ``Shell`` against the JAX package's.

- ``plan`` and ``transfer`` on the port's ``reference`` and ``cuda``
  backends (CPU tensors: the plain versions) are bit-equal to the JAX
  ``Fabric`` on ``reference`` and on ``pallas`` with
  ``kernel_mode="pallas_interpret"`` (the Pallas kernels interpreted);
- the shell's register file is equal in both packages after a sequence of
  ``Shell.post`` events, and a shell-bound fabric re-routes on the next
  call;
- the plan cache hits within an epoch and flushes on every ``Shell.post``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (assert_same_plan, assert_same_registers,
                         jax_registers, np_packets, np_registers, to_np,
                         torch_registers)
from repro.core.elastic import Region as JRegion
from repro.core.module import ModuleFootprint as JFootprint
from repro.fabric import Fabric as JFabric
from repro import shell as jshell
from repro_torch.core.elastic import Region as TRegion
from repro_torch.core.module import ModuleFootprint as TFootprint
from repro_torch.fabric import Fabric as TFabric
from repro_torch import shell as tshell

GB = 1 << 30
PAIRS = [("reference", {}, "reference"),
         ("pallas", {"kernel_mode": "pallas_interpret"}, "cuda")]


@pytest.mark.parametrize("jax_backend,jax_kw,torch_backend", PAIRS)
@pytest.mark.parametrize("n,T", [(2, 9), (4, 64), (8, 300)])
def test_plan_and_transfer_bit_equal(jax_backend, jax_kw, torch_backend, n, T):
    rng = np.random.default_rng(n * 100 + T)
    regs = np_registers(rng, n, capacity=8)
    dst, src = np_packets(rng, T, n)
    x = rng.standard_normal((T, 16)).astype(np.float32)
    w = rng.random(T).astype(np.float32)
    jf = JFabric(jax_registers(regs), backend=jax_backend, capacity=6,
                 **jax_kw)
    tf = TFabric(torch_registers(regs), backend=torch_backend, capacity=6,
                 device="cpu")
    assert_same_plan(jf.plan(jnp.asarray(dst), jnp.asarray(src)),
                     tf.plan(dst, src))

    def jfn(s):
        return s * 2.0 + 1.0

    def tfn(s):
        return s * 2.0 + 1.0

    jy, jplan = jf.transfer(jnp.asarray(x), jnp.asarray(dst),
                            jnp.asarray(src), apply_fn=jfn,
                            weights=jnp.asarray(w))
    ty, tplan = tf.transfer(torch.from_numpy(x), torch.from_numpy(dst),
                            torch.from_numpy(src), apply_fn=tfn,
                            weights=torch.from_numpy(w))
    assert_same_plan(jplan, tplan)
    assert np.array_equal(np.asarray(jy), ty.numpy())


def test_cuda_kernel_backend_transfer_bit_equal_in_bf16():
    """``cuda_kernel`` moves data through the scatter/combine entry points
    (plain versions on the CPU); bit-equal to the JAX kernel data plane."""
    from repro.fabric import PallasBackend
    rng = np.random.default_rng(5)
    n, T = 4, 200
    regs = np_registers(rng, n, capacity=16)
    dst, src = np_packets(rng, T, n)
    x = rng.standard_normal((T, 32)).astype(np.float32)
    w = rng.random(T).astype(np.float32)
    jf = JFabric(jax_registers(regs), capacity=16,
                 backend=PallasBackend(data_plane="kernel"),
                 kernel_mode="pallas_interpret")
    tf = TFabric(torch_registers(regs), backend="cuda_kernel", capacity=16,
                 device="cpu")
    jy, jplan = jf.transfer(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dst),
                            jnp.asarray(src),
                            weights=jnp.asarray(w, jnp.bfloat16))
    ty, tplan = tf.transfer(torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(dst), torch.from_numpy(src),
                            weights=torch.from_numpy(w).bfloat16())
    assert_same_plan(jplan, tplan)
    assert np.array_equal(to_np(jy), to_np(ty))


def _shells(n_regions=4):
    js = jshell.Shell([JRegion(rid=i, n_chips=8, hbm_bytes=8 * GB)
                       for i in range(n_regions)])
    ts = tshell.Shell([TRegion(rid=i, n_chips=8, hbm_bytes=8 * GB)
                       for i in range(n_regions)])
    return js, ts


def _events(pkg, fp):
    return [pkg.Submit("a", (fp, fp), app_id=0),
            pkg.Submit("b", (fp, fp, fp), app_id=1),
            pkg.FailRegion(1), pkg.Shrink("b", 1), pkg.HealRegion(1),
            pkg.Grow("b"), pkg.Migrate("a", 0, 4), pkg.Release("a")]


def test_register_files_equal_after_posts():
    js, ts = _shells(6)
    jfp, tfp = JFootprint(GB, 1e9, 4096), TFootprint(GB, 1e9, 4096)
    for je, te in zip(_events(jshell, jfp), _events(tshell, tfp)):
        jp, tp = js.post(je), ts.post(te)
        assert [a.kind for a in jp.actions] == [a.kind for a in tp.actions]
        assert js.epoch == ts.epoch
        assert ([(r.rid, r.healthy, r.tenant, r.module_idx)
                 for r in js.state.regions]
                == [(r.rid, r.healthy, r.tenant, r.module_idx)
                    for r in ts.state.regions])
        assert_same_registers(js.registers, ts.registers)
        ts.verify()
    assert ts.placement_of("b") == js.placement_of("b")


def test_shell_fabric_reroutes_and_plan_cache_flushes_per_post():
    js, ts = _shells(3)
    jfp, tfp = JFootprint(GB, 1e9, 4096), TFootprint(GB, 1e9, 4096)
    js.post(jshell.Submit("a", (jfp, jfp), app_id=0))
    ts.post(tshell.Submit("a", (tfp, tfp), app_id=0))
    jf = js.fabric(backend="pallas", plan_cache=True,
                   kernel_mode="pallas_interpret")
    tf = ts.fabric(backend="cuda", plan_cache=True, device="cpu")
    dst = np.array([1, 2, 3, -1], np.int32)
    src = np.zeros(4, np.int32)
    for step in range(6):
        if step in (2, 4):
            ev = ((jshell.FailRegion(0), tshell.FailRegion(0)) if step == 2
                  else (jshell.HealRegion(0), tshell.HealRegion(0)))
            js.post(ev[0])
            ts.post(ev[1])
        jplan, tplan = jf.plan(dst, src), tf.plan(dst, src)
        assert_same_plan(jplan, tplan)
        jf.account(jplan, src)
        tf.account(tplan, src)
    # a miss on each of the 3 epochs, hits in between; one flush per post
    assert tf.plan_cache.misses == jf.plan_cache.misses == 3
    assert tf.plan_cache.hits == jf.plan_cache.hits == 3
    assert tf.plan_cache.invalidations == 2
    assert np.array_equal(jf.port_traffic, tf.port_traffic)
    assert np.array_equal(jf.masked_by_src, tf.masked_by_src)
    # registers moved to the device once per epoch, not per call
    assert tf.register_moves == 3


def test_cached_transfer_is_bit_identical_to_uncached():
    rng = np.random.default_rng(11)
    regs = np_registers(rng, 4, capacity=8)
    dst, src = np_packets(rng, 50, 4)
    x = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32))
    cached = TFabric(torch_registers(regs), backend="cuda", device="cpu",
                     plan_cache=True)
    plain = TFabric(torch_registers(regs), backend="cuda", device="cpu")
    for _ in range(3):
        yc, pc = cached.transfer(x, dst, src)
        yp, pp = plain.transfer(x, dst, src)
        assert_same_plan(pc, pp)
        assert torch.equal(yc, yp)
    assert cached.plan_cache.hits == 2
