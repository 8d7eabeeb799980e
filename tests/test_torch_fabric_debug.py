"""The port's fabric sanitizer (``Fabric(debug=...)``, ``REPRO_FABRIC_DEBUG``)
and ``validate_registers`` against the JAX package's.

The same traffic goes to both packages' fabrics:

- under ``debug="strict"`` (or ``True``) a sprayed invalid destination, an
  isolation-blocked one and an over-capacity burst raise in both (JAX:
  ``checkify.JaxRuntimeError``; the port: ``FabricCheckError``) with the
  same message;
- ``debug="sanitize"`` raises on neither for hostile traffic: plans, slabs
  and outputs are bit-equal to ``debug=False`` and to the JAX package's;
- a NaN in a slab and a combine slab smaller than the plan's grants raise
  at both levels;
- the environment hook resolves the same way, and an explicit
  ``debug=False`` overrides it;
- with ``debug=False`` no check runs and each call dispatches exactly the
  operations it dispatches without the sanitizer.

The JAX package's in-trace cases have no counterpart (the port has no
traces); its sharded backend's sanitizer is held in
``test_torch_fabric_sharded.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_port import assert_same_plan, assert_same_registers
from repro.core import registers as jregisters
from repro.core.elastic import Region as JRegion
from repro.core.module import ModuleFootprint as JFootprint
from repro.core.registers import CrossbarRegisters as JRegisters
from repro.fabric import DEBUG_ENV_VAR as J_ENV
from repro.fabric import Fabric as JFabric
from repro import shell as jshell
from repro_torch.core import registers as tregisters
from repro_torch.core import validate_registers
from repro_torch.core.elastic import Region as TRegion
from repro_torch.core.module import ModuleFootprint as TFootprint
from repro_torch.core.registers import CrossbarRegisters as TRegisters
from repro_torch.fabric import DEBUG_ENV_VAR, Fabric, FabricCheckError
from repro_torch.fabric import sanitize
from repro_torch import shell as tshell

N, CAP, D = 4, 4, 8
# (JAX backend, port backend): the port's cuda and cuda_kernel backends run
# their kernels' plain versions on CPU tensors
BACKENDS = [("reference", "reference"), ("pallas", "cuda"),
            ("pallas", "cuda_kernel")]
GB = 1 << 30


def _traffic():
    x = np.arange(6 * D, dtype=np.float32).reshape(6, D)
    dst = np.asarray([0, 1, 2, 3, 0, 1], np.int32)
    src = np.zeros(6, np.int32)
    return x, dst, src


def _pair(jb, tb, debug=None, iso=None):
    jregs, tregs = JRegisters.create(N, capacity=CAP), \
        TRegisters.create(N, capacity=CAP)
    if iso is not None:
        jregs, tregs = jregs.with_isolation(*iso), tregs.with_isolation(*iso)
    return (JFabric(jregs, backend=jb, capacity=CAP, debug=debug),
            Fabric(tregs, backend=tb, capacity=CAP, debug=debug,
                   device="cpu"))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _both_raise(jcall, tcall, match):
    with pytest.raises(checkify.JaxRuntimeError, match=match) as je:
        jcall()
    with pytest.raises(FabricCheckError, match=match) as te:
        tcall()
    # the port's message is the JAX package's (checkify appends where)
    assert str(te.value).split(" (")[0] in str(je.value)


@pytest.fixture(autouse=True)
def _no_env_debug(monkeypatch):
    monkeypatch.delenv(DEBUG_ENV_VAR, raising=False)


@pytest.mark.parametrize("jb,tb", BACKENDS)
def test_spray_raises_under_strict_debug(jb, tb):
    jf, tf = _pair(jb, tb, debug=True)
    x, dst, src = _traffic()
    spray = dst.copy()
    spray[2] = 17                                 # out-of-range destination
    _both_raise(lambda: jf.plan(jnp.asarray(spray), jnp.asarray(src)),
                lambda: tf.plan(*_t(spray, src)), "invalid destination")
    _both_raise(lambda: jf.transfer(jnp.asarray(x), jnp.asarray(spray),
                                    jnp.asarray(src)),
                lambda: tf.transfer(*_t(x, spray, src)),
                "invalid destination")


@pytest.mark.parametrize("jb,tb", BACKENDS)
def test_isolation_spray_raises_under_strict_debug(jb, tb):
    jf, tf = _pair(jb, tb, debug=True, iso=(0, [0, 1]))
    _, dst, src = _traffic()                      # dst includes 2 and 3
    _both_raise(lambda: jf.plan(jnp.asarray(dst), jnp.asarray(src)),
                lambda: tf.plan(*_t(dst, src)), "invalid destination")


@pytest.mark.parametrize("jb,tb", BACKENDS)
def test_burst_raises_under_strict_debug(jb, tb):
    jf, tf = _pair(jb, tb, debug=True)
    burst = np.zeros(3 * CAP, np.int32)           # 12 packets at port 0
    src = np.zeros(3 * CAP, np.int32)
    _both_raise(lambda: jf.plan(jnp.asarray(burst), jnp.asarray(src)),
                lambda: tf.plan(*_t(burst, src)), "over-capacity burst")


@pytest.mark.parametrize("jb,tb", BACKENDS)
def test_clean_traffic_passes_and_is_bit_identical(jb, tb):
    x, dst, src = _traffic()
    _, plain = _pair(jb, tb, debug=False)
    jdbg, dbg = _pair(jb, tb, debug=True)
    y0, p0 = plain.transfer(*_t(x, dst, src))
    y1, p1 = dbg.transfer(*_t(x, dst, src))       # must not raise
    jy, jp = jdbg.transfer(jnp.asarray(x), jnp.asarray(dst),
                           jnp.asarray(src))
    assert torch.equal(y0, y1)
    assert np.array_equal(np.asarray(jy), y1.numpy())
    assert_same_plan(p0, p1)
    assert_same_plan(jp, p1)


@pytest.mark.parametrize("jb,tb", BACKENDS)
def test_sanitize_masks_hostile_traffic_like_normal_mode(jb, tb):
    """The sanitize level is the masked path: sprays and bursts drop with
    their error codes, bit-equal to debug off and to the JAX package's
    sanitize level; no exception."""
    _, dst, _ = _traffic()
    spray = dst.copy()
    spray[2] = 17
    _, plain = _pair(jb, tb, debug=False)
    jsan, san = _pair(jb, tb, debug="sanitize")
    for hostile in (spray, np.zeros(3 * CAP, np.int32)):
        srcs = np.zeros(hostile.shape, np.int32)
        xs = np.ones((hostile.shape[0], D), np.float32)
        p0 = plain.plan(*_t(hostile, srcs))
        p1 = san.plan(*_t(hostile, srcs))
        assert_same_plan(p0, p1)
        assert_same_plan(jsan.plan(jnp.asarray(hostile), jnp.asarray(srcs)),
                         p1)
        s0, _ = plain.dispatch(*_t(xs, hostile, srcs))
        s1, _ = san.dispatch(*_t(xs, hostile, srcs))
        js, _ = jsan.dispatch(jnp.asarray(xs), jnp.asarray(hostile),
                              jnp.asarray(srcs))
        assert torch.equal(s0, s1)
        assert np.array_equal(np.asarray(js), s1.numpy())
        assert int(p1.drops.sum()) == hostile.shape[0]  # every row accounted


@pytest.mark.parametrize("jb,tb", BACKENDS)
@pytest.mark.parametrize("level", ["sanitize", "strict"])
def test_nan_slab_raises_at_both_levels(jb, tb, level):
    x, dst, src = _traffic()
    xn = x.copy()
    xn[0, 0] = np.nan
    jf, tf = _pair(jb, tb, debug=level)
    _both_raise(lambda: jf.dispatch(jnp.asarray(xn), jnp.asarray(dst),
                                    jnp.asarray(src)),
                lambda: tf.dispatch(*_t(xn, dst, src)), "NaN")


def test_nan_returned_by_the_module_raises_in_transfer():
    x, dst, src = _traffic()
    _, tf = _pair("reference", "reference", debug="sanitize")
    with pytest.raises(FabricCheckError, match="NaN"):
        tf.transfer(*_t(x, dst, src),
                    apply_fn=lambda s: s.masked_fill(s > 40, float("nan")))


def test_combine_smaller_slab_raises():
    """A slab smaller than what the plan granted into is a silent drop in
    normal mode; the sanitizer surfaces it."""
    x, dst, src = _traffic()
    jf, tf = _pair("reference", "reference", debug=True)
    jplain, plain = _pair("reference", "reference", debug=False)
    slabs, plan = plain.dispatch(*_t(x, dst, src))
    jslabs, jplan = jplain.dispatch(jnp.asarray(x), jnp.asarray(dst),
                                    jnp.asarray(src))
    _both_raise(lambda: jf.combine(jslabs[:, :1], jplan),
                lambda: tf.combine(slabs[:, :1], plan), "combine")
    # normal mode: masked, and bit-equal to the JAX package's
    w = np.ones(dst.shape, np.float32)
    y = plain.combine(slabs[:, :1], plan, torch.from_numpy(w))
    jy = jplain.combine(jslabs[:, :1], jplan, jnp.asarray(w))
    assert np.array_equal(np.asarray(jy), y.numpy())


def test_env_hook_resolves_to_sanitize(monkeypatch):
    assert DEBUG_ENV_VAR == J_ENV == "REPRO_FABRIC_DEBUG"
    monkeypatch.setenv(DEBUG_ENV_VAR, "1")
    jf, tf = _pair("reference", "reference")
    assert tf.debug == jf.debug == "sanitize"
    x, dst, src = _traffic()
    spray = dst.copy()
    spray[2] = 17
    p = tf.plan(*_t(spray, src))                  # masked, not raised
    assert int(p.drops[1]) == 1
    xn = x.copy()
    xn[0, 0] = np.nan
    with pytest.raises(FabricCheckError, match="NaN"):
        tf.dispatch(*_t(xn, dst, src))


@pytest.mark.parametrize("value,level", [
    ("strict", "strict"), ("sanitize", "sanitize"), ("on", "sanitize"),
    ("true", "sanitize"), ("", False), ("0", False)])
def test_env_hook_levels_equal_jax(monkeypatch, value, level):
    monkeypatch.setenv(DEBUG_ENV_VAR, value)
    jf, tf = _pair("reference", "reference")
    assert tf.debug == jf.debug == level


def test_env_hook_strict(monkeypatch):
    monkeypatch.setenv(DEBUG_ENV_VAR, "strict")
    jf, tf = _pair("reference", "reference")
    _, dst, src = _traffic()
    spray = dst.copy()
    spray[2] = 17
    _both_raise(lambda: jf.plan(jnp.asarray(spray), jnp.asarray(src)),
                lambda: tf.plan(*_t(spray, src)), "invalid destination")


def test_explicit_debug_off_ignores_env(monkeypatch):
    monkeypatch.setenv(DEBUG_ENV_VAR, "strict")
    jf, tf = _pair("reference", "reference", debug=False)
    assert tf.debug is False and jf.debug is False
    _, dst, src = _traffic()
    spray = dst.copy()
    spray[2] = 17
    tf.plan(*_t(spray, src))                      # no raise


def test_bad_debug_value_raises():
    with pytest.raises(ValueError, match="debug must be"):
        Fabric(TRegisters.create(N), debug="loud", device="cpu")


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("tb", ["reference", "cuda", "cuda_kernel"])
def test_debug_off_runs_no_check_and_no_extra_op(monkeypatch, tb):
    """``debug=False`` (even with the environment hook set to strict)
    calls no check and dispatches the same operations as a fabric built
    with the hook off; the sanitize level dispatches more."""
    x, dst, src = _traffic()

    def calls(fab):
        log = _OpLog()
        with log:
            fab.plan(*_t(dst, src))
            slabs, plan = fab.dispatch(*_t(x, dst, src))
            fab.combine(slabs, plan)
            fab.transfer(*_t(x, dst, src))
        return log.ops

    reference_ops = calls(_pair("reference", tb)[1])
    sanitize_ops = calls(_pair("reference", tb, debug="sanitize")[1])

    def boom(*a, **k):
        raise AssertionError("a check ran with debug off")

    for name in ("check_plan", "check_slabs", "check_combine"):
        monkeypatch.setattr(sanitize, name, boom)
    monkeypatch.setenv(DEBUG_ENV_VAR, "strict")
    off_ops = calls(_pair("reference", tb, debug=False)[1])
    assert off_ops == reference_ops
    assert len(sanitize_ops) > len(off_ops)


def test_debug_mode_keeps_single_signature():
    """Rewriting register values between checked calls adds no signature,
    as in the JAX package (its retrace pin under debug)."""
    x, dst, src = _traffic()
    jregs = JRegisters.create(N, capacity=CAP)
    tcell = {"regs": TRegisters.create(N, capacity=CAP)}
    jf = JFabric(jregs, backend="reference", capacity=CAP, debug=True)
    tf = Fabric(lambda: tcell["regs"], backend="reference", capacity=CAP,
                debug=True, device="cpu")
    jf.transfer(jnp.asarray(x), jnp.asarray(dst), jnp.asarray(src))
    tf.transfer(*_t(x, dst, src))
    jf.transfer(jnp.asarray(x), jnp.asarray(dst), jnp.asarray(src),
                registers=jregs.with_quota(dst=1, src=0, packages=1))
    tcell["regs"] = tcell["regs"].with_quota(dst=1, src=0, packages=1)
    tf.transfer(*_t(x, dst, src))
    assert tf.trace_counts["transfer"] == jf.trace_counts["transfer"] == 1


def test_cached_calls_are_checked_too():
    """With the plan cache on, a hit's dispatch still checks its slabs."""
    x, dst, src = _traffic()
    tf = Fabric(TRegisters.create(N, capacity=CAP), backend="reference",
                capacity=CAP, debug="sanitize", plan_cache=True,
                device="cpu")
    tf.dispatch(*_t(x, dst, src))
    xn = x.copy()
    xn[0, 0] = np.nan
    with pytest.raises(FabricCheckError, match="NaN"):
        tf.dispatch(*_t(xn, dst, src))            # a cache hit
    assert tf.plan_cache.hits >= 1


# ----------------------------------------------------------------------
# validate_registers
# ----------------------------------------------------------------------
def _fp(pkg_fp, gb):
    return pkg_fp(param_bytes=gb * GB, flops_per_token=1e9,
                  activation_bytes_per_token=4096)


def _events(sh, fp):
    return [sh.Submit(tenant="a", footprints=(_fp(fp, 4),) * 3, app_id=0),
            sh.Submit(tenant="b", footprints=(_fp(fp, 2),) * 2, app_id=1),
            sh.Shrink(tenant="a", n_regions=2), sh.FailRegion(rid=2),
            sh.HealRegion(rid=2), sh.Release(tenant="a")]


@pytest.mark.parametrize("policy", ["first_fit", "best_fit", "defrag"])
def test_validate_registers_after_each_post(policy):
    """The scripted lifecycle of the JAX package's shell test: after each
    ``Shell.post`` both register files pass ``validate_registers`` and are
    equal."""
    js = jshell.Shell([JRegion(rid=i, n_chips=16, hbm_bytes=16 * GB)
                       for i in range(4)], policy=policy)
    ts = tshell.Shell([TRegion(rid=i, n_chips=16, hbm_bytes=16 * GB)
                       for i in range(4)], policy=policy)
    for je, te in zip(_events(jshell, JFootprint), _events(tshell, TFootprint)):
        js.post(je)
        ts.post(te)
        ts.verify()
        jregisters.validate_registers(js.registers)
        validate_registers(ts.registers)
        assert_same_registers(js.registers, ts.registers)


def _bad_files():
    """(field, value) rewrites that break one invariant each."""
    return [("quota", lambda r: r.quota.at[0, 1].set(-1),
             lambda r: _set(r.quota, (0, 1), -1)),
            ("capacity", lambda r: r.capacity.at[2].set(-3),
             lambda r: _set(r.capacity, (2,), -3)),
            ("dest", lambda r: r.dest.at[1].set(-1),
             lambda r: _set(r.dest, (1,), -1)),
            ("dest", lambda r: r.dest.at[1].set(N),
             lambda r: _set(r.dest, (1,), N)),
            ("allowed", lambda r: r.allowed[:, :2],
             lambda r: r.allowed[:, :2])]


def _set(t, idx, v):
    t = t.clone()
    t[idx] = v
    return t


@pytest.mark.parametrize("case", range(5))
def test_validate_registers_raises_as_jax(case):
    field, jbad, tbad = _bad_files()[case]
    jr, tr = JRegisters.create(N), TRegisters.create(N)
    validate_registers(tr)
    jr = dataclasses.replace(jr, **{field: jbad(jr)})
    tr = dataclasses.replace(tr, **{field: tbad(tr)})
    with pytest.raises(AssertionError) as je:
        jregisters.validate_registers(jr)
    with pytest.raises(AssertionError) as te:
        validate_registers(tr)
    assert str(te.value) == str(je.value)
    assert tregisters.validate_registers is validate_registers


def test_validate_registers_after_erm_build():
    """The JAX package's ERM test: a two-tenant register file is valid in
    both packages and equal."""
    from repro.core.elastic import ElasticResourceManager as JERM
    from repro_torch.core.elastic import ElasticResourceManager as TERM
    files = []
    for erm_cls, region, fp in ((JERM, JRegion, JFootprint),
                                (TERM, TRegion, TFootprint)):
        erm = erm_cls([region(rid=i, n_chips=8, hbm_bytes=1 << 34)
                       for i in range(4)])
        erm.submit("a", [_fp(fp, 1), _fp(fp, 1)])
        erm.submit("b", [_fp(fp, 1), _fp(fp, 1)])
        files.append(erm.build_registers())
    jregisters.validate_registers(files[0])
    validate_registers(files[1])
    assert_same_registers(*files)
