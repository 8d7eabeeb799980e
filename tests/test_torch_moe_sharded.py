"""The port's mesh expert parallelism (``moe_apply(dispatch_impl=
"sharded")``, ``moe_forward_sharded``) against the JAX package's
single-device oracle, ``moe_apply_sharded_reference(n_shards=4)``.

The smoke Mixtral's MoE (E=4, top-2, d=64, d_ff=128), float32, parameters
from the JAX init, on four ranks over gloo on the CPU: one spawn for the
MoE cases and one for the deprecated crossbar shims
(``_torch_sharded_worker``).  The JAX oracle runs here.  (JAX's own
forced-4-device sharded MoE does not run on this JAX version; its
one-device oracle does.)

- ``y`` within 1e-5 of its largest value (JAX's own tolerance for its
  sharded path is ``atol=1e-5``, between two XLA programs; JAX's init
  takes the fan-in from the expert axis, so ``y`` here reaches about 100,
  where a float32 ulp is 8e-6 and the port's matmuls sum in another
  order), ``aux_loss`` within ``rtol=1e-5``, every integer stat
  (``counts``, ``dropped``, ``iso_dropped``, offered, granted, local and
  remote packets and per-port splits) equal, at ample and tight capacity
  and with an expert mask; the same through ``moe_apply(dispatch_impl=
  "sharded")`` on each rank's own tokens and expert block;
- the gradients of ``x`` and of every parameter (the replicated router's
  summed over the ranks) within 1e-5 of the leaf's largest value of
  ``jax.grad`` of the oracle, on every rank;
- a ``Shell`` reconfigured between two calls (Grow, then FailRegion)
  re-routes as the oracle does under the new registers, with the cached
  fabric's ``trace_count`` unchanged;
- an expert count the ranks cannot split is refused;
- the deprecated ``exchange_sharded``/``combine_sharded`` shims: keep and
  slot equal to JAX's ``pairwise_dispatch_plan``, each rank's received
  slabs and mask what each sender sent, the combine the weighted rows.

Without a spawn: the port's ``moe_apply_sharded_reference`` against JAX's,
an expert block that does not divide E refused by ``moe_apply``, every
family's ``param_specs`` and ``batch_axes`` against JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_registers, np_registers, to_np
from _torch_sharded_worker import spawn
from repro.configs import all_configs as jax_all_configs
from repro.configs import get_config as jax_get_config
from repro.core.crossbar import pairwise_dispatch_plan
from repro.core.elastic import Region as JRegion
from repro.core.module import ModuleFootprint as JFootprint
from repro.models import moe as jmoe
from repro.models.common import init_params
from repro.models.lm import batch_axes as jax_batch_axes
from repro.models.lm import build_model as jax_build_model
from repro.shell import FailRegion as JFail
from repro.shell import Grow as JGrow
from repro.shell import Shell as JShell
from repro.shell import Submit as JSubmit
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import moe as tmoe
from repro_torch.models.config import MoEConfig as TMoEConfig
from repro_torch.models.lm import batch_axes, build_model

N = 4
B, S = 8, 16
AUX_C = 0.5
SHELL_CAP = 24
MASK = (True, True, False, True)


def _setup():
    cfg = jax_get_config("mixtral_8x7b", smoke=True)
    moe = cfg.moe
    params = init_params(jmoe.moe_defs(cfg.d_model, cfg.d_ff, moe, "swiglu"),
                         jax.random.key(0), jnp.float32)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    ample = jmoe.expert_capacity(B * S, moe)
    cases = [(ample, None), (24, None), (ample, MASK)]
    return cfg, moe, params, x, ct, cases


def _moe_kw(moe):
    return dict(n_experts=moe.n_experts, top_k=moe.top_k,
                capacity_factor=moe.capacity_factor)


@pytest.fixture(scope="module")
def moe_ranks(tmp_path_factory):
    cfg, moe, params, x, ct, cases = _setup()
    moe6 = jmoe.MoEConfig(n_experts=6, top_k=2)
    params6 = init_params(jmoe.moe_defs(cfg.d_model, cfg.d_ff, moe6,
                                        "swiglu"),
                          jax.random.key(1), jnp.float32)
    payload = {"moe": _moe_kw(moe),
               "params": {k: np.asarray(v) for k, v in params.items()},
               "params6": {k: np.asarray(v) for k, v in params6.items()},
               "x": x, "ct": ct, "aux_c": AUX_C, "cases": cases,
               "shell_cap": SHELL_CAP}
    res = spawn("moe_cases", N, tmp_path_factory.mktemp("moe"), payload)
    return (moe, params, x, ct, cases), res


def _oracle(moe, params, x, ct, **kw):
    def loss(p, xx):
        y, st = jmoe.moe_apply_sharded_reference(p, xx, moe, "swiglu",
                                                 n_shards=N, **kw)
        return jnp.sum(y * ct) + AUX_C * st["aux_loss"], (y, st)
    (_, (y, st)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    return y, st, dict(gp, x=gx)


INT_STATS = ("dropped", "iso_dropped", "capacity", "counts",
             "offered_packets", "granted_packets", "local_packets",
             "remote_packets", "local_counts", "remote_counts")


def _close(got, want):
    want = to_np(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def _same_stats(got, want):
    for k in INT_STATS:
        assert np.array_equal(np.asarray(got[k]), to_np(want[k])), (
            k, got[k], want[k])
    np.testing.assert_allclose(float(got["aux_loss"]),
                               float(want["aux_loss"]), rtol=1e-5)


@pytest.mark.parametrize("i", range(3))
def test_sharded_moe_matches_the_oracle(moe_ranks, i):
    (moe, params, x, ct, cases), res = moe_ranks
    cap, mask = cases[i]
    m = None if mask is None else jnp.asarray(mask)
    y, st, _ = _oracle(moe, params, x, ct, capacity=cap, expert_mask=m)
    for r in range(N):
        got = res[r]["cases"][i]
        _close(got["y"], y)
        _same_stats(got["stats"], st)
    if i == 1:
        assert int(st["dropped"]) > 0
    if i == 2:
        assert int(to_np(st["counts"])[2]) == 0


@pytest.mark.parametrize("i", range(3))
def test_sharded_moe_gradients_match_the_oracle(moe_ranks, i):
    (moe, params, x, ct, cases), res = moe_ranks
    cap, mask = cases[i]
    m = None if mask is None else jnp.asarray(mask)
    _, _, grads = _oracle(moe, params, x, ct, capacity=cap, expert_mask=m)
    for r in range(N):
        got = res[r]["cases"][i]["grads"]
        assert set(got) == set(grads)
        for k, want in grads.items():
            want = to_np(want)
            err = np.abs(got[k] - want).max()
            assert err <= 1e-5 * np.abs(want).max(), (r, k, err)


def test_moe_apply_sharded_on_each_ranks_block(moe_ranks):
    (moe, params, x, ct, cases), res = moe_ranks
    y, st, _ = _oracle(moe, params, x, ct, capacity=cases[0][0])
    for r in range(N):
        got = res[r]["applied"]
        _close(got["y"], y)
        _same_stats(got["stats"], st)


def _jax_shell_registers():
    GB = 1 << 30
    fp = lambda: JFootprint(param_bytes=GB, flops_per_token=1e9,
                            activation_bytes_per_token=4096)
    shell = JShell([JRegion(rid=i, n_chips=8, hbm_bytes=8 * GB)
                    for i in range(3)], capacity=SHELL_CAP)
    shell.post(JSubmit(tenant="moe", footprints=(fp(), fp()), app_id=0))
    regs0 = shell.registers
    shell.post(JGrow(tenant="moe", n_regions=3))
    shell.post(JFail(rid=1))
    return regs0, shell.registers


def test_shell_post_reroutes_without_a_new_signature(moe_ranks):
    (moe, params, x, ct, _), res = moe_ranks
    regs0, regs1 = _jax_shell_registers()
    y0, s0, _ = _oracle(moe, params, x, ct, registers=regs0,
                        capacity=SHELL_CAP)
    y1, s1, _ = _oracle(moe, params, x, ct, registers=regs1,
                        capacity=SHELL_CAP)
    for r in range(N):
        got = res[r]["reconf"]
        _close(got["y0"], y0)
        _close(got["y1"], y1)
        _same_stats(got["s0"], s0)
        _same_stats(got["s1"], s1)
        assert got["after"] == got["before"] > 0
    assert not np.allclose(to_np(y0), to_np(y1))
    assert int(to_np(s1["counts"])[2]) == 0 and int(s1["iso_dropped"]) > 0


def test_sharded_moe_refuses_an_indivisible_expert_count(moe_ranks):
    _, res = moe_ranks
    for r in range(N):
        assert "divisible" in res[r]["refused"], res[r]["refused"]


@pytest.fixture(scope="module")
def shim_ranks(tmp_path_factory):
    rng = np.random.default_rng(3)
    regs = np_registers(rng, N, capacity=6)
    T, D, cap = 10, 8, 6
    dst = rng.integers(-1, N + 1, N * T).astype(np.int32)
    payload = {"regs": regs, "cap": cap, "dst": dst,
               "x": rng.standard_normal((N * T, D)).astype(np.float32),
               "w": rng.standard_normal(N * T).astype(np.float32)}
    res = spawn("shim_cases", N, tmp_path_factory.mktemp("shims"), payload)
    return payload, res


def test_sharded_shims_plan_as_jax_pairwise(shim_ranks):
    payload, res = shim_ranks
    regs = jax_registers(payload["regs"])
    T = payload["dst"].shape[0] // N
    for r in range(N):
        keep, slot, _ = pairwise_dispatch_plan(
            jnp.asarray(payload["dst"][r * T:(r + 1) * T]), r, regs,
            payload["cap"])
        assert np.array_equal(res[r]["keep"], to_np(keep)), r
        assert np.array_equal(res[r]["slot"], to_np(slot)), r


def test_sharded_shims_deliver_what_was_sent(shim_ranks):
    payload, res = shim_ranks
    cap = payload["cap"]
    T, D = payload["dst"].shape[0] // N, payload["x"].shape[1]
    recv = np.zeros((N, N, cap, D), np.float32)        # [to, from, slot]
    mask = np.zeros((N, N, cap), np.float32)
    back = np.zeros((N, T, D), np.float32)
    for i in range(N):
        keep, slot = res[i]["keep"], res[i]["slot"]
        dst = payload["dst"][i * T:(i + 1) * T]
        x = payload["x"][i * T:(i + 1) * T]
        w = payload["w"][i * T:(i + 1) * T]
        for t in range(T):
            if keep[t] and 0 <= dst[t] < N and 0 <= slot[t] < cap:
                recv[dst[t], i, slot[t]] = x[t]
                mask[dst[t], i, slot[t]] = 1.0
                back[i, t] = 2.0 * x[t] * w[t]
    assert mask.sum() > 0
    for r in range(N):
        assert np.array_equal(res[r]["recv"], recv[r]), r
        assert np.array_equal(res[r]["mask"], mask[r]), r
        np.testing.assert_allclose(res[r]["back"], back[r], rtol=1e-6)


# ----------------------------------------------------------------------
# no spawn
# ----------------------------------------------------------------------
@pytest.mark.parametrize("capacity,mask", [(None, None), (24, None),
                                           (None, MASK)])
def test_oracle_matches_jax_oracle(capacity, mask):
    cfg, moe, params, x, _, _ = _setup()
    regs = np_registers(np.random.default_rng(4), moe.n_experts,
                        capacity=40)
    m = None if mask is None else np.asarray(mask)
    yj, sj = jmoe.moe_apply_sharded_reference(
        params, jnp.asarray(x), moe, "swiglu", n_shards=N,
        registers=jax_registers(regs), capacity=capacity,
        expert_mask=None if m is None else jnp.asarray(m))
    from _torch_sharded_worker import registers as torch_regs
    yt, st = tmoe.moe_apply_sharded_reference(
        {k: torch.from_numpy(np.array(v)) for k, v in params.items()},
        torch.from_numpy(x), TMoEConfig(**_moe_kw(moe)), "swiglu",
        n_shards=N, registers=torch_regs(regs), capacity=capacity,
        expert_mask=None if m is None else torch.from_numpy(m))
    _close(to_np(yt), yj)
    _same_stats({k: to_np(v) for k, v in st.items()}, sj)


def test_sharded_impl_refuses_an_expert_block_that_does_not_divide():
    moe = TMoEConfig(n_experts=8, top_k=2)
    params = {"w_router": torch.zeros(16, 8),
              "w_in": torch.zeros(3, 16, 64), "w_out": torch.zeros(3, 32, 16)}
    with pytest.raises(ValueError, match="divide"):
        tmoe.moe_apply(params, torch.zeros(2, 8, 16), moe, "swiglu",
                       dispatch_impl="sharded")


def _same_specs(jtree, ttree, depth=0):
    """JAX stacks per-layer leaves (one leading axis per level of lists in
    the port's tree, spec None); the rest of each spec is the port's."""
    if isinstance(ttree, list):
        for layer in ttree:
            _same_specs(jtree, layer, depth + 1)
    elif isinstance(ttree, dict):
        assert set(jtree) == set(ttree)
        for k in ttree:
            _same_specs(jtree[k], ttree[k], depth)
    else:
        assert tuple(jtree) == (None,) * depth + ttree, (tuple(jtree), ttree)


@pytest.mark.parametrize("arch", sorted(jax_all_configs(smoke=True)))
@pytest.mark.parametrize("multi_pod", [False, True])
def test_param_specs_match_jax(arch, multi_pod):
    jspecs = jax_build_model(jax_get_config(arch, smoke=True)).param_specs(
        multi_pod)
    tspecs = build_model(torch_get_config(arch, smoke=True),
                         device="cpu").param_specs(multi_pod)
    _same_specs(jspecs, tspecs)


@pytest.mark.parametrize("batch", [1, 16, 32, 48])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_batch_axes_match_jax(batch, multi_pod):
    assert batch_axes(batch, multi_pod) == jax_batch_axes(batch, multi_pod)
