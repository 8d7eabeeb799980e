"""The port's copy of the paper's hardware model (``repro_torch.core.hw``),
its module chain, its legacy Elastic Resource Manager and the use case as
a whole, against the JAX package, on the CPU.

``core/hw`` is pure Python and numpy in both packages, so every number is
held exactly equal: the Fig 5 times, the §V-D bandwidth table and the
calibration, the use case's output words and cycle counts, seeded
``CrossbarSim`` runs (several masters, quotas, isolation masks, an invalid
destination), the closed forms, the area model, the register file, the
arbiter and the Wishbone state machines.  The use case composes the port's
``Shell`` and ``ModuleChain`` with the Hamming ops (their plain versions on
CPU tensors) and is held to the JAX package's placements and words and to
``ElasticUseCase.run_case(k).output``.
"""
import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.hw as jhw
import repro_torch.core.hw as thw
from _torch_port import assert_same_registers
from repro.core import elastic as jel
from repro.core import module as jmod
from repro.core.hw import area as jarea, crossbar as jxs
from repro.kernels.hamming import ops as jops
from repro.shell import Shell as JShell
from repro_torch.core import elastic as tel
from repro_torch.core import module as tmod
from repro_torch.core.hw import area as tarea, crossbar as txs
from repro_torch.kernels.hamming.ops import paper_chain
from repro_torch.shell import Shell as TShell
from test_torch_imports import _run_blocked

GB = 1 << 30


def plain(obj):
    """A structure of Python values that compares equal across packages."""
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.value)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, np.ndarray):
        return (str(obj.dtype), obj.shape, obj.tobytes())
    if isinstance(obj, dict):
        return {plain(k): plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


# ----------------------------------------------------------------------
# the §V-C/§V-D use-case model
# ----------------------------------------------------------------------
@pytest.mark.parametrize("constant,n_words", [(3, 4096), (7, 1000)])
def test_elastic_use_case_numbers_equal(constant, n_words):
    j = jhw.ElasticUseCase(constant=constant, n_words=n_words)
    t = thw.ElasticUseCase(constant=constant, n_words=n_words)
    assert plain(t.host) == plain(j.host)
    assert t.calibration_residuals == j.calibration_residuals
    for quota in (16, 128):
        assert t.figure5(quota) == j.figure5(quota)
    assert t.bandwidth_table() == j.bandwidth_table()
    for k in (1, 2, 3):
        for seed in (0, 1):
            rt, rj = t.run_case(k, seed=seed), j.run_case(k, seed=seed)
            assert plain(rt) == plain(rj)
            assert rt.data_ok
    with pytest.raises(ValueError):
        t.run_case(4)


def test_paper_headline_numbers():
    """Fig 5's two calibrated endpoints, as the JAX package reproduces them."""
    fig5 = thw.ElasticUseCase().figure5()
    assert fig5[1] == pytest.approx(16.9) and fig5[3] == pytest.approx(10.87)
    assert fig5[1] > fig5[2] > fig5[3]


def test_computation_module_sims_equal():
    words = np.random.default_rng(3).integers(
        0, 1 << 32, size=777, dtype=np.uint64).astype(np.uint32)
    for tm, jm in ((thw.MultiplierModule(5), jhw.MultiplierModule(5)),
                   (thw.HammingEncoderModule(), jhw.HammingEncoderModule()),
                   (thw.HammingDecoderModule(), jhw.HammingDecoderModule())):
        (to, tc), (jo, jc) = tm.process(words), jm.process(words)
        assert tm.name == jm.name and tc == jc
        np.testing.assert_array_equal(to, jo)


# ----------------------------------------------------------------------
# the cycle-level crossbar, arbiter, registers, Wishbone, area
# ----------------------------------------------------------------------
def _regfile(hw, n_ports, rng_seed):
    """A register file with seeded isolation masks and quotas (one master
    isolated from one slave), written through the typed fields."""
    rng = np.random.default_rng(rng_seed)
    rf = hw.RegisterFile(n_ports=n_ports)
    for m in range(n_ports):
        mask = (1 << n_ports) - 1
        if m == 1:
            mask &= ~(1 << (n_ports - 1))
        rf.set_allowed_mask(m, mask)
        for s in range(n_ports):
            rf.set_quota(s, m, int(rng.integers(0, 5)))
    return rf


def _requests(hw, n_ports, seed, n=24):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        dst = int(rng.integers(0, n_ports))
        onehot = 1 << dst
        if rng.random() < 0.1:
            onehot = 0b11                    # not one-hot: invalid destination
        reqs.append(hw.MasterRequest(
            cycle=int(rng.integers(0, 40)),
            master=int(rng.integers(0, n_ports)),
            dst_onehot=onehot, n_words=int(rng.integers(1, 20)),
            app_id=int(rng.integers(0, 3))))
    return reqs


@pytest.mark.parametrize("n_ports,seed", [(4, 0), (4, 1), (6, 2), (8, 3)])
def test_crossbar_sim_results_equal(n_ports, seed):
    out = {}
    for name, hw in (("jax", jhw), ("torch", thw)):
        rf = _regfile(hw, n_ports, seed)
        sim = hw.CrossbarSim(n_ports=n_ports, regfile=rf)
        for req in _requests(hw, n_ports, seed):
            sim.submit(req)
        results = sim.run()
        out[name] = (plain(results), dict(rf.regs),
                     [(r.time_to_grant, r.completion_latency)
                      for r in results])
    assert out["torch"] == out["jax"]
    errors = {e[0] for e in (r["error"] for r in out["torch"][0])}
    assert errors == {"ErrorCode"}
    codes = {r["error"][1] for r in out["torch"][0]}
    assert len(codes) > 1                     # some transfers fail


def test_crossbar_sim_refuses_a_master_in_reset():
    for hw in (jhw, thw):
        rf = hw.RegisterFile(n_ports=4)
        rf.set_reset(2, True)
        with pytest.raises(RuntimeError, match="reset"):
            hw.CrossbarSim(regfile=rf).submit(
                hw.MasterRequest(cycle=0, master=2, dst_onehot=1))


def test_closed_forms_equal():
    assert txs.best_case_time_to_grant() == jxs.best_case_time_to_grant() == 4
    for n in range(1, 40):
        assert txs.request_completion_cc(n) == jxs.request_completion_cc(n)
    for m in range(1, 10):
        for n in (1, 8, 16):
            assert (txs.worst_case_time_to_grant(m, n)
                    == jxs.worst_case_time_to_grant(m, n))
            assert (txs.worst_case_completion_cc(m, n)
                    == jxs.worst_case_completion_cc(m, n))
    assert txs.worst_case_completion_cc(3) == 37


def test_area_model_equal():
    t, j = tarea.AreaModel(), jarea.AreaModel()
    for fn in ("lut_saving_vs_noc", "ff_saving_vs_noc", "power_ratio_vs_noc",
               "lut_overhead_vs_ewb", "ff_saving_vs_ewb"):
        assert getattr(t, fn)() == getattr(j, fn)(), fn
    for n in (2, 4, 8):
        assert t.crossbar_lut(n) == j.crossbar_lut(n)
        assert t.system_ff(n) == j.system_ff(n)
        assert t.latency_saving_vs_noc(n) == j.latency_saving_vs_noc(n)
    assert (tarea.AreaModel.worst_case_latency_curve(8)
            == jarea.AreaModel.worst_case_latency_curve(8))
    assert (tarea.AreaModel.register_count(3)
            == jarea.AreaModel.register_count(3))


def test_register_file_contents_equal():
    files = []
    for hw in (jhw, thw):
        rf = hw.RegisterFile(n_ports=4)
        rf.set_allowed_mask(0, 0b1010)
        rf.set_quota(3, 1, 200)
        rf.set_quota(2, 0, 7)
        rf.set_pr_dest(1, 0b0100)
        rf.set_app_dest(2, 0b0001)
        rf.set_reset(3, True)
        rf.set_pr_error(2, 3)
        rf.set_app_error(1, 2)
        rf.set_icap_status(5)
        rf.write(int(hw.RegAddr.DEVICE_ID), -1)          # 32-bit wrap
        files.append((dict(rf.regs), rf.quota_row(3), rf.allowed_mask(0),
                      rf.in_reset(3), rf.pr_error(2), rf.app_error(1)))
    assert files[0] == files[1]
    assert [a.name for a in thw.RegAddr] == [a.name for a in jhw.RegAddr]


def test_arbiter_grant_sequences_equal():
    rng = np.random.default_rng(9)
    for x in [0, 1, 2**31, 2**32 - 1] + list(rng.integers(0, 2**32, 50)):
        assert thw.lzc32(int(x)) == jhw.lzc32(int(x))
        assert thw.rotl(int(x), 5, 32) == jhw.rotl(int(x), 5, 32)
    requests = [int(v) for v in rng.integers(0, 16, 80)]
    packages = [int(v) for v in rng.integers(1, 4, 80)]
    grants = []
    for hw in (jhw, thw):
        arb = hw.WRRArbiter(n_ports=4, quotas=[3, 1, 0, 2])
        seq = []
        for req, n_pkg in zip(requests, packages):
            g = arb.grant_next(req)
            if g is not None:
                seq.append((g, [arb.on_package() for _ in range(n_pkg)]))
                arb.release()
        grants.append((seq, arb.grants_issued, arb.preemptions))
    assert grants[0] == grants[1]
    for req in range(16):
        for start in range(4):
            assert (thw.first_requester(req, start, 4)
                    == jhw.first_requester(req, start, 4))


def test_wishbone_state_machines_equal():
    from repro.core.hw import wishbone as jwb
    from repro_torch.core.hw import wishbone as twb
    trace = []
    for wb in (jwb, twb):
        rng = np.random.default_rng(4)
        m, s = wb.WBMasterIF(watchdog_grant=6), wb.WBSlaveIF(buffer_words=3)
        m.start(list(range(10)), 0b0100)
        steps = []
        ack = False
        for _ in range(60):
            word = m.step(grant=bool(rng.random() < 0.7), stall=s.stall,
                          ack=ack)
            ack = s.step(request=m.state.name in ("SEND", "WAIT_ACK"),
                         word=word)
            if s.buffer_full and rng.random() < 0.5:
                s.module_read()
            steps.append((m.state.name, m.error.value, word, ack,
                          s.state.name, len(s.regs)))
        trace.append(steps)
    assert trace[0] == trace[1]


# ----------------------------------------------------------------------
# the legacy Elastic Resource Manager
# ----------------------------------------------------------------------


def _erm_run(el, mod):
    erm = el.ElasticResourceManager(
        [el.Region(rid=i, n_chips=16, hbm_bytes=16 * GB) for i in range(4)])
    def fp(g):
        return mod.ModuleFootprint(param_bytes=g * GB, flops_per_token=1e9,
                                   activation_bytes_per_token=4096)
    log = [erm.submit("a", [fp(1), fp(2), fp(1)]),
           erm.submit("b", [fp(1), fp(1)], app_id=1),
           erm.shrink("a", 1), erm.placement_of("b"),
           erm.grow("a"), erm.placement_of("b")]
    erm.fail_region(0)
    log.append(erm.placement_of("a"))
    erm.heal_region(0)
    erm.release("b")
    log += [erm.placement_of("a"), erm.utilization(),
            erm.reconfig_cost_s(fp(3)), len(erm.free_regions())]
    events = [(e.kind, e.tenant, e.module_idx, e.region, e.cost_s,
               e.wall_time) for e in erm.events]
    tenants = {n: (t.placement, t.max_regions, t.on_server_modules,
                   t.placed_count, t.may_grow())
               for n, t in erm.tenants.items()}
    regions = {r: (v.tenant, v.module_idx, v.healthy, v.free)
               for r, v in erm.regions.items()}
    return log, events, tenants, regions, erm.build_registers(capacity=16)


def test_elastic_resource_manager_equal():
    jlog, jev, jten, jreg, jregs = _erm_run(jel, jmod)
    tlog, tev, tten, treg, tregs = _erm_run(tel, tmod)
    assert (tlog, tev, tten, treg) == (jlog, jev, jten, jreg)
    assert_same_registers(jregs, tregs)
    assert {e[0] for e in tev} >= {"allocate", "demote", "promote", "fail"}
    assert tel.ON_SERVER == jel.ON_SERVER == -1


# ----------------------------------------------------------------------
# the use case as a whole: shell placement + module chain
# ----------------------------------------------------------------------
def _jax_chain(constant=3):
    def module(name, fn):
        return jmod.module_from_layer(name, lambda key: None,
                                      lambda p, x: fn(x), d_model=1,
                                      param_count=0, flops_per_token=1.0,
                                      dtype_bytes=4)
    return jmod.ModuleChain([
        module("multiplier", lambda x: jops.multiply_const(x, constant)),
        module("hamming_encoder", jops.hamming_encode),
        module("hamming_decoder", lambda x: jops.hamming_decode(x)[0]),
    ])


def _regions(el, n):
    return [el.Region(rid=i, n_chips=1, hbm_bytes=GB) for i in range(n)]


def _use_case_words(n_words):
    return np.random.default_rng(0).integers(0, 1 << 26, size=n_words,
                                             dtype=np.uint32)


def _both_apply(tchain, jchain, placement, data):
    tout = tchain.apply(tchain.init(torch.Generator().manual_seed(0)),
                        torch.from_numpy(data), placement)
    jout = jchain.apply(jchain.init(jax.random.key(0)), jnp.asarray(data),
                        placement)
    assert tout.dtype == torch.uint32
    out = tout.view(torch.int32).numpy().view(np.uint32)
    np.testing.assert_array_equal(out, np.asarray(jout))
    return out


@pytest.mark.parametrize("k", [1, 2, 3])
def test_use_case_cases_place_and_compute_as_jax(k):
    uc = thw.ElasticUseCase()
    tchain, jchain = paper_chain(uc.constant), _jax_chain(uc.constant)
    assert tchain.footprints == [tmod.ModuleFootprint(**dataclasses.asdict(f))
                                 for f in jchain.footprints]
    tsh, jsh = TShell(_regions(tel, k)), JShell(_regions(jel, k))
    placement = tsh.submit("usecase", tchain)
    assert placement == jsh.submit("usecase", jchain)
    assert placement == list(range(k)) + [tel.ON_SERVER] * (3 - k)
    out = _both_apply(tchain, jchain, placement, _use_case_words(uc.n_words))
    np.testing.assert_array_equal(out, uc.run_case(k).output)
    assert_same_registers(jsh.registers, tsh.registers)


def test_use_case_grows_from_one_region_to_three_as_jax():
    """Three regions, two held by a second tenant; the use-case tenant is
    admitted on one, capped there, keeps it when the other leaves, and
    Grow moves its encoder and decoder onto the freed regions."""
    uc = thw.ElasticUseCase()
    data = _use_case_words(uc.n_words)
    tchain, jchain = paper_chain(uc.constant), _jax_chain(uc.constant)
    tsh, jsh = TShell(_regions(tel, 3)), JShell(_regions(jel, 3))
    tsh.submit("other", [tmod.ModuleFootprint(0, 1.0, 4)] * 2)
    jsh.submit("other", [jmod.ModuleFootprint(0, 1.0, 4)] * 2)
    placements = []
    for step in (lambda s, c: s.submit("usecase", c),
                 lambda s, c: s.shrink("usecase", 1),
                 lambda s, c: s.release("other"),
                 lambda s, c: s.grow("usecase")):
        step(tsh, tchain)
        step(jsh, jchain)
        placement = tsh.placement_of("usecase")
        assert placement == jsh.placement_of("usecase")
        assert_same_registers(jsh.registers, tsh.registers)
        placements.append(placement)
        out = _both_apply(tchain, jchain, placement, data)
        np.testing.assert_array_equal(out, uc.run_case(3).output)
    assert placements[0] == [2, -1, -1] == placements[-2]
    assert sorted(placements[-1]) == [0, 1, 2]


def test_hw_model_and_use_case_run_with_jax_blocked():
    code = (
        "import numpy as np, torch\n"
        "import repro_torch.core.hw as hw\n"
        "from repro_torch.kernels.hamming.ops import paper_chain\n"
        "uc = hw.ElasticUseCase()\n"
        "f = uc.figure5()\n"
        "ch = paper_chain(uc.constant)\n"
        "x = np.random.default_rng(0).integers(0, 1 << 26, size=uc.n_words,"
        " dtype=np.uint32)\n"
        "out = ch.apply(ch.init(torch.Generator()), torch.from_numpy(x),"
        " [0, -1, -1])\n"
        "ok = np.array_equal(out.view(torch.int32).numpy().view(np.uint32),"
        " uc.run_case(1).output)\n"
        "print(round(f[1], 2), ok)\n")
    assert _run_blocked(code) == "16.9 True"
