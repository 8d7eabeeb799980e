"""The launch tools of the port (``repro_torch.launch``: ``roofline``,
``costfit``, ``dryrun``, ``mesh``, ``steps``) and the shape helpers of its
models, held against the JAX package at smoke widths on the CPU.

Nothing here runs JAX's ``build_step``, ``lower_step`` or dry run (they
compile on a forced 512-device mesh); the JAX side is its pure functions
(``attn_area``, ``model_flops_for``, ``model_bytes_for``,
``parse_collectives``, ``dense_routing_bytes``), its models' shape and
spec trees, and ``NamedSharding.shard_shape`` on an ``AbstractMesh``.

The cost fit is held exact (holdout below 1e-6) where its structural
model covers every cost of the port's plain path: decode for each family,
and prefill's attention area on the smoke Mixtral.  A train step's bytes
are not in it: the plain path's autograd writes a full-size gradient for
each chunk slice (``select``/``slice`` backward), a cost cubic in S in
the chunked attention, so a train cell's holdout error is recorded, not
bounded.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.launch import costfit as jcostfit
from repro.launch import roofline as jroofline
from repro.models.config import LM_SHAPES as J_LM_SHAPES
from repro.models.config import shapes_for as j_shapes_for
from repro.models.lm import build_model as jax_build_model
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.registers import CrossbarRegisters
from repro_torch.fabric import Fabric
from repro_torch.launch import costfit, dryrun, roofline
from repro_torch.launch.mesh import (MESH_NAMES, MeshSpec,
                                     make_production_mesh, make_smoke_mesh)
from repro_torch.launch.steps import (NamedSharding, OpRecorder, StepBundle,
                                      build_step, lower_step,
                                      make_train_step, named,
                                      opt_state_specs, opt_state_structs,
                                      record_step)
from repro_torch.models.common import tree_leaves
from repro_torch.models.config import ShapeConfig, shapes_for
from repro_torch.models.lm import build_model
from repro_torch.models.moe import expert_capacity
from repro_torch.optim.adamw import AdamW

from _torch_port import smoke_mixtral

FAMILY_ARCHS = ("tinyllama_1_1b", "mamba2_780m", "recurrentgemma_9b",
                "whisper_medium")
SMOKE_SHAPE = {"train": ShapeConfig("train_small", 32, 2, "train"),
               "prefill": ShapeConfig("prefill_small", 32, 2, "prefill"),
               "decode": ShapeConfig("decode_small", 32, 2, "decode")}
CARD = make_smoke_mesh()


def _dtype_name(d) -> str:
    return str(d).rsplit(".", 1)[-1]


# ----------------------------------------------------------------------
# roofline and costfit against the JAX package
# ----------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 48, 4096])
def test_attn_area_equals_jax(causal, window):
    for S in (64, 512, 1000, 4096, 32768):
        assert costfit.attn_area(S, causal=causal, window=window) == \
            jcostfit.attn_area(S, causal=causal, window=window), S


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_bytes_equal_jax(arch):
    cfg_t, cfg_j = get_config(arch), jax_get_config(arch)
    model_t = build_model(cfg_t, device="meta")
    model_j = jax_build_model(cfg_j)
    n = model_t.n_params()
    assert n == model_j.n_params()
    assert [s.name for s in shapes_for(cfg_t)] == \
        [s.name for s in j_shapes_for(cfg_j)]
    for shape_t in shapes_for(cfg_t):
        shape_j = next(s for s in J_LM_SHAPES if s.name == shape_t.name)
        for n_active in (None, n // 3):
            assert roofline.model_flops_for(cfg_t, shape_t, n, n_active) == \
                jroofline.model_flops_for(cfg_j, shape_j, n, n_active)
        assert roofline.model_bytes_for(cfg_t, shape_t, n, model_t) == \
            jroofline.model_bytes_for(cfg_j, shape_j, n, model_j)


def test_h100_constants_and_bound():
    assert (roofline.PEAK_FLOPS, roofline.PEAK_FLOPS_F32, roofline.HBM_BW,
            roofline.ICI_BW) == (989e12, 67e12, 3.35e12, 450e9)
    # the formula chip_smoke.py's kernels line has always used
    n_bytes, n_ops = 3.0e9, 5.0e13
    assert roofline.bound(n_bytes, n_ops) == (
        max(n_bytes / 3.35e12 * 1e3, n_ops / 67e12 * 1e3), "operations")
    assert roofline.bound(n_bytes, 1.0, 989e12)[1] == "bytes"
    terms = roofline.RooflineTerms(
        arch="a", shape="s", mesh="card", chips=1, flops_per_device=989e12,
        bytes_per_device=3.35e12 / 2, collective_bytes_per_device=0.0,
        collectives={}, model_flops=989e12 / 2)
    assert terms.bottleneck == "compute" and terms.roofline_s == 1.0
    assert terms.roofline_fraction == 0.5
    assert set(terms.to_dict()) == set(jroofline.RooflineTerms(
        **dataclasses.asdict(terms)).to_dict())


def test_kernel_mode_for_target():
    from repro_torch.fabric.interface import KernelMode, parse_kernel_mode
    assert roofline.kernel_mode_for_target("cuda") == "cuda_kernel"
    assert roofline.kernel_mode_for_target("cpu") == "torch"
    assert roofline.kernel_mode_for_target("meta") == "torch"
    assert parse_kernel_mode("cuda_kernel") is KernelMode.CUDA
    with pytest.raises(ValueError):
        roofline.kernel_mode_for_target("tpu")


HLO_TEXT = """\
%ar = bf16[16,512]{1,0} all-reduce(bf16[16,512] %x), replica_groups={}
ROOT %ag.1 = f32[4,8,64] all-gather(f32[1,8,64] %y), dimensions={0}
%s = (f32[8], f32[8]) all-reduce-start(f32[8] %a, f32[8] %b)
%d = (f32[8], f32[8]) all-reduce-done((f32[8], f32[8]) %s)
%a2a = s32[4,256] all-to-all(s32[4,256] %z)
%rs = pred[2,2] reduce-scatter(pred[4,2] %w)
%cp = u8[128] collective-permute(u8[128] %v)
%sel = bf16[96,4,32]{2,1,0} multiply(bf16[96,4,32] %p, bf16[96,4,32] %q)
%sel2 = f32[128,96] copy(f32[96,128] %r)
%small = s8[96,128] convert(s32[96,128] %t)
"""


def test_parse_collectives_and_dense_routing_equal_jax():
    assert roofline.parse_collectives(HLO_TEXT) == \
        jroofline.parse_collectives(HLO_TEXT)
    assert roofline.parse_collectives(HLO_TEXT)["all-reduce"]["count"] == 2
    for tokens, pxc in ((96, 128), (96, 64), (128, 96), (7, 3)):
        got = roofline.dense_routing_bytes(HLO_TEXT, tokens, pxc)
        assert got == jroofline.dense_routing_bytes(HLO_TEXT, tokens, pxc)
    assert roofline.dense_routing_bytes(HLO_TEXT, 96, 128) == 96 * 128 * 4


# ----------------------------------------------------------------------
# the shape helpers against the JAX package's models
# ----------------------------------------------------------------------
def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _assert_same_tree(port, jtree, spec: bool, strip: int = 0):
    """``port`` (per-layer lists) against ``jtree`` (stacked layer axes):
    every port list stands for one more leading axis of the JAX leaves."""
    if isinstance(port, list):
        if not spec:
            assert len(port) == _first_leaf(jtree).shape[strip]
        for p in port:
            _assert_same_tree(p, jtree, spec, strip + 1)
        return
    if isinstance(port, dict):
        assert set(port) == set(jtree)
        for k in port:
            _assert_same_tree(port[k], jtree[k], spec, strip)
        return
    if spec:
        assert port == tuple(jtree)[strip:], (port, jtree)
    else:
        assert port.device.type == "meta"
        assert tuple(port.shape) == tuple(jtree.shape)[strip:]
        assert _dtype_name(port.dtype) == _dtype_name(jtree.dtype)


def _assert_same_state(port, jstate, spec: bool):
    for f in dataclasses.fields(jstate):
        j, p = getattr(jstate, f.name), getattr(port, f.name)
        assert (j is None) == (p is None), f.name
        if j is not None:
            _assert_same_tree(p, j, spec)


@pytest.mark.parametrize("arch", FAMILY_ARCHS + ("llava_next_34b",
                                                 "mixtral_8x7b"))
def test_shape_helpers_equal_jax(arch):
    cfg_t, cfg_j = get_config(arch, smoke=True), jax_get_config(arch,
                                                                 smoke=True)
    mt, mj = build_model(cfg_t, device="meta"), jax_build_model(cfg_j)
    _assert_same_tree(mt.param_shapes(), mj.param_shapes(), False)
    for multi_pod in (False, True):
        _assert_same_tree(mt.param_specs(multi_pod),
                          mj.param_specs(multi_pod), True)
        for kind, shape in SMOKE_SHAPE.items():
            for B in (1, 16, 32):
                sh = dataclasses.replace(shape, global_batch=B)
                st, sp = mt.input_shapes(sh, multi_pod)
                jst, jsp = mj.input_shapes(sh, multi_pod)
                _assert_same_tree(st, jst, False)
                _assert_same_tree(sp, jsp, True)
                if kind == "decode":
                    st, sp = mt.decode_state_shapes(sh, multi_pod)
                    jst, jsp = mj.decode_state_shapes(sh, multi_pod)
                    _assert_same_state(st, jst, False)
                    _assert_same_state(sp, jsp, True)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_state_bytes_equal_allocation(arch):
    """``decode_state_shapes`` holds the tensors ``init_decode_state``
    allocates for the same batch and length, plus ``pos``: JAX's int32
    scalar, a host int in the port's live state."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model = build_model(cfg, device="cpu")
    shape = ShapeConfig("d", 40, 3, "decode")
    structs, _ = model.decode_state_shapes(shape, False)
    live = model.init_decode_state(3, 40)
    assert isinstance(live.pos, int)
    assert structs.pos.shape == () and structs.pos.dtype == torch.int32
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    assert nbytes(structs.leaves()) - 4 == nbytes(live.leaves()) > 0
    assert [(t.shape, t.dtype) for t in structs.leaves()[1:]] == \
        [(t.shape, t.dtype) for t in live.leaves()]


def test_constrain_is_identity_off_a_mesh():
    model = build_model(get_config("tinyllama_1_1b", smoke=True),
                        device="cpu")
    x = torch.ones(2, 3, 4)
    assert model.batch_axis is None and model.constrain(x) is x
    model.batch_axis = "data"
    assert model.constrain(x) is x


# ----------------------------------------------------------------------
# meshes and shardings
# ----------------------------------------------------------------------
def test_meshes():
    pod, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (pod.shape, pod.axis_names, pod.size) == ((16, 16),
                                                    ("data", "model"), 256)
    assert (multi.shape, multi.axis_names, multi.size) == (
        (2, 16, 16), ("pod", "data", "model"), 512)
    assert multi.axis_size("pod") == 2 and pod.axis_size("model") == 16
    assert make_smoke_mesh() == MeshSpec((1, 1), ("data", "model"))
    assert MESH_NAMES == {"card": False, "pod": False, "multipod": True}
    with pytest.raises(RuntimeError, match="ranks"):
        pod.device_mesh()
    with pytest.raises(ValueError):
        MeshSpec((2, 2), ("data",))


def test_shard_shape_equals_jax_on_production_meshes():
    """Every parameter leaf of the published configs, with the spec the
    port gives it, on both production meshes: the same block, or
    ``ValueError`` from both where a dim does not divide."""
    cases = set()
    for arch in ARCH_IDS:
        model = build_model(get_config(arch), device="meta")
        for multi_pod in (False, True):
            shapes = tree_leaves(model.param_shapes())
            specs = tree_leaves(model.param_specs(multi_pod))
            cases |= {(multi_pod, tuple(t.shape), s)
                      for t, s in zip(shapes, specs)}
    raised = 0
    for multi_pod, shape, spec in sorted(cases, key=repr):
        mesh = make_production_mesh(multi_pod=multi_pod)
        jmesh = AbstractMesh(mesh.shape, mesh.axis_names)
        try:
            want = JNamedSharding(jmesh, P(*spec)).shard_shape(shape)
        except ValueError:
            raised += 1
            with pytest.raises(ValueError):
                NamedSharding(mesh, spec).shard_shape(shape)
            continue
        assert NamedSharding(mesh, spec).shard_shape(shape) == tuple(want)
    assert len(cases) > 50


def test_named_maps_every_spec():
    model = build_model(get_config("mamba2_780m", smoke=True), device="meta")
    ospecs = named(CARD, opt_state_specs(model, False))
    assert ospecs.step == NamedSharding(CARD, ())
    assert all(isinstance(s, NamedSharding) for s in tree_leaves(ospecs.m))
    _, sspecs = model.decode_state_shapes(SMOKE_SHAPE["decode"], False)
    state = named(CARD, sspecs)
    assert isinstance(state.ssm_state[0], NamedSharding)
    structs = opt_state_structs(model)
    assert structs.step.dtype == torch.int32
    assert all(t.dtype == torch.float32 and t.device.type == "meta"
               for t in tree_leaves(structs.m) + tree_leaves(structs.v))


# ----------------------------------------------------------------------
# build_step and lower_step
# ----------------------------------------------------------------------
def _smoke_params(model, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return model.init(gen)


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                                       .astype(np.int32)),
            "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                                       .astype(np.int32))}


def test_build_step_train_is_make_train_step_bit_for_bit():
    cfg = smoke_mixtral("cuda_kernel")(get_config)
    shape = ShapeConfig("t", 16, 2, "train")
    bundle = build_step(cfg, shape, CARD, multi_pod=False,
                        opt=AdamW(lr=1e-3), device="cpu")
    assert isinstance(bundle, StepBundle) and bundle.donate_argnums == (0, 1)
    structs = bundle.arg_structs
    assert set(structs[2]) == {"tokens", "labels"}
    batch = _batch(cfg, 2, 16)

    def run(step, model):
        params = _smoke_params(model)
        return step(params, AdamW(lr=1e-3).init(params), batch)

    pa, sa, la = run(bundle.step, build_model(cfg, device="cpu"))
    plain = build_model(cfg, device="cpu")
    pb, sb, lb = run(make_train_step(plain, AdamW(lr=1e-3)), plain)
    assert torch.equal(la, lb) and sa.step == sb.step == 1
    for a, b in zip(tree_leaves(pa) + tree_leaves(sa.m) + tree_leaves(sa.v),
                    tree_leaves(pb) + tree_leaves(sb.m) + tree_leaves(sb.v)):
        assert torch.equal(a, b)


def test_build_step_serving_bundles_are_the_model():
    cfg = dataclasses.replace(get_config("tinyllama_1_1b", smoke=True),
                              dtype="float32")
    model = build_model(cfg, device="cpu")
    params = _smoke_params(model)
    pre = build_step(cfg, ShapeConfig("p", 12, 2, "prefill"), CARD,
                     multi_pod=False, device="cpu")
    tokens = _batch(cfg, 2, 12)["tokens"]
    assert torch.equal(pre.step(params, {"tokens": tokens}),
                       model.prefill(params, {"tokens": tokens}))
    dec = build_step(cfg, ShapeConfig("d", 12, 2, "decode"), CARD,
                     multi_pod=False, device="cpu")
    assert dec.donate_argnums == (1,)
    sa, sb = (model.init_decode_state(2, 12) for _ in range(2))
    la, sa = dec.step(params, sa, {"tokens": tokens[:, :1]})
    lb, sb = model.decode_step(params, sb, {"tokens": tokens[:, :1]})
    assert torch.equal(la, lb) and sa.pos == sb.pos == 1
    assert all(torch.equal(a, b) for a, b in zip(sa.leaves(), sb.leaves()))


def test_op_recorder_counts_live_memory_flops_and_bytes():
    a = torch.ones(1000, device="meta")           # an argument: 4,000 bytes

    def step(x):
        t = torch.empty(2000, device="meta")      # 8,000, freed below
        del t
        y = x * 2                                 # 4,000, returned
        v = y.view(10, 100)                       # a view: no bytes
        m = torch.empty(10, 20, device="meta") @ torch.empty(
            20, 30, device="meta")                # 800 + 2,400 + 1,200
        del m
        return v

    low = record_step(step, (a,))
    mem = low.memory_analysis()
    assert mem.argument_size_in_bytes == 4000
    assert mem.output_size_in_bytes == 4000 and mem.alias_size_in_bytes == 0
    # live at the matmul: y 4,000 + its operands 3,200 + its result 1,200
    assert mem.temp_size_in_bytes + 4000 == 4000 + 3200 + 1200
    assert low.cost_analysis()["flops"] == 2 * 10 * 20 * 30
    assert low.cost_analysis()["bytes accessed"] == \
        8000 + (4000 + 4000) + 800 + 2400 + (800 + 2400 + 1200)
    text = low.as_text()
    assert "f32[1000] aten.mul.Tensor(f32[1000])" in text
    assert "f32[10,30] aten.mm.default(f32[10,20], f32[20,30])" in text


def test_op_recorder_flops_equal_flop_counter_mode():
    from torch.utils.flop_counter import FlopCounterMode
    cfg = dataclasses.replace(get_config("whisper_medium", smoke=True),
                              dtype="float32")
    model = build_model(cfg, device="cpu")
    params = _smoke_params(model)
    batch = {**_batch(cfg, 2, 16), "frames": torch.randn(2, cfg.encoder_len,
                                                         cfg.d_model)}
    with FlopCounterMode(display=False) as fc:
        model.loss(params, batch)
    low = record_step(lambda p, b: model.loss(p, b), (params, batch))
    assert low.cost_analysis()["flops"] == fc.get_total_flops() > 0


def test_routing_by_address_on_the_recorded_train_step():
    """The smoke Mixtral's recorded train step, forward and backward: no
    dense [g*k, G*E*C] selection tensor on the fabric impl (plain data
    plane, ``kernel_mode="torch"``); the ``dense`` impl builds one."""
    shape = ShapeConfig("t", 48, 1, "train")
    g = shape.tokens                     # one group of 48 tokens
    found = {}
    for impl in ("cuda_kernel", "dense"):
        cfg = smoke_mixtral(impl)(get_config)
        cap = expert_capacity(g, cfg.moe)
        bundle = build_step(cfg, shape, CARD, multi_pod=False,
                            kernel_mode="torch", device="cpu")
        text = lower_step(bundle, CARD).as_text()
        found[impl] = roofline.dense_routing_bytes(
            text, g * cfg.moe.top_k, cfg.moe.n_experts * cap,
            min_dtype_bytes=2)
    assert found["cuda_kernel"] == 0 and found["dense"] > 0, found


def test_lower_step_refuses_a_production_mesh():
    """Only ``DenseLM`` is tensor-parallel: the SSM family's step over the
    pod names ROADMAP A11."""
    cfg = get_config("mamba2_780m", smoke=True)
    pod = make_production_mesh()
    bundle = build_step(cfg, SMOKE_SHAPE["prefill"], pod, multi_pod=False,
                        device="meta")
    with pytest.raises(NotImplementedError, match="A11"):
        lower_step(bundle, pod)


def test_lower_step_on_meta_every_kind():
    cfg = get_config("recurrentgemma_9b", smoke=True)
    for kind, shape in SMOKE_SHAPE.items():
        low = lower_step(build_step(cfg, shape, CARD, multi_pod=False,
                                    device="meta"), CARD)
        ca, mem = low.cost_analysis(), low.memory_analysis()
        assert ca["flops"] > 0 and ca["bytes accessed"] > 0, kind
        assert mem.argument_size_in_bytes > 0 and mem.temp_size_in_bytes > 0
        flops, byts, colls, peak = roofline.extract(low)
        assert colls == {} and peak >= mem.argument_size_in_bytes


# ----------------------------------------------------------------------
# the fit and the dry run
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch,kind", [(a, "decode") for a in FAMILY_ARCHS]
                         + [("mixtral_8x7b", "prefill")])
def test_fit_cell_holdout_is_exact(arch, kind):
    cfg = get_config(arch, smoke=True)
    fitted = costfit.fit_cell(cfg, ShapeConfig("x", 4096, 1, kind), CARD,
                              False)
    assert fitted.val_points == 5
    assert max(fitted.holdout_rel_err.values()) < 1e-6, \
        fitted.holdout_rel_err
    assert fitted.flops > 0 and fitted.bytes > 0 and fitted.coll_moved == 0


def test_run_cell_card_record(tmp_path):
    shape = ShapeConfig("decode_small", 1024, 2, "decode")
    rec = dryrun.run_cell("mamba2_780m", shape, "card", tmp_path, smoke=True)
    on_disk = json.loads((tmp_path / "mamba2_780m_decode_small_card.json")
                         .read_text())
    assert on_disk == json.loads(json.dumps(rec))
    reference_keys = {
        "arch", "shape", "mesh", "chips", "flops_per_device",
        "bytes_per_device", "collective_bytes_per_device", "collectives",
        "peak_memory_bytes", "model_flops", "model_bytes", "kind",
        "t_compute", "t_memory", "t_collective", "bottleneck", "roofline_s",
        "useful_flops_ratio", "useful_bytes_ratio", "roofline_fraction",
        "lower_s", "compile_s", "n_params", "microbatches",
        "peak_memory_est", "fits_hbm", "holdout_rel_err", "raw_uncorrected",
        "memory_analysis"}
    assert set(dryrun.COMPILE_ONLY_KEYS) == {"compile_s", "raw_uncorrected",
                                             "memory_analysis"}
    assert reference_keys - set(rec) == set(dryrun.COMPILE_ONLY_KEYS)
    assert rec["fits_hbm"] and rec["microbatches"] == 1
    assert rec["peak_memory_bytes"] is None and rec["peak_memory_est"] > 0
    model = build_model(get_config("mamba2_780m", smoke=True), device="meta")
    assert rec["param_bytes"] == sum(
        t.numel() * t.element_size() for t in tree_leaves(
            model.param_shapes()))
    assert rec["opt_state_bytes"] == 0


def test_run_cell_production_mesh_records_bytes_then_raises(tmp_path):
    """The published Mamba-2 780M (the smoke config's widths do not divide
    over 16 devices): its state bytes a device are recorded, then the run
    names ROADMAP A11."""
    with pytest.raises(NotImplementedError, match="A11"):
        dryrun.run_cell("mamba2_780m", "train_4k", "pod", tmp_path)
    rec = json.loads((tmp_path / "mamba2_780m_train_4k_pod.json")
                     .read_text())
    model = build_model(get_config("mamba2_780m"), device="meta")
    full = sum(t.numel() * 2 for t in tree_leaves(model.param_shapes()))
    assert rec["chips"] == 256 and rec["flops_per_device"] is None
    assert full / 256 <= rec["param_bytes"] < full
    assert rec["opt_state_bytes"] == 4 * rec["param_bytes"]


# ----------------------------------------------------------------------
# accounting on the meta device
# ----------------------------------------------------------------------
def test_accounting_records_nothing_on_meta():
    regs = CrossbarRegisters.create(4, capacity=8)
    dst = torch.tensor([0, 1, 1, 3, -1], dtype=torch.int32)
    src = torch.zeros(5, dtype=torch.int32)
    meta = Fabric(regs, capacity=8, device="meta")
    plan = meta.plan(dst.to("meta"), src.to("meta"))
    assert plan.counts.device.type == "meta"
    meta.account(plan, src.to("meta"))
    meta.account_stats({"counts": plan.counts,
                        "offered_packets": torch.ones((), device="meta")})
    assert meta.offered_packets == meta.granted_packets == 0
    assert not meta.port_traffic.any()
    # a CPU plan never takes the meta branch
    cpu = Fabric(regs, capacity=8, device="cpu")
    cpu.account(cpu.plan(dst, src), src)
    assert (cpu.offered_packets, cpu.granted_packets) == (4, 4)
    assert cpu.port_traffic.tolist() == [1, 2, 0, 1]


# ----------------------------------------------------------------------
# on one launched rank: DTensor placements and recorded collectives
# ----------------------------------------------------------------------
def test_one_rank_mesh_constrain_and_recorded_collectives(tmp_path):
    """On a gloo world of one rank: the card mesh as a live ``DeviceMesh``,
    ``constrain`` redistributing a ``DTensor`` to ``Shard(0)`` over the
    batch axis, spec placements, and the collectives' lines in a recorded
    text under XLA's names, read by ``parse_collectives``."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.fabric import collectives as coll
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = CARD.device_mesh("cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        with pytest.raises(RuntimeError, match="ranks"):
            make_production_mesh().device_mesh("cpu")
        model = build_model(get_config("tinyllama_1_1b", smoke=True),
                            device="cpu")
        x = distribute_tensor(torch.arange(8.0).reshape(2, 2, 2), mesh,
                              [Replicate(), Replicate()])
        model.batch_axis = "data"
        y = model.constrain(x)
        assert tuple(y.placements) == (Shard(0), Replicate())
        assert torch.equal(y.full_tensor(), x.full_tensor())
        assert NamedSharding(CARD, ("data", None, "model")).placements(
            mesh) == [Shard(0), Shard(2)]
        with OpRecorder() as rec:
            coll.psum(torch.ones(3, dtype=torch.bfloat16))
            coll.all_to_all(torch.ones(1, 4))
            coll.all_gather(torch.ones(2, dtype=torch.int32))
        assert roofline.parse_collectives(rec.text()) == {
            "all-reduce": {"count": 1, "bytes": 6.0, "moved": 12.0},
            "all-to-all": {"count": 1, "bytes": 16.0, "moved": 16.0},
            "all-gather": {"count": 1, "bytes": 8.0, "moved": 8.0}}
        assert coll.recorders == []
    finally:
        dist.destroy_process_group()
