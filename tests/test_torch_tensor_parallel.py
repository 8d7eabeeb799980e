"""Tensor parallelism and FSDP of ``DenseLM`` over a (data, model) mesh
(``repro_torch.models.parallel``) against the JAX package, on the CPU.

- **Sharding, no ranks.**  ``shard_params``/``unshard_params`` round-trip
  every leaf bit for bit on (2, 2), (1, 4) and (4, 1) for the smoke
  TinyLlama, granite (tied embeddings) and Mixtral; every local shape is
  JAX's ``NamedSharding(AbstractMesh).shard_shape``, and a fused gate|up
  ``w_in`` holds ``gate[r] | up[r]``.
- **Live ranks.**  Two spawns of 4 gloo ranks (``tp_cases`` in
  ``tests/_torch_sharded_worker.py``), on (2, 2) and (1, 4), float32.  The
  unsharded results are held against the JAX package's single-device
  functions on the same parameters, converted (what its SPMD program
  computes): the loss and every gradient leaf within 1e-4 of the leaf's
  largest value; ``prefill`` logits and 4 teacher-forced ``decode_step``
  logits within 1e-4 of their largest value; the parameters after one
  ``build_step`` train step, whose clip bites (``GRAD_CLIP``: the clipped
  gradients sit at AdamW's epsilon, so the update reads the global norm),
  within 1e-5 of each leaf's largest value.  TinyLlama and Mixtral run
  B=16, whose batch is sharded over ``data``; granite B=4, replicated
  over ``data`` (``lm.batch_axes``), as in the JAX package's own (2, 2)
  test.  Mixtral's MoE runs the fabric impl (``cuda_kernel``, plain on the
  CPU) at S=128, so each data rank's tokens are whole groups of 1024;
  JAX's runs its default, ``dense``: the same grants.

  The parameters are the port's seeded ``init``, converted to the JAX
  layout (``params_to_numpy``), not the JAX package's: its ``normal_init``
  takes the fan-in from the stacked layer axis (ROADMAP C), which makes
  the smoke models' gradients ill-conditioned.  On its init the port's
  one-device gradients already sit 1.0e-4 (TinyLlama), 1.8e-4 (granite)
  and 4.5e-4 (Mixtral) of a leaf's largest value from JAX's, and moving
  every parameter by one float32 ulp moves them by up to 5.2e-4, so a
  limit of 1e-4 could not see the sharding; on the port's init both are
  under 3e-6 (measured on this batch), and the tensor-parallel program
  against the one-rank port was 2.6e-5 or less on either init.
  ``ServeLoop(shard=)`` returns the one-process loop's tokens on every
  rank.
- **One launched rank, in-process.**  On a (1, 1) gloo mesh every
  collective is a copy: the loss and the prefill logits equal the program
  without a mesh bit for bit, and each MoE impl that takes ``shard``
  agrees with it within 1e-6.
- **Meta meshes, no ranks.**  ``lower_step`` over a (2, 2) ``MeshSpec``:
  FLOPs a device equal the one-device FLOPs / (model x the batch's data
  shards) exactly for the dense smoke train cell at B=4 (/2) and B=16
  (/4); for Mixtral the router's product, replicated over ``model``,
  is the only difference.  The recorded text has all-gather and
  all-reduce lines.  The (16, 16) and (2, 16, 16) meshes lower for every
  kind, their argument bytes those of the rank's shards.  The other
  families lower and shard on (2, 2) too (held against JAX in
  ``tests/test_torch_tensor_parallel_families.py``), and ``run_cell`` on
  ``pod`` writes FLOPs and collectives.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P

from _torch_sharded_worker import spawn
from repro.configs import get_config as jax_get_config
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models.lm import build_model as jax_build_model
from repro.optim.adamw import AdamW as JaxAdamW
from repro_torch.ckpt.convert import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import (MeshSpec, make_production_mesh,
                                     make_smoke_mesh)
from repro_torch.launch.steps import build_step, lower_step
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.config import ShapeConfig
from repro_torch.models.lm import build_model
from repro_torch.models.parallel import (Pieces, ShardCtx, layout_specs,
                                         mesh_coords, shard_params,
                                         unshard_params)

ARCHS = ("tinyllama_1_1b", "granite_3_2b", "mixtral_8x7b")
# (batch, sequence) of each live case: B=16 shards over data, B=4 does not
SHAPES = {"tinyllama_1_1b": (16, 32), "granite_3_2b": (4, 32),
          "mixtral_8x7b": (16, 128)}
MESHES = ((2, 2), (1, 4))
# ServeLoop on TinyLlama: 16 slots (sharded over data), prompts of 6, 5 new
SERVE = (16, 6, 5)
LR = 1e-3
GRAD_CLIP = 1e-8
DECODE_STEPS = 4
TOL = 1e-4
STEP_TOL = 1e-5
CARD = make_smoke_mesh()


def _configs(arch):
    """(JAX config, port config): float32; the port's MoE on the fabric
    impl."""
    f32 = lambda cfg: dataclasses.replace(cfg, dtype="float32")  # noqa: E731
    cfg_t = f32(get_config(arch, smoke=True))
    if cfg_t.moe is not None:
        cfg_t = dataclasses.replace(cfg_t, moe=dataclasses.replace(
            cfg_t.moe, dispatch="cuda_kernel"))
    return f32(jax_get_config(arch, smoke=True)), cfg_t


def _batch(arch, vocab):
    B, S = SHAPES[arch]
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _scaled_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pairs(tree_j, tree_np):
    """(path, JAX leaf, port leaf) over JAX's tree; the port's tree in the
    JAX layout (``params_to_numpy``)."""
    out = []
    for path, a in jax.tree_util.tree_leaves_with_path(tree_j):
        b = tree_np
        for k in path:
            b = b[k.key]
        out.append((jax.tree_util.keystr(path), a, b))
    return out


# ----------------------------------------------------------------------
# sharding, no ranks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_params_round_trips_with_jax_shard_shapes(arch, shape):
    mesh = make_smoke_mesh(*shape)
    model = build_model(get_config(arch, smoke=True), device="cpu")
    gen = torch.Generator().manual_seed(0)
    full = model.init(gen)
    layout = layout_specs(model)
    shards = [shard_params(full, layout, mesh, mesh_coords(mesh, r))
              for r in range(mesh.size)]
    back = unshard_params(shards, layout, mesh)
    for a, b in zip(tree_leaves(back), tree_leaves(full)):
        assert torch.equal(a, b)
    jmesh = AbstractMesh(mesh.shape, mesh.axis_names)
    for x, local, spec in zip(tree_leaves(full), tree_leaves(shards[-1]),
                              tree_leaves(layout)):
        want = JNamedSharding(jmesh, P(*spec)).shard_shape(tuple(x.shape))
        assert tuple(local.shape) == tuple(want), (spec, x.shape)
    # the gated halves: rank r of the model axis holds gate[r] | up[r]
    M = mesh.axis_size("model")
    key = "moe" if model.cfg.moe is not None else "mlp"
    assert isinstance(layout["layers"][0][key]["w_in"], Pieces)
    assert layout["layers"][0][key]["w_in"].widths == (1, 1)
    w = full["layers"][0][key]["w_in"]
    gate, up = w.chunk(2, -1)
    for r, local in enumerate(shards):
        m, d = mesh_coords(mesh, r)[1], mesh_coords(mesh, r)[0]
        lw = local["layers"][0][key]["w_in"]
        c = gate.shape[-1] // M
        rows = lw.shape[-2]
        want = torch.cat([gate[..., d * rows:(d + 1) * rows,
                               m * c:(m + 1) * c],
                          up[..., d * rows:(d + 1) * rows,
                             m * c:(m + 1) * c]], -1)
        assert torch.equal(lw, want)


def test_head_layouts_of_the_awkward_meshes():
    """Kv=2 over a model axis of 4 gathers the kv heads; 8 heads over 16
    split over 8 and share each block between 2 ranks; LLaVA-NeXT's 56
    heads over 16 likewise (7 a block, one kv head)."""
    smoke = get_config("tinyllama_1_1b", smoke=True)
    lay = ShardCtx.described(make_smoke_mesh(1, 4), (0, 3)).heads(smoke)
    assert (lay.n_q, lay.n_kv, lay.kv0, lay.kv_src) == (2, 1, 1, "gather")
    assert lay.q_group is None and lay.o_cols == (0, 16)
    pod = ShardCtx.described(make_production_mesh(), (0, 5))
    lay = pod.heads(smoke)
    assert (lay.n_q, lay.n_kv, lay.kv0, lay.kv_src) == (1, 1, 0, "gather")
    assert lay.q_group.size == 2 and lay.o_cols == (4, 8)
    llava = get_config("llava_next_34b")
    lay = pod.heads(llava)
    assert (lay.n_q, lay.n_kv, lay.kv0) == (7, 1, 2)
    assert lay.kv_src == ("replicated" if llava.kv_shard != "tp"
                          else "gather")
    full = get_config("tinyllama_1_1b")
    lay = ShardCtx.described(make_smoke_mesh(2, 2), (1, 1)).heads(full)
    assert (lay.n_q, lay.n_kv, lay.kv0, lay.kv_src) == (16, 2, 2, "local")


# ----------------------------------------------------------------------
# live ranks against JAX
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_answers():
    """Per arch: the JAX parameters (numpy), the batch, and JAX's loss,
    gradients, prefill logits, 4 decode logits and one train step."""
    out = {}
    for arch in ARCHS:
        cfg_j, cfg_t = _configs(arch)
        jm = jax_build_model(cfg_j)
        init = build_model(cfg_t, device="cpu").init(
            torch.Generator().manual_seed(0))
        jp = jax.tree.map(jnp.asarray, params_to_numpy(init))
        batch = _batch(arch, cfg_t.vocab)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        opt = JaxAdamW(lr=LR, grad_clip=GRAD_CLIP)

        def answers(params, b):
            state = jm.init_decode_state(b["tokens"].shape[0], 16)
            logits = []
            for t in range(DECODE_STEPS):
                lg, state = jm.decode_step(params, state,
                                           {"tokens": b["tokens"][:, t:t + 1]})
                logits.append(lg)
            return {"value_and_grad": jax.value_and_grad(jm.loss)(params, b),
                    "prefill": jm.prefill(params, {"tokens": b["tokens"]}),
                    "decode": jnp.stack(logits),
                    "step": jax_make_train_step(jm, opt, 1)(
                        params, opt.init(params), b)}

        ref = jax.jit(answers)(jp, jb)
        gnorm = float(jnp.sqrt(sum(jnp.sum(g.astype(jnp.float32) ** 2)
                                   for g in jax.tree.leaves(
                                       ref["value_and_grad"][1]))))
        out[arch] = {"params": jax.tree.map(np.asarray, jp), "batch": batch,
                     "ref": ref, "cfg": cfg_t, "gnorm": gnorm}
    return out


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def ranks(request, jax_answers, tmp_path_factory):
    """One spawn of 4 gloo ranks on the mesh; every case's results
    unsharded."""
    shape = request.param
    mesh = make_smoke_mesh(*shape)
    cases = [{"arch": arch, "params": jax_answers[arch]["params"],
              "batch": jax_answers[arch]["batch"], "lr": LR,
              "grad_clip": GRAD_CLIP, "decode_steps": DECODE_STEPS,
              "moe": (dataclasses.asdict(jax_answers[arch]["cfg"].moe)
                      if jax_answers[arch]["cfg"].moe else None),
              "serve": (_serve_case(jax_answers[arch]["cfg"])
                        if arch == "tinyllama_1_1b" else None)}
             for arch in ARCHS]
    res = spawn("tp_cases", mesh.size, tmp_path_factory.mktemp("tp"),
                {"mesh": shape, "cases": cases})
    assert [r["coords"] for r in res] == [mesh_coords(mesh, r)
                                          for r in range(mesh.size)]
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = jax_answers[arch]["cfg"]
        layout = layout_specs(build_model(cfg, device="cpu"))
        t = lambda tree: tree_map(torch.from_numpy, tree)  # noqa: E731
        per = [r["cases"][i] for r in res]
        B = SHAPES[arch][0]
        bspec = "data" if B % 16 == 0 else None
        out[arch] = {
            "serve": [p.get("serve") for p in per],
            "losses": [float(p["loss"]) for p in per],
            "step_losses": [float(p["step_loss"]) for p in per],
            "grads": unshard_params([t(p["grads"]) for p in per], layout,
                                    mesh),
            "stepped": unshard_params([t(p["stepped"]) for p in per],
                                      layout, mesh),
            "prefill": unshard_params(
                [torch.from_numpy(p["prefill"]) for p in per],
                (bspec, "model"), mesh),
            "decode": unshard_params(
                [torch.from_numpy(p["decode"]) for p in per],
                (None, bspec, "model"), mesh),
        }
    return shape, out


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_loss_and_every_gradient_leaf_match_jax(ranks, jax_answers,
                                                   arch):
    _, out = ranks
    ref = jax_answers[arch]["ref"]
    loss_j, grads_j = ref["value_and_grad"]
    got = out[arch]
    assert len(set(got["losses"])) == 1, got["losses"]
    assert abs(got["losses"][0] - float(loss_j)) <= 1e-5 * abs(
        float(loss_j))
    worst = max((_scaled_err(b, a), path) for path, a, b in _pairs(
        grads_j, params_to_numpy(got["grads"])))
    assert worst[0] <= TOL, worst


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_prefill_and_decode_logits_match_jax(ranks, jax_answers, arch):
    _, out = ranks
    ref = jax_answers[arch]["ref"]
    got = out[arch]
    assert _scaled_err(got["prefill"], ref["prefill"]) <= TOL
    for s in range(DECODE_STEPS):
        assert _scaled_err(got["decode"][s], ref["decode"][s]) <= TOL, s


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_adamw_step_with_a_biting_clip_matches_jax(ranks, jax_answers,
                                                      arch):
    _, out = ranks
    ans = jax_answers[arch]
    assert ans["gnorm"] > 1e3 * GRAD_CLIP      # the clip bites
    new_j, _, loss_j = ans["ref"]["step"]
    got = out[arch]
    assert len(set(got["step_losses"])) == 1
    assert abs(got["step_losses"][0] - float(loss_j)) <= 1e-5 * abs(
        float(loss_j))
    worst = max((_scaled_err(b, a), path) for path, a, b in _pairs(
        new_j, params_to_numpy(got["stepped"])))
    assert worst[0] <= STEP_TOL, worst


def _serve_case(cfg):
    slots, plen, new = SERVE
    rng = np.random.default_rng(3)
    return (slots, [rng.integers(0, cfg.vocab, plen).astype(np.int32)
                    for _ in range(slots)], new)


def test_tp_serve_loop_tokens_equal_the_one_rank_loop(ranks, jax_answers):
    """Every rank returns the same completions, equal to the one-process
    ``ServeLoop``'s on the same parameters."""
    import warnings
    from repro_torch.runtime.serve import Request, ServeLoop
    _, out = ranks
    ans = jax_answers["tinyllama_1_1b"]
    slots, prompts, new = _serve_case(ans["cfg"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        loop = ServeLoop(ans["cfg"], batch=slots, max_len=32, device="cpu",
                         params=params_from_numpy(ans["params"], ans["cfg"],
                                                  "cpu"))
    want = [c.tokens for c in loop.serve(
        [Request(app_id=i, prompt=p, max_new=new)
         for i, p in enumerate(prompts)])]
    got = out["tinyllama_1_1b"]["serve"]
    assert all(g == want for g in got), (got[0], want)


def test_one_rank_mesh_is_bit_equal_to_no_mesh(tmp_path):
    """On a (1, 1) mesh of one launched gloo rank every collective is a
    copy: the loss and the prefill logits equal the program without a
    mesh bit for bit (the card's NCCL leg holds the loss so).  The
    gradients round otherwise in one place, the cross-entropy's backward
    (autograd through max, exp and log where the plain path takes
    ``logsumexp``'s), so they are held within 1e-6 of the leaf's largest
    value."""
    import torch.distributed as dist
    from repro_torch.launch.steps import _value_and_grad
    cfg = _configs("tinyllama_1_1b")[1]
    batch = {k: torch.from_numpy(v) for k, v in
             _batch("tinyllama_1_1b", cfg.vocab).items()}
    mesh = make_smoke_mesh(1, 1)
    shape = ShapeConfig("t", batch["tokens"].shape[1],
                        batch["tokens"].shape[0], "train")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        out = {}
        for name, shard in (("plain", None),
                            ("mesh", ShardCtx.launched(mesh))):
            model = build_step(cfg, shape, mesh, multi_pod=False,
                               device="cpu", shard=shard).model
            params = model.init(torch.Generator().manual_seed(0))
            loss, grads = _value_and_grad(model, params, batch)
            with torch.no_grad():
                logits = model.prefill(params, {"tokens": batch["tokens"]})
            out[name] = (loss, tree_leaves(grads), logits)
    finally:
        dist.destroy_process_group()
    (lp, gp, pp), (lm, gm, pm) = out["plain"], out["mesh"]
    assert torch.equal(lp, lm) and torch.equal(pp, pm)
    worst = max(_scaled_err(b.numpy(), a.numpy()) for a, b in zip(gp, gm))
    assert worst <= 1e-6, worst


@pytest.mark.parametrize("impl", ["dense", "gather", "cuda_kernel"])
def test_moe_impls_on_a_one_rank_mesh_equal_no_mesh(impl, tmp_path):
    """Each MoE impl that takes ``shard`` (the batch sharded over a data
    axis of one rank, so the load-balance statistics take their
    ``batch_sum`` path): output, aux loss and the gradients of the input
    and every weight within 1e-6 of the program without a mesh."""
    import torch.distributed as dist
    from repro_torch.models.moe import moe_apply
    cfg = _configs("mixtral_8x7b")[1]
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))["layers"][0]["moe"]
    x = torch.randn(4, 32, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    specs = layout_specs(model)["layers"][0]["moe"]

    def run(shard):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        xg = x.clone().requires_grad_()
        w = leaves if shard is None else shard.weights(leaves, specs)
        y, st = moe_apply(w, xg, cfg.moe, cfg.mlp_act, group_size=64,
                          dispatch_impl=impl, shard=shard)
        loss = (y * y).sum() + st["aux_loss"]
        return [y, st["aux_loss"], *torch.autograd.grad(
            loss, [xg, *leaves.values()])]

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        shard = ShardCtx.launched(make_smoke_mesh(1, 1)).with_batch("data")
        got, want = run(shard), run(None)
    finally:
        dist.destroy_process_group()
    for a, b in zip(got, want):
        assert _scaled_err(a.detach().numpy(), b.detach().numpy()) <= 1e-6


# ----------------------------------------------------------------------
# meta meshes, no ranks
# ----------------------------------------------------------------------
def _flops(cfg, shape, mesh):
    low = lower_step(build_step(cfg, shape, mesh, multi_pod=len(mesh.shape)
                                == 3, device="meta"), mesh)
    return low.cost_analysis()["flops"], low


@pytest.mark.parametrize("B,shards", [(4, 1), (16, 2)])
@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "granite_3_2b"])
def test_flops_a_device_divide_by_model_and_batch_shards(arch, B, shards):
    cfg = get_config(arch, smoke=True)
    shape = ShapeConfig("t", 64, B, "train")
    one, _ = _flops(cfg, shape, CARD)
    per, low = _flops(cfg, shape, make_smoke_mesh(2, 2))
    assert per * 2 * shards == one
    text = low.as_text()
    assert "all-reduce" in text and "all-gather" in text
    assert "reduce-scatter" in text


@pytest.mark.parametrize("B,shards", [(4, 1), (16, 2)])
def test_mixtral_flops_a_device_differ_by_the_router_only(B, shards):
    """The router's product runs on every model rank of a data shard:
    6 x tokens x d x E a layer (forward, and the two backward products;
    remat "dots" saves it)."""
    cfg = _configs("mixtral_8x7b")[1]
    shape = ShapeConfig("t", 64, B, "train")
    one, _ = _flops(cfg, shape, CARD)
    per, low = _flops(cfg, shape, make_smoke_mesh(2, 2))
    router = 6 * B * 64 * cfg.d_model * cfg.moe.n_experts * cfg.n_layers
    assert per == (one - router) / (2 * shards) + router / shards
    colls = roofline.parse_collectives(low.as_text())
    assert {"all-reduce", "all-gather", "reduce-scatter"} <= set(colls)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("mesh", [make_production_mesh(),
                                  make_production_mesh(multi_pod=True)],
                         ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lower_step_on_production_meshes(arch, mesh, kind):
    cfg = get_config(arch, smoke=True)
    shape = ShapeConfig("t", 64, 64, kind)
    flops, low = _flops(cfg, shape, mesh)
    assert flops > 0
    colls = roofline.parse_collectives(low.as_text())
    assert colls["all-gather"]["count"] > 0
    assert colls["all-reduce"]["count"] > 0
    # the arguments are the rank's shards
    model = build_model(cfg, device="meta")
    local = shard_params(model.param_shapes(), layout_specs(
        model, len(mesh.shape) == 3), mesh, (0,) * len(mesh.shape))
    pbytes = sum(t.numel() * t.element_size() for t in tree_leaves(local))
    args = low.memory_analysis().argument_size_in_bytes
    assert pbytes < args < pbytes * (5 if kind == "train" else 2) + 2 ** 22


@pytest.mark.parametrize("arch", ["mamba2_780m", "recurrentgemma_9b",
                                  "whisper_medium"])
def test_other_families_refuse_a_mesh_naming_a11(arch):
    """Each of the other families lowers and shards on (2, 2): the train
    step's rank 0 runs on its local shards with the model axis's
    collectives, and a prefill bundle built for a described rank holds
    its shards.  (They raised naming ROADMAP A11 until they sharded; the
    name is kept.  ``tests/test_torch_tensor_parallel_families.py`` holds
    them against JAX on live ranks.)"""
    cfg = get_config(arch, smoke=True)
    mesh = make_smoke_mesh(2, 2)
    bundle = build_step(cfg, ShapeConfig("t", 32, 4, "train"), mesh,
                        multi_pod=False, device="meta")
    low = lower_step(bundle, mesh)
    colls = roofline.parse_collectives(low.as_text())
    assert low.cost_analysis()["flops"] > 0
    assert {"all-reduce", "all-gather", "reduce-scatter"} <= set(colls)
    pre = build_step(cfg, ShapeConfig("t", 32, 4, "prefill"), mesh,
                     multi_pod=False, device="meta",
                     shard=ShardCtx.described(mesh))
    model = pre.model
    local = shard_params(model.param_shapes(), layout_specs(model), mesh,
                         (0, 0))
    assert [tuple(t.shape) for t in tree_leaves(pre.arg_structs[0])] == \
        [tuple(t.shape) for t in tree_leaves(local)]


def test_run_cell_on_pod_writes_flops_and_collectives(tmp_path):
    rec = dryrun.run_cell("tinyllama_1_1b", "train_4k", "pod", tmp_path,
                          smoke=True)
    on_disk = json.loads((tmp_path / "tinyllama_1_1b_train_4k_pod.json")
                         .read_text())
    assert on_disk == json.loads(json.dumps(rec))
    assert rec["chips"] == 256 and rec["flops_per_device"] > 0
    assert rec["collectives"]["all-gather"]["moved"] > 0
    assert rec["collectives"]["all-reduce"]["moved"] > 0
    assert rec["collective_bytes_per_device"] > 0
    assert rec["fits_hbm"] and rec["peak_memory_est"] > 0
    assert rec["opt_state_bytes"] == 4 * rec["param_bytes"]


def test_meta_groups_refuse_live_tensors():
    from repro_torch.fabric import collectives as coll
    g = coll.MetaGroup(4, 1)
    assert coll.axis_size(g) == 4 and coll.axis_index(g) == 1
    out = coll.gather_shards(torch.empty(3, 2, device="meta"), 1, g)
    assert out.shape == (3, 8) and out.device.type == "meta"
    with pytest.raises(RuntimeError, match="meta"):
        coll.psum(torch.ones(3), g)
    with pytest.raises(ValueError):
        coll.MetaGroup(2, 2)
    assert isinstance(MeshSpec((2, 2), ("data", "model")).size, int)
