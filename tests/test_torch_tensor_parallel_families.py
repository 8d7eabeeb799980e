"""Tensor parallelism and FSDP of the SSM (Mamba-2), hybrid
(RecurrentGemma) and encoder-decoder (Whisper) families over a (data,
model) mesh (``repro_torch.models.parallel``), against the JAX package, on
the CPU; ``tests/test_torch_tensor_parallel.py`` holds ``DenseLM``.

- **Sharding, no ranks.**  ``shard_params``/``unshard_params`` round-trip
  every leaf bit for bit on (2, 2), (1, 4) and (4, 1).  Every local shape
  is JAX's ``NamedSharding(AbstractMesh).shard_shape`` of the leaf's
  ``param_specs``, except the RG-LRU's ``w_r``/``w_i``, which the port cuts
  on the block axis (``parallel.BLOCK_AXIS``: the same bytes, another
  shape, ROADMAP C) and which are asserted by themselves.  The SSM's
  ``in_proj`` holds z_r | x_r | B_r | C_r | dt_r and its conv x_r | B_r |
  C_r.  A model axis that cuts inside a unit raises, naming the widths.
- **Live ranks.**  Two spawns of 4 gloo ranks (``tp_cases`` in
  ``tests/_torch_sharded_worker.py``), on (2, 2) and (1, 4), each running
  all three smoke families in float32 at B=16 (sharded over ``data``):
  the loss and every gradient leaf, the prefill logits, 4 teacher-forced
  ``decode_step`` logits (Whisper's with a random cross-attention cache),
  the parameters after one ``build_step`` AdamW step whose clip bites
  (``GRAD_CLIP``) and ``ServeLoop(shard=)``'s tokens.

  Against the JAX package's single-device functions on the same
  parameters: the loss within the families' one-device limits
  (``test_torch_recurrent_train.py``, ``test_torch_encdec_vlm.py``: 1e-6,
  1e-5 and 1e-5 relative) and every gradient leaf within theirs (1e-4,
  5e-2 and 2e-3 of the leaf's largest value), the logits within 1e-4 of
  their largest value.  Against the one-rank port (the same parameters
  and batch in this process, no mesh): the loss, every gradient leaf and
  the logits within 1e-4 of their largest value (``TOL``), so that the
  sharding itself is seen; the stepped parameters within 1e-5 (the
  clipped update reads the global norm); the tokens equal.

  The parameters are the port's seeded ``init`` converted to the JAX
  layout (``params_to_numpy``), as the ``DenseLM`` file does and for its
  reason (ROADMAP C: JAX's ``normal_init`` takes the fan-in from the
  stacked layer axis, which makes the smoke gradients ill-conditioned).
  The hybrid's gradients are ill-conditioned on any init (its decays sit
  within 1e-5 of 1, ``test_torch_recurrent_train.py``), but on this one
  the tensor-parallel program stays within ``TOL`` of the one-rank port.
- **One launched rank, in-process.**  On a (1, 1) gloo mesh every
  collective is a copy: each family's loss, gradients and prefill logits
  equal the program without a mesh bit for bit.
- **Meta meshes, no ranks.**  ``lower_step`` over a (2, 2) ``MeshSpec``:
  the train step's FLOPs a device equal the one-device FLOPs / (model x
  data shards), plus the work every model rank repeats, named and
  counted by :func:`_replicated_flops` (the SSD's C.B^T products, which
  read the whole state width; the hybrid's single kv head, gathered on
  each rank); Whisper's divide exactly.  The published Mamba-2 780M,
  RecurrentGemma-9B and Whisper-medium, cut to a few layers, lower on the
  (16, 16) and (2, 16, 16) meshes for every kind.
"""
import dataclasses

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
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
from repro_torch.launch.steps import (_value_and_grad, build_step,
                                      lower_step, make_train_step)
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.config import ShapeConfig
from repro_torch.models.lm import build_model
from repro_torch.models.parallel import (BLOCK_AXIS, Pieces, ShardCtx,
                                         layout_specs, mesh_coords,
                                         shard_params, unshard_params)
from repro_torch.optim.adamw import AdamW

ARCHS = ("mamba2_780m", "recurrentgemma_9b", "whisper_medium")
B, S = 16, 32
MESHES = ((2, 2), (1, 4))
# ServeLoop: 16 slots (sharded over data), prompts of 6, 5 new tokens
SERVE = (16, 6, 5)
LR = 1e-3
GRAD_CLIP = 1e-8
DECODE_STEPS = 4
TOL = 1e-4              # against the one-rank port, of the largest value
STEP_TOL = 1e-5
# against JAX: the one-device tests' limits
LOSS_REL = {"mamba2_780m": 1e-6, "recurrentgemma_9b": 1e-5,
            "whisper_medium": 1e-5}
GRAD_REL = {"mamba2_780m": 1e-4, "recurrentgemma_9b": 5e-2,
            "whisper_medium": 2e-3}
OUT_REL = 1e-4
ONE_RANK_GRAD = 1e-5    # (1, 1) mesh against no mesh, see its test
SPAWN_S = 150.0
CARD = make_smoke_mesh()


def _configs(arch):
    f32 = lambda cfg: dataclasses.replace(cfg, dtype="float32")  # noqa: E731
    return (f32(jax_get_config(arch, smoke=True)),
            f32(get_config(arch, smoke=True)))


def _batch(cfg):
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(0, 0.02, (B, cfg.encoder_len,
                                             cfg.d_model)).astype(np.float32)
    return out


def _cross(cfg):
    """A random cross-attention cache: {"cross_k", "cross_v"}, each a list
    of [B, F, Kv, hd] per decoder layer."""
    rng = np.random.default_rng(5)
    shape = (B, cfg.encoder_len, cfg.n_kv_heads, cfg.hd)
    return {f: [rng.normal(0, 1, shape).astype(np.float32)
                for _ in range(cfg.n_layers)]
            for f in ("cross_k", "cross_v")}


def _serve_case(cfg):
    slots, plen, new = SERVE
    rng = np.random.default_rng(3)
    return (slots, [rng.integers(0, cfg.vocab, plen).astype(np.int32)
                    for _ in range(slots)], new)


def _scaled_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pairs(tree_j, tree_np):
    """(keys, JAX leaf, port leaf) over JAX's tree; the port's tree in the
    JAX layout (``params_to_numpy``)."""
    out = []
    for path, a in jax.tree_util.tree_leaves_with_path(tree_j):
        keys = tuple(k.key for k in path)
        out.append((keys, a, _at(tree_np, keys)))
    return out


def _at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def _init(cfg):
    return build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))


# ----------------------------------------------------------------------
# sharding, no ranks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_params_round_trips_with_jax_shard_shapes(arch, shape):
    mesh = make_smoke_mesh(*shape)
    model = build_model(get_config(arch, smoke=True), device="cpu")
    full = model.init(torch.Generator().manual_seed(0))
    layout = layout_specs(model)
    shards = [shard_params(full, layout, mesh, mesh_coords(mesh, r))
              for r in range(mesh.size)]
    back = unshard_params(shards, layout, mesh)
    for a, b in zip(tree_leaves(back), tree_leaves(full)):
        assert torch.equal(a, b)
    jmesh = AbstractMesh(mesh.shape, mesh.axis_names)
    M = mesh.axis_size("model")
    for x, local, spec, jspec in zip(
            tree_leaves(full), tree_leaves(shards[-1]), tree_leaves(layout),
            tree_leaves(model.param_specs(False))):
        want = JNamedSharding(jmesh, P(*jspec)).shard_shape(tuple(x.shape))
        if tuple(spec) == BLOCK_AXIS:
            # the RG-LRU gates: whole blocks, JAX's bytes
            nb, blk, _ = x.shape
            assert tuple(local.shape) == (nb // M, blk, blk)
            assert local.numel() == np.prod(want)
        else:
            assert tuple(local.shape) == tuple(want), (spec, x.shape)
    if model.cfg.family == "ssm":
        _assert_ssm_pieces(model, full, shards, mesh)


def _assert_ssm_pieces(model, full, shards, mesh):
    cfg = model.cfg
    d_in = cfg.ssm.expand * cfg.d_model
    N, H = cfg.ssm.d_state, cfg.ssm.n_heads(cfg.d_model)
    M = mesh.axis_size("model")
    lay = layout_specs(model)["layers"][0]["mixer"]
    assert isinstance(lay["in_proj"], Pieces)
    assert lay["in_proj"].widths == (d_in, d_in, N, N, H)
    w = full["layers"][0]["mixer"]["in_proj"]
    cw = full["layers"][0]["mixer"]["conv_w"]
    for r, local in enumerate(shards):
        d, m = mesh_coords(mesh, r)
        rows = slice(d * (w.shape[0] // mesh.axis_size("data")),
                     (d + 1) * (w.shape[0] // mesh.axis_size("data")))
        pieces = w[rows].split([d_in, d_in, N, N, H], -1)
        want = torch.cat([p.chunk(M, -1)[m] for p in pieces], -1)
        assert torch.equal(local["layers"][0]["mixer"]["in_proj"], want)
        conv = torch.cat([p.chunk(M, -1)[m]
                          for p in cw.split([d_in, N, N], -1)], -1)
        assert torch.equal(local["layers"][0]["mixer"]["conv_w"], conv)


@pytest.mark.parametrize("arch,M,match", [
    ("mamba2_780m", 16, "8 SSM heads and state width 16"),
    ("recurrentgemma_9b", 32, "16 gate blocks"),
])
def test_a_model_axis_that_cuts_a_unit_raises_naming_it(arch, M, match):
    cfg = get_config(arch, smoke=True)
    mesh = make_smoke_mesh(1, M) if M <= 16 else None
    model = build_model(cfg, device="meta")
    with pytest.raises(ValueError, match=match):
        model._check_model_axis(M)
    if mesh is not None:
        with pytest.raises(ValueError, match=match):
            build_step(cfg, ShapeConfig("t", 32, 16, "train"), mesh,
                       multi_pod=False, device="meta",
                       shard=ShardCtx.described(mesh))


# ----------------------------------------------------------------------
# live ranks against JAX and the one-rank port
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def answers():
    """Per arch: the parameters (numpy, JAX layout), the batch, the
    cross-attention cache, JAX's loss, gradients, logits and train step,
    and the one-rank port's."""
    out = {}
    for arch in ARCHS:
        cfg_j, cfg_t = _configs(arch)
        jm = jax_build_model(cfg_j)
        init = _init(cfg_t)
        params_np = params_to_numpy(init)
        jp = jax.tree.map(jnp.asarray, params_np)
        batch = _batch(cfg_t)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        cross = _cross(cfg_t) if cfg_t.family == "encdec" else None
        opt = JaxAdamW(lr=LR, grad_clip=GRAD_CLIP)
        no_labels = {k: v for k, v in jb.items() if k != "labels"}

        def jax_answers(params, b, nl):
            state = jm.init_decode_state(B, 16)
            if cross is not None:
                state = dataclasses.replace(
                    state, **{f: jnp.stack([jnp.asarray(c)
                                            for c in cross[f]])
                              for f in cross})
            logits = []
            for t in range(DECODE_STEPS):
                lg, state = jm.decode_step(
                    params, state, {**nl, "tokens": b["tokens"][:, t:t + 1]})
                logits.append(lg)
            return {"value_and_grad": jax.value_and_grad(jm.loss)(params, b),
                    "prefill": jm.prefill(params, nl),
                    "decode": jnp.stack(logits),
                    "step": jax_make_train_step(jm, opt, 1)(
                        params, opt.init(params), b)}

        ref = jax.jit(jax_answers)(jp, jb, no_labels)
        out[arch] = {"params": params_np, "batch": batch, "cross": cross,
                     "cfg": cfg_t, "jax": ref,
                     "port": _port_answers(cfg_t, params_np, batch, cross)}
    return out


def _port_answers(cfg, params_np, batch, cross):
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(params_np, cfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = _value_and_grad(model, params, tb)
    nl = {k: v for k, v in tb.items() if k != "labels"}
    with torch.no_grad():
        prefill = model.prefill(params, nl)
        state = model.init_decode_state(B, 16)
        if cross is not None:
            state = dataclasses.replace(state, **{
                f: [torch.from_numpy(c) for c in cross[f]] for f in cross})
        logits = []
        for t in range(DECODE_STEPS):
            lg, state = model.decode_step(
                params, state, {"tokens": tb["tokens"][:, t:t + 1]})
            logits.append(lg)
    opt = AdamW(lr=LR, grad_clip=GRAD_CLIP)
    fresh = params_from_numpy(params_np, cfg, device="cpu")
    new, _, step_loss = make_train_step(model, opt, 1)(
        fresh, opt.init(fresh), tb)
    return {"loss": float(loss), "grads": params_to_numpy(grads),
            "prefill": prefill.numpy(), "decode": torch.stack(logits).numpy(),
            "step_loss": float(step_loss),
            "stepped": params_to_numpy(new)}


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def ranks(request, answers, tmp_path_factory):
    """One spawn of 4 gloo ranks on the mesh running every family; each
    case's results unsharded."""
    shape = request.param
    mesh = make_smoke_mesh(*shape)
    cases = [{"arch": arch, "params": answers[arch]["params"],
              "batch": answers[arch]["batch"], "lr": LR,
              "grad_clip": GRAD_CLIP, "decode_steps": DECODE_STEPS,
              "cross": answers[arch]["cross"],
              "serve": _serve_case(answers[arch]["cfg"])}
             for arch in ARCHS]
    res = spawn("tp_cases", mesh.size, tmp_path_factory.mktemp("tpf"),
                {"mesh": shape, "cases": cases}, timeout=SPAWN_S)
    assert [r["coords"] for r in res] == [mesh_coords(mesh, r)
                                          for r in range(mesh.size)]
    out = {}
    for i, arch in enumerate(ARCHS):
        layout = layout_specs(build_model(answers[arch]["cfg"],
                                          device="cpu"))
        t = lambda tree: tree_map(torch.from_numpy, tree)  # noqa: E731
        per = [r["cases"][i] for r in res]
        out[arch] = {
            "serve": [p["serve"] for p in per],
            "losses": [float(p["loss"]) for p in per],
            "step_losses": [float(p["step_loss"]) for p in per],
            "grads": params_to_numpy(unshard_params(
                [t(p["grads"]) for p in per], layout, mesh)),
            "stepped": params_to_numpy(unshard_params(
                [t(p["stepped"]) for p in per], layout, mesh)),
            "prefill": unshard_params(
                [torch.from_numpy(p["prefill"]) for p in per],
                ("data", "model"), mesh).numpy(),
            "decode": unshard_params(
                [torch.from_numpy(p["decode"]) for p in per],
                (None, "data", "model"), mesh).numpy(),
        }
    return shape, out


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_loss_and_every_gradient_leaf_match_jax_and_one_rank(
        ranks, answers, arch):
    _, out = ranks
    got, ans = out[arch], answers[arch]
    loss_j, grads_j = ans["jax"]["value_and_grad"]
    assert len(set(got["losses"])) == 1, got["losses"]
    loss = got["losses"][0]
    assert abs(loss - float(loss_j)) <= LOSS_REL[arch] * abs(float(loss_j))
    assert abs(loss - ans["port"]["loss"]) <= TOL * abs(ans["port"]["loss"])
    worst_j = max((_scaled_err(b, a), path)
                  for path, a, b in _pairs(grads_j, got["grads"]))
    assert worst_j[0] <= GRAD_REL[arch], worst_j
    worst = max((_scaled_err(b, _at(ans["port"]["grads"], path)), path)
                for path, _, b in _pairs(grads_j, got["grads"]))
    assert worst[0] <= TOL, worst


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_prefill_and_decode_logits_match_jax_and_one_rank(
        ranks, answers, arch):
    _, out = ranks
    got, ans = out[arch], answers[arch]
    for want in (ans["jax"], ans["port"]):
        assert _scaled_err(got["prefill"], want["prefill"]) <= OUT_REL
        for s in range(DECODE_STEPS):
            assert _scaled_err(got["decode"][s], want["decode"][s]) \
                <= OUT_REL, s


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_adamw_step_with_a_biting_clip_matches_the_one_rank_step(
        ranks, answers, arch):
    """The clip bites (the global norm is over 1e3 times ``GRAD_CLIP``),
    so the update reads the global norm over every rank, each replicated
    leaf (``a_log``, ``dt_bias``, ``d_skip``, the norms) counted once."""
    _, out = ranks
    got, ans = out[arch], answers[arch]
    gnorm = float(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                              for g in jax.tree.leaves(ans["port"]["grads"]))))
    assert gnorm > 1e3 * GRAD_CLIP
    assert len(set(got["step_losses"])) == 1
    new_j, _, loss_j = ans["jax"]["step"]
    assert abs(got["step_losses"][0] - float(loss_j)) <= LOSS_REL[arch] * \
        abs(float(loss_j))
    worst = max((_scaled_err(b, _at(ans["port"]["stepped"], path)), path)
                for path, _, b in _pairs(new_j, got["stepped"]))
    assert worst[0] <= STEP_TOL, worst


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_serve_loop_tokens_equal_the_one_rank_loop(ranks, answers, arch):
    import warnings
    from repro_torch.runtime.serve import Request, ServeLoop
    _, out = ranks
    ans = answers[arch]
    slots, prompts, new = _serve_case(ans["cfg"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        loop = ServeLoop(ans["cfg"], batch=slots, max_len=32, device="cpu",
                         params=params_from_numpy(ans["params"], ans["cfg"],
                                                  "cpu"))
    want = [c.tokens for c in loop.serve(
        [Request(app_id=i, prompt=p, max_new=new)
         for i, p in enumerate(prompts)])]
    got = out[arch]["serve"]
    assert all(g == want for g in got), (got[0], want)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_is_bit_equal_to_no_mesh(arch, tmp_path):
    """On a (1, 1) mesh of one launched gloo rank every collective is a
    copy and the SSM's norm over ``model`` is ``rms_norm`` op for op: the
    loss and the prefill logits equal the program without a mesh bit for
    bit (the card's NCCL leg holds the Mamba-2 step so).  The gradients
    round otherwise in one place, the vocab-parallel cross-entropy's
    backward (autograd through max, exp and log where the plain path takes
    ``logsumexp``'s), as ``DenseLM``'s do; through the recurrences that
    moves a leaf by up to 2.5e-6 of its largest value (measured: Mamba-2's
    ``a_log``; RecurrentGemma 8.9e-7, Whisper 1.0e-6), so they are held
    within ``ONE_RANK_GRAD`` of it."""
    import torch.distributed as dist
    cfg = _configs(arch)[1]
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    mesh = make_smoke_mesh(1, 1)
    shape = ShapeConfig("t", S, B, "train")
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
                logits = model.prefill(params, {
                    k: v for k, v in batch.items() if k != "labels"})
            out[name] = (loss, tree_leaves(grads), logits)
    finally:
        dist.destroy_process_group()
    (lp, gp, pp), (lm, gm, pm) = out["plain"], out["mesh"]
    assert torch.equal(lp, lm) and torch.equal(pp, pm)
    worst = max(_scaled_err(b.numpy(), a.numpy()) for a, b in zip(gp, gm))
    assert worst <= ONE_RANK_GRAD, worst


# ----------------------------------------------------------------------
# meta meshes, no ranks
# ----------------------------------------------------------------------
def _flops(cfg, shape, mesh):
    low = lower_step(build_step(cfg, shape, mesh, multi_pod=len(mesh.shape)
                                == 3, device="meta"), mesh)
    return low.cost_analysis()["flops"], low


def _replicated_flops(cfg, B_loc, S):
    """The train step's FLOPs that every model rank of a data shard
    repeats, whatever its heads.  The SSD reads the whole state width N:
    its C.B^T within each chunk of Q (2QN a token) runs in the forward,
    again in remat "dots"'s recompute (a batched product, not saved) and
    again in the plain backward (``ssd_bwd_ref`` recomputes the chunk
    forward), and the backward's dB and dC products take D summed over
    the heads first (``torch.einsum`` reduces an index its other operand
    lacks before the product): 10QN a token and layer.  The hybrid's
    single kv head is gathered and projected on every rank: ``wk`` and
    ``wv``, forward and the two backward products (remat saves them)."""
    if cfg.family == "ssm":
        return 10 * B_loc * S * cfg.ssm.chunk * cfg.ssm.d_state * \
            cfg.n_layers
    if cfg.family == "hybrid":
        kv = 2 * cfg.d_model * cfg.n_kv_heads * cfg.hd
        per = cfg.hybrid.pattern_rec + 1
        return 3 * 2 * B_loc * S * kv * (cfg.n_layers // per)
    return 0


@pytest.mark.parametrize("Bg,shards", [(4, 1), (16, 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_a_device_divide_but_for_the_named_replicated_work(
        arch, Bg, shards):
    cfg = get_config(arch, smoke=True)
    shape = ShapeConfig("t", 64, Bg, "train")
    one, _ = _flops(cfg, shape, CARD)
    per, low = _flops(cfg, shape, make_smoke_mesh(2, 2))
    rep = _replicated_flops(cfg, Bg // shards, 64)
    assert per == (one - rep * shards) / (2 * shards) + rep
    colls = roofline.parse_collectives(low.as_text())
    assert {"all-reduce", "all-gather", "reduce-scatter"} <= set(colls)


def _published(arch):
    """The published config cut to a few layers (its widths whole)."""
    cfg = get_config(arch)
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=3 * 1 + 1)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=1, n_encoder_layers=1)
    return dataclasses.replace(cfg, n_layers=1)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("mesh", [make_production_mesh(),
                                  make_production_mesh(multi_pod=True)],
                         ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_published_configs_lower_on_production_meshes(arch, mesh, kind):
    cfg = _published(arch)
    shape = ShapeConfig("t", 512, 64, kind)
    flops, low = _flops(cfg, shape, mesh)
    assert flops > 0
    colls = roofline.parse_collectives(low.as_text())
    assert colls["all-reduce"]["count"] > 0
    model = build_model(cfg, device="meta")
    local = shard_params(model.param_shapes(), layout_specs(
        model, len(mesh.shape) == 3), mesh, (0,) * len(mesh.shape))
    pbytes = sum(t.numel() * t.element_size() for t in tree_leaves(local))
    args = low.memory_analysis().argument_size_in_bytes
    assert pbytes < args < pbytes * (5 if kind == "train" else 2) + 2 ** 26
