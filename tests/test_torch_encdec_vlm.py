"""The ``encdec`` (Whisper) and ``vlm`` (LLaVA-NeXT) families against the
JAX package, on the CPU: each smoke config in float32, the port's
parameters converted from the JAX package's own ``init`` by
``params_from_numpy``, inputs from numpy seed 0 (frames and patches drawn
from N(0, 0.02), as ``tests/test_models_smoke.py`` draws them).

- ``prefill`` logits, the ``loss`` value, every gradient leaf, one AdamW
  step (``make_train_step``), 4 teacher-forced ``decode_step`` logits (the
  encoder-decoder's with a random cross-attention cache in both packages,
  so the cross path is read) against JAX.
- ``ElasticServer`` + ``ModelEngine`` token streams, entry ports and port
  traffic equal to the JAX package's on the same shell events.
- A checkpoint of (params, OptState) written by either package restored
  by the other, bit for bit.
- The attention cases the encoder-decoder adds: the encoder's
  bidirectional self-attention against JAX's ``attention_prefill(causal=
  False)``, and the port's plain attention at Sq != Sk, non-causal (the
  cross-attention) against JAX's ``attention_ref``.
- ``n_params`` from ``param_defs`` equal to the JAX package's for every
  full config, with ``build_model`` working for all ten.

Tolerances (float32; the same arithmetic summed in other orders): logits
and decode logits within 1e-4 of their largest value, the loss within
1e-5 relative; every gradient leaf and the first moment within 1e-4 of
the leaf's largest value for the vlm (the second moment twice that: it
squares the gradient), the updated parameters within 1e-3 of the
learning rate where the first moments agree to 1e-3 of themselves, as
``tests/test_torch_recurrent_train.py`` holds the SSM; attention outputs
within 2e-5, the JAX package's forward tolerance of its flash kernel.

The smoke Whisper's gradients are ill-conditioned, so its leaves are held
within 2e-3 of their largest value and 2e-3 in relative L2, and its
update within 1e-2 of the learning rate where the first moments agree to
1e-2 (measured 1.5e-3), as the hybrid's in that file.  Moving every parameter
by a relative 1e-7 (one float32 ulp) moves the port's own gradient leaves
by up to 1.6e-3 of their largest value, and the frames by as much moves
them by 3.2e-3 (the encoder's leaves; JAX's own by 3.1e-3); against JAX
the worst leaf is 7.3e-4 (the encoder's ``attn.wk``) and the worst
relative L2 distance 6.6e-4, measured on this seed.  The cause is the
JAX package's init: ``normal_init`` takes the fan-in from a shape's first
axis, which for the stacked layers is the layer count, so the smoke
model's projections have a standard deviation of 1/sqrt(2) = 0.71 (the
port's own init, per layer, gives 1/8), and its attention is peaked.
With the port's init the same perturbation moves no leaf by more than
4e-6.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import shell as jshell
from repro.ckpt import checkpoint as jckpt
from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.core.elastic import Region as JRegion
from repro.core.module import ModuleFootprint as JFootprint
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import attention as jattn
from repro.models.lm import build_model as jax_build_model
from repro.optim.adamw import AdamW as JaxAdamW
from repro.shell.server import ElasticServer as JServer
from repro.shell.server import ModelEngine as JEngine
from repro.shell.server import StreamRequest as JRequest
from repro_torch import shell as tshell
from repro_torch.ckpt.checkpoint import CheckpointManager, save_checkpoint
from repro_torch.ckpt.convert import (opt_state_to_numpy, params_from_numpy,
                                      params_to_numpy)
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.elastic import Region as TRegion
from repro_torch.core.module import ModuleFootprint as TFootprint
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.steps import make_train_step
from repro_torch.models import attention as tattn
from repro_torch.models.common import tree_leaves
from repro_torch.models.lm import DenseLM, EncDecLM, build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.shell.server import ElasticServer as TServer
from repro_torch.shell.server import ModelEngine as TEngine
from repro_torch.shell.server import StreamRequest as TRequest

ARCHS = ["whisper_medium", "llava_next_34b"]
B, S = 2, 32
LR = 1e-3
OUT_REL = 1e-4          # logits, of their largest value
LOSS_REL = 1e-5
GRAD_REL = {"whisper_medium": 2e-3, "llava_next_34b": 1e-4}  # of leaf max
GRAD_L2 = 2e-3          # the smoke Whisper's leaves, relative L2
M_AGREE = {"whisper_medium": 1e-2, "llava_next_34b": 1e-3}
UPDATE_TOL = {"whisper_medium": 1e-2 * LR, "llava_next_34b": 1e-3 * LR}
ATTN_TOL = 2e-5
MAX_LEN = 24
PROMPT_LEN = 8
MAX_NEW = 6
GB = 1 << 30


def _configs(arch, **kw):
    f32 = lambda cfg: dataclasses.replace(cfg, dtype="float32", **kw)  # noqa: E731
    return (f32(jax_get_config(arch, smoke=True)),
            f32(torch_get_config(arch, smoke=True)))


def _batch(cfg, seed=0):
    """tokens, labels and the family's input (frames or patches) as numpy,
    drawn as ``tests/test_models_smoke.py`` draws them."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(0, 0.02, (B, cfg.encoder_len,
                                             cfg.d_model)).astype(np.float32)
    else:
        out["patches"] = rng.normal(0, 0.02, (B, cfg.n_vision_patches,
                                              cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """(arch, JAX model, its params, the port's model, its params, the
    batch, JAX's answers): ``prefill``, ``loss``, ``value_and_grad`` of
    the loss and one step of JAX's ``make_train_step`` with AdamW, all in
    one compiled call."""
    arch = request.param
    cfg_j, cfg_t = _configs(arch)
    jm = jax_build_model(cfg_j)
    jp = jm.init(jax.random.key(0))
    tm = build_model(cfg_t, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg_t, "cpu")
    batch = _batch(cfg_t)
    opt = JaxAdamW(lr=LR)

    def answers(params, b):
        return {"prefill": jm.prefill(params, b), "loss": jm.loss(params, b),
                "value_and_grad": jax.value_and_grad(jm.loss)(params, b),
                "step": jax_make_train_step(jm, opt, 1)(
                    params, opt.init(params), b)}

    ref = jax.jit(answers)(jp, _jax(batch))
    return arch, jm, jp, tm, tp, batch, ref


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_scaled_close(got, want, what, tol=OUT_REL):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _pairs(tree_j, tree_np):
    """(path, JAX leaf, port leaf) in JAX's order, the port's tree in the
    JAX layout (``params_to_numpy``)."""
    out = []
    for path, a in jax.tree_util.tree_leaves_with_path(tree_j):
        b = tree_np
        for k in path:
            b = b[k.key]
        out.append((jax.tree_util.keystr(path), np.asarray(a, np.float64),
                    np.asarray(b, np.float64)))
    assert len(out) == len(jax.tree_util.tree_leaves(tree_np))
    return out


def _port_grads(model, params, batch):
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    it = iter(grads)
    return float(loss.detach()), jax.tree.map(lambda _: next(it), params)


# ----------------------------------------------------------------------
# the families against JAX
# ----------------------------------------------------------------------
def test_model_class_and_input_path(models):
    arch, _, _, tm, tp, batch, _ = models
    assert type(tm) is {"whisper_medium": EncDecLM,
                        "llava_next_34b": DenseLM}[arch]
    if arch == "llava_next_34b":
        # the patches replace the first Pn positions, cast to the model type
        n = tm.cfg.n_vision_patches
        x = tm._inputs_embed(tp, _torch(batch))
        assert x.shape == (B, S, tm.cfg.d_model) and x.dtype == torch.float32
        assert torch.equal(x[:, :n], torch.from_numpy(batch["patches"]))
        assert torch.equal(x[:, n:], tm._embed(tp, batch["tokens"])[:, n:])


def test_prefill_and_loss_match_jax(models):
    _, _, _, tm, tp, batch, ref = models
    _assert_scaled_close(tm.prefill(tp, _torch(batch)), ref["prefill"],
                         "prefill")
    lj, lt = float(ref["loss"]), float(tm.loss(tp, _torch(batch)))
    assert abs(lt - lj) <= LOSS_REL * abs(lj), (lt, lj)


def _assert_leaves_close(arch, tree_j, tree_np, factor=1.0):
    for name, a, b in _pairs(tree_j, tree_np):
        scale = float(np.abs(a).max())
        assert scale > 0, name
        err = float(np.abs(a - b).max())
        assert err <= factor * GRAD_REL[arch] * scale, (name, err, scale)
        if arch == "whisper_medium":
            l2 = float(np.linalg.norm(a - b) / np.linalg.norm(a))
            assert l2 <= factor * GRAD_L2, (name, l2)


def test_every_gradient_leaf_matches_jax(models):
    arch, _, _, tm, tp, batch, ref = models
    loss_j, grads_j = ref["value_and_grad"]
    loss_t, grads_t = _port_grads(tm, tp, _torch(batch))
    assert abs(loss_t - float(loss_j)) <= LOSS_REL * abs(float(loss_j))
    _assert_leaves_close(arch, grads_j, params_to_numpy(grads_t))


def test_adamw_train_step_matches_jax(models):
    arch, _, jp, tm, _, batch, ref = models
    old = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(old, tm.cfg, "cpu")          # updated in place
    opt_t = AdamW(lr=LR)
    new_j, state_j, loss_j = ref["step"]
    new_t, state_t, loss_t = make_train_step(tm, opt_t, 1)(
        tp, opt_t.init(tp), _torch(batch))
    assert abs(float(loss_t) - float(loss_j)) <= LOSS_REL * abs(float(loss_j))
    step, m, v = opt_state_to_numpy(state_t)
    assert step == int(state_j.step) == 1
    _assert_leaves_close(arch, state_j.m, m)
    _assert_leaves_close(arch, state_j.v, v, factor=2.0)
    for (name, a, b), (_, mj, mt), (_, o, _) in zip(
            _pairs(new_j, params_to_numpy(new_t)), _pairs(state_j.m, m),
            _pairs(old, old)):
        agree = np.abs(mt - mj) <= M_AGREE[arch] * np.abs(mj)
        assert agree.mean() >= 0.5, (name, float(agree.mean()))
        err = float(np.abs((a - o) - (b - o))[agree].max())
        assert err <= UPDATE_TOL[arch], (name, err)


def test_teacher_forced_decode_matches_jax(models):
    """4 decode steps with the same tokens; the encoder-decoder's
    cross-attention cache holds the same random values in both packages
    (``init_decode_state`` leaves it zero, which would hide the path)."""
    arch, jm, jp, tm, tp, batch, _ = models
    js = jm.init_decode_state(B, MAX_LEN)
    ts = tm.init_decode_state(B, MAX_LEN)
    if arch == "whisper_medium":
        assert len(ts.cross_k) == tm.cfg.n_layers
        assert all(not c.any() for c in ts.cross_k + ts.cross_v)
        rng = np.random.default_rng(1)
        shape = (tm.cfg.n_layers,) + tuple(ts.cross_k[0].shape)
        ck, cv = (rng.normal(0, 1, shape).astype(np.float32)
                  for _ in range(2))
        js = dataclasses.replace(js, cross_k=jnp.asarray(ck),
                                 cross_v=jnp.asarray(cv))
        ts = dataclasses.replace(ts, cross_k=list(torch.from_numpy(ck)),
                                 cross_v=list(torch.from_numpy(cv)))
    step = jax.jit(jm.decode_step)
    toks = batch["tokens"]
    for s in range(4):
        col = toks[:, s:s + 1]
        jl, js = step(jp, js, {"tokens": jnp.asarray(col)})
        tl, ts = tm.decode_step(tp, ts, {"tokens": torch.from_numpy(col)})
        _assert_scaled_close(tl, jl, f"logits step {s}")
        _assert_scaled_close(torch.stack(ts.kv_k), js.kv_k, f"kv_k {s}")
        assert np.array_equal(ts.kv_pos.numpy(), np.asarray(js.kv_pos))
        assert ts.pos == int(js.pos)
    if arch == "whisper_medium":
        parts = ts.split()
        assert len(parts) == B
        for i, part in enumerate(parts):
            for f in ("kv_k", "kv_v", "cross_k", "cross_v"):
                for a, b in zip(getattr(part, f), getattr(ts, f)):
                    assert a.shape[0] == 1 and torch.equal(a[0], b[i])
                    assert a.data_ptr() != b.data_ptr()      # a copy


def test_engine_replay_passes_the_decode_inputs(models):
    """``ModelEngine``'s replay prefill hands ``decode_step`` the family's
    decode inputs (zero frames [B, F, d] for the encoder-decoder, none
    for the vlm), as the JAX package's engine does."""
    arch, _, _, tm, tp, _, _ = models
    engine = TEngine(tm.cfg, max_len=MAX_LEN, device="cpu", params=tp)
    seen = []
    step = engine.model.decode_step

    def spy(params, state, batch):
        seen.append({k: tuple(v.shape) for k, v in batch.items()
                     if k != "tokens"})
        return step(params, state, batch)

    engine.model.decode_step = spy
    engine.prefill_batch([np.arange(3, dtype=np.int32)] * 2)
    engine.decode(5, engine.prefill(np.arange(3, dtype=np.int32))[1])
    cfg = tm.cfg
    want = ({"frames": (2, cfg.encoder_len, cfg.d_model)}
            if arch == "whisper_medium" else {})
    assert seen[:3] == [want] * 3
    assert seen[-1] == {k: (1,) + v[1:] for k, v in want.items()}


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, PROMPT_LEN).astype(np.int32)
            for _ in range(4)]


def _serve(pkg, Region, Footprint, Server, Request, engine, backend, vocab,
           **kw):
    shell = pkg.Shell([Region(rid=i, n_chips=8, hbm_bytes=8 * GB)
                       for i in range(2)])
    shell.submit("lm", [Footprint(GB, 1e9, 4096)], app_id=0)
    shell.post(pkg.Shrink("lm", 0))             # starts on the host port
    server = Server(shell, n_slots=4, fabric_backend=backend, **kw)
    server.register_engine(0, engine)
    prompts = _prompts(vocab)
    for p in prompts[:2]:
        server.submit(Request(app_id=0, prompt=p, max_new=MAX_NEW))
    for _ in range(3):
        server.step()
    shell.post(pkg.Grow("lm"))                  # next admissions -> port 1
    for p in prompts[2:]:
        server.submit(Request(app_id=0, prompt=p, max_new=MAX_NEW))
    server.run()
    return server


@pytest.mark.parametrize("arch", ARCHS)
def test_served_streams_and_traffic_equal_jax(arch):
    cfg_j, cfg_t = _configs(arch)
    jeng = JEngine(cfg_j, max_len=MAX_LEN, seed=0)
    teng = TEngine(cfg_t, max_len=MAX_LEN, device="cpu",
                   params=params_from_numpy(
                       jax.tree.map(np.asarray, jeng.params), cfg_t, "cpu"))
    js = _serve(jshell, JRegion, JFootprint, JServer, JRequest, jeng,
                "pallas", cfg_j.vocab)
    ts = _serve(tshell, TRegion, TFootprint, TServer, TRequest, teng,
                "cuda", cfg_t.vocab, device="cpu")
    jc = sorted(js.completions, key=lambda c: c.rid)
    tc = sorted(ts.completions, key=lambda c: c.rid)
    assert len(tc) == 4 and all(len(c.tokens) == MAX_NEW for c in tc)
    assert [(c.tokens, c.entry_port, c.admitted_tick, c.finished_tick)
            for c in jc] == [(c.tokens, c.entry_port, c.admitted_tick,
                              c.finished_tick) for c in tc]
    assert {c.entry_port for c in tc} == {0, 1}   # the Grow re-routed
    assert np.array_equal(js.port_traffic, ts.port_traffic)


# ----------------------------------------------------------------------
# checkpoints across the packages, and the parameter tree
# ----------------------------------------------------------------------
def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _sorted_leaves(tree):
    """A port tree's leaves in the JAX package's order (keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _bf16(arch):
    return tuple(dataclasses.replace(c, dtype="bfloat16")
                 for c in _configs(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_restores_into_the_port(tmp_path, arch):
    """JAX's (params, OptState) (bf16 parameters, float32 moments) into the
    port's own tree, every leaf bit-equal, the layers unstacked."""
    cfg_j, cfg_t = _bf16(arch)
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.key(3))
    rng = np.random.default_rng(3)
    noise = lambda p: jnp.asarray(rng.standard_normal(p.shape),  # noqa: E731
                                  jnp.float32)
    opt_j = JaxAdamW().init(params_j)
    state_j = opt_j._replace(step=jnp.int32(5),
                             m=jax.tree.map(noise, params_j),
                             v=jax.tree.map(noise, params_j))
    jckpt.save_checkpoint(tmp_path, 5, (params_j, state_j))
    model_t = build_model(cfg_t, device="cpu")
    params_t = model_t.init(torch.Generator().manual_seed(0))
    state_t = AdamW().init(params_t)
    step, (params_r, state_r) = CheckpointManager(tmp_path).restore_latest(
        (params_t, state_t))
    assert step == 5 and state_r.step == 5
    want = params_from_numpy(jax.tree.map(
        lambda a: np.asarray(a, np.float32), params_j), cfg_t, device="cpu")
    for a, b in zip(_sorted_leaves(want), _sorted_leaves(params_r)):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(a), _bits(b))
    _, m, v = opt_state_to_numpy(state_r)
    for ours, theirs in ((m, state_j.m), (v, state_j.v)):
        for _, a, b in _pairs(theirs, ours):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_jax(tmp_path, arch):
    """The port's (params, OptState) restored by the JAX package into its
    stacked tree: the same leaf paths in the same order, bit for bit."""
    cfg_j, cfg_t = _bf16(arch)
    params_t = build_model(cfg_t, device="cpu").init(
        torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(5)
    state_t = AdamW().init(params_t)
    for leaf in tree_leaves(state_t.m) + tree_leaves(state_t.v):
        leaf.normal_(generator=gen)
    state_t = state_t._replace(step=6)
    save_checkpoint(tmp_path, 6, (params_t, state_t))
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.key(0))
    like = (params_j, JaxAdamW().init(params_j))
    jckpt.save_checkpoint(tmp_path / "jax", 6, like)
    mine = json.loads((tmp_path / "step_00000006/manifest.json").read_text())
    theirs = json.loads(
        (tmp_path / "jax/step_00000006/manifest.json").read_text())
    assert mine["paths"] == theirs["paths"]
    assert mine["leaves"] == theirs["leaves"]
    params_r, state_r = jckpt.restore_checkpoint(tmp_path, like, step=6)
    assert int(state_r.step) == 6
    for _, a, b in _pairs(params_r, params_to_numpy(params_t)):
        np.testing.assert_array_equal(a, b)
    _, m, _ = opt_state_to_numpy(state_t)
    for _, a, b in _pairs(state_r.m, m):
        np.testing.assert_array_equal(a, b)


def test_encdec_parameter_tree_round_trips():
    cfg_j, cfg_t = _configs("whisper_medium")
    tree = jax.tree.map(np.asarray,
                        jax_build_model(cfg_j).init(jax.random.key(2)))
    tp = params_from_numpy(tree, cfg_t, "cpu")
    assert len(tp["enc_layers"]) == cfg_t.n_encoder_layers
    assert len(tp["dec_layers"]) == cfg_t.n_layers
    want = np.array(tree["dec_layers"]["xattn"]["wk"][1])
    assert torch.equal(tp["dec_layers"][1]["xattn"]["wk"],
                       torch.from_numpy(want))
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_dots_and_full_give_the_gradients_of_nothing(arch):
    """Both stacks under remat recompute the same operations: bit for
    bit."""
    cfg_t = _configs(arch)[1]
    batch = _torch(_batch(cfg_t))
    out = {}
    for policy in ("nothing", "dots", "full"):
        model = build_model(dataclasses.replace(cfg_t, remat=policy),
                            device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        out[policy] = _port_grads(model, params, batch)
    (ln, gn) = out["nothing"]
    for policy in ("dots", "full"):
        lr, gr = out[policy]
        assert lr == ln
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(gn),
                                                     tree_leaves(gr)))


# ----------------------------------------------------------------------
# the attention cases the encoder-decoder adds
# ----------------------------------------------------------------------
def _qkv(Sq, Sk, H, Kv, D, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return mk(1, Sq, H, D), mk(1, Sk, Kv, D), mk(1, Sk, Kv, D)


@pytest.mark.parametrize("S_enc", [40, 1500])
def test_encoder_attention_matches_jax(S_enc):
    """Bidirectional self-attention over encoder frames (1500 is no
    multiple of a chunk or tile): the port's plain path and the flash
    entry's CPU path against JAX's ``attention_prefill(causal=False)``."""
    H, Kv, D = (4, 4, 16) if S_enc == 40 else (2, 2, 64)
    q, k, v = _qkv(S_enc, S_enc, H, Kv, D, S_enc)
    want = np.asarray(jattn.attention_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for got in (tattn.attention_prefill(tq, tk, tv, causal=False),
                flash_ops.flash_attention(tq, tk, tv, causal=False)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL,
                                   rtol=ATTN_TOL)


@pytest.mark.parametrize("Sq,Sk", [(48, 1500), (1500, 48), (5, 3)])
def test_cross_attention_plain_matches_jax_reference(Sq, Sk):
    """Non-causal attention with Sq != Sk and ``q_offset=0`` (the
    decoder's queries against the encoder's keys, and the other way
    round): the port's plain path and the flash entry's CPU path (its
    forward and its backward against ``jax.vjp``) against JAX's
    ``attention_ref``."""
    from repro.kernels.flash_attention.ref import attention_ref
    H, Kv, D = 4, 2, 16
    q, k, v = _qkv(Sq, Sk, H, Kv, D, Sq + Sk)
    do = np.random.default_rng(7).standard_normal(q.shape).astype(
        np.float32)
    fn = lambda a, b, c: attention_ref(a, b, c, causal=False)  # noqa: E731
    want, grads_j = jax.jit(lambda a, b, c, g: (
        fn(a, b, c), jax.vjp(fn, a, b, c)[1](g)))(
            *(jnp.asarray(t) for t in (q, k, v, do)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = tattn.attention_prefill(tq.detach(), tk.detach(), tv.detach(),
                                  causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)
    out = flash_ops.flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATTN_TOL, rtol=ATTN_TOL)
    grads_t = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for name, a, b in zip("qkv", grads_t, grads_j):
        _assert_scaled_close(a, b, f"d{name}", OUT_REL)


# ----------------------------------------------------------------------
# every config: build_model and n_params
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_n_params_from_param_defs_matches_jax(arch):
    """``build_model`` takes every full config, and ``n_params`` counts
    the JAX package's parameters without allocating any."""
    model = build_model(torch_get_config(arch), device="cpu")
    assert model.n_params() == jax_build_model(jax_get_config(arch)).n_params()
