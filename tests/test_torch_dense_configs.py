"""The four published dense-family configs that no other test holds
against the JAX package: Qwen2.5-3B (QKV bias, tied head), Granite-3-2B
(head dim 64, tied head), Command R+ (G = 4 at smoke width, tied head)
and Mixtral-8x22B (sliding window, MoE), each at its smoke widths in
float32.  ``DenseLM.loss`` and every gradient leaf, ``DenseLM.prefill``,
and Qwen's greedy tokens through ``decode_step``.

Parameters are the JAX initialisation converted with
``repro_torch.ckpt.convert``.  Both inits leave Qwen's ``bq``/``bk``/``bv``
at zero, so its biases are replaced in both packages by the same seeded
nonzero values.  Mixtral-8x22B's MoE runs on JAX's ``dense`` dispatch
against the port's, and on JAX's Pallas kernel data plane (interpret mode)
against the port's ``cuda_kernel``, as ``test_torch_train.py`` does; its
window (32) is shorter than the sequence (64), so it cuts keys.

Tolerances are ``test_torch_train.py``'s, for its reasons: the loss within
1e-6 relative; every gradient leaf within 2e-3 of the leaf's largest value
(JAX's init makes the smoke models' gradients ill-conditioned; the pieces
agree to about 1e-7); the last-token logits within 2e-5 absolute and
relative; the greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.fabric import PallasBackend, register_fabric_backend
from repro.models.lm import build_model as jax_build_model
from repro_torch.ckpt.convert import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models.lm import DenseLM

JAX_KERNEL_BACKEND = "pallas_kernel_dense_configs_test"
register_fabric_backend(
    JAX_KERNEL_BACKEND, lambda **kw: PallasBackend(data_plane="kernel", **kw))

ARCHS = ("qwen2_5_3b", "granite_3_2b", "command_r_plus_104b",
         "mixtral_8x22b")
# path -> (JAX dispatch, JAX kernel mode, port dispatch); the dense configs
# have no MoE and run the "plain" path only
PATHS = {"plain": ("dense", "auto", "dense"),
         "kernel": (JAX_KERNEL_BACKEND, "pallas_interpret", "cuda_kernel")}
CASES = [(a, "plain") for a in ARCHS] + [("mixtral_8x22b", "kernel")]
B, S = 2, 64
LOSS_REL = 1e-6
GRAD_REL = 2e-3
LOGITS_TOL = 2e-5
BIAS_STD = 0.5        # Qwen's drawn biases: the scale of q, k and v
PROMPT_LEN, MAX_NEW = 8, 8


def _cfg(get_config, arch, dispatch, **moe_kw):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch=dispatch, **moe_kw))


def _with_biases(tree, seed: int = 1):
    """``tree`` (the JAX layout, numpy leaves) with every ``bq``, ``bk``
    and ``bv`` drawn from N(0, ``BIAS_STD``)."""
    rng = np.random.default_rng(seed)
    attn = tree["layers"]["attn"]
    for k in ("bq", "bk", "bv"):
        attn[k] = rng.normal(0, BIAS_STD, attn[k].shape).astype(np.float32)
    return tree


def _setup(arch, path):
    jd, jmode, td = PATHS[path]
    cfg_j = _cfg(jax_get_config, arch, jd, kernel_mode=jmode)
    cfg_t = _cfg(torch_get_config, arch, td)
    model_j = jax_build_model(cfg_j)
    tree = jax.tree.map(np.asarray, model_j.init(jax.random.key(0)))
    if cfg_t.qkv_bias:
        tree = _with_biases(tree)
    params_j = jax.tree.map(jnp.asarray, tree)
    model_t = DenseLM(cfg_t, device="cpu")
    params_t = params_from_numpy(tree, cfg_t, device="cpu")
    batch = jax_synthetic_batch(0, 0, 0, 1, B, S, cfg_t.vocab)
    return model_j, params_j, model_t, params_t, batch


def _assert_trees_close(tree_j, tree_np, rel):
    leaves = jax.tree_util.tree_leaves_with_path(tree_j)
    assert len(leaves) == len(jax.tree_util.tree_leaves(tree_np))
    for path, a in leaves:
        b = tree_np
        for k in path:
            b = b[k.key]
        a = np.asarray(a, np.float32)
        tol = rel * float(np.abs(a).max())
        err = float(np.abs(a - b).max())
        assert err <= tol, (jax.tree_util.keystr(path), err, tol)


def test_qwen_biases_are_drawn_and_reach_the_logits():
    """The biases the other tests use are nonzero, and the prefill logits
    move when they are zeroed: the QKV-bias path carries them."""
    _, _, model_t, params_t, batch = _setup("qwen2_5_3b", "plain")
    for lp in params_t["layers"]:
        assert all(float(lp["attn"][k].abs().min()) > 0
                   for k in ("bq", "bk", "bv"))
    with torch.no_grad():
        with_b = model_t.prefill(params_t, {"tokens": batch["tokens"]})
        for lp in params_t["layers"]:
            for k in ("bq", "bk", "bv"):
                lp["attn"][k].zero_()
        without = model_t.prefill(params_t, {"tokens": batch["tokens"]})
    assert float((with_b - without).abs().max()) > 1e-3


@pytest.mark.parametrize("arch,path", CASES)
def test_loss_and_every_gradient_leaf_match_jax(arch, path):
    model_j, params_j, model_t, params_t, batch = _setup(arch, path)
    loss_j, grads_j = jax.value_and_grad(model_j.loss)(
        params_j, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [p.requires_grad_() for p in jax.tree_util.tree_leaves(params_t)]
    loss_t = model_t.loss(params_t, batch)
    grads = torch.autograd.grad(loss_t, leaves)
    assert all(float(g.abs().max()) > 0 for g in grads)
    it = iter(grads)
    grads_t = jax.tree.map(lambda _: next(it), params_t)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=LOSS_REL)
    _assert_trees_close(grads_j, params_to_numpy(grads_t), GRAD_REL)


@pytest.mark.parametrize("arch,path", CASES)
def test_prefill_logits_match_jax(arch, path):
    model_j, params_j, model_t, params_t, batch = _setup(arch, path)
    logits_j = model_j.prefill(params_j,
                               {"tokens": jnp.asarray(batch["tokens"])})
    with torch.no_grad():
        logits_t = model_t.prefill(params_t, {"tokens": batch["tokens"]})
    assert logits_t.shape == (B, model_t.cfg.vocab_padded)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_qwen_greedy_decode_matches_jax():
    """A prompt fed through ``decode_step`` token by token, then
    ``MAX_NEW`` greedy tokens, each package feeding its own argmax: the
    same tokens (and each step's logits within 2e-4, as
    ``test_torch_serve.py`` holds them)."""
    model_j, params_j, model_t, params_t, batch = _setup("qwen2_5_3b",
                                                         "plain")
    vocab = model_t.cfg.vocab
    prompt = np.asarray(batch["tokens"][:, :PROMPT_LEN])
    max_len = PROMPT_LEN + MAX_NEW
    js = model_j.init_decode_state(B, max_len)
    ts = model_t.init_decode_state(B, max_len)
    step = jax.jit(model_j.decode_step)
    tok_j = tok_t = prompt[:, :1]
    out_j, out_t = [], []
    for s in range(max_len - 1):
        jl, js = step(params_j, js, {"tokens": jnp.asarray(tok_j)})
        with torch.no_grad():
            tl, ts = model_t.decode_step(params_t, ts,
                                         {"tokens": torch.from_numpy(tok_t)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                                   atol=2e-4)
        if s + 1 < PROMPT_LEN:
            tok_j = tok_t = prompt[:, s + 1:s + 2]
            continue
        tok_j = np.asarray(jnp.argmax(jl[:, :vocab], -1), np.int32)[:, None]
        tok_t = tl[:, :vocab].argmax(-1).numpy().astype(np.int32)[:, None]
        out_j.append(tok_j[:, 0].tolist())
        out_t.append(tok_t[:, 0].tolist())
    assert len(out_t) == MAX_NEW
    assert out_t == out_j
