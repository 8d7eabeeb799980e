"""The recurrent families as a whole: the smoke Mamba-2 (``SSMLM``) and the
smoke RecurrentGemma (``HybridLM``), float32, in both packages, with the
port's parameters converted from the JAX initialisation by
``params_from_numpy``.

- ``prefill`` logits, the ``loss`` value, and 8 teacher-forced
  ``decode_step`` logits and decode states, against JAX.  Tolerance: a
  fraction of the largest value of each tensor compared (the smoke models'
  activations reach some 10^3, the hybrid's recurrent state some 70, and
  float32 rounding differences in the matmuls scale with them, so an
  element-wise relative limit would hold small entries to less than their
  rounding noise): 2e-4 for the SSM (measured worst 5e-6 over six
  initialisations) and 1e-3 for the hybrid.  The hybrid's gated input
  ``sqrt(1 - a^2)`` loses digits where the decay ``a = exp(-8 softplus(L)
  r)`` is near 1, and the two packages' float32 ``exp`` differ by one ulp
  (6e-8) on some of those inputs: one such element of the first block's
  gated input differs by 1e-4 of the input's largest value, and the
  prefill logits by up to 2.5e-4 of theirs (measured over six
  initialisations; a wrong gate, decay or scan moves them by far more).
- Both families served by ``ElasticServer`` + ``ModelEngine`` in both
  packages on the same shell events and requests: token streams, entry
  ports and ``port_traffic`` equal, as ``tests/test_torch_serve.py`` holds
  the Mixtral.
- On the port alone: ``prefill`` (the scans) against the engine's replay
  of the same prompt through ``decode_step`` (the recurrences): the same
  greedy token and logits within 2e-4 of their largest value (one
  package, so no ``exp`` differs; the two forms sum in other orders).
- The hybrid's parameter tree round-trips through ``ckpt/convert.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import shell as jshell
from repro.configs import get_config as jax_get_config
from repro.core.elastic import Region as JRegion
from repro.core.module import ModuleFootprint as JFootprint
from repro.models.lm import build_model as jax_build_model
from repro.shell.server import ElasticServer as JServer
from repro.shell.server import ModelEngine as JEngine
from repro.shell.server import StreamRequest as JRequest
from repro_torch import shell as tshell
from repro_torch.ckpt.convert import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.elastic import Region as TRegion
from repro_torch.core.module import ModuleFootprint as TFootprint
from repro_torch.models.lm import HybridLM, SSMLM, build_model
from repro_torch.shell.server import ElasticServer as TServer
from repro_torch.shell.server import ModelEngine as TEngine
from repro_torch.shell.server import StreamRequest as TRequest

ARCHS = ["mamba2_780m", "recurrentgemma_9b"]
TOL = {"mamba2_780m": 2e-4, "recurrentgemma_9b": 1e-3}
B, S = 2, 64
MAX_LEN = 24            # the hybrid's window is 16: its ring wraps
PROMPT_LEN = 8
MAX_NEW = 6
GB = 1 << 30
STATE_FIELDS = {"mamba2_780m": ("ssm_state", "conv_tail"),
                "recurrentgemma_9b": ("kv_k", "kv_v", "rec_h", "rec_tail")}


def _configs(arch):
    f32 = lambda cfg: dataclasses.replace(cfg, dtype="float32")
    return (f32(jax_get_config(arch, smoke=True)),
            f32(torch_get_config(arch, smoke=True)))


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    cfg_j, cfg_t = _configs(arch)
    jm = jax_build_model(cfg_j)
    jp = jm.init(jax.random.key(1))
    tm = build_model(cfg_t, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg_t, "cpu")
    return arch, jm, jp, tm, tp


def _assert_scaled_close(got, want, what, tol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def test_model_class_per_family(models):
    arch, _, _, tm, _ = models
    assert type(tm) is {"mamba2_780m": SSMLM,
                        "recurrentgemma_9b": HybridLM}[arch]


def test_prefill_and_loss_match_jax(models):
    arch, jm, jp, tm, tp = models
    batch = _batch(tm.cfg.vocab)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _assert_scaled_close(tm.prefill(tp, tb), jm.prefill(jp, jb), "prefill",
                         TOL[arch])
    lj, lt = float(jm.loss(jp, jb)), float(tm.loss(tp, tb))
    assert abs(lt - lj) <= TOL[arch] * abs(lj), (lt, lj)


def _stacked(state, field):
    v = getattr(state, field)
    return torch.stack(v) if isinstance(v, list) else v


def test_teacher_forced_decode_matches_jax(models):
    arch, jm, jp, tm, tp = models
    toks = _batch(tm.cfg.vocab, seed=1)["tokens"]
    js = jm.init_decode_state(B, MAX_LEN)
    ts = tm.init_decode_state(B, MAX_LEN)
    step = jax.jit(jm.decode_step)
    for s in range(8):
        col = toks[:, s:s + 1]
        jl, js = step(jp, js, {"tokens": jnp.asarray(col)})
        tl, ts = tm.decode_step(tp, ts, {"tokens": torch.from_numpy(col)})
        _assert_scaled_close(tl, jl, f"logits step {s}", TOL[arch])
        for f in STATE_FIELDS[arch]:
            _assert_scaled_close(_stacked(ts, f), getattr(js, f),
                                 f"{f} step {s}", TOL[arch])
        if arch == "recurrentgemma_9b":
            assert np.array_equal(ts.kv_pos.numpy(), np.asarray(js.kv_pos))
        assert ts.pos == int(js.pos)


def test_split_cuts_every_field_per_row(models):
    arch, _, _, tm, tp = models
    state = tm.init_decode_state(3, MAX_LEN)
    toks = torch.tensor([[5], [17], [300]], dtype=torch.int32)
    _, state = tm.decode_step(tp, state, {"tokens": toks})
    parts = state.split()
    assert len(parts) == 3
    for i, part in enumerate(parts):
        assert part.pos == state.pos
        for f in STATE_FIELDS[arch]:
            whole = getattr(state, f)
            for a, b in zip(getattr(part, f), whole):
                assert a.shape[0] == 1 and torch.equal(a[0], b[i])
                assert a.data_ptr() != b.data_ptr()          # a copy


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
def test_served_streams_and_traffic_equal(arch):
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
    assert len(tc) == 4
    assert [(c.tokens, c.entry_port, c.admitted_tick, c.finished_tick)
            for c in jc] == [(c.tokens, c.entry_port, c.admitted_tick,
                              c.finished_tick) for c in tc]
    assert {c.entry_port for c in tc} == {0, 1}   # the Grow re-routed
    assert np.array_equal(js.port_traffic, ts.port_traffic)


def test_prefill_equals_replay_through_decode(models):
    """The full-sequence scans (``prefill``) and the one-token recurrences
    (``ModelEngine``'s replay through ``decode_step``) give the same next
    token and logits for the same prompt."""
    arch, _, _, tm, tp = models
    engine = TEngine(tm.cfg, max_len=40, device="cpu", params=tp)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, tm.cfg.vocab, 32).astype(np.int32)
    tok, state = engine.prefill(prompt)
    logits = tm.prefill(tp, {"tokens": torch.from_numpy(prompt[None])})
    replay = tm.init_decode_state(1, 40)
    for t in prompt:
        replay_logits, replay = tm.decode_step(
            tp, replay, {"tokens": torch.tensor([[t]], dtype=torch.int32)})
    _assert_scaled_close(logits, replay_logits, "prefill vs replay", 2e-4)
    masked = logits[0, :tm.cfg.vocab]
    assert int(masked.argmax()) == tok
    assert state.pos == len(prompt)


def test_hybrid_parameter_tree_round_trips():
    cfg_j, cfg_t = _configs("recurrentgemma_9b")
    jp = jax_build_model(cfg_j).init(jax.random.key(2))
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(tree, cfg_t, "cpu")
    n_groups = 5 // 3
    assert len(tp["groups"]) == n_groups and len(tp["trail"]) == 2
    assert len(tp["groups"][0]["rec"]) == cfg_t.hybrid.pattern_rec
    w_r = np.array(tree["groups"]["rec"]["rec"]["w_r"][0, 1])
    assert torch.equal(tp["groups"][0]["rec"][1]["rec"]["w_r"],
                       torch.from_numpy(w_r))
    w_in = np.array(tree["trail"]["mlp"]["w_in"][1])
    assert torch.equal(tp["trail"][1]["mlp"]["w_in"], torch.from_numpy(w_in))
    back = params_to_numpy(tp)
    assert (jax.tree.structure(back) == jax.tree.structure(tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    # and the port's own init in the other direction
    tm = build_model(cfg_t, device="cpu")
    tp2 = tm.init(torch.Generator().manual_seed(0))
    again = params_from_numpy(params_to_numpy(tp2), cfg_t, "cpu")
    for a, b in zip(jax.tree.leaves(params_to_numpy(again)),
                    jax.tree.leaves(params_to_numpy(tp2))):
        assert np.array_equal(a, b)
