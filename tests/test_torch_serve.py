"""The slice as a whole: the smoke Mixtral (float32, MoE on the kernel
backend) served by ``ElasticServer`` + ``ModelEngine`` in both packages,
on the same shell events and requests, with the port's parameters
converted from the JAX engine's by ``params_from_numpy``.

The JAX side runs its MoE through ``PallasBackend(data_plane="kernel")``
with ``kernel_mode="xla"`` (the kernels' reference lowering, which the
JAX package's own tests pin bit-equal to the interpreted kernels) and its
server tick on the ``pallas`` backend; the port runs ``cuda_kernel`` and
``cuda`` on CPU tensors (the plain versions of its kernels).

Token streams, entry ports and ``port_traffic`` are equal.  Per-step
logits, teacher-forced on the JAX tokens, match within 2e-4 (absolute and
relative, float32): matmuls and softmax sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.elastic import Region as JRegion
from repro.core.module import ModuleFootprint as JFootprint
from repro.fabric import PallasBackend, register_fabric_backend
from repro import shell as jshell
from repro.shell.server import ElasticServer as JServer
from repro.shell.server import ModelEngine as JEngine
from repro.shell.server import StreamRequest as JRequest
from repro_torch.ckpt.convert import params_from_numpy
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.elastic import Region as TRegion
from repro_torch.core.module import ModuleFootprint as TFootprint
from repro_torch import shell as tshell
from repro_torch.shell.server import ElasticServer as TServer
from repro_torch.shell.server import ModelEngine as TEngine
from repro_torch.shell.server import StreamRequest as TRequest

from _torch_port import smoke_mixtral

JAX_BACKEND = "pallas_kernel_serve_test"
register_fabric_backend(
    JAX_BACKEND, lambda **kw: PallasBackend(data_plane="kernel", **kw))

GB = 1 << 30
MAX_LEN = 24
PROMPT_LEN = 8
MAX_NEW = 6


@pytest.fixture(scope="module")
def engines():
    cfg_j = smoke_mixtral(JAX_BACKEND, kernel_mode="xla")(jax_get_config)
    cfg_t = smoke_mixtral("cuda_kernel")(torch_get_config)
    jeng = JEngine(cfg_j, max_len=MAX_LEN, seed=0)
    tree = jax.tree.map(np.asarray, jeng.params)
    teng = TEngine(cfg_t, max_len=MAX_LEN, device="cpu",
                   params=params_from_numpy(tree, cfg_t, "cpu"))
    return jeng, teng


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, PROMPT_LEN).astype(np.int32)
            for _ in range(4)]


def _serve(pkg, Region, Footprint, Server, Request, engine, backend, **kw):
    shell = pkg.Shell([Region(rid=i, n_chips=8, hbm_bytes=8 * GB)
                       for i in range(2)])
    shell.submit("mixtral", [Footprint(GB, 1e9, 4096)], app_id=0)
    shell.post(pkg.Shrink("mixtral", 0))        # starts on the host port
    server = Server(shell, n_slots=4, fabric_backend=backend, **kw)
    server.register_engine(0, engine)
    prompts = _prompts()
    for p in prompts[:2]:
        server.submit(Request(app_id=0, prompt=p, max_new=MAX_NEW))
    for _ in range(3):
        server.step()
    shell.post(pkg.Grow("mixtral"))             # next admissions -> port 1
    for p in prompts[2:]:
        server.submit(Request(app_id=0, prompt=p, max_new=MAX_NEW))
    server.run()
    return server


def test_served_streams_and_traffic_equal(engines):
    jeng, teng = engines
    js = _serve(jshell, JRegion, JFootprint, JServer, JRequest, jeng,
                "pallas")
    ts = _serve(tshell, TRegion, TFootprint, TServer, TRequest, teng,
                "cuda", device="cpu")
    jc = sorted(js.completions, key=lambda c: c.rid)
    tc = sorted(ts.completions, key=lambda c: c.rid)
    assert [(c.tokens, c.entry_port, c.admitted_tick, c.finished_tick)
            for c in jc] == [(c.tokens, c.entry_port, c.admitted_tick,
                              c.finished_tick) for c in tc]
    assert {c.entry_port for c in tc} == {0, 1}   # the Grow re-routed
    assert np.array_equal(js.port_traffic, ts.port_traffic)
    assert (js.offered_packets, js.granted_packets) == (
        ts.offered_packets, ts.granted_packets)


def test_per_step_logits_match(engines):
    jeng, teng = engines
    prompts = np.stack(_prompts()[:2])              # B = 2
    B = prompts.shape[0]
    jstate = jeng.model.init_decode_state(B, MAX_LEN)
    tstate = teng.model.init_decode_state(B, MAX_LEN)
    step = jax.jit(jeng.model.decode_step)
    toks = prompts[:, 0]
    for s in range(PROMPT_LEN + MAX_NEW):
        jl, jstate = step(jeng.params, jstate,
                          {"tokens": jnp.asarray(toks[:, None])})
        tl, tstate = teng.model.decode_step(
            teng.params, tstate, {"tokens": torch.from_numpy(toks[:, None])})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                                   atol=2e-4)
        nxt = np.array(jnp.argmax(jl[:, :512], axis=-1), np.int32)
        toks = prompts[:, s + 1] if s + 1 < PROMPT_LEN else nxt


def test_dense_family_logits_match():
    """The ``dense`` family (TinyLlama smoke, float32, qkv-free GQA) on the
    same converted parameters: per-step logits within 2e-4."""
    from repro.models.lm import build_model as jax_build
    from repro_torch.models.lm import build_model as torch_build
    cfg_j = jax_get_config("tinyllama_1_1b", smoke=True)
    cfg_j = type(cfg_j)(**{**cfg_j.__dict__, "dtype": "float32"})
    cfg_t = torch_get_config("tinyllama_1_1b", smoke=True)
    cfg_t = type(cfg_t)(**{**cfg_t.__dict__, "dtype": "float32"})
    jm, tm = jax_build(cfg_j), torch_build(cfg_t, device="cpu")
    jp = jm.init(jax.random.key(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg_t, "cpu")
    toks = np.array([[5], [17], [300]], np.int32)
    js, ts = jm.init_decode_state(3, 8), tm.init_decode_state(3, 8)
    step = jax.jit(jm.decode_step)
    for _ in range(5):
        jl, js = step(jp, js, {"tokens": jnp.asarray(toks)})
        tl, ts = tm.decode_step(tp, ts, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                                   atol=2e-4)
        toks = np.array(jnp.argmax(jl[:, :cfg_j.vocab], -1),
                        np.int32)[:, None]
