"""The fixed-wave ``ServeLoop`` of the port (``repro_torch.runtime.serve``)
against the JAX package's on the smoke Mixtral (float32): the same
parameters (JAX's init, converted by ``params_from_numpy``), the same
wave of left-padded requests, the same greedy tokens.  The JAX side runs
its MoE on the ``dense`` impl, the port on the crossbar fabric's kernel
backend (``cuda_kernel``, its plain versions on CPU tensors): the grants
are the same, so the tokens are."""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.runtime.serve import Request as JRequest
from repro.runtime.serve import ServeLoop as JServeLoop
from repro_torch.ckpt.convert import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.runtime.serve import (Completion, Request, ServeLoop,
                                       extra_decode_inputs)

from _torch_port import smoke_mixtral

MAX_LEN = 24
PROMPTS = ((5, 7, 11, 13, 17, 19), (2, 3, 4), (400, 1, 300, 2, 200))
MAX_NEW = (6, 4, 5)


def _loops():
    cfg_j = smoke_mixtral("dense")(jax_get_config)
    cfg_t = smoke_mixtral("cuda_kernel")(get_config)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jloop = JServeLoop(cfg_j, batch=4, max_len=MAX_LEN, seed=0)
    tree = jax.tree.map(np.asarray, jloop.params)
    with pytest.warns(DeprecationWarning, match="^DEPRECATED"):
        tloop = ServeLoop(cfg_t, batch=4, max_len=MAX_LEN, device="cpu",
                          params=params_from_numpy(tree, cfg_t, "cpu"))
    return jloop, tloop


def test_serve_loop_tokens_equal_jax():
    jloop, tloop = _loops()
    reqs = [(i, np.asarray(p, np.int32), n)
            for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW))]
    want = jloop.serve([JRequest(app_id=i, prompt=p, max_new=n)
                        for i, p, n in reqs])
    got = tloop.serve([Request(app_id=i, prompt=p, max_new=n)
                       for i, p, n in reqs])
    assert all(isinstance(c, Completion) for c in got)
    assert [c.app_id for c in got] == [c.app_id for c in want]
    assert [c.tokens for c in got] == [[int(t) for t in c.tokens]
                                       for c in want]
    assert [len(c.tokens) for c in got] == list(MAX_NEW)
    assert all(c.prefill_s > 0 and c.decode_s > 0 for c in got)
    # a second wave reuses nothing of the first
    again = tloop.serve([Request(app_id=9, prompt=reqs[0][1], max_new=6)])
    assert again[0].tokens == got[0].tokens


def test_serve_loop_seeded_init_and_defaults():
    cfg = smoke_mixtral("dense")(get_config)
    with pytest.warns(DeprecationWarning, match="^DEPRECATED"):
        a = ServeLoop(cfg, batch=2, max_len=16, seed=3, device="cpu")
    with pytest.warns(DeprecationWarning):
        b = ServeLoop(cfg, batch=2, max_len=16, seed=3, device="cpu")
    assert torch.equal(a.params["embed"], b.params["embed"])
    prompt = np.arange(1, 5, dtype=np.int32)
    out = a.serve([Request(app_id=0, prompt=prompt, max_new=3)])
    assert out[0].tokens == b.serve([Request(app_id=0, prompt=prompt,
                                             max_new=3)])[0].tokens
    assert Request(app_id=1, prompt=prompt).max_new == 16


def test_extra_decode_inputs_default_to_the_card():
    cfg = get_config("whisper_medium", smoke=True)
    got = extra_decode_inputs(cfg, 2, torch.float32, "cpu")
    assert got["frames"].shape == (2, cfg.encoder_len, cfg.d_model)
    assert extra_decode_inputs(get_config("tinyllama_1_1b", smoke=True), 2,
                               torch.float32) == {}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            extra_decode_inputs(cfg, 2, torch.float32)
