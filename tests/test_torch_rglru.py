"""The port's RG-LRU scan against the JAX package's, on the CPU.

The port's ``rglru_scan`` (the model's plain path: a doubling scan within
chunks of 2048 and a carried state) and ``rglru_scan_kernel`` (whose CPU
path is the kernel's plain version), with and without an initial state,
against JAX's ``rglru_scan``, ``rglru_scan_kernel`` (its Pallas kernel run
with ``interpret=True``, as ``tests/test_kernels.py`` runs it) and the
sequential oracle ``rglru_ref``.  Also the recurrent block
``rglru_block_apply`` on converted parameters.  Inputs are seeded numpy
arrays handed to both.

Tolerance: float32 5e-5, absolute and relative (the JAX package's own for
its kernel): the scans sum the same products in other orders.  Shapes are
those of ``test_kernels.py``, plus one sequence longer than the model's
chunk, so that the carry across chunks is exercised.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru.ops import rglru_scan_kernel as jax_scan_kernel
from repro.kernels.rglru.ref import rglru_ref as jax_rglru_ref
from repro.models import rglru as jax_rglru
from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels.rglru import kernel as K
from repro_torch.kernels.rglru.ops import rglru_scan_kernel
from repro_torch.kernels.rglru.ref import (rglru_bwd_ref, rglru_bwd_tiled_ref,
                                         rglru_ref, rglru_tiled_ref)
from repro_torch.models import rglru as torch_rglru

CASES = [                      # B, S, L, JAX kernel chunk, block_l
    (2, 512, 512, 256, 256),
    (1, 256, 1024, 128, 512),
    (3, 384, 256, 128, 256),
    (1, 4096, 64, 256, 64),    # two chunks of the model's 2048
]
TOL = 5e-5


def _inputs(case, seed=0):
    B, S, L = case[:3]
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal((B, S, L)))) * 0.98
         + 0.01).astype(np.float32)
    u = (rng.standard_normal((B, S, L)) * 0.5).astype(np.float32)
    h0 = (rng.standard_normal((B, L)) * 0.3).astype(np.float32)
    return a, u, h0


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_rglru_scans_match_jax_scans_and_oracle(case, with_h0):
    a, u, h0 = _inputs(case)
    _, _, _, chunk, block_l = case
    h0 = h0 if with_h0 else None
    ja, ju = jnp.asarray(a), jnp.asarray(u)
    jh0 = None if h0 is None else jnp.asarray(h0)
    hr, hlr = jax_rglru_ref(ja, ju, jh0)
    hk, hlk = jax_scan_kernel(ju, ja, jh0, chunk=chunk, block_l=block_l,
                              interpret=True)
    hm, hlm = jax_rglru.rglru_scan(ju, ja, jh0)
    ta, tu = torch.from_numpy(a), torch.from_numpy(u)
    th0 = None if h0 is None else torch.from_numpy(h0)
    ports = {"rglru_scan": torch_rglru.rglru_scan(tu, ta, th0),
             "rglru_scan_kernel": rglru_scan_kernel(tu, ta, th0),
             "rglru_ref": rglru_ref(ta, tu, th0)}
    for name, (h, hl) in ports.items():
        assert h.dtype == torch.float32 and tuple(h.shape) == a.shape, name
        for want, want_last in ((hr, hlr), (hk, hlk), (hm, hlm)):
            _close(h, want)
            _close(hl, want_last)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("L", [1, 33, 96])
@pytest.mark.parametrize("S", [1, 7, 64, 1001])
def test_rglru_tile_composition_matches_jax(S, L, with_h0):
    """The CUDA kernel's order of summation (``rglru_tiled_ref``: tiles
    reduced to affine maps and composed tile by tile, ``h0`` folded into
    the first step) against JAX's kernel in interpret mode and the
    sequential oracle, within 1e-5: ragged S and L, one tile and many, at
    several tile sizes, since the algebra holds for any."""
    a, u, h0 = _inputs((1, S, L), seed=S + L)
    h0 = h0 if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    hk, hlk = jax_scan_kernel(jnp.asarray(u), jnp.asarray(a), jh0, chunk=S,
                              block_l=L, interpret=True)
    ta, tu = torch.from_numpy(a), torch.from_numpy(u)
    th0 = None if h0 is None else torch.from_numpy(h0)
    ho, hlo = rglru_ref(ta, tu, th0)
    for steps in (5, 16, 64):
        h, hl = rglru_tiled_ref(ta, tu, th0, steps=steps)
        for want, want_last in ((hk, hlk), (ho, hlo)):
            _close(h, want, 1e-5)
            _close(hl, want_last, 1e-5)


def test_rglru_scan_kernel_keeps_the_input_dtype():
    a, u, h0 = _inputs((1, 64, 32, 64, 32))
    tu = torch.from_numpy(u).to(torch.bfloat16)
    h, hl = rglru_scan_kernel(tu, torch.from_numpy(a), torch.from_numpy(h0))
    assert h.dtype == torch.bfloat16 and hl.dtype == torch.float32
    hj, hlj = jax_scan_kernel(jnp.asarray(tu.float().numpy(), jnp.bfloat16),
                              jnp.asarray(a), jnp.asarray(h0), chunk=64,
                              block_l=32, interpret=True)
    _close(h.float(), np.asarray(hj, np.float32), 1e-2)
    _close(hl, hlj)


@pytest.mark.parametrize("decode", [False, True])
def test_rglru_block_matches_jax(decode):
    """The Griffin recurrent block on the same parameters: full sequence
    (the scan) and one decode step (the O(1) update)."""
    d, lru, S = 64, 64, 1 if decode else 96
    rng = np.random.default_rng(4)
    defs = jax_rglru.rglru_defs(d, lru)
    params = {k: (rng.standard_normal(v.shape) * 0.2).astype(np.float32)
              for k, v in defs.items()}
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    h0 = rng.standard_normal((2, lru)).astype(np.float32) if decode else None
    tail = (rng.standard_normal((2, 3, lru)).astype(np.float32) if decode
            else None)
    conv = lambda t, f: None if t is None else f(t)
    yj, hj, tj = jax_rglru.rglru_block_apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        conv(h0, jnp.asarray), conv(tail, jnp.asarray), decode=decode)
    yt, ht, tt = torch_rglru.rglru_block_apply(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), conv(h0, torch.from_numpy),
        conv(tail, torch.from_numpy), decode=decode)
    scale = float(np.abs(np.asarray(yj)).max())
    _close(yt.numpy() / scale, np.asarray(yj) / scale, 1e-5)
    _close(ht, hj, 1e-5)
    if decode:
        _close(tt, tj, 0.0)


def test_rglru_cuda_mode_refuses_cpu_tensors():
    a, u, _ = _inputs((1, 64, 32, 64, 32))
    ta, tu = torch.from_numpy(a), torch.from_numpy(u)
    before = K.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan_kernel(tu, ta, mode=KernelMode.CUDA)
    with pytest.raises(ValueError, match="CUDA"):
        K.rglru_call(ta, tu, mode="pallas")
    assert K.launch_counts() == before


# ----------------------------------------------------------------------
# the backward: ``rglru_bwd_ref`` (the plain version of the backward
# kernel) and the gradients of ``rglru_scan_kernel`` (its autograd
# Function) against ``jax.vjp`` of JAX's ``rglru_scan``, with an initial
# state and a cotangent of h_last.  float32, within 5e-5 (TOL): the doubling
# scans of both packages, summed in other orders.
# ----------------------------------------------------------------------
GRAD_CASES = [(2, 64, 32), (1, 100, 48), (1, 4096, 16)]   # B, S, L


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("path", ["rglru_bwd_ref", "rglru_scan_kernel"])
@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_rglru_backward_matches_jax_vjp(case, path, with_h0):
    a, u, h0 = _inputs(case, seed=sum(case))
    rng = np.random.default_rng(9)
    dh = rng.standard_normal(a.shape).astype(np.float32)
    dh_last = rng.standard_normal(h0.shape).astype(np.float32)
    h0 = h0 if with_h0 else None
    if h0 is None:
        fn = lambda uu, aa: jax_rglru.rglru_scan(uu, aa, None)  # noqa: E731
        args = (jnp.asarray(u), jnp.asarray(a))
    else:
        fn = jax_rglru.rglru_scan
        args = (jnp.asarray(u), jnp.asarray(a), jnp.asarray(h0))
    _, vjp = jax.vjp(fn, *args)
    want = vjp((jnp.asarray(dh), jnp.asarray(dh_last)))
    tu, ta = torch.from_numpy(u), torch.from_numpy(a)
    th0 = None if h0 is None else torch.from_numpy(h0)
    tdh, tdl = torch.from_numpy(dh), torch.from_numpy(dh_last)
    if path == "rglru_bwd_ref":
        du, da, dh0 = K.rglru_scan_bwd(tu, ta, th0, tdh, tdl)
        assert (dh0 is None) == (h0 is None)
        got = (du, da) if h0 is None else (du, da, dh0)
    else:
        leaves = [t.requires_grad_() for t in (tu, ta, th0) if t is not None]
        h, h_last = rglru_scan_kernel(tu, ta, th0)
        got = torch.autograd.grad((h, h_last), leaves, (tdh, tdl))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g.detach(), w)


def test_rglru_backward_keeps_the_types():
    """bf16 u: du in bf16, da and dh0 in float32, as the kernel writes
    them; the plain forward saves no carries (the kernel's alone)."""
    a, u, h0 = _inputs((1, 64, 32))
    ta, th0 = torch.from_numpy(a), torch.from_numpy(h0)
    tu = torch.from_numpy(u).bfloat16()
    h, h_last, carries = K.rglru_scan(tu, ta, th0, save_carries=True)
    assert carries is None and h.dtype == torch.bfloat16
    du, da, dh0 = K.rglru_scan_bwd(tu, ta, th0, h, h_last)
    assert (du.dtype, da.dtype, dh0.dtype) == (torch.bfloat16, torch.float32,
                                               torch.float32)


@pytest.mark.parametrize("S", [1, 15, 16, 17, 100, 128, 255, 256, 257, 511,
                               512, 513, 1000, 4095, 4096, 4097, 32768])
def test_rglru_backward_chunks_start_at_tile_edges(S):
    """The backward's chunks, from the last: contiguous, covering [0, S),
    each starting at a multiple of ``BWD_CHUNK_TILES`` tiles, only the one
    at the end of the sequence shorter."""
    chunks = K.bwd_chunks(S)
    step = K.BWD_CHUNK_TILES * K.TILE_STEPS
    assert chunks[0][1] == S and chunks[-1][0] == 0
    assert all(b[1] == a[0] for a, b in zip(chunks, chunks[1:]))
    assert all(lo % step == 0 and lo % K.TILE_STEPS == 0 for lo, _ in chunks)
    assert all(hi - lo == step for lo, hi in chunks[1:])
    assert 0 < chunks[0][1] - chunks[0][0] <= step


@pytest.mark.parametrize("with_dh_last", [False, True])
@pytest.mark.parametrize("B,S,L", [(1, 1, 3), (2, 100, 33), (1, 1000, 8),
                                   (1, 2048, 4)])
def test_rglru_backward_chunked_chain_equals_tile_by_tile(B, S, L,
                                                          with_dh_last):
    """The float32 CPU mirror of the backward's gradient scan cut into
    chunks, as the kernel's blocks take it, equals the tile-by-tile walk
    bit for bit for every chunk size, and the gradient of the plain
    backward (``rglru_bwd_ref``'s du in float32) within 1e-5."""
    a, _, _ = _inputs((B, S, L), seed=5)
    rng = np.random.default_rng(6)
    dh = torch.from_numpy(rng.standard_normal((B, S, L)).astype(np.float32))
    dhl = (torch.from_numpy(rng.standard_normal((B, L)).astype(np.float32))
           if with_dh_last else None)
    a = torch.from_numpy(a)
    tiled = rglru_bwd_tiled_ref(a, dh, dhl, steps=K.TILE_STEPS)
    for chunk_tiles in (1, 3, 8, K.BWD_CHUNK_TILES, 32):
        got = rglru_bwd_tiled_ref(a, dh, dhl, steps=K.TILE_STEPS,
                                  chunk_tiles=chunk_tiles)
        assert torch.equal(got, tiled), chunk_tiles
    du, _, _ = rglru_bwd_ref(dh, a, None, dh, dhl)
    _close(tiled, du.float(), tol=1e-5)
