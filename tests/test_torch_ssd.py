"""The port's SSD scan against the JAX package's, on the CPU.

The port's ``ssd_scan`` (whose CPU path is the kernel's plain version),
``ssd_chunked`` and ``ssd_ref`` against JAX's ``ssd_scan`` (its Pallas
kernel run with ``interpret=True``, as ``tests/test_kernels.py`` runs it),
``ssd_chunked`` and ``ssd_ref``, at that file's three shape cases and at a
sequence shorter than the chunk.  Inputs are seeded numpy arrays handed to
both.

Tolerances, absolute and relative: float32 5e-4 against the sequential
oracle (the JAX package's own for its kernel; the chunked algebra sums in
another order than the recurrence) and 2e-4 against the chunked path
(``test_kernels.py``'s); bfloat16 5e-2 (x, B and C rounded to bfloat16,
y rounded once).  The final state is held within 5e-4 in every case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd.ops import ssd_scan
from repro_torch.kernels.ssd.ref import ssd_ref
from repro_torch.models.ssm import ssd_chunked

CASES = [                      # B, S, H, P, N, chunk
    (2, 512, 4, 64, 128, 256),
    (1, 256, 8, 64, 64, 128),
    (2, 384, 2, 32, 128, 128),
    (1, 200, 4, 32, 64, 256),  # S below the chunk: one chunk of 200
]
ORACLE_TOL = {"float32": 5e-4, "bfloat16": 5e-2}
CHUNKED_TOL = 2e-4
STATE_TOL = 5e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(case, seed=0):
    B, S, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t,
                      np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_ssd_scan_matches_jax_kernel_and_oracle(case, dtype):
    x, dt, A, Bm, Cm = _inputs(case)
    jd, td = DTYPES[dtype]
    chunk = case[-1]
    jx, jB, jC = (jnp.asarray(a, jd) for a in (x, Bm, Cm))
    y_j, h_j = jax_ssd_scan(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                            chunk=chunk, interpret=True)
    dA = np.moveaxis(dt, 2, 1) * A[None, :, None]
    yr_j, hr_j = jax_ssd_ref(jnp.moveaxis(jx, 2, 1), jnp.asarray(dA),
                             jnp.asarray(np.moveaxis(dt, 2, 1)), jB, jC)
    tx, tB, tC = (torch.from_numpy(a).to(td) for a in (x, Bm, Cm))
    y_t, h_t = ssd_scan(tx, torch.from_numpy(dt), torch.from_numpy(A), tB,
                        tC, chunk=chunk)
    assert y_t.dtype == td and h_t.dtype == torch.float32
    assert tuple(y_t.shape) == x.shape
    tol = ORACLE_TOL[dtype]
    _close(y_t, jnp.moveaxis(yr_j, 1, 2), tol)          # the oracle
    _close(y_t, y_j, tol)                               # JAX's kernel
    _close(h_t, hr_j, STATE_TOL)
    _close(h_t, h_j, STATE_TOL)
    # the port's own oracle is JAX's, step for step
    yr_t, hr_t = ssd_ref(tx.transpose(1, 2), torch.from_numpy(dA),
                         torch.from_numpy(np.moveaxis(dt, 2, 1)), tB, tC)
    _close(yr_t, yr_j, 1e-5 if dtype == "float32" else tol)
    _close(hr_t, hr_j, 1e-5)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_ssd_chunked_matches_jax_chunked(case):
    x, dt, A, Bm, Cm = _inputs(case, seed=1)
    chunk = case[-1]
    rng = np.random.default_rng(2)
    h0 = rng.standard_normal((case[0], case[2], case[3], case[4])).astype(
        np.float32) * 0.1
    for init in (None, h0):
        y_j, h_j = jax_ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                   chunk, None if init is None
                                   else jnp.asarray(init))
        t_in = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
        t_h0 = None if init is None else torch.from_numpy(init)
        y_t, h_t = ssd_chunked(*t_in, chunk, t_h0)
        _close(y_t, y_j, CHUNKED_TOL)
        _close(h_t, h_j, CHUNKED_TOL)
        # the kernel's entry point takes the same initial state
        y_s, h_s = ssd_scan(*t_in, chunk=chunk, h0=t_h0)
        _close(y_s, y_j, CHUNKED_TOL)
        _close(h_s, h_j, CHUNKED_TOL)


def test_ssd_scan_refuses_a_chunk_that_does_not_divide_the_sequence():
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _inputs((1, 300, 2, 32, 64, 256)))
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=256)


def test_ssd_scan_cuda_mode_refuses_cpu_tensors():
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _inputs((1, 64, 2, 32, 64, 64)))
    before = K.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=64, mode=KernelMode.CUDA)
    with pytest.raises(ValueError, match="CUDA"):
        K.ssd_call(x.transpose(1, 2), dt.transpose(1, 2), dt.transpose(1, 2),
                   Bm, Cm, chunk=64, mode="pallas")
    assert K.launch_counts() == before


def test_ssd_scan_is_differentiable_on_the_cpu():
    """On CPU tensors the plain path carries autograd: its gradients equal
    those of ``ssd_chunked`` (the same algebra)."""
    x, dt, A, Bm, Cm = _inputs((1, 128, 2, 32, 64, 64), seed=3)
    grads = []
    for fn in (lambda *a: ssd_scan(*a, chunk=64),
               lambda *a: ssd_chunked(*a, 64)):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (x, dt, Bm)]
        y, h = fn(leaves[0], leaves[1], torch.from_numpy(A), leaves[2],
                  torch.from_numpy(Cm))
        grads.append(torch.autograd.grad(y.square().sum() + h.sum(), leaves))
    for a, b in zip(*grads):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b)
