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

``ssd_passes`` mirrors the CUDA kernel's forward on its tensor-core route
(``csrc/ssd.cu``: each chunk's own state, the carry across chunks, then
the outputs of each group of heads tile by tile, C.B^T formed once for the
group) in plain PyTorch, float64, with and without an emulation of the
kernel's bf16 hi + lo operands, so its algebra is held against JAX's
kernel and oracle here; nothing on the card runs it.
``ssd_bwd_passes`` does the same for the backward's tensor-core passes
(bf16 at Mamba-2 780M's widths), with and without an emulation of the
kernel's bf16 hi + lo operands, against ``jax.vjp`` of JAX's
``ssd_chunked`` and the port's ``ssd_bwd_ref``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.kernel import ssd_call as jax_ssd_call
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


TILE = 64     # rows of a chunk tile in csrc/ssd.cu


def _split(v, bf16):
    """An operand formed in float32 as the tensor cores take it: hi + lo,
    each a bf16 value (with ``bf16``), else as it is."""
    if not bf16:
        return v
    v32 = v.float()
    hi = v32.bfloat16().float()
    return hi.double() + (v32 - hi).bfloat16().double()


def ssd_passes(x, dA, dt, Bm, Cm, chunk, h0=None, *, bf16=False,
               group=K.FWD_HEAD_GROUP):
    """The forward's passes on head-major inputs (x [B, H, S, P]; dA, dt
    [B, H, S]; Bm, Cm [B, S, N]; h0 [B, H, P, N] or None), in float64, as
    the tensor-core route runs them: returns (y [B, H, S, P], h_last [B, H,
    P, N]).  2: each chunk's own state, (x w)^T B; 3: the carry across
    chunks, each chunk's incoming state h_in; 4: for each group of
    ``group`` heads and 64-row tile I, each head's carried state exp(cum_i)
    C_I . h_in^T, then for each tile J <= I the block's C_I . B_J^T, formed
    once for the group, and each head's G = CB exp(cum_i - cum_j) dt_j on
    j <= i times x_J.  With ``bf16`` every operand the kernel forms in
    float32 (x w, h_in, G) is rounded to float32 and split into hi + lo
    bf16 values (``_split``); x, B and C are taken as they are.  Without
    it, this is also the FMA route's algebra (C.B^T per chunk in its pass
    1 holds the same values)."""
    Bsz, H, S, P = x.shape
    N, Q = Bm.shape[-1], chunk
    nc, nI = S // Q, -(-Q // TILE)
    sp = lambda v: _split(v, bf16)                       # noqa: E731
    x, dA, dt, Bm, Cm = (t.double() for t in (x, dA, dt, Bm, Cm))
    cum = dA.reshape(Bsz, H, nc, Q).cumsum(-1)
    dtc = dt.reshape(Bsz, H, nc, Q)
    xc = x.reshape(Bsz, H, nc, Q, P)
    Cc, Bc = (t.reshape(Bsz, nc, Q, N) for t in (Cm, Bm))
    # 2. each chunk's own state, sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T
    w = torch.exp(cum[..., -1:] - cum) * dtc
    states = torch.einsum("bhcjp,bcjn->bhcpn", sp(xc * w[..., None]), Bc)
    # 3. the carry across chunks: each chunk's incoming state, and h_last
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float64) if h0 is None
         else h0.double())
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(cum[:, :, c, -1])[..., None, None] * h + states[:, :, c]
    h_in = sp(torch.stack(h_in, dim=2))
    # 4. the outputs of each (group, 64-row tile I): the carried state, then
    # G x_J with C_I . B_J^T formed once for the group
    y = torch.empty((Bsz, H, nc, Q, P), dtype=torch.float64)
    for I in range(nI):
        r = slice(I * TILE, min((I + 1) * TILE, Q))
        i = torch.arange(Q)[r]
        for g0 in range(0, H, group):
            hs = slice(g0, min(g0 + group, H))
            acc = torch.exp(cum[:, hs, :, r])[..., None] * torch.einsum(
                "bcin,bhcpn->bhcip", Cc[:, :, r], h_in[:, hs])
            for J in range(I + 1):
                cols = slice(J * TILE, min((J + 1) * TILE, Q))
                cb = Cc[:, :, r] @ Bc[:, :, cols].transpose(-1, -2)
                live = torch.arange(Q)[cols][None, :] <= i[:, None]
                li = cum[:, hs, :, r, None] - cum[:, hs, :, None, cols]
                # masked before exp: above the diagonal li > 0 may overflow
                decay = torch.where(live, torch.exp(torch.where(live, li,
                                                                0.0)), 0.0)
                G = sp(cb[:, None] * decay * dtc[:, hs, :, None, cols])
                acc = acc + G @ xc[:, hs, :, cols]
            y[:, hs, :, r] = acc
    return y.reshape(Bsz, H, S, P), h


PASS_CASES = [                     # B, S, H, P, N, chunk, with h0
    (1, 512, 2, 64, 128, 256, False),    # Mamba-2 780M's widths, 2 chunks
    (1, 768, 2, 64, 128, 256, True),     # 3 chunks, an initial state
    (1, 200, 2, 64, 128, 200, False),    # a ragged chunk of 200
    (1, 48, 3, 16, 16, 16, True),        # the smoke widths, chunk 16
    (2, 600, 2, 16, 16, 200, False),     # smoke widths, 3 ragged chunks
]


@pytest.mark.parametrize("case", PASS_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_kernel_passes_match_jax_kernel_and_oracle(case):
    """The mirror of the kernel's passes against JAX's Pallas ``ssd_call``
    (interpret) and ``ssd_ref`` without an initial state, JAX's
    ``ssd_chunked`` with one, and the port's plain version always."""
    B, S, H, P, N, chunk, with_h0 = case
    x, dt, A, Bm, Cm = _inputs(case[:6], seed=4)
    xh, dth = np.moveaxis(x, 2, 1), np.moveaxis(dt, 2, 1)
    dA = dth * A[None, :, None]
    h0 = (np.random.default_rng(5).standard_normal((B, H, P, N)) * 0.1
          ).astype(np.float32) if with_h0 else None
    t = lambda a: None if a is None else torch.from_numpy(
        np.ascontiguousarray(a))
    y, h = ssd_passes(t(xh), t(dA), t(dth), t(Bm), t(Cm), chunk, t(h0))
    yp, hp = K.ref.ssd_call_ref(t(xh), t(dA), t(dth), t(Bm), t(Cm), chunk,
                                t(h0))
    _close(y, yp, CHUNKED_TOL)
    _close(h, hp, CHUNKED_TOL)
    if with_h0:
        y_j, h_j = jax_ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                   chunk, jnp.asarray(h0))
        _close(y, jnp.moveaxis(y_j, 2, 1), CHUNKED_TOL)
        _close(h, h_j, CHUNKED_TOL)
        return
    y_k, h_k = jax_ssd_call(*map(jnp.asarray, (xh, dA, dth, Bm, Cm)),
                            chunk=chunk, interpret=True)
    _close(y, y_k, CHUNKED_TOL)
    _close(h, h_k, CHUNKED_TOL)
    y_o, h_o = jax_ssd_ref(*map(jnp.asarray, (xh, dA, dth, Bm, Cm)))
    _close(y, y_o, ORACLE_TOL["float32"])
    _close(h, h_o, STATE_TOL)


@pytest.mark.parametrize("case", PASS_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_kernel_passes_with_bf16_splits_match_jax_kernel_and_oracle(case):
    """The mirror with the tensor-core route's hi + lo operands (x w, h_in
    and G split into two bf16 values each) on inputs that are bf16 values:
    within the float32 tolerances of JAX's Pallas ``ssd_call`` (interpret)
    and ``ssd_ref`` without an initial state, JAX's ``ssd_chunked`` with
    one, and the port's plain version always.  Each split carries its
    operand to about 2^-17 of itself, far inside those limits."""
    B, S, H, P, N, chunk, with_h0 = case
    x, dt, A, Bm, Cm = _inputs(case[:6], seed=6)
    x, Bm, Cm = (_bf16_values(a) for a in (x, Bm, Cm))
    xh, dth = np.moveaxis(x, 2, 1), np.moveaxis(dt, 2, 1)
    dA = dth * A[None, :, None]
    h0 = (np.random.default_rng(7).standard_normal((B, H, P, N)) * 0.1
          ).astype(np.float32) if with_h0 else None
    t = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a))
    y, h = ssd_passes(t(xh), t(dA), t(dth), t(Bm), t(Cm), chunk, t(h0),
                      bf16=True)
    yp, hp = K.ref.ssd_call_ref(t(xh), t(dA), t(dth), t(Bm), t(Cm), chunk,
                                t(h0))
    _close(y, yp, CHUNKED_TOL)
    _close(h, hp, CHUNKED_TOL)
    if with_h0:
        y_j, h_j = jax_ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                   chunk, jnp.asarray(h0))
        _close(y, jnp.moveaxis(y_j, 2, 1), CHUNKED_TOL)
        _close(h, h_j, CHUNKED_TOL)
        return
    y_k, h_k = jax_ssd_call(*map(jnp.asarray, (xh, dA, dth, Bm, Cm)),
                            chunk=chunk, interpret=True)
    _close(y, y_k, CHUNKED_TOL)
    _close(h, h_k, CHUNKED_TOL)
    y_o, h_o = jax_ssd_ref(*map(jnp.asarray, (xh, dA, dth, Bm, Cm)))
    _close(y, y_o, ORACLE_TOL["float32"])
    _close(h, h_o, STATE_TOL)


@pytest.mark.parametrize("group", [1, 2, 3])
def test_forward_passes_give_one_output_whatever_the_head_group(group):
    """The mirror with head groups of 1, 2 and 3 heads at 5 heads (a last
    group cut short) against JAX's Pallas ``ssd_call`` (interpret) and the
    port's plain version, and bit for bit against one head a group: a
    block's C.B^T is shared by its heads, and nothing else crosses them."""
    case = (1, 384, 5, 64, 128, 128)
    x, dt, A, Bm, Cm = _inputs(case, seed=8)
    xh, dth = np.moveaxis(x, 2, 1), np.moveaxis(dt, 2, 1)
    dA = dth * A[None, :, None]
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (xh, dA, dth, Bm, Cm)]
    y, h = ssd_passes(*args, 128, group=group)
    y1, h1 = ssd_passes(*args, 128, group=1)
    assert torch.equal(y, y1) and torch.equal(h, h1)
    yp, hp = K.ref.ssd_call_ref(*args, 128)
    _close(y, yp, CHUNKED_TOL)
    _close(h, hp, CHUNKED_TOL)
    y_k, h_k = jax_ssd_call(*map(jnp.asarray, (xh, dA, dth, Bm, Cm)),
                            chunk=128, interpret=True)
    _close(y, y_k, CHUNKED_TOL)
    _close(h, h_k, CHUNKED_TOL)


def test_forward_head_group_agrees_with_the_kernel_source():
    """The wrapper's forward head group is the one the kernel's source
    names, and it leaves a last group cut short at 5 heads."""
    import re
    src = K.SOURCES[0].read_text()
    found = re.findall(r"constexpr int FWD_HEAD_GROUP = (\d+);", src)
    assert found == [str(K.FWD_HEAD_GROUP)]
    assert 5 % K.FWD_HEAD_GROUP


@pytest.mark.parametrize("smoke", [False, True])
def test_the_ssm_configs_widths_have_a_kernel(smoke):
    """Mamba-2's (head dim, state) and chunk, full and smoke, are widths the
    SSD kernel is built for."""
    from repro_torch.configs import get_config
    ssm = get_config("mamba2_780m", smoke).ssm
    assert (ssm.head_dim, ssm.d_state) in K.WIDTHS
    assert 0 < ssm.chunk <= K.MAX_CHUNK


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


# ----------------------------------------------------------------------
# the backward: ``ssd_bwd_ref`` (the plain version of the backward kernel,
# explicit formulas) and the gradients of ``ssd_scan`` (its autograd
# Function, whose CPU backward is ``ssd_bwd_ref``) against ``jax.vjp`` of
# JAX's ``ssd_chunked``.  float32; each gradient within GRAD_REL of its
# largest value: the same sums in other orders.  Against a float64 run of
# the same formulas, the port's gradients and JAX's both lie within 7.5e-6
# of their largest value (and within 6.3e-6 of each other), but for A's:
# a sum over every position and batch row with cancellation, which both
# packages miss by up to 3.2e-5 (2.9e-5 apart), so it is held within 1e-4.
# ----------------------------------------------------------------------
GRAD_REL = 2e-5
SUM_REL = 1e-4      # dA: summed over batch and sequence
GRAD_CASES = [                  # B, S, H, P, N, chunk
    (1, 512, 3, 64, 128, 256),  # Mamba-2 780M's widths, two chunks
    (2, 200, 2, 64, 128, 256),  # S below the chunk: one chunk of 200
    (1, 64, 3, 16, 16, 16),     # the smoke widths, four chunks
    (2, 48, 2, 16, 16, 16),     # smoke widths, three chunks, B = 2
]


def _grad_inputs(case, with_h0, seed=3):
    B, S, H, P, N, _ = case
    x, dt, A, Bm, Cm = _inputs(case, seed)
    rng = np.random.default_rng(seed + 1)
    h0 = (rng.standard_normal((B, H, P, N)) * 0.3).astype(np.float32) \
        if with_h0 else None
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dh_last = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return (x, dt, A, Bm, Cm, h0), (dy, dh_last)


def _jax_vjp(ins, cots, chunk):
    x, dt, A, Bm, Cm, h0 = ins
    args = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    if h0 is None:
        fn = lambda *a: jax_ssd_chunked(*a, chunk)   # noqa: E731
    else:
        fn = lambda *a: jax_ssd_chunked(*a[:5], chunk, a[5])  # noqa: E731
        args.append(jnp.asarray(h0))
    _, vjp = jax.vjp(fn, *args)
    return vjp(tuple(jnp.asarray(c) for c in cots))


def _close_scaled(got, want, what, tol=None):
    """Within ``tol`` of the largest value; by default GRAD_REL, SUM_REL for
    dA."""
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    if tol is None:
        tol = SUM_REL if what == "dA" else GRAD_REL
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("path", ["ssd_bwd_ref", "ssd_scan"])
@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_ssd_backward_matches_jax_vjp(case, path, with_h0):
    """dx, dt, A, B, C and h0 for cotangents of y and h_last, from the
    plain backward (composed by hand from its d(dA) and d(dt) as autograd
    composes it through dA = dt A) and through ``ssd_scan``'s autograd
    Function, against JAX's."""
    ins, cots = _grad_inputs(case, with_h0)
    chunk = case[-1]
    want = _jax_vjp(ins, cots, chunk)
    x, dt, A, Bm, Cm, h0 = (None if a is None else torch.from_numpy(a)
                            for a in ins)
    dy, dh_last = (torch.from_numpy(c) for c in cots)
    Q = min(chunk, case[1])
    if path == "ssd_bwd_ref":
        dth = dt.transpose(1, 2)
        dx, ddA, ddt, dB, dC, dh0 = K.ssd_call_bwd(
            x.transpose(1, 2), dth * A[None, :, None], dth, Bm, Cm,
            dy.transpose(1, 2), chunk=Q, h0=h0, dh_last=dh_last)
        got = [dx.transpose(1, 2), (ddt + ddA * A[None, :, None]
                                    ).transpose(1, 2),
               (ddA * dth).sum((0, 2)), dB, dC] + ([dh0] if with_h0 else [])
        assert (dh0 is None) == (not with_h0)
    else:
        leaves = [t.requires_grad_() for t in (x, dt, A, Bm, Cm, h0)
                  if t is not None]
        y, h_last = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
        got = torch.autograd.grad((y, h_last), leaves, (dy, dh_last))
    names = ["dx", "ddt", "dA", "dB", "dC", "dh0"]
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        _close_scaled(g, w, name)


def test_ssd_backward_plain_version_keeps_the_types():
    """bf16 x, B and C: dx, dB and dC come back in bf16, d(dA), d(dt) and
    dh0 in float32; the plain version is deterministic."""
    case = GRAD_CASES[2]
    ins, cots = _grad_inputs(case, True)
    x, dt, A, Bm, Cm, h0 = (torch.from_numpy(a) for a in ins)
    bf = lambda t: t.transpose(1, 2).to(torch.bfloat16)  # noqa: E731
    dth = dt.transpose(1, 2)
    args = (bf(x), dth * A[None, :, None], dth, Bm.bfloat16(), Cm.bfloat16(),
            bf(torch.from_numpy(cots[0])))
    out = K.ssd_call_bwd(*args, chunk=16, h0=h0,
                         dh_last=torch.from_numpy(cots[1]))
    assert [t.dtype for t in out] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.float32]
    again = K.ssd_call_bwd(*args, chunk=16, h0=h0,
                           dh_last=torch.from_numpy(cots[1]))
    assert all(torch.equal(a, b) for a, b in zip(out, again))


# ----------------------------------------------------------------------
# the backward's passes: ``ssd_bwd_passes`` mirrors the tensor-core route
# of the backward in ``csrc/ssd.cu`` (bf16 at Mamba-2 780M's widths) in
# plain PyTorch, float64, so its algebra is held against ``jax.vjp`` of
# JAX's ``ssd_chunked`` and against ``ssd_bwd_ref`` here; nothing on the
# card runs it.  With ``bf16=True`` it feeds every operand the kernel forms
# in float32 to its products as the kernel does, rounded to float32 and
# split into hi + lo bf16 values (``split_bf16``), and takes x, dy, B and C
# as the bf16 values they are; the outputs are left unrounded (the kernel
# rounds dx, dB and dC once, as the plain version does).
# ----------------------------------------------------------------------
def ssd_bwd_passes(x, dA, dt, Bm, Cm, dy, chunk, h0=None, dh_last=None, *,
                   bf16=False, group=K.HEAD_GROUP, sub=K.FWD_HEAD_GROUP):
    """The tensor-core backward's passes on head-major inputs (as
    ``ssd_bwd_ref`` takes them), in float64: returns (dx, ddA, ddt, dB, dC,
    dh0).  1: the chunk states and the dual states through the forward's
    state form (the latter with dy for x, C for B, w = exp(cum)); 2-3: the
    carry, h_in as hi + lo planes, and g carried backward, g as hi + lo
    planes; then for each 64-row tile, with no C.B^T scratch: 4: dx, ddt,
    colsum and m2 of the rows t, B_t . C_J^T formed once for
    a tile J >= t, colsum = sum_s T (x_t . dy_s) dt_t from T before its
    split; for each group of ``group`` heads, ``sub`` at a time into one
    partial: 5: dB of the rows t, each head's x_t^T g scaled, then the
    tiles s >= t in turn, the sub-group's D^T summed over its heads (in
    order) before one product with C; 6: dC and rowsum + m1 of the rows s,
    each head's dy_s^T h_in, then the tiles t <= s in turn, C_s . B_J^T,
    each head's D times B in order; 7: ddA's scans; 8: the groups' dB and
    dC summed in order."""
    Bsz, H, S, P = x.shape
    N, Q = Bm.shape[-1], chunk
    nc, nI = S // Q, -(-Q // TILE)
    QP = nI * TILE
    sp = lambda v: _split(v, bf16)                       # noqa: E731
    x, dA, dt, Bm, Cm, dy = (t.double() for t in (x, dA, dt, Bm, Cm, dy))
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, QP - Q))  # noqa
    xc, dyc = (pad(t.reshape(Bsz, H, nc, Q, P)) for t in (x, dy))
    Bc, Cc = (pad(t.reshape(Bsz, nc, Q, N)) for t in (Bm, Cm))
    cum = dA.reshape(Bsz, H, nc, Q).cumsum(-1)
    dtc = dt.reshape(Bsz, H, nc, Q)
    cum_p = torch.nn.functional.pad(cum, (0, QP - Q))
    dt_p = torch.nn.functional.pad(dtc, (0, QP - Q))
    pos = torch.arange(QP)
    valid = pos < Q
    e_end = torch.where(valid, torch.exp(cum[..., -1:] - cum_p), 0.0)
    e_cum = torch.where(valid, torch.exp(cum_p), 0.0)

    def state_form(v, w, W):
        """The state pass: sum_j (v_j w_j)^T W_j of each (head, chunk), v w
        as hi + lo, W as it is."""
        return torch.einsum("bhcjp,bcjn->bhcpn",
                            sp(v.reshape(Bsz, H, nc, Q, -1) * w[..., None]),
                            W.reshape(Bsz, nc, Q, N))

    # 1. the chunk states and the dual states (one launch)
    states = state_form(x, torch.exp(cum[..., -1:] - cum) * dtc, Bm)
    sdy = state_form(dy, torch.exp(cum), Cm)
    # 2. the carry
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float64) if h0 is None
         else h0.double())
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(cum[:, :, c, -1])[..., None, None] * h + states[:, :, c]
    h_in = sp(torch.stack(h_in, dim=2))
    # 3. g carried backward
    g = (torch.zeros((Bsz, H, P, N), dtype=torch.float64) if dh_last is None
         else dh_last.double())
    g_end = [None] * nc
    for c in reversed(range(nc)):
        g_end[c] = g
        g = torch.exp(cum[:, :, c, -1])[..., None, None] * g + sdy[:, :, c]
    dh0, g_end = g, sp(torch.stack(g_end, dim=2))

    tile = lambda i: slice(i * TILE, (i + 1) * TILE)     # noqa: E731

    def decay(h, rows, cols, upper):
        """exp(cum_s - cum_t) of head(s) ``h`` on the tile's live pairs
        (s >= t, both in the chunk), masked before exp; rows t and columns
        s when ``upper``, else rows s and columns t."""
        r, q = pos[rows], pos[cols]
        if upper:
            live = (q[None, :] >= r[:, None]) & (q[None, :] < Q)
            li = cum_p[:, h, :, None, cols] - cum_p[:, h, :, rows, None]
        else:
            live = (q[None, :] <= r[:, None]) & (r[:, None] < Q)
            li = cum_p[:, h, :, rows, None] - cum_p[:, h, :, None, cols]
        return torch.where(live, torch.exp(torch.where(live, li, 0.0)), 0.0)

    dx = torch.zeros((Bsz, H, nc, QP, P), dtype=torch.float64)
    ddt, m2, colsum, rowm1 = (torch.zeros((Bsz, H, nc, QP),
                                          dtype=torch.float64)
                              for _ in range(4))
    groups = [range(h, min(h + group, H)) for h in range(0, H, group)]
    dBp, dCp = (torch.zeros((Bsz, len(groups), nc, QP, N),
                            dtype=torch.float64) for _ in range(2))
    for I in range(nI):
        r = tile(I)
        for gi, hs in enumerate(groups):
            hs_ = slice(hs[0], hs[-1] + 1)
            # 4. dx, ddt, colsum and m2 of the rows t, B_t . C_J^T formed
            # once a tile J >= t (a head's values do not depend on its group)
            z = 0.0
            for J in range(I, nI):
                s = tile(J)
                BC = Bc[:, :, r] @ Cc[:, :, s].transpose(-1, -2)
                T = BC[:, None] * decay(hs_, r, s, True)
                raw = xc[:, hs_, :, r] @ dyc[:, hs_, :, s].transpose(-1, -2)
                colsum[:, hs_, :, r] += dt_p[:, hs_, :, r] * (T * raw).sum(-1)
                z = z + sp(T) @ dyc[:, hs_, :, s]
            xz = (xc[:, hs_, :, r] * z).sum(-1)
            carry = e_end[:, hs_, :, r, None] * torch.einsum(
                "bcin,bhcpn->bhcip", Bc[:, :, r], g_end[:, hs_])
            xc_carry = (xc[:, hs_, :, r] * carry).sum(-1)
            m2[:, hs_, :, r] = dt_p[:, hs_, :, r] * xc_carry
            ddt[:, hs_, :, r] = xz + xc_carry
            dx[:, hs_, :, r] = dt_p[:, hs_, :, r, None] * (z + carry)
            subs = [hs[i:i + sub] for i in range(0, len(hs), sub)]
            # 5. dB of the rows t for the group's heads, a sub-group at a time
            acc = 0.0
            for ss in subs:
                for h in ss:
                    acc = acc + (xc[:, h, :, r] @ g_end[:, h]) * (
                        dt_p[:, h, :, r] * e_end[:, h, :, r])[..., None]
                for J in range(I, nI):
                    s = tile(J)
                    ubar = 0.0
                    for h in ss:
                        raw = xc[:, h, :, r] @ dyc[:, h, :, s].transpose(-1, -2)
                        ubar = ubar + (raw * decay(h, r, s, True)
                                       * dt_p[:, h, :, r, None])
                    acc = acc + sp(ubar) @ Cc[:, :, s]
            dBp[:, gi, :, r] = acc
            # 6. dC and rowsum + m1 of the rows s for the group's heads, a
            # sub-group at a time
            acc = 0.0
            for ss in subs:
                for h in ss:
                    part = e_cum[:, h, :, r, None] * (dyc[:, h, :, r]
                                                      @ h_in[:, h])
                    acc = acc + part
                    rowm1[:, h, :, r] += (part * Cc[:, :, r]).sum(-1)
                for J in range(I + 1):
                    t = tile(J)
                    CB = Cc[:, :, r] @ Bc[:, :, t].transpose(-1, -2)
                    for h in ss:
                        raw = dyc[:, h, :, r] @ xc[:, h, :, t].transpose(-1, -2)
                        d = raw * decay(h, r, t, False) * dt_p[:, h, :, None, t]
                        rowm1[:, h, :, r] += (d * CB).sum(-1)
                        acc = acc + sp(d) @ Bc[:, :, t]
            dCp[:, gi, :, r] = acc
    # 7. ddA: the suffix sums of rowsum + m1 - colsum, the exclusive prefix
    # sums of m2 and m3 = exp(cum_Q) <g, h_in>
    inner = (rowm1 - colsum)[..., :Q]
    suffix = torch.flip(torch.cumsum(torch.flip(inner, (-1,)), -1), (-1,))
    before = torch.cumsum(m2[..., :Q], -1) - m2[..., :Q]
    m3 = torch.exp(cum[..., -1]) * (g_end * h_in).sum((-1, -2))
    ddA = suffix + before + m3[..., None]
    # 8. the groups' partials summed in order
    dB, dC = dBp[:, 0], dCp[:, 0]
    for gi in range(1, len(groups)):
        dB, dC = dB + dBp[:, gi], dC + dCp[:, gi]
    cut = lambda t, w: t[..., :Q, :].reshape(Bsz, S, w)  # noqa: E731
    return (dx[..., :Q, :].reshape(Bsz, H, S, P), ddA.reshape(Bsz, H, S),
            ddt[..., :Q].reshape(Bsz, H, S), cut(dB, N), cut(dC, N), dh0)


# Against JAX's float32 gradients, the bf16 emulation adds the hi + lo
# splits: each operand formed in float32 is carried to about 2^-17 of
# itself (hi to 8 bits, lo to 8 more).  At the cases below the gradients
# then lie within 3.2e-5 of their largest value (within 2e-5 without the
# emulation), so BF16_SPLIT_REL leaves a margin of 3; feeding each of those
# operands rounded once to bf16 instead puts them 1.7e-3 to 2.9e-3 off,
# 17 times the limit or more.
BF16_SPLIT_REL = 1e-4


def _bf16_values(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("bf16", [False, True], ids=["f64", "bf16_split"])
@pytest.mark.parametrize("case", PASS_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_backward_passes_match_jax_vjp_and_plain(case, bf16):
    """The mirror of the backward's passes against ``jax.vjp`` of JAX's
    ``ssd_chunked`` (dx, dt, A, B, C and h0, composed as autograd composes
    them through dA = dt A) and against the port's ``ssd_bwd_ref``; with the
    bf16 emulation, on inputs that are bf16 values."""
    B, S, H, P, N, chunk, with_h0 = case
    ins, cots = _grad_inputs(case[:6], with_h0, seed=7)
    if bf16:
        ins = tuple(_bf16_values(a) if i in (0, 3, 4) else a
                    for i, a in enumerate(ins))
        cots = (_bf16_values(cots[0]), cots[1])
    want = _jax_vjp(ins, cots, chunk)
    x, dt, A, Bm, Cm, h0 = (None if a is None else torch.from_numpy(a)
                            for a in ins)
    dy, dh_last = (torch.from_numpy(c) for c in cots)
    dth = dt.transpose(1, 2)
    args = (x.transpose(1, 2), dth * A[None, :, None], dth, Bm, Cm,
            dy.transpose(1, 2))
    got = ssd_bwd_passes(*args, chunk, h0, dh_last, bf16=bf16)
    plain = K.ref.ssd_bwd_ref(*args, chunk, h0, dh_last)
    names = ["dx", "ddA", "ddt", "dB", "dC", "dh0"]
    tol = BF16_SPLIT_REL if bf16 else None
    for name, g, p in zip(names, got, plain):
        if name == "dh0" and not with_h0:
            continue
        _close_scaled(g, p, name, tol)
    dx, ddA, ddt, dB, dC, dh0 = got
    composed = [dx.transpose(1, 2),
                (ddt + ddA * A[None, :, None]).transpose(1, 2),
                (ddA * dth).sum((0, 2)), dB, dC] + ([dh0] if with_h0 else [])
    for name, g, w in zip(["dx", "ddt", "dA", "dB", "dC", "dh0"], composed,
                          want):
        _close_scaled(g, w, name, tol)



@pytest.mark.parametrize("group", [1, 2, 3])
def test_backward_passes_sum_head_groups_to_one_gradient(group):
    """The mirror with head groups of 1, 2 and 3 (a last group cut short:
    5 heads) against ``ssd_bwd_ref``: the groups' partial dB and dC summed
    in order give the one gradient whatever the group."""
    case = (1, 384, 5, 64, 128, 128)
    ins, cots = _grad_inputs(case, True, seed=9)
    x, dt, A, Bm, Cm, h0 = (torch.from_numpy(a) for a in ins)
    dy, dh_last = (torch.from_numpy(c) for c in cots)
    dth = dt.transpose(1, 2)
    args = (x.transpose(1, 2), dth * A[None, :, None], dth, Bm, Cm,
            dy.transpose(1, 2))
    got = ssd_bwd_passes(*args, 128, h0, dh_last, group=group)
    plain = K.ref.ssd_bwd_ref(*args, 128, h0, dh_last)
    for name, g, p in zip(["dx", "ddA", "ddt", "dB", "dC", "dh0"], got,
                          plain):
        _close_scaled(g, p, name)


@pytest.mark.parametrize("dtype,P,N,route,planes", [
    (torch.bfloat16, 64, 128, "tc", 12),
    (torch.bfloat16, 16, 16, "fma", 48),
    (torch.float32, 64, 128, "fma", 48),
])
def test_backward_route_and_partials(dtype, P, N, route, planes):
    """bf16 at Mamba-2 780M's widths takes the tensor-core passes, which
    leave one partial dB and dC for each group of heads (48 heads: 12);
    float32 and the smoke widths take the FMA passes, one partial a
    head."""
    assert K.route(dtype, P, N) == route
    assert K.bwd_partials(48, dtype, P, N) == planes
    if route == "tc":
        assert K.bwd_partials(6, dtype, P, N) == 2     # a last group of 2


def test_backward_head_group_agrees_with_the_kernel_source():
    """The wrapper sizes the partials by ``HEAD_GROUP``; the kernel's
    source names the same group."""
    import re
    src = K.SOURCES[0].read_text()
    found = re.findall(r"constexpr int HEAD_GROUP = (\d+);", src)
    assert found == [str(K.HEAD_GROUP)]
