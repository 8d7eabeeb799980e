"""The CUDA kernels against their plain versions on the card: the crossbar
kernels, flash attention forward and backward (and the forward at head
dim 256), the gradients of the MoE through the crossbar kernel data plane,
and the recurrent families' SSD and RG-LRU scans.

Imports nothing of JAX, so it runs where only PyTorch and the CUDA toolkit
are installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Every test is marked ``cuda`` and skips where there is no CUDA device
(decided inside the test).  Inputs are seeded registers with isolation
holes and quotas, ``dst = -1`` padding and out-of-range ports; slots come
from the plan, so (dst, slot) is unique as on the served path.  The row
kernels take float32 and bfloat16 rows of a multiple of 16 bytes.

Flash attention is held against autograd through ``ref.attention_ref``
with the JAX package's forward tolerances (2e-5 in float32, 3e-2 in
bfloat16); the backward within 1e-4 in float32 (the same arithmetic
summed in another order) and 5e-2 in bfloat16 (the kernel takes
``rowsum(dO * O)`` from the bfloat16 output, and its gradients are
rounded to bfloat16), both absolute and relative.  Elementwise limits that
loose would pass a wrong mask in bfloat16, so the output and each
gradient are also held within a relative L2 distance (1e-5 in float32,
1e-2 in bfloat16) and the float32 row log-sum-exp within 2e-5 (float32
inputs) or 1e-3 (bfloat16 inputs) absolute, as ``chip_smoke.py`` holds
them.

The SSD kernel is held to the plain chunked version within 2e-4 (float32:
the same algebra summed in another order) and to the sequential oracle
within 5e-4 (the JAX package's tolerance for its kernel), absolute and
relative; in bfloat16 within 5e-2 and a relative L2 distance of 1e-2.  The
RG-LRU kernel sums in the sequential order, so it is held to the oracle
within 1e-5 and to the doubling scan within 5e-5.  A backward through any
of the three forward-only kernels raises and launches no plain version.
"""

import numpy as np
import pytest
import torch

from repro_torch.fabric.backends import CudaBackend, ReferenceBackend
from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels.crossbar_dispatch import kernel as K
from repro_torch.kernels.crossbar_dispatch import ref
from repro_torch.core.registers import CrossbarRegisters
from repro_torch.kernels.crossbar_dispatch import crossbar_plan
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.hamming import kernel as HK
from repro_torch.kernels.hamming import ops as hamming_ops
from repro_torch.kernels.hamming import ref as href


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _inputs(T, S, seed):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, S, T).astype(np.int32)
    dst[rng.random(T) < 0.1] = -1
    dst[rng.random(T) < 0.02] = S
    src = rng.integers(0, S, T).astype(np.int32)
    allowed = rng.random((S, S)) > 0.2
    quota = np.where(rng.random((S, S)) > 0.5,
                     rng.integers(1, 40, (S, S)), 0).astype(np.int32)
    cu = lambda a: torch.from_numpy(a).cuda()
    regs = CrossbarRegisters.create(S, capacity=64, device="cuda").write(
        allowed=cu(allowed), quota=cu(quota))
    return cu(dst), cu(src), regs


@pytest.mark.cuda
@pytest.mark.parametrize("T,S", [(1, 2), (255, 4), (3000, 8), (20000, 16),
                                 (300000, 8)])
def test_plan_multi_bit_equal_on_card(T, S):
    _card()
    dst, src, regs = _inputs(T, S, seed=T + S)
    allowed = regs.allowed.to(torch.int32)
    quota_sd = regs.quota.T                     # strided view, as served
    pk = K.plan_multi(dst, src, allowed, quota_sd, mode=KernelMode.CUDA)
    pr = ref.plan_multi_ref(dst, src, allowed, quota_sd)
    assert all(torch.equal(a, b) for a, b in zip(pk, pr))
    plan_k = CudaBackend(kernel_mode=KernelMode.CUDA).plan(dst, src, regs)
    plan_r = ReferenceBackend().plan(dst, src, regs)
    for f in ("keep", "slot", "dst", "error", "counts", "drops"):
        assert torch.equal(getattr(plan_k, f), getattr(plan_r, f)), f


def _row_inputs(T, S, C, D, dtype, seed):
    dst, src, regs = _inputs(T, S, seed=seed)
    plan = ReferenceBackend().plan(dst, src, regs)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((T, D), generator=gen, device="cuda").to(dtype)
    y = torch.randn((S, C, D), generator=gen, device="cuda").to(dtype)
    w = torch.rand((T,), generator=gen, device="cuda")
    return x, y, w, dst, plan.keep.to(torch.int32), plan.slot


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 4096])
def test_scatter_and_combine_bit_equal_on_card(dtype, D):
    _card()
    T, S, C = 3000, 8, 128
    x, y, w, dst, keep, slot = _row_inputs(T, S, C, D, dtype, seed=D)
    assert torch.equal(K.scatter(x, dst, keep, slot, n_ports=S, capacity=C),
                       ref.scatter_ref(x, dst, keep, slot, S, C))
    assert torch.equal(K.combine(y, dst, keep, slot, w),
                       ref.combine_ref(y, dst, keep, slot, w))


@pytest.mark.cuda
def test_rows_at_an_odd_offset_bit_equal_on_card():
    """A contiguous view whose storage starts off a 16-byte boundary is
    copied to aligned storage before the vector kernels read it."""
    _card()
    T, S, C, D = 300, 4, 128, 64
    x, y, w, dst, keep, slot = _row_inputs(T, S, C, D, torch.float32, 5)
    xv = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(T, D)
    yv = torch.cat([y.new_zeros(1), y.flatten()])[1:].view(S, C, D)
    assert xv.is_contiguous() and xv.data_ptr() % 16
    assert yv.is_contiguous() and yv.data_ptr() % 16
    assert torch.equal(K.scatter(xv, dst, keep, slot, n_ports=S, capacity=C),
                       ref.scatter_ref(xv, dst, keep, slot, S, C))
    assert torch.equal(K.combine(yv, dst, keep, slot, w),
                       ref.combine_ref(yv, dst, keep, slot, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [(torch.float16, 256),
                                     (torch.float32, 6),
                                     (torch.bfloat16, 4)])
def test_row_kernels_refuse_what_they_cannot_move_on_card(dtype, D):
    """Only float32/bfloat16 rows of a multiple of 16 bytes launch."""
    _card()
    x, y, w, dst, keep, slot = _row_inputs(64, 4, 32, D, dtype, seed=1)
    before = K.launch_counts()
    with pytest.raises((TypeError, ValueError)):
        K.scatter(x, dst, keep, slot, n_ports=4, capacity=32)
    with pytest.raises((TypeError, ValueError)):
        K.combine(y, dst, keep, slot, w)
    assert K.launch_counts() == before


FLASH_CASES = [   # B, Sq, Sk, H, Kv, D, causal, window, dtype
    (1, 256, 256, 4, 2, 64, True, None, torch.float32),
    (2, 300, 300, 8, 2, 128, True, None, torch.bfloat16),    # ragged
    (1, 128, 512, 8, 2, 128, True, None, torch.bfloat16),    # q_offset
    (1, 512, 512, 4, 1, 64, True, 128, torch.float32),       # window
    (1, 1000, 1000, 4, 2, 128, True, 256, torch.bfloat16),   # window, ragged
    (1, 200, 200, 4, 4, 64, False, None, torch.float32),     # non-causal
]
FWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LSE_ABS = {torch.float32: 2e-5, torch.bfloat16: 1e-3}


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_flash_attention_forward_and_backward_on_card(case):
    _card()
    B, Sq, Sk, H, Kv, D, causal, window, dtype = case
    gen = torch.Generator(device="cuda").manual_seed(Sq + D)
    mk = lambda *shape: torch.randn(shape, generator=gen, device="cuda"
                                    ).to(dtype)
    q, k, v, do = mk(B, Sq, H, D), mk(B, Sk, Kv, D), mk(B, Sk, Kv, D), \
        mk(B, Sq, H, D)
    kw = dict(causal=causal, window=window, q_offset=Sk - Sq)
    before = FK.launch_counts()
    o, lse = FK.flash_fwd(q, k, v, **kw)
    grads = FK.flash_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert FK.launch_counts() == {**before,
                                  "flash_fwd": before["flash_fwd"] + 1,
                                  "flash_bwd": before["flash_bwd"] + 1}
    o_ref, lse_ref = fref.attention_fwd_ref(q, k, v, **kw)
    tol = FWD_TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_ref, atol=tol, rtol=tol)
    assert _rel_l2(o, o_ref) <= REL_L2[dtype]
    torch.testing.assert_close(lse, lse_ref, atol=LSE_ABS[dtype], rtol=0)
    want = fref.attention_bwd_ref(q, k, v, do, **kw)
    tol = BWD_TOL[dtype]
    for name, a, b in zip("qkv", grads, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol,
                                   msg=lambda m: f"d{name}: {m}")
        assert _rel_l2(a, b) <= REL_L2[dtype], name


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype", [(96, torch.float32),
                                     (64, torch.float16)])
def test_flash_kernel_refuses_what_it_cannot_take_on_card(D, dtype):
    _card()
    q = torch.zeros((1, 64, 2, D), dtype=dtype, device="cuda")
    before = FK.launch_counts()
    with pytest.raises((TypeError, ValueError)):
        FK.flash_fwd(q, q, q)
    assert FK.launch_counts() == before


GRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gradients_cross_the_kernel_data_plane_on_card(dtype):
    """The router and expert weights get their gradients through the
    scatter and combine kernels, equal to the plain path on the card
    (float32: within 1e-5 of each leaf's largest value, the weight
    gradient's row dot sums in another order; bfloat16: within 2e-2, the
    plain combine rounds ``w`` to bfloat16 before the product)."""
    _card()
    from repro_torch.models import moe
    from repro_torch.models.config import MoEConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = MoEConfig(n_experts=8, top_k=2, capacity_factor=1.0)
    rng = np.random.default_rng(0)
    d, f, T = 256, 512, 1024
    params = {k: torch.from_numpy(
        (rng.standard_normal(p.shape) / np.sqrt(p.shape[-2])).astype(
            np.float32)).cuda().to(dtype)
        for k, p in moe.moe_defs(d, f, cfg, "swiglu").items()}
    x = torch.from_numpy(rng.standard_normal((1, T, d)).astype(np.float32)
                         ).cuda().to(dtype)
    g = torch.from_numpy(rng.standard_normal((1, T, d)).astype(np.float32)
                         ).cuda().to(dtype)
    K.reset_launch_counts()
    grads = {}
    for mode in ("cuda", "torch"):
        leaves = {k: p.detach().clone().requires_grad_()
                  for k, p in params.items()}
        y, stats = moe.moe_apply_fabric(leaves, x, cfg, "swiglu",
                                        group_size=512,
                                        backend="cuda_kernel",
                                        kernel_mode=mode)
        assert int(stats["dropped"]) > 0
        grads[mode] = dict(zip(leaves, torch.autograd.grad(
            (y.float() * g.float()).sum(), list(leaves.values()),
            allow_unused=True)))
    counts = K.launch_counts()
    assert counts["scatter"] > 0 and counts["combine"] > 0
    for name in params:
        a, b = grads["cuda"][name], grads["torch"][name]
        assert a is not None, f"no gradient reached {name}"
        assert float(a.abs().max()) > 0, name
        tol = GRAD_REL[dtype] * float(b.abs().max())
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=0,
                                   msg=lambda m: f"{name}: {m}")


# ----------------------------------------------------------------------
# SSD, RG-LRU and the flash forward at head dim 256
# ----------------------------------------------------------------------
from repro_torch.kernels.ssd import kernel as SK
from repro_torch.kernels.ssd import ref as sref
from repro_torch.kernels.ssd.ops import ssd_scan
from repro_torch.kernels.rglru import kernel as RK
from repro_torch.kernels.rglru import ref as rref
from repro_torch.kernels.rglru.ops import rglru_scan_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention

SSD_CASES = [                     # B, S, H, P, N, chunk, dtype, with h0
    (1, 1024, 48, 64, 128, 256, torch.float32, False),   # Mamba-2 780M
    (1, 2048, 48, 64, 128, 256, torch.bfloat16, False),
    (2, 512, 4, 64, 128, 256, torch.bfloat16, True),
    (1, 256, 8, 64, 128, 128, torch.float32, True),
    (2, 384, 2, 64, 128, 128, torch.float32, False),     # 3 chunks
    (1, 200, 4, 64, 128, 200, torch.float32, False),     # S below the chunk
    (1, 96, 4, 64, 128, 32, torch.float32, False),       # a chunk below 64
]


def _ssd_inputs(B, S, H, P, N, dtype, with_h0, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = rn(B, H, S, P).to(dtype)
    dt = torch.nn.functional.softplus(rn(B, H, S))
    A = -torch.exp(rn(H) * 0.5)
    dA = dt * A[None, :, None]
    Bm = (rn(B, S, N) * 0.3).to(dtype)
    Cm = (rn(B, S, N) * 0.3).to(dtype)
    h0 = rn(B, H, P, N) * 0.1 if with_h0 else None
    return x, dA, dt, Bm, Cm, h0


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_ssd_kernel_matches_plain_on_card(case):
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, H, P, N, chunk, dtype, with_h0 = case
    x, dA, dt, Bm, Cm, h0 = _ssd_inputs(B, S, H, P, N, dtype, with_h0)
    before = SK.launch_counts()["ssd"]
    y, h = SK.ssd_call(x, dA, dt, Bm, Cm, chunk=chunk, h0=h0,
                       mode=KernelMode.CUDA)
    torch.cuda.synchronize()
    assert SK.launch_counts()["ssd"] == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    yp, hp = sref.ssd_call_ref(x, dA, dt, Bm, Cm, chunk, h0)
    if dtype == torch.float32:
        torch.testing.assert_close(y, yp, atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(h, hp, atol=2e-4, rtol=2e-4)
        if not with_h0 and S <= 1024:
            yo, ho = sref.ssd_ref(x, dA, dt, Bm, Cm)
            torch.testing.assert_close(y, yo, atol=5e-4, rtol=5e-4)
            torch.testing.assert_close(h, ho, atol=5e-4, rtol=5e-4)
    else:
        torch.testing.assert_close(y.float(), yp.float(), atol=5e-2,
                                   rtol=5e-2)
        assert _rel_l2(y, yp) <= 1e-2
        torch.testing.assert_close(h, hp, atol=5e-4, rtol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["dtype", "chunk", "widths", "bc_dtype"])
def test_ssd_kernel_refuses_what_it_cannot_take_on_card(what):
    _card()
    x, dA, dt, Bm, Cm, _ = _ssd_inputs(1, 256, 2, 64, 128, torch.float32,
                                       False)
    chunk = 256
    if what == "dtype":
        x, Bm, Cm = x.half(), Bm.half(), Cm.half()
    elif what == "chunk":
        chunk = 96                        # 256 % 96 != 0
    elif what == "widths":
        x = x[..., :32].contiguous()      # P = 32 is not instantiated
    else:
        Bm = Bm.bfloat16()
    before = SK.launch_counts()
    with pytest.raises((TypeError, ValueError)):
        SK.ssd_call(x, dA, dt, Bm, Cm, chunk=chunk, mode=KernelMode.CUDA)
    assert SK.launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,L", [(1, 4096, 4096), (2, 1001, 96)])
def test_rglru_kernel_matches_plain_on_card(B, S, L):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(S)
    a = torch.sigmoid(torch.randn((B, S, L), generator=gen,
                                  device="cuda")) * 0.98 + 0.01
    b = torch.randn((B, S, L), generator=gen, device="cuda") * 0.5
    before = RK.launch_counts()["rglru"]
    h, hl = RK.rglru_call(a, b, mode=KernelMode.CUDA)
    torch.cuda.synchronize()
    assert RK.launch_counts()["rglru"] == before + 1
    ho, hlo = rref.rglru_ref(a, b)
    torch.testing.assert_close(h, ho, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(hl, hlo, atol=1e-5, rtol=1e-5)
    Q = 1001 if S == 1001 else 2048
    hp, hlp = rref.rglru_call_ref(a, b, chunk=Q)
    torch.testing.assert_close(h, hp, atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(hl, hlp, atol=5e-5, rtol=5e-5)


@pytest.mark.cuda
def test_rglru_kernel_refuses_what_it_cannot_take_on_card():
    _card()
    a = torch.rand((1, 64, 32), device="cuda")
    before = RK.launch_counts()
    with pytest.raises(TypeError):
        RK.rglru_call(a.bfloat16(), a.bfloat16(), mode=KernelMode.CUDA)
    with pytest.raises(ValueError):
        RK.rglru_call(a, a[:, :32], mode=KernelMode.CUDA)
    assert RK.launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_at_head_dim_256_on_card(dtype):
    """RecurrentGemma's local attention: MQA, 16 heads, head dim 256, a
    sliding window; causal, ragged, the forward only."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(256)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)
    q, k, v = mk(1, 1000, 16, 256), mk(1, 1000, 1, 256), mk(1, 1000, 1, 256)
    kw = dict(causal=True, window=256, q_offset=0)
    before = FK.launch_counts()
    o, lse = FK.flash_fwd(q, k, v, mode=KernelMode.CUDA, **kw)
    torch.cuda.synchronize()
    assert FK.launch_counts() == {
        **before, "flash_fwd_d256": before["flash_fwd_d256"] + 1}
    o_ref, lse_ref = fref.attention_fwd_ref(q, k, v, **kw)
    tol = FWD_TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    assert _rel_l2(o, o_ref) <= REL_L2[dtype]
    torch.testing.assert_close(lse, lse_ref, atol=LSE_ABS[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["ssd", "rglru", "flash_d256"])
def test_backward_through_a_forward_only_kernel_raises_on_card(kernel):
    """The forward launches the kernel; the backward raises, and nothing
    falls back to the plain version (no plain backward runs, no kernel
    launches)."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    if kernel == "ssd":
        x = rn(1, 256, 2, 64).requires_grad_()
        out, _ = ssd_scan(x, torch.rand((1, 256, 2), device="cuda"),
                          -torch.ones(2, device="cuda"), rn(1, 256, 128),
                          rn(1, 256, 128), chunk=256)
        err = NotImplementedError
    elif kernel == "rglru":
        u = rn(1, 256, 64).requires_grad_()
        out, _ = rglru_scan_kernel(u, torch.rand((1, 256, 64),
                                                 device="cuda"))
        err = NotImplementedError
    else:
        q = rn(1, 128, 2, 256).requires_grad_()
        kv = rn(1, 128, 1, 256)
        out = flash_attention(q, kv, kv, window=64)
        err = ValueError
    counts = {**SK.launch_counts(), **RK.launch_counts(),
              **FK.launch_counts()}
    with pytest.raises(err, match="ROADMAP B8"):
        out.sum().backward()
    assert {**SK.launch_counts(), **RK.launch_counts(),
            **FK.launch_counts()} == counts


# ----------------------------------------------------------------------
# the paper's use-case modules and the single-source plan
# ----------------------------------------------------------------------
HAMMING_LENGTHS = [0, 1, 3, 4, 5, 1023, 2**20 + 1]
MUL_CONSTANTS = [3, 7, 2654435761, 2**32 - 1, -1, -3]


def _card_words(n, seed, bits=32):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lo = -(1 << 31) if bits == 32 else 0
    return torch.randint(lo, lo + (1 << bits), (n,), generator=gen,
                         device="cuda", dtype=torch.int64).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("n", HAMMING_LENGTHS)
def test_hamming_kernels_bit_equal_on_card(n):
    _card()
    x = _card_words(n, n)
    before = HK.launch_counts()
    enc = HK.hamming_encode(x, mode=KernelMode.CUDA)
    dec, corr = HK.hamming_decode(x, mode=KernelMode.CUDA)
    mul = HK.mul_const(x, 3, mode=KernelMode.CUDA)
    torch.cuda.synchronize()
    assert torch.equal(enc, href.encode_ref(x))
    d_ref, c_ref = href.decode_ref(x)
    assert torch.equal(dec, d_ref) and torch.equal(corr, c_ref)
    assert torch.equal(mul, href.multiply_ref(x, 3))
    launched = int(n > 0)                       # an empty stream launches nothing
    assert HK.launch_counts() == {k: v + launched for k, v in before.items()}


@pytest.mark.cuda
def test_hamming_decode_corrects_every_position_on_card():
    """Bit p flipped in block p of a stream of codewords, p = 0..31 (bit 31
    lies outside the codeword), and seeded double-bit errors."""
    _card()
    n_per = 4096
    data = _card_words(32 * n_per, 31, bits=26)
    code = HK.hamming_encode(data, mode=KernelMode.CUDA)
    pos = torch.arange(32, device="cuda").repeat_interleave(n_per)
    flip = torch.bitwise_left_shift(torch.ones_like(pos), pos).to(torch.int64)
    bad = code ^ torch.where(flip >= 1 << 31, flip - (1 << 32), flip).to(
        torch.int32)
    dec, corr = HK.hamming_decode(bad, mode=KernelMode.CUDA)
    assert torch.equal(dec, data)
    assert torch.equal(corr, (pos < 31).to(torch.int32))
    d_ref, c_ref = href.decode_ref(bad)
    assert torch.equal(dec, d_ref) and torch.equal(corr, c_ref)
    gen = torch.Generator(device="cuda").manual_seed(32)
    p1 = torch.randint(0, 31, code.shape, generator=gen, device="cuda")
    p2 = (p1 + torch.randint(1, 31, code.shape, generator=gen,
                             device="cuda")) % 31
    double = code ^ ((1 << p1) | (1 << p2)).to(torch.int32)
    dec, corr = HK.hamming_decode(double, mode=KernelMode.CUDA)
    d_ref, c_ref = href.decode_ref(double)
    assert torch.equal(dec, d_ref) and torch.equal(corr, c_ref)
    assert bool((dec != data).any())                      # miscorrected


@pytest.mark.cuda
@pytest.mark.parametrize("constant", MUL_CONSTANTS)
def test_mul_const_bit_equal_on_card(constant):
    _card()
    x = _card_words(2**20 + 3, 40)
    assert torch.equal(HK.mul_const(x, constant, mode=KernelMode.CUDA),
                       href.multiply_ref(x, constant))


@pytest.mark.cuda
def test_hamming_stream_at_an_odd_offset_on_card():
    """A word stream whose storage starts off a 16-byte boundary is copied
    to aligned storage before the 16-byte kernels read it; the uint32 ops
    give uint32 words."""
    _card()
    base = _card_words(4099, 41)
    x = base[1:]
    assert x.data_ptr() % 16
    assert torch.equal(HK.hamming_encode(x), href.encode_ref(x))
    out = hamming_ops.multiply_const(x.view(torch.uint32), 3)
    assert out.dtype == torch.uint32 and out.device.type == "cuda"
    assert torch.equal(out.view(torch.int32), href.multiply_ref(x, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("T,S", [(0, 4), (1, 2), (300, 8), (1024, 16),
                                 (70000, 16), (4096, 64), (300000, 4),
                                 (70000, 2048), (70000, K.PLAN_MAX_PORTS)])
def test_plan_bit_equal_on_card(T, S):
    """One source's plan, with ``dst = -1`` padding and ``dst`` = S, S + 3
    and -S - 1 among the packets, isolation holes, quotas and capacities.
    T = 300000 scans more token blocks than one prefix block holds; from
    S = 2048 on, the rank pass needs more than 48 KB of shared memory."""
    _card()
    rng = np.random.default_rng(T + S)
    dst = rng.integers(0, S, T).astype(np.int32)
    bad = rng.random(T) < 0.15
    dst[bad] = rng.choice(np.array([-1, S, S + 3, -S - 1], np.int32),
                          bad.sum())
    allowed = (rng.random(S) > 0.2).astype(np.int32)
    quota = np.where(rng.random(S) > 0.5, rng.integers(1, 40, S),
                     0).astype(np.int32)
    cap = rng.integers(1, 64, S).astype(np.int32)
    cu = [torch.from_numpy(a).cuda() for a in (dst, allowed, quota, cap)]
    before = K.launch_counts()["plan"]
    pk = crossbar_plan(*cu, mode=KernelMode.CUDA)
    pr = ref.plan_ref(*cu)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(pk, pr))
    assert K.launch_counts()["plan"] == before + int(T > 0)
    if T > 100:                                 # drops and grants both occur
        assert int((pk[2] == 1).sum()) > 0 and int(pk[0].sum()) > 0
