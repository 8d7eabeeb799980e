"""The crossbar CUDA kernels against their plain versions on the card.

Imports nothing of JAX, so it runs where only PyTorch and the CUDA toolkit
are installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Every test is marked ``cuda`` and skips where there is no CUDA device
(decided inside the test).  Inputs are seeded registers with isolation
holes and quotas, ``dst = -1`` padding and out-of-range ports; slots come
from the plan, so (dst, slot) is unique as on the served path.  The row
kernels take float32 and bfloat16 rows of a multiple of 16 bytes.
"""
import numpy as np
import pytest
import torch

from repro_torch.fabric.backends import CudaBackend, ReferenceBackend
from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels.crossbar_dispatch import kernel as K
from repro_torch.kernels.crossbar_dispatch import ref
from repro_torch.core.registers import CrossbarRegisters


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
@pytest.mark.parametrize("T,S", [(1, 2), (255, 4), (3000, 8), (20000, 16)])
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
