"""The CUDA kernels against their plain versions on the card: the crossbar
kernels, flash attention forward and backward (and the forward at head
dim 256), the gradients of the MoE through the crossbar kernel data plane,
the sharded backend's data plane on two gloo ranks sharing the card, and
the recurrent families' SSD and RG-LRU scans.

Imports nothing of JAX, so it runs where only PyTorch and the CUDA toolkit
are installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Every test is marked ``cuda`` and skips where there is no CUDA device
(decided inside the test).  Inputs are seeded registers with isolation
holes and quotas, ``dst = -1`` padding and out-of-range ports; slots come
from the plan, so (dst, slot) is unique as on the served path.  The row
kernels take float32 and bfloat16 rows of a multiple of 16 bytes; they are
held at the edge shapes (one packet, none or every slab row granted, the
two-pass scatter at T = 65536, 16-byte rows, the decode shape), in the
combine's unit-weight form, and counted by ``torch.profiler`` at one
device kernel and no memset per scatter call.  The plans (``plan_multi``,
the fabric's ``plan_fabric`` and ``CudaBackend.plan`` around it, and the
single-source ``plan``) are held bit-equal to their plain versions and to
``ReferenceBackend.plan`` from one packet to 300,000 (several blocks, one
after another on one stream, so the scratch they leave zeroed is used
again), counted at one device kernel and no memset or fill a call up to
``PLAN_BLOCK_T`` packets, and rerouted by a ``Shell.post`` without a
second library load.

One tensor-parallel rank's heads (``parallel.HeadLayout`` on a (2, 2)
mesh) on the flash kernels, forward and backward, are held against the
same heads of the one-rank call.

Flash attention is held against autograd through ``ref.attention_ref``
(bfloat16 on the tensor-core kernels, float32 and the smoke configs' head
dims 8, 12 and 16 on the FMA kernels, each call's route counted; the bf16
forward at head dim 256 on the tensor-core kernel also against the FMA
one), including shapes cut to the tensor-core tiles
(ragged ends, a query tile shorter than one tile, windows narrower than a
tile, one, seven and eight query heads per kv head, non-causal with more
or fewer queries than keys) and rows with no live key,
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
relative; in bfloat16 within 5e-2 and a relative L2 distance of 1e-2; at
Mamba-2 780M's widths and its smoke config's, ragged chunks among them.
Each smoke config of a ported family runs ``prefill`` and ``loss`` (and the
dense and MoE backward) on the kernels against the plain path, within the
limits of ``repro_torch.launch.smoke_widths``.  The
RG-LRU kernel sums sequentially within tiles and composes the tiles in
order, so it is held to the oracle within 1e-5 and to the
doubling scan within 5e-5, at the tile edges too; its model entry (bf16 or
float32 u, an initial state folded in the kernel) is held bit-equal to the
float32 kernel followed by the cast, two calls bit-equal, and a call to
one kernel.  The word-stream kernels are held bit-equal around their
launch's block.  A backward through SSD, RG-LRU or the head-dim-256 flash
attention launches its backward kernel and no plain backward, gives the
same bits twice, and matches the plain backward.  The bf16 flash backward
at head dim 256 (on wgmma) and the RG-LRU backward (in chunks across
blocks) are also held at their edge shapes, and shown not to depend on the
order of their blocks or the size of their chunks.
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


def _inputs(T, S, seed, capacity=64):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, S, T).astype(np.int32)
    dst[rng.random(T) < 0.1] = -1
    dst[rng.random(T) < 0.02] = S
    src = rng.integers(0, S, T).astype(np.int32)
    allowed = rng.random((S, S)) > 0.2
    quota = np.where(rng.random((S, S)) > 0.5,
                     rng.integers(1, 40, (S, S)), 0).astype(np.int32)
    cu = lambda a: torch.from_numpy(a).cuda()
    regs = CrossbarRegisters.create(S, capacity=capacity,
                                    device="cuda").write(
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


def _fabric_registers(S, seed, capacity=64):
    """Registers as ``Fabric._on_device`` hands them over: isolation holes,
    quotas, a reset port and per-port capacities clamped to the slab."""
    rng = np.random.default_rng(seed)
    allowed = rng.random((S, S)) > 0.2
    quota = np.where(rng.random((S, S)) > 0.5,
                     rng.integers(1, 40, (S, S)), 0).astype(np.int32)
    reset = np.zeros(S, bool)
    reset[rng.integers(0, S)] = S > 2
    cap = rng.integers(1, capacity + 1, S).astype(np.int32)
    cu = lambda a: torch.from_numpy(a).cuda()
    return CrossbarRegisters.create(S, capacity=capacity, device="cuda").write(
        allowed=cu(allowed), quota=cu(quota), reset=cu(reset),
        capacity=cu(cap))


PLAN_FABRIC_SHAPES = [(1, 2), (2, 8), (255, 4), (2048, 8), (3000, 8),
                      (20000, 16), (300000, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,S", PLAN_FABRIC_SHAPES)
def test_plan_fabric_bit_equal_on_card(T, S):
    """The fabric's plan entry and ``CudaBackend.plan`` against
    ``ReferenceBackend.plan`` (stable-sort ranks) and ``plan_fabric_ref``,
    every field and its type, with reset ports, quota, capacity drops,
    ``dst = -1`` padding and out-of-range ``dst``; one launch counted."""
    _card()
    dst, src, _ = _inputs(T, S, seed=T + S)
    regs = _fabric_registers(S, seed=T * S)
    args = (dst, src, regs.allowed, regs.reset, regs.quota, regs.capacity)
    before = K.launch_counts()["plan_multi"]
    pk = K.plan_fabric(*args, mode=KernelMode.CUDA)
    pb = CudaBackend(kernel_mode=KernelMode.CUDA).plan(dst, src, regs)
    torch.cuda.synchronize()
    assert K.launch_counts()["plan_multi"] == before + 2
    pr = ReferenceBackend().plan(dst, src, regs)
    pf = ref.plan_fabric_ref(*args)
    for f in ("keep", "slot", "dst", "error", "counts", "drops"):
        for plan in (pk, pb, pf):
            got = getattr(plan, f)
            assert got.dtype == getattr(pr, f).dtype, f
            assert torch.equal(got, getattr(pr, f)), f
    if T >= 2048:                       # every verdict occurs
        assert all(int(n) > 0 for n in pr.drops), pr.drops


def _plan_calls(T, S, seed):
    """The three plan kernels at one shape, as the fabric and the shims
    call them."""
    dst, src, regs = _inputs(T, S, seed=seed)
    allowed = regs.allowed.to(torch.int32)
    one = torch.ones(S, dtype=torch.int32, device="cuda")
    cuda = KernelMode.CUDA
    return {
        "plan_multi": lambda: K.plan_multi(dst, src, allowed, regs.quota.T,
                                           mode=cuda),
        "plan_fabric": lambda: K.plan_fabric(
            dst, src, regs.allowed, regs.reset, regs.quota, regs.capacity,
            mode=cuda),
        "backend_plan": lambda: CudaBackend(kernel_mode=cuda).plan(
            dst, src, regs),
        "plan": lambda: K.plan(dst, one, regs.quota[0], regs.capacity,
                               mode=cuda),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("T,S", [(2, 8), (2048, 8), (K.PLAN_BLOCK_T, 8)])
def test_plans_are_one_kernel_and_no_memset_on_card(T, S):
    """Up to ``PLAN_BLOCK_T`` packets a plan call (``plan_multi``, the
    fabric's entry, ``CudaBackend.plan``, ``plan``) is one device kernel and
    no memset or fill, counted by ``torch.profiler``."""
    _card()
    from repro_torch.kernels.timing import device_profile
    for name, call in _plan_calls(T, S, seed=T).items():
        got = device_profile(call, calls=10, kernel="plan_kernel")
        assert got["kernels"] == 1 and got["memsets"] == 0, (name, got)


@pytest.mark.cuda
def test_plans_over_several_blocks_leave_no_state_on_card():
    """Plans over several blocks, one after another at other sizes on one
    stream, each bit-equal: the scratch every launch leaves zeroed needs no
    memset between calls."""
    _card()
    for T, S in ((20000, 16), (K.PLAN_BLOCK_T + 1, 8), (70000, 4),
                 (20000, 16)):
        dst, src, regs = _inputs(T, S, seed=T)
        allowed = regs.allowed.to(torch.int32)
        for _ in range(2):
            pk = K.plan_multi(dst, src, allowed, regs.quota.T,
                              mode=KernelMode.CUDA)
            pr = ref.plan_multi_ref(dst, src, allowed, regs.quota.T)
            assert all(torch.equal(a, b) for a, b in zip(pk, pr)), (T, S)
            fk = K.plan_fabric(dst, src, regs.allowed, regs.reset,
                               regs.quota, regs.capacity, mode=KernelMode.CUDA)
            fr = ReferenceBackend().plan(dst, src, regs)
            assert all(torch.equal(getattr(fk, f), getattr(fr, f))
                       for f in ("keep", "slot", "error", "counts", "drops"))


@pytest.mark.cuda
def test_shell_post_between_plans_reroutes_without_a_rebuild_on_card():
    """A ``Shell`` fabric on the card plans, a ``Shell.post`` rewrites the
    registers, and the next plan follows the new registers (equal to the
    reference backend's) through the kernels already loaded."""
    _card()
    from repro_torch.kernels import build
    from repro_torch.core.elastic import Region
    from repro_torch.core.module import ModuleFootprint
    from repro_torch.shell import FailRegion, Shell, Submit
    shell = Shell([Region(rid=i, n_chips=8, hbm_bytes=8 << 30)
                   for i in range(3)])
    fp = ModuleFootprint(1 << 30, 1e9, 4096)
    shell.post(Submit("a", (fp, fp), app_id=0))
    fab = shell.fabric(backend="cuda", device="cuda")
    ref_fab = shell.fabric(backend="reference", device="cuda")
    dst = torch.tensor([1, 2, 0, -1, 1], dtype=torch.int32, device="cuda")
    src = torch.tensor([0, 0, 1, 0, 2], dtype=torch.int32, device="cuda")
    K.library()
    loads = build.load_count[K.LIB_NAME]
    before = K.launch_counts()["plan_multi"]
    plans = []
    for step in range(2):
        if step:
            shell.post(FailRegion(0))
        got, want = fab.plan(dst, src), ref_fab.plan(dst, src)
        for f in ("keep", "slot", "error", "counts", "drops"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        plans.append(got)
    assert not torch.equal(plans[0].keep, plans[1].keep)
    assert K.launch_counts()["plan_multi"] == before + 2
    assert build.load_count[K.LIB_NAME] == loads == 1


def _row_inputs(T, S, C, D, dtype, seed, capacity=64):
    dst, src, regs = _inputs(T, S, seed=seed, capacity=capacity)
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


def _granted_everywhere(S, C, D, dtype, seed):
    """T = S * C packets that fill every slab row, in a shuffled order."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    perm = torch.randperm(S * C, generator=gen, device="cuda")
    dst = (perm // C).to(torch.int32)
    slot = (perm % C).to(torch.int32)
    keep = torch.ones_like(dst)
    x = torch.randn((S * C, D), generator=gen, device="cuda").to(dtype)
    y = torch.randn((S, C, D), generator=gen, device="cuda").to(dtype)
    w = torch.rand((S * C,), generator=gen, device="cuda")
    return x, y, w, dst, keep, slot


# name: T, S, C, D, dtype, how keep is made
ROW_CASES = {
    "T1": (1, 4, 8, 64, torch.bfloat16, "plan"),
    "T1_f32": (1, 4, 8, 64, torch.float32, "plan"),
    "none_granted": (500, 8, 64, 256, torch.bfloat16, "none"),
    "every_row_granted": (None, 8, 96, 256, torch.bfloat16, "all"),
    # 32768 slab rows: more than one block's table (kMaxBlockRows = 4096)
    "many_row_blocks": (3000, 16, 2048, 8, torch.float32, "plan"),
    "T8189_D8": (8189, 8, 1280, 8, torch.float32, "plan"),
    "T65536_D8": (65536, 16, 4096, 8, torch.float32, "plan"),
    "server_tick_D4": (4, 3, 8, 4, torch.float32, "plan"),
    "moe_decode": (2, 8, 8, 4096, torch.bfloat16, "plan"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ROW_CASES))
def test_scatter_and_combine_at_edge_shapes_on_card(name):
    """Bit-equal to the plain versions at T = 1, with nothing granted, with
    every slab row granted, with more slab rows than one block takes, at
    T = 8189 and T = 65536 (the two-pass scatter) with 32-byte rows, with
    16-byte rows, and at the served decode shape; the combine's unit-weight
    form equals weights of one."""
    _card()
    T, S, C, D, dtype, how = ROW_CASES[name]
    if how == "all":
        x, y, w, dst, keep, slot = _granted_everywhere(S, C, D, dtype, 3)
        T = S * C
    else:
        x, y, w, dst, keep, slot = _row_inputs(T, S, C, D, dtype, seed=T + C,
                                               capacity=C)
    if how == "none":
        keep = torch.zeros_like(keep)
    before = K.launch_counts()
    slabs = K.scatter(x, dst, keep, slot, n_ports=S, capacity=C)
    want = ref.scatter_ref(x, dst, keep, slot, S, C)
    assert torch.equal(slabs, want)
    if how == "all":
        assert bool((slabs.reshape(S * C, D)[dst * C + slot] == x).all())
    assert torch.equal(K.combine(y, dst, keep, slot, w),
                       ref.combine_ref(y, dst, keep, slot, w))
    ones = torch.ones((T,), dtype=torch.float32, device="cuda")
    unit = K.combine(y, dst, keep, slot, None)
    assert torch.equal(unit, ref.combine_ref(y, dst, keep, slot, ones))
    assert torch.equal(unit, K.combine(y, dst, keep, slot, ones))
    after = K.launch_counts()
    assert after["scatter"] - before["scatter"] == 1
    assert after["combine"] - before["combine"] == 3


ONE_LAUNCH_SHAPES = {"moe_decode": (2, 8, 8), "moe_train": (2048, 8, 320)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(ONE_LAUNCH_SHAPES))
def test_scatter_is_one_kernel_and_no_memset_on_card(shape):
    """One scatter call at the decode and train shapes (D = 4096, bf16) is
    one device kernel and no memset, counted by ``torch.profiler``; so is
    one combine call."""
    _card()
    from torch.profiler import ProfilerActivity, profile
    T, S, C = ONE_LAUNCH_SHAPES[shape]
    x, y, w, dst, keep, slot = _row_inputs(T, S, C, 4096, torch.bfloat16,
                                           seed=T, capacity=C)
    assert all(t.dtype == torch.int32 for t in (dst, keep, slot))
    for kernel, call in (
            ("scan_scatter_kernel",
             lambda: K.scatter(x, dst, keep, slot, n_ports=S, capacity=C)),
            ("gather_kernel", lambda: K.combine(y, dst, keep, slot, w))):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == 1 and kernel in names[0], names


FLASH_CASES = [   # B, Sq, Sk, H, Kv, D, causal, window, dtype
    (1, 256, 256, 4, 2, 64, True, None, torch.float32),
    (2, 300, 300, 8, 2, 128, True, None, torch.bfloat16),    # ragged
    (1, 128, 512, 8, 2, 128, True, None, torch.bfloat16),    # q_offset
    (1, 512, 512, 4, 1, 64, True, 128, torch.float32),       # window
    (1, 1000, 1000, 4, 2, 128, True, 256, torch.bfloat16),   # window, ragged
    (1, 200, 200, 4, 4, 64, False, None, torch.float32),     # non-causal
    # the tensor-core kernels' tiles (forward and dQ 128 queries x 64 keys,
    # dK/dV 128 keys x 32 or 64 queries):
    (1, 512, 512, 4, 2, 64, True, None, torch.bfloat16),     # head dim 64
    (1, 384, 384, 4, 4, 128, True, None, torch.bfloat16),    # G = 1
    (1, 256, 256, 16, 2, 128, True, None, torch.bfloat16),   # G = 8
    (2, 200, 457, 8, 2, 64, True, None, torch.bfloat16),     # ragged, q_offset
    (1, 40, 700, 8, 2, 128, True, None, torch.bfloat16),     # Sq < one tile
    (1, 600, 600, 8, 2, 128, True, 48, torch.bfloat16),      # window < a tile
    (1, 333, 333, 4, 1, 64, False, 48, torch.bfloat16),      # window, non-causal
    # the smoke configs' head dims on the FMA kernels, a tile 16 wide:
    (1, 256, 256, 8, 2, 8, True, 32, torch.bfloat16),        # GQA, window
    (2, 300, 300, 8, 2, 12, True, 64, torch.float32),        # ragged, window
    (1, 256, 256, 8, 2, 12, True, 32, torch.bfloat16),
    (1, 200, 457, 6, 2, 16, True, None, torch.bfloat16),     # q_offset
    (1, 333, 333, 4, 4, 16, False, 48, torch.float32),       # non-causal
    (1, 128, 128, 4, 2, 8, True, None, torch.float32),
    # the encoder-decoder's non-causal calls (Whisper: 1500 frames, 16 heads
    # of 64; q_offset 0 where Sq > Sk) and LLaVA-NeXT's GQA group of 7:
    (1, 448, 1500, 16, 16, 64, False, None, torch.bfloat16),  # cross
    (1, 1500, 1500, 16, 16, 64, False, None, torch.bfloat16),  # encoder
    (1, 1500, 448, 16, 16, 64, False, None, torch.bfloat16),  # Sq > Sk
    (1, 300, 300, 56, 8, 128, True, None, torch.bfloat16),    # G = 7
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
    kw = dict(causal=causal, window=window, q_offset=max(Sk - Sq, 0))
    before = FK.launch_counts()
    o, lse = FK.flash_fwd(q, k, v, **kw)
    grads = FK.flash_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    _assert_one_launch_each(before, FK.route(dtype, D))
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
@pytest.mark.parametrize("arch,m", [("tinyllama_1_1b", 0),
                                    ("tinyllama_1_1b", 1),
                                    ("mixtral_8x7b", 1)])
def test_flash_on_one_tensor_parallel_rank_heads_on_card(arch, m):
    """One model rank's attention shard of a (2, 2) mesh
    (``parallel.HeadLayout``: TinyLlama's 16 of 32 q heads and 2 of 4 kv
    heads at D=64, Mixtral's 16 and 4 at D=128) on the ``tc`` kernels,
    forward and backward, against the same heads sliced from the one-rank
    call, within the flash limits."""
    _card()
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.parallel import ShardCtx
    cfg = get_config(arch)
    lay = ShardCtx.described(make_smoke_mesh(2, 2), (0, m)).heads(cfg)
    H, Kv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    assert (lay.n_q, lay.n_kv, lay.kv_src) == (H // 2, Kv // 2, "local")
    B, S, dtype = 2, 512, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(S + D + m)
    mk = lambda *shape: torch.randn(shape, generator=gen, device="cuda"
                                    ).to(dtype)
    q, k, v, do = mk(B, S, H, D), mk(B, S, Kv, D), mk(B, S, Kv, D), \
        mk(B, S, H, D)
    kw = dict(causal=True, window=cfg.attn_window, q_offset=0)
    qs = slice(m * lay.n_q, (m + 1) * lay.n_q)
    ks = slice(lay.kv0, lay.kv0 + lay.n_kv)
    o, lse = FK.flash_fwd(q, k, v, **kw)
    grads = FK.flash_bwd(q, k, v, o, lse, do, **kw)
    local = [t[:, :, sl].contiguous() for t, sl in
             ((q, qs), (k, ks), (v, ks), (do, qs))]
    before = FK.launch_counts()
    o_l, lse_l = FK.flash_fwd(*local[:3], **kw)
    grads_l = FK.flash_bwd(*local[:3], o_l, lse_l, local[3], **kw)
    torch.cuda.synchronize()
    _assert_one_launch_each(before, "tc")
    tol = FWD_TOL[dtype]
    torch.testing.assert_close(o_l.float(), o[:, :, qs].float(), atol=tol,
                               rtol=tol)
    assert _rel_l2(o_l, o[:, :, qs]) <= REL_L2[dtype]
    tol = BWD_TOL[dtype]
    for name, a, b in zip("qkv", grads_l, (grads[0][:, :, qs],
                                           grads[1][:, :, ks],
                                           grads[2][:, :, ks])):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol,
                                   msg=lambda msg: f"d{name}: {msg}")
        assert _rel_l2(a, b) <= REL_L2[dtype], name


def _assert_one_launch_each(before, route):
    """One forward and one backward launched since ``before``, both on
    ``route`` (``FK.route``: bfloat16 at head dims 64 and 128 on the
    tensor-core kernels, the rest on the FMA ones)."""
    keys = ("flash_fwd", "flash_bwd", f"flash_fwd_{route}",
            f"flash_bwd_{route}")
    assert FK.launch_counts() == {**before,
                                  **{k: before[k] + 1 for k in keys}}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_rows_with_no_live_key_on_card(dtype, causal):
    """Query rows past the keys' reach (q_offset + a window of 48): rows
    whose keys are all masked get o == 0 and lse == -inf, as the TPU kernel
    gives them; the other rows, and every gradient, equal the plain version
    run on the live rows alone (the plain version spreads a dead row's
    softmax evenly over its masked keys, and the dead rows' o is constant
    zero, so they add nothing to any gradient)."""
    _card()
    B, Sq, Sk, H, Kv, D, W, qo = 1, 96, 64, 4, 2, 128, 48, 40
    gen = torch.Generator(device="cuda").manual_seed(96)
    mk = lambda *shape: torch.randn(shape, generator=gen, device="cuda"
                                    ).to(dtype)
    q, k, v, do = mk(B, Sq, H, D), mk(B, Sk, Kv, D), mk(B, Sk, Kv, D), \
        mk(B, Sq, H, D)
    kw = dict(causal=causal, window=W, q_offset=qo)
    before = FK.launch_counts()
    o, lse = FK.flash_fwd(q, k, v, **kw)
    dq, dk, dv = FK.flash_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    _assert_one_launch_each(before, "tc" if dtype == torch.bfloat16
                            else "fma")
    n = Sk - 1 + W - qo                  # rows [n, Sq) see no key
    assert 0 < n < Sq
    assert bool((lse[:, :, n:] == -torch.inf).all())
    assert bool((o[:, n:] == 0).all()) and bool((dq[:, n:] == 0).all())
    o_ref, lse_ref = fref.attention_fwd_ref(q[:, :n], k, v, **kw)
    tol = FWD_TOL[dtype]
    torch.testing.assert_close(o[:, :n].float(), o_ref.float(), atol=tol,
                               rtol=tol)
    assert _rel_l2(o[:, :n], o_ref) <= REL_L2[dtype]
    torch.testing.assert_close(lse[:, :, :n], lse_ref, atol=LSE_ABS[dtype],
                               rtol=0)
    want = fref.attention_bwd_ref(q[:, :n], k, v, do[:, :n], **kw)
    tol = BWD_TOL[dtype]
    for name, a, b in zip("qkv", (dq[:, :n], dk, dv), want):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol,
                                   msg=lambda m: f"d{name}: {m}")
        assert _rel_l2(a, b) <= REL_L2[dtype], name


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_flash_tensor_core_backward_is_deterministic_on_card(D):
    """dQ has its own kernel instead of atomics, so two backward runs on
    the same inputs give the same bits."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(D)
    mk = lambda *shape: torch.randn(shape, generator=gen, device="cuda"
                                    ).bfloat16()
    q, k, v, do = mk(1, 1024, 8, D), mk(1, 1024, 2, D), mk(1, 1024, 2, D), \
        mk(1, 1024, 8, D)
    o, lse = FK.flash_fwd(q, k, v)
    first = FK.flash_bwd(q, k, v, o, lse, do)
    second = FK.flash_bwd(q, k, v, o, lse, do)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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


@pytest.mark.cuda
def test_sharded_data_plane_on_the_kernels_on_card(tmp_path):
    """Two gloo ranks on one card: the sharded backend's dispatch and
    combine, forward and backward, through the scatter and combine
    kernels, bit-equal in bfloat16 to the plain versions on the same ranks
    and inputs (pure row moves, and one product rounded once); the weight
    gradient in the weights' type, as the JAX package's."""
    _card()
    from _torch_sharded_worker import spawn
    K.library()                     # built here; the ranks only load it
    rng = np.random.default_rng(7)
    n, S, T, D, cap = 2, 4, 300, 64, 64
    dst = rng.integers(0, S, n * T).astype(np.int32)
    dst[rng.random(n * T) < 0.1] = -1
    regs = {"dest": np.arange(S, dtype=np.int32),
            "allowed": rng.random((S, S)) > 0.2,
            "quota": np.where(rng.random((S, S)) > 0.5,
                              rng.integers(20, 200, (S, S)), 0
                              ).astype(np.int32),
            "capacity": rng.integers(cap // 2, cap + 1, S).astype(np.int32),
            "reset": np.zeros(S, bool), "error": np.zeros(S, np.int32),
            "version": np.int32(0)}
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    payload = {"regs": regs, "cap": cap, "dst": dst, "dtype": "bfloat16",
               "x": f(n * T, D), "w": f(n * T), "ct": f(n * T, D),
               "scale": f(S, cap, D)}
    res = spawn("card_data_plane", n, tmp_path, payload, device="cuda:0")
    for r, got in enumerate(res):
        assert all(got["equal"]), (r, got["equal"])
        assert got["d_w_dtype"] == "torch.bfloat16"     # the weights' type
        assert got["launches"]["scatter"] > 0, (r, got["launches"])
        assert got["launches"]["combine"] > 0, (r, got["launches"])


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
    (1, 1000, 4, 64, 128, 200, torch.bfloat16, True),    # ragged chunks
    (1, 200, 4, 64, 128, 200, torch.bfloat16, False),    # S below the chunk
    (1, 32768, 48, 64, 128, 256, torch.bfloat16, False), # the prefill's S
    (1, 256, 4, 16, 16, 16, torch.float32, True),        # smoke widths
    (2, 96, 3, 16, 16, 16, torch.bfloat16, False),
    (1, 600, 3, 16, 16, 200, torch.bfloat16, True),      # smoke, ragged
    (1, 600, 3, 16, 16, 200, torch.float32, False),
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


# (B, tiles, steps, L): S = tiles x the kernel's tile steps + steps
RGLRU_EDGES = [(1, 0, 1, 32), (3, 1, -1, 33), (2, 1, 1, 1), (1, 5, 3, 4096),
               (1, 0, 32768, 64)]


def _rglru_inputs(B, S, L, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    a = torch.sigmoid(rn(B, S, L)) * 0.98 + 0.01
    return a, rn(B, S, L) * 0.5, rn(B, L) * 0.3


@pytest.mark.cuda
@pytest.mark.parametrize("B,tiles,steps,L", RGLRU_EDGES)
def test_rglru_kernel_at_tile_edges_on_card(B, tiles, steps, L):
    """Ragged tiles and channel groups: one step, one step short of and past
    a tile, one channel, 33 channels, and a long sequence at the smoke
    width; both entries against the oracle and the doubling scan, and
    against each other bit for bit on float32 inputs."""
    _card()
    S = tiles * RK.tile_steps() + steps
    a, b, _ = _rglru_inputs(B, S, L, S + L)
    h, hl = RK.rglru_call(a, b, mode=KernelMode.CUDA)
    hs, hls = RK.rglru_scan(b, a, mode=KernelMode.CUDA)
    torch.cuda.synchronize()
    assert torch.equal(h, hs) and torch.equal(hl, hls)
    ho, hlo = rref.rglru_ref(a, b)
    torch.testing.assert_close(h, ho, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(hl, hlo, atol=1e-5, rtol=1e-5)
    hp, hlp = rref.rglru_call_ref(a, b, chunk=S)
    torch.testing.assert_close(h, hp, atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(hl, hlp, atol=5e-5, rtol=5e-5)


def _fold_then_call(u, a, h0):
    """The route the entry replaced: u to float32, h0 folded into the first
    step with ``torch.cat``, the float32 kernel, h cast to u's type."""
    b = u.float()
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    h, h_last = RK.rglru_call(a, b, mode=KernelMode.CUDA)
    return h.to(u.dtype), h_last


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,L", [(1, 4096, 4096), (2, 1001, 96),
                                   (1, 1, 33)])
def test_rglru_entry_equals_fold_then_call_on_card(B, S, L, dtype, with_h0):
    """``rglru_scan_kernel`` reads u in its own type and folds h0 in the
    kernel: the same bits as the float32 route with the fold and the cast
    outside it; and against the plain version on the same inputs within
    the doubling scan's 5e-5, plus one ulp of |h| for bf16."""
    _card()
    a, b, h0 = _rglru_inputs(B, S, L, 3 * S + L)
    u = b.to(dtype)
    h0 = h0 if with_h0 else None
    before = RK.launch_counts()["rglru"]
    h, hl = rglru_scan_kernel(u, a, h0, mode=KernelMode.CUDA)
    torch.cuda.synchronize()
    assert RK.launch_counts()["rglru"] == before + 1
    assert h.dtype == dtype and hl.dtype == torch.float32
    hf, hlf = _fold_then_call(u, a, h0)
    hp, hlp = rglru_scan_kernel(u, a, h0, mode=KernelMode.TORCH)
    torch.cuda.synchronize()
    assert torch.equal(h, hf) and torch.equal(hl, hlf)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 5e-5   # a bf16 ulp
    assert bool(((h.double() - hp.double()).abs()
                 <= 5e-5 + rtol * hp.double().abs()).all())
    torch.testing.assert_close(hl, hlp, atol=5e-5, rtol=5e-5)


@pytest.mark.cuda
def test_rglru_kernel_is_deterministic_on_card():
    _card()
    a, b, h0 = _rglru_inputs(1, 32768, 4096, 11)
    h1, hl1 = RK.rglru_call(a, b, mode=KernelMode.CUDA)
    h2, hl2 = RK.rglru_call(a, b, mode=KernelMode.CUDA)
    u = b.to(torch.bfloat16)
    g1, gl1 = rglru_scan_kernel(u, a, h0, mode=KernelMode.CUDA)
    g2, gl2 = rglru_scan_kernel(u, a, h0, mode=KernelMode.CUDA)
    torch.cuda.synchronize()
    assert torch.equal(h1, h2) and torch.equal(hl1, hl2)
    assert torch.equal(g1, g2) and torch.equal(gl1, gl2)


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_entry_is_one_kernel_on_card(with_h0):
    """One ``rglru_scan_kernel`` call on bfloat16 u launches the port's
    kernel once and nothing else: no conversion copy, no concatenation
    (``torch.profiler`` over 10 calls, counted per launch of the kernel)."""
    _card()
    from repro_torch.kernels.timing import device_profile
    a, b, h0 = _rglru_inputs(1, 2048, 4096, 12)
    u = b.to(torch.bfloat16)
    h0 = h0 if with_h0 else None
    n_calls = []

    def call():
        n_calls.append(1)
        return rglru_scan_kernel(u, a, h0)
    before = RK.launch_counts()["rglru"]
    got = device_profile(call, calls=10, kernel="rglru_kernel")
    assert RK.launch_counts()["rglru"] == before + len(n_calls)  # one a call
    assert got["kernels"] == 1 and got["memsets"] == 0, got
    assert all("rglru_kernel" in n for n in got["names"]), got


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["u_dtype", "a_dtype", "shape", "h0_shape"])
def test_rglru_entry_refuses_what_it_cannot_take_on_card(what):
    _card()
    a, u, h0 = _rglru_inputs(1, 64, 32, 5)
    if what == "u_dtype":
        u = u.half()
    elif what == "a_dtype":
        a = a.bfloat16()
    elif what == "shape":
        u = u[:, :32]
    else:
        h0 = h0[:, :16]
    before = RK.launch_counts()
    with pytest.raises(TypeError if what.endswith("dtype") else ValueError):
        RK.rglru_scan(u, a, h0, mode=KernelMode.CUDA)
    assert RK.launch_counts() == before


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
    sliding window; causal, ragged, the forward only (bfloat16 on the
    tensor-core kernel, float32 on the FMA one)."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(256)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)
    q, k, v = mk(1, 1000, 16, 256), mk(1, 1000, 1, 256), mk(1, 1000, 1, 256)
    kw = dict(causal=True, window=256, q_offset=0)
    before = FK.launch_counts()
    o, lse = FK.flash_fwd(q, k, v, mode=KernelMode.CUDA, **kw)
    torch.cuda.synchronize()
    split = f"flash_fwd_d256_{FK.route(dtype, 256)}"
    assert FK.launch_counts() == {
        **before, "flash_fwd_d256": before["flash_fwd_d256"] + 1,
        split: before[split] + 1}
    o_ref, lse_ref = fref.attention_fwd_ref(q, k, v, **kw)
    tol = FWD_TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    assert _rel_l2(o, o_ref) <= REL_L2[dtype]
    torch.testing.assert_close(lse, lse_ref, atol=LSE_ABS[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,Kv,causal,window", [
    (1, 1000, 1000, 16, 1, True, 2048),     # RecurrentGemma: MQA, a window
    (2, 100, 700, 4, 2, True, 64),          # q_offset, a ragged query tile
    (1, 300, 300, 4, 4, False, None),       # non-causal, every key live
])
def test_flash_d256_tensor_core_forward_on_card(B, Sq, Sk, H, Kv, causal,
                                                window):
    """The bf16 forward at head dim 256 on the tensor-core kernel against
    the plain version and against the FMA kernel on the same inputs."""
    _card()
    assert FK.route(torch.bfloat16, 256) == "tc"
    gen = torch.Generator(device="cuda").manual_seed(Sq)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").bfloat16()
    q, k, v = mk(B, Sq, H, 256), mk(B, Sk, Kv, 256), mk(B, Sk, Kv, 256)
    kw = dict(causal=causal, window=window, q_offset=Sk - Sq)
    o, lse = FK.launch_fwd(q, k, v, kernel="tc", **kw)
    o_f, lse_f = FK.launch_fwd(q, k, v, kernel="fma", **kw)
    o_ref, lse_ref = fref.attention_fwd_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    dt = torch.bfloat16
    for name, a, la in (("tc", o, lse), ("fma", o_f, lse_f)):
        torch.testing.assert_close(a.float(), o_ref.float(), atol=FWD_TOL[dt],
                                   rtol=FWD_TOL[dt], msg=lambda m: f"{name}: {m}")
        assert _rel_l2(a, o_ref) <= REL_L2[dt], name
        torch.testing.assert_close(la, lse_ref, atol=LSE_ABS[dt], rtol=0)
    assert _rel_l2(o, o_f) <= REL_L2[dt]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [
    "mixtral_8x7b", "mixtral_8x22b", "command_r_plus_104b", "granite_3_2b",
    "qwen2_5_3b", "tinyllama_1_1b", "mamba2_780m", "recurrentgemma_9b",
    "whisper_medium", "llava_next_34b"])
def test_smoke_config_runs_on_the_kernels_on_card(arch):
    """The smoke config's narrow widths (head dims 8, 12, 16, non-causal
    in the encoder-decoder; SSD at (16, 16), chunk 16) under
    ``kernel_mode="auto"``: bf16 prefill, float32
    loss and every family's gradients on the kernels (the SSM's and the
    hybrid's through the SSD and RG-LRU backward kernels) within the limits
    of ``repro_torch.launch.smoke_widths`` of the plain path."""
    _card()
    from repro_torch.launch import smoke_widths
    res = smoke_widths.check(arch)
    assert res["ok"], res


BACKWARD_KERNELS = {   # wrapper module, launch count, plain backward
    "ssd": ("ssd_bwd", "repro_torch.kernels.ssd.ref", "ssd_bwd_ref"),
    "rglru": ("rglru_bwd", "repro_torch.kernels.rglru.ref", "rglru_bwd_ref"),
    "flash_d256": ("flash_bwd_d256", "repro_torch.kernels.flash_attention.ref",
                   "attention_bwd_ref"),
}


def _backward_case(kernel, dtype, mode):
    """Seeded inputs (fresh leaves), the op's outputs and their cotangents,
    through the model-layout entry point of ``kernel``."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    if kernel == "ssd":
        x, dt = rn(1, 512, 4, 64).to(dtype), torch.rand(
            (1, 512, 4), generator=gen, device="cuda") * 0.5
        A, Bm, Cm = -torch.exp(rn(4) * 0.5), (rn(1, 512, 128) * 0.3).to(
            dtype), (rn(1, 512, 128) * 0.3).to(dtype)
        h0 = rn(1, 4, 64, 128) * 0.3
        leaves = [t.requires_grad_() for t in (x, dt, A, Bm, Cm, h0)]
        outs = ssd_scan(*leaves[:5], chunk=256, h0=h0, mode=mode)
    elif kernel == "rglru":
        u = (rn(1, 300, 96) * 0.5).to(dtype)
        a = torch.sigmoid(rn(1, 300, 96) + 2.0) * 0.98 + 0.01
        leaves = [t.requires_grad_() for t in (u, a, rn(1, 96) * 0.3)]
        outs = rglru_scan_kernel(*leaves, mode=mode)
    else:
        q, kv = rn(1, 300, 16, 256).to(dtype), rn(1, 300, 1, 256).to(dtype)
        leaves = [t.requires_grad_() for t in (q, kv, rn(1, 300, 1, 256)
                                               .to(dtype))]
        outs = (flash_attention(*leaves, window=64, mode=mode),)
    gen.manual_seed(12)
    cots = tuple(rn(*o.shape).to(o.dtype) for o in outs)
    return leaves, outs, cots


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["ssd", "rglru", "flash_d256"])
def test_backward_kernel_runs_and_matches_the_plain_backward_on_card(
        kernel, dtype, monkeypatch):
    """A backward through SSD, RG-LRU or the head-dim-256 flash attention
    on CUDA tensors launches its backward kernel, once a backward, and no
    plain backward (the plain version is made to raise while it runs);
    two backwards give the same bits; the gradients equal the plain
    backward's (``KernelMode.TORCH``, the same Function on the same card)
    within a relative L2 distance of 1e-5 in float32 and 1e-2 in bfloat16
    (dx, dB, dC and du rounded to bf16 in both)."""
    _card()
    import importlib
    count, module, plain_name = BACKWARD_KERNELS[kernel]
    counts = lambda: {**SK.launch_counts(), **RK.launch_counts(),  # noqa
                      **FK.launch_counts()}
    plain_mod = importlib.import_module(module)
    plain_fn = getattr(plain_mod, plain_name)
    leaves, outs, cots = _backward_case(kernel, dtype, KernelMode.TORCH)
    want = torch.autograd.grad(outs, leaves, cots)

    def refuse(*a, **k):
        raise AssertionError(f"{plain_name} ran on the kernel path")

    monkeypatch.setattr(plain_mod, plain_name, refuse)
    got = []
    for _ in range(2):
        leaves, outs, cots = _backward_case(kernel, dtype, KernelMode.AUTO)
        before = counts()
        got.append(torch.autograd.grad(outs, leaves, cots))
        after = counts()
        assert after[count] == before[count] + 1
        if kernel == "flash_d256":
            route = FK.route(dtype, 256, backward=True)
            assert after[f"flash_bwd_d256_{route}"] == \
                before[f"flash_bwd_d256_{route}"] + 1
    monkeypatch.setattr(plain_mod, plain_name, plain_fn)
    torch.cuda.synchronize()
    for a, b in zip(*got):
        assert torch.equal(a, b)
    tol = REL_L2[dtype]
    for i, (a, b) in enumerate(zip(got[0], want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert _rel_l2(a, b) <= tol, (i, _rel_l2(a, b))


SSD_BWD_CASES = [                 # B, S, H, P, N, chunk, dtype, with h0
    (1, 600, 6, 64, 128, 200, torch.bfloat16, True),   # ragged; groups 4 + 2
    (2, 512, 48, 64, 128, 256, torch.bfloat16, False),  # Mamba-2's 48 heads
    (1, 256, 3, 64, 128, 32, torch.bfloat16, True),    # a chunk below a tile
    (1, 600, 6, 64, 128, 200, torch.float32, True),    # the FMA route
    (1, 96, 3, 16, 16, 16, torch.bfloat16, True),      # smoke widths (FMA)
    (1, 600, 3, 16, 16, 200, torch.bfloat16, False),   # smoke, ragged
]
# On the tensor-core route every operand formed in float32 enters as hi +
# lo, so the bf16 gradients differ from the plain version's (float32 sums of
# the same bf16 inputs, rounded once) by roundings of nearly equal values:
# some 6e-5 relative L2 on the FMA route at the train shape.  An operand
# rounded once to bf16 instead moves them by 2e-3 or more (the CPU mirror in
# tests/test_torch_ssd.py), so the route is also held within SPLIT_REL_L2.
SPLIT_REL_L2 = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_BWD_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_ssd_backward_kernel_matches_plain_on_card(case):
    """The SSD backward kernel on its route (``bwd_route``: bf16 at Mamba-2
    780M's widths on the tensor cores, with the heads in groups of
    ``HEAD_GROUP``, a last group cut short among them) against
    ``ssd_bwd_ref``: every gradient within 1e-2 relative L2 in bf16 (and
    ``SPLIT_REL_L2`` on the tensor cores), 1e-5 in float32; two calls
    bit-equal; one ``ssd_bwd`` launch a call."""
    _card()
    B, S, H, P, N, chunk, dtype, with_h0 = case
    x, dA, dt, Bm, Cm, h0 = _ssd_inputs(B, S, H, P, N, dtype, with_h0,
                                        seed=S + H)
    gen = torch.Generator(device="cuda").manual_seed(S)
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
    dhl = torch.randn((B, H, P, N), generator=gen, device="cuda")
    got = []
    for _ in range(2):
        before = SK.launch_counts()["ssd_bwd"]
        got.append(SK.ssd_call_bwd(x, dA, dt, Bm, Cm, dy, chunk=chunk, h0=h0,
                                   dh_last=dhl, mode=KernelMode.CUDA))
        assert SK.launch_counts()["ssd_bwd"] == before + 1
    torch.cuda.synchronize()
    want = sref.ssd_bwd_ref(x, dA, dt, Bm, Cm, dy, chunk, h0, dhl)
    tol = REL_L2[dtype]
    if SK.bwd_route(dtype, P, N) == "tc":
        tol = min(tol, SPLIT_REL_L2)
    names = ("dx", "ddA", "ddt", "dB", "dC", "dh0")
    for name, a, again, w in zip(names, got[0], got[1], want):
        if name == "dh0" and not with_h0:
            assert a is None
            continue
        assert torch.equal(a, again), name
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert _rel_l2(a, w) <= tol, (name, _rel_l2(a, w))


D256_BWD_CASES = [   # B, Sq, Sk, H, Kv, causal, window, q_offset
    (1, 300, 300, 2, 2, True, None, 0),      # G = 1, S not a multiple of 64
    (1, 200, 200, 4, 2, True, 40, 0),        # G = 2, a window below a tile
    (1, 130, 258, 16, 1, True, 100, 128),    # G = 16, q_offset > 0
    (2, 200, 200, 4, 2, True, None, 0),      # B = 2, Kv = 2
    (1, 96, 64, 2, 1, True, 50, 100),        # rows with no live key
    (1, 333, 333, 4, 1, False, 48, 0),       # a window, not causal
]


def _d256_case(case, seed):
    B, Sq, Sk, H, Kv, causal, window, q_offset = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(  # noqa
        torch.bfloat16)
    q, k, v, do = mk(B, Sq, H, 256), mk(B, Sk, Kv, 256), mk(B, Sk, Kv, 256), \
        mk(B, Sq, H, 256)
    return q, k, v, do, dict(causal=causal, window=window, q_offset=q_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("case", D256_BWD_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_flash_d256_wgmma_backward_matches_plain_on_card(case):
    """The bf16 backward at head dim 256 (dK/dV partials per head group and
    dQ on wgmma, then their sum) against ``attention_bwd_ref`` and autograd
    through ``attention_ref``, every gradient within a relative L2 distance
    of 1e-2; two calls bit-equal; one ``flash_bwd_d256`` launch a call on
    route "tc".  Rows with no live key get zero gradients (the plain
    version spreads them uniformly, so their cotangent is zeroed for the
    comparison)."""
    _card()
    q, k, v, do, kw = _d256_case(case, seed=sum(case[:5]))
    o, lse = FK.flash_fwd(q, k, v, **kw)
    dead = torch.isinf(lse)                                   # [B, H, Sq]
    got = []
    for _ in range(2):
        before = FK.launch_counts()
        got.append(FK.flash_bwd(q, k, v, o, lse, do, **kw))
        after = FK.launch_counts()
        assert after["flash_bwd_d256_tc"] == before["flash_bwd_d256_tc"] + 1
    torch.cuda.synchronize()
    for a, b in zip(*got):
        assert torch.equal(a, b)
    dq = got[0][0].float().transpose(1, 2)                    # [B, H, Sq, D]
    assert not dq[dead].any()
    live_do = do.masked_fill(dead.transpose(1, 2)[..., None], 0)
    want = fref.attention_bwd_ref(q, k, v, live_do, **kw)
    want_ag = _autograd_grads(q, k, v, live_do, kw)
    for name, a, b, c in zip("qkv", got[0], want, want_ag):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name == "q":   # the plain version's dead rows are not zero
            a = a.masked_fill(dead.transpose(1, 2)[..., None], 0)
            b = b.masked_fill(dead.transpose(1, 2)[..., None], 0)
            c = c.masked_fill(dead.transpose(1, 2)[..., None], 0)
        assert _rel_l2(a, b) <= REL_L2[torch.bfloat16], (name, _rel_l2(a, b))
        assert _rel_l2(a, c) <= REL_L2[torch.bfloat16], (name, _rel_l2(a, c))


def _autograd_grads(q, k, v, do, kw):
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        out = fref.attention_ref(*leaves, **kw)
        return torch.autograd.grad(out, leaves, do.float())


@pytest.mark.cuda
def test_flash_d256_backward_does_not_depend_on_the_block_order_on_card():
    """Each dK/dV block writes its head group's partial sums and the sum
    pass adds the groups in the order 0, 1, ...: launching the blocks in the
    reverse of the schedule gives the same bits."""
    _card()
    case = (1, 700, 700, 16, 1, True, 256, 0)
    q, k, v, do, kw = _d256_case(case, seed=7)
    o, lse = FK.flash_fwd(q, k, v, **kw)
    want = FK.launch_bwd(q, k, v, o, lse, do, kernel="tc", **kw)
    n = len(FK.head_groups(16))
    key = (q.device.index, 700, 700, 16, n, True, 256, 0)
    sched = FK._SCHEDULES[key]
    assert sched.tolist() == FK.dkdv_schedule(700, 700, 16, n, **kw)
    sched.copy_(sched.flip(0))
    try:
        got = FK.launch_bwd(q, k, v, o, lse, do, kernel="tc", **kw)
    finally:
        sched.copy_(sched.flip(0))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


RGLRU_BWD_CASES = [   # B, S, L, dtype, with h0
    (1, 100, 64, torch.bfloat16, True),     # S below one chunk
    (2, 1000, 100, torch.bfloat16, True),   # S ragged to tiles and chunks,
    (1, 1000, 100, torch.float32, False),   # L not a multiple of 32
    (1, 4096, 4096, torch.bfloat16, False),  # RecurrentGemma-9B's train shape
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", RGLRU_BWD_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_rglru_backward_in_chunks_matches_plain_on_card(case):
    """The RG-LRU backward, its sequence cut into chunks across blocks,
    against ``rglru_bwd_ref`` and autograd through the plain forward within
    a relative L2 distance of 1e-2 (bf16) or 1e-5 (float32); two calls
    bit-equal, the second reading carry words that the first tagged with
    its epoch."""
    _card()
    assert RK.tile_steps() == RK.TILE_STEPS
    assert RK.library().rglru_bwd_chunk_tiles() == RK.BWD_CHUNK_TILES
    B, S, L, dtype, with_h0 = case
    gen = torch.Generator(device="cuda").manual_seed(S + L)
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa
    a = torch.sigmoid(rn(B, S, L) + 2.0) * 0.98 + 0.01
    u = (rn(B, S, L) * 0.5).to(dtype)
    h0 = rn(B, L) * 0.3 if with_h0 else None
    dh, dhl = rn(B, S, L).to(dtype), rn(B, L)
    _, _, carries = RK.rglru_scan(u, a, h0, mode=KernelMode.CUDA,
                                  save_carries=True)
    got = [RK.rglru_scan_bwd(u, a, h0, dh, dhl, carries, mode=KernelMode.CUDA)
           for _ in range(2)]
    torch.cuda.synchronize()
    for other in got[1:]:
        for x, y in zip(got[0], other):
            assert (x is None and y is None) or torch.equal(x, y)
    want = rref.rglru_bwd_ref(u, a, h0, dh, dhl)
    leaves = [t.detach().requires_grad_() for t in (u, a)] + (
        [h0.detach().requires_grad_()] if with_h0 else [])
    with torch.enable_grad():
        h, h_last = rref.rglru_call_ref(leaves[1], leaves[0].float(),
                                        leaves[2] if with_h0 else None)
        ag = torch.autograd.grad((h.to(dtype), h_last), leaves, (dh, dhl))
    tol = REL_L2[dtype]
    for name, x, w, c in zip(("du", "da", "dh0"), got[0], want,
                             (*ag, None)):
        if name == "dh0" and not with_h0:
            assert x is None
            continue
        assert x.dtype == w.dtype and x.shape == w.shape, name
        assert _rel_l2(x, w) <= tol, (name, _rel_l2(x, w))
        assert _rel_l2(x, c) <= tol, (name, _rel_l2(x, c))


@pytest.mark.cuda
def test_rglru_backward_refuses_cuda_graph_capture_on_card():
    """The RG-LRU backward's carry words are tagged with an epoch the host
    passes each launch, which a CUDA graph's replays would repeat: capturing
    a call raises instead of recording it."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    a = torch.sigmoid(torch.randn(1, 300, 64, generator=gen, device="cuda"))
    u = torch.randn(1, 300, 64, generator=gen, device="cuda")
    _, _, carries = RK.rglru_scan(u, a, None, mode=KernelMode.CUDA,
                                  save_carries=True)
    dh = torch.randn_like(u)
    RK.rglru_scan_bwd(u, a, None, dh, None, carries, mode=KernelMode.CUDA)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(graph):
            RK.rglru_scan_bwd(u, a, None, dh, None, carries,
                              mode=KernelMode.CUDA)


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


# hamming.cu's launch: a block of 256 threads takes 256 vectors of 4 words,
# one block per 1024 words and no loop; the first threads take the n % 4
# words of the tail
BLOCK_WORDS = 256 * 4
TILING_LENGTHS = list(range(1, 10)) + [
    k * BLOCK_WORDS + d for k in (1, 2, 8192) for d in (-1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", TILING_LENGTHS)
def test_word_kernels_at_the_launch_tiling_on_card(n):
    """The multiplier and the encoder (and the decoder, which shares the
    launch) at lengths around the launch shape's block: the last block's
    vectors and the masked tail of n % 4 words."""
    _card()
    x = _card_words(n, n + 7)
    assert torch.equal(HK.mul_const(x, 2654435761, mode=KernelMode.CUDA),
                       href.multiply_ref(x, 2654435761))
    assert torch.equal(HK.hamming_encode(x, mode=KernelMode.CUDA),
                       href.encode_ref(x))
    dec, corr = HK.hamming_decode(x, mode=KernelMode.CUDA)
    d_ref, c_ref = href.decode_ref(x)
    assert torch.equal(dec, d_ref) and torch.equal(corr, c_ref)


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
