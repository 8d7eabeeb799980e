"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. device   needs ``torch.cuda.is_available()``; prints the card's name and
            power limit (``nvidia-smi``).
2. build    builds the crossbar, flash-attention, SSD, RG-LRU and Hamming
            kernel libraries from ``src/repro_torch`` (one ``nvcc`` each,
            started together).
3. kernels  holds ``plan_multi``, the fabric's plan entry
            (``plan_fabric``, and ``CudaBackend.plan`` around it),
            ``scatter`` and ``combine`` bit-equal (``torch.equal``) to
            their plain versions and the whole plan to
            ``ReferenceBackend.plan`` at the served shapes, the train
            step's (``moe_train``: T=2048, C=320) and large shapes, and
            times kernel, plain version and one library call with CUDA
            events (median of 20 after warm-up); at the decode, train and
            large shapes the plans, scatter, combine and their library
            calls also by device time (``torch.profiler``, 20 calls, with
            kernels and memsets per call) and host time per call (1,000
            calls enqueued on a busy card; ``repro_torch/kernels/timing.py``),
            and fails unless a plan (``plan_multi``, ``plan_fabric``,
            ``CudaBackend.plan``), scatter or combine call at the decode
            and train shapes is one device kernel and no memset.
4. flash    holds the flash-attention forward and backward kernels to
            their plain versions (autograd through ``attention_ref``) at
            seven shapes (bfloat16 on the tensor-core kernels at head dims
            128 and 64, a window of 48 keys; float32 on the FMA kernels),
            and times kernel, plain version,
            ``scaled_dot_product_attention`` and the FMA kernels on the
            same bfloat16 inputs at the train shape.
5. serve    a full-width Mixtral-8x7B (2 of 32 layers, bf16, random weights
            from a seed) behind ``ElasticServer`` on the ``cuda`` fabric,
            MoE on ``cuda_kernel``: 4 requests, one ``Shell.post(Grow)``
            midway.  Counts kernel launches on exactly this run, then serves
            the same requests through the plain versions on the card and
            requires identical token streams and port traffic.
5b. manager_mixtral
            the paper's resource manager closing the loop over that
            engine: one 4-module Mixtral tenant in a 4-region shell of
            80 GB regions, started on 1 region, ``ElasticServer`` with
            ``slots_per_region=1`` (a region buys a decode slot) on the
            ``cuda`` fabric and a ``Manager(Hysteresis())`` ticking with
            the server (deciding every second tick).  16 requests at tick
            0, then quiet to tick 72: the manager must post a Grow and
            later a Shrink, the placed regions must follow its decisions,
            and token streams, decisions and placements must equal the same
            loop on the plain path; the plan, scatter and combine kernels
            launch, the crossbar library loads once.
6. train    3 AdamW steps of ``make_train_step`` on the served model's
            parameters (B=1, S=4096), counting kernel launches on exactly
            these steps (bfloat16 flash only on the tensor-core route);
            then the prefill logits of the kernel path against
            the plain path, and one float32 loss and backward of a 1-layer
            full-width model on the kernel path against the plain path.
7. ssd, rglru, flash_d256
            the recurrent families' kernels (built in phase 2 with the
            others) against their plain versions: SSD at Mamba-2 780M's
            widths (bf16 at S=4096 and 32768, float32 at S=1024 also
            against the sequential oracle, S=200 below the chunk), RG-LRU
            at RecurrentGemma-9B's width (S=32768, and float32 with an
            initial state; the model's entry on bf16 u and float32 a, with
            and without an initial state, bit-equal to the float32 kernel
            followed by the cast, and one kernel a call, timed as
            ``entry_ms``), the flash forward at head dim 256 at
            RecurrentGemma's attention shape (S=32768, window 2048; bf16 on
            the tensor-core kernel, also timed on the FMA one); each timed
            against its plain version and its bound.
7b. smoke_widths
            every ported family's smoke config (head dims 8, 12 and 16;
            SSD at (P, N) = (16, 16), chunk 16) under ``kernel_mode="auto"``
            (``repro_torch.launch.smoke_widths``): bf16 prefill, float32
            loss and the dense and MoE gradients on the kernels against the
            plain path; the SSM and hybrid backward raise, naming B8.
8. serve_ssm, serve_hybrid
            the full Mamba-2 780M (48 layers) and the full
            RecurrentGemma-9B (38 layers), bf16, random weights from a
            seed, behind ``ElasticServer`` with the serve phase's requests
            and ``Shell.post(Grow)``, then ``prefill`` at S=32768, B=1,
            counting launches over exactly the serve and the prefill; the
            same on the plain path (token streams and port traffic equal;
            every block of the prefill within 2e-2 relative L2 of the plain
            path's on the same input; the end-to-end logits within 3 times
            a rounding-sized control of the same run); then a float32 copy
            cut to 2 layers (the hybrid to 3, one whole group): prefill
            logits and loss against the plain path, and prefill's token
            against ``ModelEngine``'s replay of
            the same 512-token prompt through ``decode_step``.
9. paper_usecase
            the paper's experiments on the port's copy of the hardware
            model (Fig 5, §V-D, §V-E, Fig 6, Table II; model milliseconds
            and FPGA cycles, each beside the paper's value); the use case
            (multiplier -> Hamming(31,26) encoder -> decoder, 16 KB) on a
            ``Shell`` with 1, 2 and 3 free regions, placed modules on the
            card's kernels and ``ON_SERVER`` ones on the CPU, each output
            equal to ``ElasticUseCase.run_case(k).output``, then one tenant
            grown from 1 region to 3 without a rebuild (launches counted
            over exactly these runs); the three Hamming kernels bit-equal
            to their plain versions at 16 KB, 2^28 and 2^28 - 3 words,
            every single-bit error position, double-bit errors and several
            constants, timed at 2^28 words (the multiplier also in 10
            rounds alternating with ``torch.mul``, ``mul_rounds``: each
            side's quartiles and the rounds the multiplier won); then
            the single-source plan
            kernel through the deprecated ``crossbar_plan`` ->
            ``crossbar_dispatch`` -> ``crossbar_combine`` shims at the four
            shapes of ``tests/test_kernels.py``, the zero-packet round and
            out-of-range ``dst`` (launches counted over exactly these
            rounds), bit-equal to ``plan_ref``, timed at T = 2^20, S = 16
            (also by device time, kernels and memsets a call, and host
            time; it fails if that plan clears memory).

10. serve_harness
            ``ServeHarness`` + ``SeededEngine`` over an ``ElasticServer`` on
            the ``cuda`` fabric at ``benchmarks/serve_bench.py``'s shapes
            (read, not imported): 2,048 front-loaded streams through 1,024
            slots, ``max_new=48``, with the plan cache on and off, and
            2,048 heavy-tailed streams through 256 slots under a FailRegion
            / heal / Shrink / Grow script with the cache on.  Each report's
            integers and sha256 token digest, and the port traffic, equal
            the same run on the ``reference`` backend on the CPU; the digest
            is the same with the cache on and off; the storm's cache
            invalidations equal its posts; one plan signature
            (``fabric_retraces`` 1); one plan launch per cache miss, or per
            tick with an active slot with the cache off; the crossbar
            library loaded once.  Tick percentiles and tokens/s printed.
11. manager_scenarios
            ``run_scenario`` on the card (``fabric_backend="cuda"``):
            ``bursty``, ``production`` on a ``ServerPool`` of 4 servers over
            24 regions, ``adversarial`` under ``adversarial_policy()``,
            seed 0, 48 ticks, each ``to_json()`` equal to the same call on
            ``reference`` on the CPU; ``production`` recorded on the card
            and replayed through ``RecordedWorkload`` to the same trace;
            plan launches > 0 and the crossbar library loaded once.

``--profile`` adds a phase after serving and one after the train steps:
``torch.profiler`` over 8 warm decode steps of the served engine and over
one more train step, and one over each recurrent model's S=32768
prefill; device time by kernel, the device's idle share, and Chrome traces
in ``build/profile/``.  ``--seed N`` (default 0) draws every input, weight
and prompt from another seed.

The last line is ``{"ok": true, "device": {...}}``; any failure raises and
exits non-zero before it.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
F32_OPS_PER_S = 67e12              # H100 SXM, float32 outside tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM, dense bf16 tensor cores
SEED = 0
GB = 1 << 30


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one call of ``fn`` over ``reps`` runs, CUDA events."""
    from repro_torch.kernels.timing import event_ms
    return event_ms(fn, reps=reps, warmup=warmup)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def bound(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------------------
# kernel inputs: real plans over seeded random registers
# ----------------------------------------------------------------------
def random_registers(S: int, capacity: int, gen: torch.Generator, *,
                     holes: bool = True):
    from repro_torch.core.registers import CrossbarRegisters
    regs = CrossbarRegisters.create(S, capacity=capacity, device="cuda")
    if not holes:
        return regs
    dev = "cuda"
    allowed = torch.rand((S, S), generator=gen, device=dev) > 0.15
    quota = torch.randint(0, 4 * capacity, (S, S), generator=gen, device=dev,
                          dtype=torch.int32)
    quota = torch.where(torch.rand((S, S), generator=gen, device=dev) > 0.5,
                        quota, 0)
    reset = torch.zeros((S,), dtype=torch.bool, device=dev)
    reset[int(torch.randint(0, S, (1,), generator=gen, device=dev))] = True
    return regs.write(allowed=allowed, quota=quota, reset=reset)


def random_packets(T: int, S: int, n_src: int, gen: torch.Generator,
                   pad: float = 0.05):
    dst = torch.randint(0, S, (T,), generator=gen, device="cuda",
                        dtype=torch.int32)
    dst = torch.where(torch.rand((T,), generator=gen, device="cuda") < pad,
                      -1, dst).to(torch.int32)
    src = torch.randint(0, n_src, (T,), generator=gen, device="cuda",
                        dtype=torch.int32)
    return dst, src


class Case:
    """One shape the kernels are held to: packets, registers, a plan."""

    def __init__(self, name, T, S, C, D, dtype, n_src, gen, holes=True):
        from repro_torch.fabric.backends import ReferenceBackend
        self.name, self.T, self.S, self.C, self.D = name, T, S, C, D
        self.dtype = dtype
        self.regs = random_registers(S, C, gen, holes=holes)
        self.dst, self.src = random_packets(T, S, n_src, gen,
                                            pad=0.05 if holes else 0.0)
        self.allowed = (self.regs.allowed & ~self.regs.reset[:, None]
                        & ~self.regs.reset[None, :]).to(torch.int32)
        self.quota_sd = self.regs.quota.T            # a strided view on purpose
        plan = ReferenceBackend().plan(self.dst, self.src, self.regs)
        self.keep = plan.keep.to(torch.int32)
        self.slot = plan.slot
        self.x = torch.randn((T, D), generator=gen, device="cuda").to(dtype)
        self.y = torch.randn((S, C, D), generator=gen, device="cuda").to(dtype)
        self.w = torch.rand((T,), generator=gen, device="cuda")

    def check(self):
        """Kernel vs plain version, bit-equal; also the backend's whole plan
        (kernel + closed-form slots) vs the reference plan.  Returns each
        kernel's max abs difference from its plain version."""
        from repro_torch.fabric.backends import CudaBackend, ReferenceBackend
        from repro_torch.fabric.interface import KernelMode
        from repro_torch.kernels.crossbar_dispatch import kernel as K, ref
        pk = K.plan_multi(self.dst, self.src, self.allowed, self.quota_sd,
                          mode=KernelMode.CUDA)
        pr = ref.plan_multi_ref(self.dst, self.src, self.allowed,
                                self.quota_sd)
        sk = K.scatter(self.x, self.dst, self.keep, self.slot,
                       n_ports=self.S, capacity=self.C, mode=KernelMode.CUDA)
        sr = ref.scatter_ref(self.x, self.dst, self.keep, self.slot, self.S,
                             self.C)
        ck = K.combine(self.y, self.dst, self.keep, self.slot, self.w,
                       mode=KernelMode.CUDA)
        cr = ref.combine_ref(self.y, self.dst, self.keep, self.slot, self.w)
        be = CudaBackend(kernel_mode=KernelMode.CUDA)
        plan_k = be.plan(self.dst, self.src, self.regs)
        plan_f = K.plan_fabric(self.dst, self.src, self.regs.allowed,
                               self.regs.reset, self.regs.quota,
                               self.regs.capacity, mode=KernelMode.CUDA)
        plan_r = ReferenceBackend().plan(self.dst, self.src, self.regs)
        torch.cuda.synchronize()
        errs = {"plan_multi": max(max_abs_err(a, b) for a, b in zip(pk, pr)),
                "scatter": max_abs_err(sk, sr),
                "combine": max_abs_err(ck, cr)}
        res = {
            "plan_multi": all(torch.equal(a, b) for a, b in zip(pk, pr)),
            "scatter": torch.equal(sk, sr),
            "combine": torch.equal(ck, cr),
            "backend_plan": all(
                torch.equal(getattr(plan_k, f.name), getattr(plan_r, f.name))
                for f in dataclasses.fields(plan_r)),
            "plan_fabric": all(
                torch.equal(getattr(plan_f, f.name), getattr(plan_r, f.name))
                for f in dataclasses.fields(plan_r)),
        }
        emit("kernels.check", case=self.name, T=self.T, S=self.S, C=self.C,
             D=self.D, dtype=str(self.dtype).replace("torch.", ""),
             granted=int(self.keep.sum()), max_abs_err=errs, **res)
        if not all(res.values()):
            raise AssertionError(f"kernel mismatch on {self.name}: {res}")
        return errs

    def timings(self):
        """(kernel, plain, library, bound, bound_by) per kernel, in ms; for
        scatter and combine also the device ms (``torch.profiler``, 20
        calls, with kernels and memsets per call) and host us per call
        (1,000 calls, card busy) of the kernel and of the library call;
        for ``plan_multi`` the same of its call and, as ``plan_fabric`` and
        ``backend_plan``, of the fabric's plan entry and of
        ``CudaBackend.plan`` around it."""
        from repro_torch.fabric.backends import CudaBackend
        from repro_torch.fabric.interface import KernelMode
        from repro_torch.kernels.crossbar_dispatch import kernel as K, ref
        from repro_torch.kernels.timing import device_profile, host_us
        T, S, C, D = self.T, self.S, self.C, self.D
        es = self.x.element_size()
        kept = int(self.keep.sum())
        cuda = KernelMode.CUDA
        out = {}
        b, by = bound(5 * T * 4 + 3 * S * S * 4, 0)
        plan_multi = lambda: K.plan_multi(self.dst, self.src, self.allowed,
                                          self.quota_sd, mode=cuda)
        out["plan_multi"] = dict(
            ms=time_ms(plan_multi),
            plain_ms=time_ms(lambda: ref.plan_multi_ref(
                self.dst, self.src, self.allowed, self.quota_sd)),
            library_ms=None, bound_ms=b, bound_by=by)
        regs = self.regs
        backend = CudaBackend(kernel_mode=cuda)
        plans = {
            "plan_multi": plan_multi,
            "plan_fabric": lambda: K.plan_fabric(
                self.dst, self.src, regs.allowed, regs.reset, regs.quota,
                regs.capacity, mode=cuda),
            "backend_plan": lambda: backend.plan(self.dst, self.src, regs),
        }
        for name, fn in plans.items():
            prof = device_profile(fn)
            out.setdefault(name, {}).update(
                device_ms=prof["device_ms"], kernels_per_call=prof["kernels"],
                memsets_per_call=prof["memsets"], host_us=host_us(fn))
            if name != "plan_multi":
                out[name]["ms"] = time_ms(fn)

        ok = ((self.keep > 0) & (self.dst >= 0) & (self.slot < C))
        trash = S * C
        addr = torch.where(ok, self.dst * C + self.slot, trash).long()
        flat = torch.zeros((S * C + 1, D), dtype=self.dtype, device="cuda")
        b, by = bound(kept * D * es + 3 * T * 4 + S * C * D * es, 0)
        out["scatter"] = dict(
            ms=time_ms(lambda: K.scatter(self.x, self.dst, self.keep,
                                         self.slot, n_ports=S, capacity=C,
                                         mode=cuda)),
            plain_ms=time_ms(lambda: ref.scatter_ref(
                self.x, self.dst, self.keep, self.slot, S, C)),
            library_ms=time_ms(lambda: flat.index_copy_(0, addr, self.x)),
            bound_ms=b, bound_by=by)

        y_flat = self.y.reshape(S * C, D)
        w_lib = (self.w * ok).to(self.dtype)
        cidx = torch.where(ok, addr, 0)
        b, by = bound(kept * D * es + 4 * T * 4 + T * D * es, T * D)
        out["combine"] = dict(
            ms=time_ms(lambda: K.combine(self.y, self.dst, self.keep,
                                         self.slot, self.w, mode=cuda)),
            plain_ms=time_ms(lambda: ref.combine_ref(
                self.y, self.dst, self.keep, self.slot, self.w)),
            library_ms=time_ms(
                lambda: y_flat.index_select(0, cidx) * w_lib[:, None]),
            bound_ms=b, bound_by=by)
        calls = {
            "scatter": (lambda: K.scatter(self.x, self.dst, self.keep,
                                          self.slot, n_ports=S, capacity=C,
                                          mode=cuda),
                        lambda: flat.index_copy_(0, addr, self.x)),
            "combine": (lambda: K.combine(self.y, self.dst, self.keep,
                                          self.slot, self.w, mode=cuda),
                        lambda: y_flat.index_select(0, cidx)
                        * w_lib[:, None]),
        }
        for name, (kernel, library) in calls.items():
            k, lib = device_profile(kernel), device_profile(library)
            out[name].update(
                device_ms=k["device_ms"], kernels_per_call=k["kernels"],
                memsets_per_call=k["memsets"], host_us=host_us(kernel),
                library_device_ms=lib["device_ms"],
                library_host_us=host_us(library))
        emit("kernels.time", case=self.name, T=T, S=S, C=C, D=D,
             dtype=str(self.dtype).replace("torch.", ""), **out)
        return out


# ----------------------------------------------------------------------
# flash attention: forward and backward against the plain versions
# ----------------------------------------------------------------------
# Each case is held three ways, with limits by dtype:
# - every element of o and lse (forward) and of dq, dk, dv (backward)
#   within FLASH_TOL, absolute and relative: the JAX package's own forward
#   tolerance and 1e-4 / 5e-2 backward;
# - o, dq, dk and dv each within FLASH_REL_L2 relative L2 of the plain
#   version: a wrong mask or a skipped 64-key tile moves it by some 1e-1
#   at these shapes, while bf16 rounding of the output moves it by some
#   1e-3 (PERF.md gives the readings);
# - the row log-sum-exp (float32 in both) within FLASH_LSE_ABS absolute:
#   one skipped 64-key tile moves it by about 64/4096 = 1.6e-2.
FLASH_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (3e-2, 5e-2)}
FLASH_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
FLASH_LSE_ABS = {torch.float32: 2e-5, torch.bfloat16: 1e-3}
PLAIN_KV_HEADS = 2     # kv heads per plain-version call: bounds its memory


def flash_live_tiles(Sq, Sk, causal, window, q_offset, dtype, D) -> int:
    """(q tile, k tile) pairs the forward kernel of the route that takes
    (dtype, D) visits per (batch, head): the kernels' own tile skip (none
    above the causal diagonal, none wholly outside the window)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    BLOCK_Q, BLOCK_K = FK.fwd_tile(dtype, D)
    n = 0
    for q0 in range(0, Sq, BLOCK_Q):
        q_last = q_offset + min(q0 + BLOCK_Q, Sq) - 1
        end = -(-Sk // BLOCK_K)
        if causal:
            end = min(end, q_last // BLOCK_K + 1)
        begin = 0
        if window is not None:
            begin = max(q_offset + q0 - window + 1, 0) // BLOCK_K
        n += max(0, end - begin)
    return n


def flash_live_pairs(Sq, Sk, causal, window, q_offset) -> int:
    """Unmasked (query, key) pairs per (batch, head): the work the function
    needs, which the bounds count (the kernels also compute the masked part
    of the diagonal and window-edge tiles they visit)."""
    q_pos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(q_pos + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(q_pos - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo, 0).sum())


def within(a: torch.Tensor, b: torch.Tensor, tol: float) -> bool:
    return bool(torch.isclose(a.double(), b.double(), rtol=tol,
                              atol=tol).all())


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def lse_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|, rows that are -inf in both (no live key) counting
    as equal."""
    a, b = a.double(), b.double()
    return float(torch.where(a == b, 0.0, a - b).abs().max())


class FlashCase:
    """One shape the flash kernels are held to."""

    def __init__(self, name, B, Sq, Sk, H, Kv, D, dtype, causal, window,
                 gen):
        self.name, self.dtype = name, dtype
        self.kw = dict(causal=causal, window=window, q_offset=Sk - Sq)
        mk = lambda *shape: torch.randn(shape, generator=gen,
                                        device="cuda").to(dtype)
        self.q, self.k, self.v = mk(B, Sq, H, D), mk(B, Sk, Kv, D), \
            mk(B, Sk, Kv, D)
        self.do = mk(B, Sq, H, D)
        self.tiles = B * H * flash_live_tiles(Sq, Sk, causal, window,
                                              Sk - Sq, dtype, D)
        self.pairs = B * H * flash_live_pairs(Sq, Sk, causal, window,
                                              Sk - Sq)
        self.shape = dict(B=B, Sq=Sq, Sk=Sk, H=H, Kv=Kv, D=D,
                          dtype=str(dtype).replace("torch.", ""),
                          causal=causal, window=window, q_offset=Sk - Sq)

    def plain(self):
        """The plain versions, a few kv heads per call (every head is
        independent, so this is the same function with less memory)."""
        from repro_torch.kernels.flash_attention import ref
        q, k, v, do = self.q, self.k, self.v, self.do
        G = q.shape[2] // k.shape[2]
        parts = []
        for j in range(0, k.shape[2], PLAIN_KV_HEADS):
            hq = slice(j * G, (j + PLAIN_KV_HEADS) * G)
            hk = slice(j, j + PLAIN_KV_HEADS)
            o, lse = ref.attention_fwd_ref(q[:, :, hq], k[:, :, hk],
                                           v[:, :, hk], **self.kw)
            grads = ref.attention_bwd_ref(q[:, :, hq], k[:, :, hk],
                                          v[:, :, hk], do[:, :, hq],
                                          **self.kw)
            parts.append((o, lse, *grads))
        cat = lambda i, dim: torch.cat([p[i] for p in parts], dim=dim)
        return cat(0, 2), cat(1, 1), cat(2, 2), cat(3, 2), cat(4, 2)

    def check(self):
        """Kernel vs plain version; returns (forward, backward) max abs
        errors."""
        from repro_torch.fabric.interface import KernelMode
        from repro_torch.kernels.flash_attention import kernel as FK
        cuda = KernelMode.CUDA
        o, lse = FK.flash_fwd(self.q, self.k, self.v, mode=cuda, **self.kw)
        grads = FK.flash_bwd(self.q, self.k, self.v, o, lse, self.do,
                             mode=cuda, **self.kw)
        o_r, lse_r, *grads_r = self.plain()
        torch.cuda.synchronize()
        f_tol, b_tol = FLASH_TOL[self.dtype]
        rel_tol, lse_tol = FLASH_REL_L2[self.dtype], FLASH_LSE_ABS[self.dtype]
        err_f = max(max_abs_err(o, o_r), lse_abs_err(lse, lse_r))
        err_b = max(max_abs_err(a, b) for a, b in zip(grads, grads_r))
        rel = {"o": rel_l2(o, o_r), **{f"d{n}": rel_l2(a, b) for n, a, b
                                       in zip("qkv", grads, grads_r)}}
        lse_err = lse_abs_err(lse, lse_r)
        res = {"forward": (within(o, o_r, f_tol) and within(lse, lse_r, f_tol)
                           and rel["o"] <= rel_tol and lse_err <= lse_tol),
               "backward": all(within(a, b, b_tol)
                               for a, b in zip(grads, grads_r))
               and all(rel[f"d{n}"] <= rel_tol for n in "qkv")}
        emit("flash.check", case=self.name, **self.shape,
             live_tiles=self.tiles, live_pairs=self.pairs, tol={"forward": f_tol, "backward": b_tol,
                                         "rel_l2": rel_tol, "lse": lse_tol},
             max_abs_err={"forward": err_f, "backward": err_b},
             rel_l2=rel, lse_abs_err=lse_err, **res)
        if not all(res.values()):
            raise AssertionError(f"flash kernel mismatch on {self.name}: "
                                 f"{res}")
        return err_f, err_b

    def timings(self):
        """(kernel, plain, library, bound) ms for forward and backward; the
        library call is ``scaled_dot_product_attention`` (causal, GQA) in
        its head-major layout, the same function at the train shape.  For
        bfloat16 also ``fma_ms``: the float32 FMA kernels, which bfloat16
        took before the tensor-core kernels, on the same inputs."""
        from repro_torch.fabric.interface import KernelMode
        from repro_torch.kernels.flash_attention import kernel as FK
        from repro_torch.kernels.flash_attention import ref
        F = torch.nn.functional
        cuda = KernelMode.CUDA
        q, k, v, do = self.q, self.k, self.v, self.do
        B, Sq, H, D = q.shape
        es = q.element_size()
        rate = BF16_OPS_PER_S if self.dtype == torch.bfloat16 \
            else F32_OPS_PER_S
        fwd_ops = 4 * D * self.pairs                 # QK^T and PV
        io = (2 * q.numel() + k.numel() + v.numel()) * es
        o, lse = FK.flash_fwd(q, k, v, mode=cuda, **self.kw)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = ref.attention_ref(*leaves, **self.kw)
        hm = [t.transpose(1, 2).contiguous().requires_grad_()
              for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*hm, is_causal=True,
                                                 enable_gqa=True)
        do_hm = do.transpose(1, 2).contiguous()
        out_f = {}
        b, by = bound(io + B * H * Sq * 4, fwd_ops, rate)
        out_f["flash_fwd"] = dict(
            ms=time_ms(lambda: FK.flash_fwd(q, k, v, mode=cuda, **self.kw),
                       reps=10),
            plain_ms=time_ms(lambda: ref.attention_fwd_ref(q, k, v,
                                                           **self.kw),
                             reps=5),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                *[t.detach() for t in hm], is_causal=True, enable_gqa=True),
                reps=10),
            bound_ms=b, bound_by=by)
        if self.dtype == torch.bfloat16:
            out_f["flash_fwd"]["fma_ms"] = time_ms(
                lambda: FK.launch_fwd(q, k, v, kernel="fma", **self.kw),
                reps=3)
        # backward reads q, k, v, o, dO, lse and writes dq, dk, dv; it
        # needs S = QK^T, dP = dO V^T, dV, dK and dQ: 2.5x the forward
        b, by = bound(2 * io + B * H * Sq * 4, 2.5 * fwd_ops, rate)
        out_f["flash_bwd"] = dict(
            ms=time_ms(lambda: FK.flash_bwd(q, k, v, o, lse, do, mode=cuda,
                                            **self.kw), reps=10),
            plain_ms=time_ms(lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True), reps=5),
            library_ms=time_ms(lambda: torch.autograd.grad(
                lib_out, hm, do_hm, retain_graph=True), reps=10),
            bound_ms=b, bound_by=by)
        if self.dtype == torch.bfloat16:
            out_f["flash_bwd"]["fma_ms"] = time_ms(
                lambda: FK.launch_bwd(q, k, v, o, lse, do, kernel="fma",
                                      **self.kw), reps=3)
        for t in out_f.values():
            t["library_factor"] = t["ms"] / t["library_ms"]
            t["bound_share"] = t["bound_ms"] / t["ms"]
        emit("flash.time", case=self.name, **self.shape, **out_f)
        return out_f


def flash_phase():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        FlashCase("train", 1, 4096, 4096, 32, 8, 128, bf16, True, 4096, gen),
        FlashCase("banded", 1, 8192, 8192, 32, 8, 128, bf16, True, 4096,
                  gen),
        FlashCase("ragged", 1, 4001, 4001, 32, 8, 128, bf16, True, 4096,
                  gen),
        FlashCase("continuation", 1, 512, 4096, 32, 8, 128, bf16, True,
                  4096, gen),
        FlashCase("noncausal_f32", 1, 1024, 1024, 16, 4, 64, f32, False,
                  None, gen),
        FlashCase("d64", 1, 2048, 2048, 16, 4, 64, bf16, True, None, gen),
        FlashCase("small_window", 1, 2000, 2000, 32, 8, 128, bf16, True, 48,
                  gen),
    ]
    errs = [c.check() for c in cases]
    times = cases[0].timings()
    err = {"flash_fwd": max(e[0] for e in errs),
           "flash_bwd": max(e[1] for e in errs)}
    return err, times


# ----------------------------------------------------------------------
# the served path
# ----------------------------------------------------------------------
N_SLOTS = 4
PROMPT_LEN = 16
MAX_NEW = 8


def serving_config():
    from repro_torch.configs import get_config
    cfg = get_config("mixtral_8x7b")
    return dataclasses.replace(
        cfg, n_layers=2, dtype="bfloat16",
        moe=dataclasses.replace(cfg.moe, dispatch="cuda_kernel"))


def serve(engine, fabric_backend: str, prompts):
    """Serve the 4 requests: 2 at tick 0, then ``Shell.post(Grow)`` after
    4 ticks and 2 more.  Returns (server, shell, wall seconds, ticks)."""
    from repro_torch.core.elastic import Region
    from repro_torch.core.module import ModuleFootprint
    from repro_torch.shell import Grow, Shell, Shrink
    from repro_torch.shell.server import ElasticServer, StreamRequest
    shell = Shell([Region(rid=i, n_chips=8, hbm_bytes=80 * GB)
                   for i in range(2)])
    shell.submit("mixtral", [ModuleFootprint(7 * GB, 2 * 3.2e9, 8192)],
                 app_id=0)
    shell.post(Shrink("mixtral", 0))        # starts on the host port
    server = ElasticServer(shell, n_slots=N_SLOTS,
                           fabric_backend=fabric_backend)
    server.register_engine(0, engine)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts[:2]:
        server.submit(StreamRequest(app_id=0, prompt=p, max_new=MAX_NEW))
    for _ in range(4):
        server.step()
    shell.post(Grow("mixtral"))             # re-route: next admissions -> port 1
    for p in prompts[2:]:
        server.submit(StreamRequest(app_id=0, prompt=p, max_new=MAX_NEW))
    server.run()
    torch.cuda.synchronize()
    return server, shell, time.perf_counter() - t0


# ----------------------------------------------------------------------
# the train path
# ----------------------------------------------------------------------
TRAIN_SEQ = 4096        # train_4k's sequence length; batch cut 256 -> 1
TRAIN_STEPS = 3
TRAIN_LR = 1e-3         # constant; AdamW's other settings are its defaults
PREFILL_REL = 2e-2      # bf16 prefill logits: relative L2, kernel vs plain
F32_SEQ = 1024
F32_REL = 1e-4          # float32 loss and each gradient leaf, see f32_check
SERVE_KERNELS = ("plan_multi", "scatter", "combine")
TRAIN_KERNELS = SERVE_KERNELS + ("flash_fwd", "flash_bwd")
# the flash route each type must take: bfloat16 on the tensor-core kernels,
# float32 on the FMA ones, and no launch on the other route
FLASH_ROUTE = {"bfloat16": "tc", "float32": "fma"}


def check_flash_route(launches, dtype: str, what: str,
                      kernels=("flash_fwd", "flash_bwd")) -> None:
    """Each of ``kernels`` (the counts of ``FK.launch_counts``) ran on
    ``dtype``'s route and never on the other."""
    want = FLASH_ROUTE[dtype]
    other = ({"tc", "fma"} - {want}).pop()
    if not all(launches[f"{k}_{want}"] > 0 for k in kernels) \
            or any(launches[f"{k}_{other}"] for k in kernels):
        raise AssertionError(f"{what} ({dtype}) did not take only the "
                             f"{want} flash kernels: {launches}")


def _kernel_modules():
    from repro_torch.kernels.crossbar_dispatch import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.hamming import kernel as HK
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.ssd import kernel as SK
    return FK, K, SK, RK, HK


def _counts():
    """Launches of every kernel since the last ``_reset_counts``."""
    return {k: v for m in _kernel_modules()
            for k, v in m.launch_counts().items()}


def _reset_counts():
    for m in _kernel_modules():
        m.reset_launch_counts()


def train_phase(engine, smi):
    """3 ``make_train_step`` steps on the served model's parameters (the
    engine's own bf16 tensors, updated in place), then the prefill check.
    Returns the launches of the steps and the step timings."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels import build
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamW
    model, params = engine.model, engine.params
    cfg = model.cfg
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        SEED, 0, 0, 1, 1, TRAIN_SEQ, cfg.vocab).items()}
    opt = AdamW(lr=TRAIN_LR)
    step = make_train_step(model, opt)
    t0 = time.perf_counter()
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    losses, walls = [], []
    for _ in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss))
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    loads = dict(build.load_count)
    emit("train", smi=smi, model=cfg.name, layers=cfg.n_layers,
         batch=1, seq=TRAIN_SEQ, lr=TRAIN_LR, losses=losses,
         step_wall_ms=walls, max_memory_allocated=peak,
         max_memory_gb=peak / 1e9, kernels=launches, library_loads=loads,
         seconds=time.perf_counter() - t0)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"a training loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if any(launches[k] <= 0 for k in TRAIN_KERNELS):
        raise AssertionError(f"a kernel was not launched while training: "
                             f"{launches}")
    check_flash_route(launches, cfg.dtype, "the train step")
    if any(n != 1 for n in loads.values()):
        raise AssertionError(f"a kernel library was loaded twice: {loads}")
    if "--profile" in sys.argv[1:]:
        profile("train.profile", lambda: step(params, state, batch), 1)
    del state
    prefill_check(model, params, batch["tokens"])
    return launches, walls


def _plain(cfg, **kw):
    """The same model on the plain path on the card (``kernel_mode="torch"``:
    attention and the MoE's crossbar on their plain versions)."""
    from repro_torch.models.lm import DenseLM
    return DenseLM(dataclasses.replace(cfg, kernel_mode="torch"), **kw)


@torch.no_grad()
def prefill_check(model, params, tokens):
    """``DenseLM.prefill`` (bf16, S=4096) on the kernel path against the
    plain path on the card.  bf16 rounds at other places in the two
    attentions (the plain path scales q in bf16), which can flip a
    near-tied expert choice, so the last-token logits are held by their
    relative L2 distance."""
    t0 = time.perf_counter()
    logits = model.prefill(params, {"tokens": tokens})
    ref = _plain(model.cfg).prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    rel = float((logits.float() - ref.float()).norm() / ref.float().norm())
    finite = bool(torch.isfinite(logits).all())
    emit("prefill.check", seq=tokens.shape[1], shape=list(logits.shape),
         finite=finite, rel_l2=rel, tol=PREFILL_REL,
         max_abs_err=max_abs_err(logits, ref),
         seconds=time.perf_counter() - t0)
    if not (finite and rel <= PREFILL_REL
            and tuple(logits.shape) == (1, model.cfg.vocab_padded)):
        raise AssertionError("prefill logits disagree with the plain path")


def f32_check(cfg):
    """One float32 loss and backward of a 1-layer full-width model
    (S=1024) on the kernel path against the plain path on the card, TF32
    off.  Both paths plan and route the same packets and differ only in
    the order of the attention sums, so the loss and every gradient leaf
    are held within 1e-4 of the leaf's largest value (an earlier run on an
    H100 measured 3e-6), and every leaf must be nonzero."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.lm import DenseLM
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, n_layers=1, dtype="float32")
    model = DenseLM(cfg32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    params = model.init(gen)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        SEED, 1, 0, 1, 1, F32_SEQ, cfg.vocab).items()}
    out = {}
    for name, m in (("kernel", model), ("plain", _plain(cfg32))):
        _reset_counts()
        loss = m.loss(params, batch)
        out[name] = (float(loss.detach()),
                     torch.autograd.grad(loss, leaves), _counts())
        del loss
    torch.cuda.synchronize()
    (lk, gk, ck), (lp, gp, cp) = out["kernel"], out["plain"]
    rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(gk, gp)]
    nonzero = all(float(a.abs().max()) > 0 for a in gk)
    emit("f32.check", layers=1, seq=F32_SEQ, params=sum(
        p.numel() for p in leaves), loss_kernel=lk, loss_plain=lp,
        grad_leaves=len(rel), grad_rel_max=max(rel), tol=F32_REL,
        grads_nonzero=nonzero, kernel_launches=ck, plain_launches=cp,
        seconds=time.perf_counter() - t0)
    if not (abs(lk - lp) <= F32_REL * abs(lp) and max(rel) <= F32_REL
            and nonzero and all(ck[k] > 0 for k in TRAIN_KERNELS)
            and not any(cp.values())):
        raise AssertionError("float32 loss or gradients disagree with the "
                             "plain path")
    check_flash_route(ck, "float32", "the float32 loss and backward")


def serve_phase(cfg, smi):
    """The served run; returns the engine (its parameters are reused by
    the train phase) and the launches of exactly this run."""
    from repro_torch.kernels import build
    from repro_torch.kernels.crossbar_dispatch import kernel as K
    from repro_torch.models.common import tree_leaves
    from repro_torch.shell.server import ModelEngine
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, PROMPT_LEN).astype(np.int32)
               for _ in range(4)]
    t0 = time.perf_counter()
    engine = ModelEngine(cfg, max_len=PROMPT_LEN + MAX_NEW, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(engine.params))
    emit("model", name=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         d_ff=cfg.d_ff, experts=cfg.moe.n_experts, params=n_params,
         init_seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    engine.prefill(prompts[0])               # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    loads_before = build.load_count[K.LIB_NAME]
    K.reset_launch_counts()
    server, shell, wall = serve(engine, "cuda", prompts)
    launches = K.launch_counts()
    loads_after = build.load_count[K.LIB_NAME]
    comps = sorted(server.completions, key=lambda c: c.rid)
    tokens = sum(len(c.tokens) for c in comps)
    emit("serve", smi=smi, requests=len(comps), ticks=server.tick,
         wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
         epoch=shell.epoch,
         completions=[{"rid": c.rid, "entry_port": c.entry_port,
                       "tokens": c.tokens} for c in comps],
         port_traffic=server.port_traffic.tolist(),
         offered=server.offered_packets, granted=server.granted_packets,
         kernels=launches, library_loads=loads_after,
         register_moves=server.fabric.register_moves)
    if len(comps) != 4 or any(len(c.tokens) != MAX_NEW for c in comps):
        raise AssertionError("not every request completed")
    if sorted({c.entry_port for c in comps}) != [0, 1]:
        raise AssertionError("the Grow did not re-route new admissions")
    if any(launches[k] <= 0 for k in SERVE_KERNELS):
        raise AssertionError(f"a kernel was not launched while serving: "
                             f"{launches}")
    if loads_before != 1 or loads_after != 1:
        raise AssertionError("the kernel library was loaded more than once")
    # the same requests through the plain versions on the card
    plain_cfg = dataclasses.replace(cfg, kernel_mode="torch")
    plain = ModelEngine(plain_cfg, max_len=PROMPT_LEN + MAX_NEW,
                        params=engine.params)
    ref_server, _, ref_wall = serve(plain, "reference", prompts)
    ref_comps = sorted(ref_server.completions, key=lambda c: c.rid)
    same_tokens = [c.tokens for c in comps] == [c.tokens for c in ref_comps]
    same_traffic = (server.port_traffic.tolist()
                    == ref_server.port_traffic.tolist())
    logits, _ = engine.model.decode_step(
        engine.params, engine.model.init_decode_state(1, 4),
        {"tokens": torch.tensor([[1]], dtype=torch.int32, device="cuda")})
    finite = bool(torch.isfinite(logits).all())
    emit("serve.check", plain_wall_s=ref_wall, same_tokens=same_tokens,
         same_port_traffic=same_traffic, logits_shape=list(logits.shape),
         logits_finite=finite, seconds=time.perf_counter() - t0)
    if not (same_tokens and same_traffic and finite
            and tuple(logits.shape) == (1, cfg.vocab_padded)):
        raise AssertionError("served output disagrees with the plain path")
    if "--profile" in sys.argv[1:]:
        tok, state = engine.prefill(prompts[0])
        for _ in range(2):
            tok, state = engine.decode(tok, state)

        def decode():
            nonlocal tok, state
            tok, state = engine.decode(tok, state)
        profile("serve.profile", decode, 8)
    return engine, launches


# ----------------------------------------------------------------------
# the control plane: the seeded serve harness, the manager's scenarios and
# the closed loop over the served Mixtral
# ----------------------------------------------------------------------
# ``benchmarks/serve_bench.py``'s two shapes (read, not imported): 2,048
# front-loaded streams through 1,024 slots, and heavy-tailed arrivals
# through 256 slots under a FailRegion / heal / Shrink / Grow script.
HARNESS_SEED = 11
STEADY_STREAMS, STEADY_SLOTS, STEADY_MAX_NEW = 2048, 1024, 48
STORM_STREAMS, STORM_SLOTS, STORM_GAP = 2048, 256, 0.1
STORM_TICKS = (20, 35, 50, 65)
# every ``ServeReport`` field that is a function of the seed alone
REPORT_INTS = ("n_streams", "n_slots", "ticks", "steady_ticks",
               "completions", "tokens", "reconfigs", "admission_p50_ticks",
               "admission_p99_ticks", "fabric_retraces", "plan_cache_hits",
               "plan_cache_misses", "plan_cache_invalidations",
               "token_digest")
SCENARIO_TICKS = 48
# the closed loop over the Mixtral tenant: a burst at tick 0, then quiet
LOOP_REQUESTS = 16
LOOP_TICKS = 72


def crossbar_loads() -> int:
    from repro_torch.kernels import build
    from repro_torch.kernels.crossbar_dispatch import kernel as K
    return build.load_count[K.LIB_NAME]


def harness_run(arrivals, *, plan_cache: bool, n_slots: int, storm: bool,
                backend: str, device):
    """One ``ServeHarness`` run over a fresh ``ElasticServer``: a 4-region
    shell with one 2-module tenant and a ``SeededEngine`` (serve_bench's
    server)."""
    from repro_torch.core.elastic import Region
    from repro_torch.core.module import ModuleFootprint
    from repro_torch.serve import ReconfigEvent, SeededEngine, ServeHarness
    from repro_torch.shell import Shell
    from repro_torch.shell.server import ElasticServer
    shell = Shell([Region(rid=i, n_chips=8, hbm_bytes=8 * GB)
                   for i in range(4)])
    shell.submit("svc", [ModuleFootprint(GB, 1e9, 4096)] * 2, app_id=0)
    server = ElasticServer(shell, n_slots=n_slots, plan_cache=plan_cache,
                           fabric_backend=backend, device=device)
    server.register_engine(0, SeededEngine(seed=HARNESS_SEED))
    script = ()
    if storm:
        a, b, c, d = STORM_TICKS
        script = [ReconfigEvent(a, lambda sh: sh.fail_region(2), "fail R2"),
                  ReconfigEvent(b, lambda sh: sh.heal_region(2), "heal R2"),
                  ReconfigEvent(c, lambda sh: sh.shrink("svc", 1), "shrink"),
                  ReconfigEvent(d, lambda sh: sh.grow("svc", 1), "grow")]
    return ServeHarness(server, arrivals, reconfigs=script).run(), server


def active_ticks(server) -> int:
    """Ticks on which some slot was active (a request decodes from its
    admission tick to its finishing tick, both included)."""
    return len({t for c in server.completions
                for t in range(c.admitted_tick, c.finished_tick + 1)})


def serve_harness_phase(smi):
    """``ServeHarness`` + ``SeededEngine`` over an ``ElasticServer`` on the
    ``cuda`` fabric on the card, at serve_bench's shapes: the steady state
    with the plan cache on and off, the storm with it on.  Each run is held
    to the same run on the ``reference`` backend on the CPU.  Returns the
    launches of the card runs."""
    from repro_torch.serve import front_loaded_arrivals, heavy_tailed_arrivals
    t0 = time.perf_counter()
    steady = front_loaded_arrivals(STEADY_STREAMS, seed=HARNESS_SEED,
                                   max_new=STEADY_MAX_NEW)
    bursty = heavy_tailed_arrivals(STORM_STREAMS, seed=HARNESS_SEED,
                                   mean_gap_ticks=STORM_GAP)
    runs = (("steady_cache_on", steady, True, STEADY_SLOTS, False),
            ("steady_cache_off", steady, False, STEADY_SLOTS, False),
            ("storm", bursty, True, STORM_SLOTS, True))
    launches = {}
    digests = {}
    for name, arrivals, cache, slots, storm in runs:
        kw = dict(plan_cache=cache, n_slots=slots, storm=storm)
        torch.cuda.synchronize()
        _reset_counts()
        report, server = harness_run(arrivals, backend="cuda", device=None,
                                     **kw)
        torch.cuda.synchronize()
        counts = _counts()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        ref, ref_server = harness_run(arrivals, backend="reference",
                                      device="cpu", **kw)
        plans = counts["plan_multi"]
        want_plans = (report.plan_cache_misses if cache
                      else active_ticks(server))
        same = {f: getattr(report, f) == getattr(ref, f)
                for f in REPORT_INTS}
        same_traffic = (server.port_traffic.tolist()
                        == ref_server.port_traffic.tolist()
                        and (server.offered_packets, server.granted_packets)
                        == (ref_server.offered_packets,
                            ref_server.granted_packets))
        digests[name] = report.token_digest
        emit(f"serve_harness.{name}", smi=smi, streams=report.n_streams,
             slots=report.n_slots, ticks=report.ticks,
             steady_ticks=report.steady_ticks, tokens=report.tokens,
             completions=report.completions, reconfigs=report.reconfigs,
             wall_s=report.wall_s, tokens_per_s=report.tokens_per_s,
             tick_p50_us=report.tick_p50_us, tick_p99_us=report.tick_p99_us,
             steady_tick_p50_us=report.steady_tick_p50_us,
             steady_tick_p99_us=report.steady_tick_p99_us,
             admission_p50_ticks=report.admission_p50_ticks,
             admission_p99_ticks=report.admission_p99_ticks,
             plan_cache_hits=report.plan_cache_hits,
             plan_cache_misses=report.plan_cache_misses,
             plan_cache_invalidations=report.plan_cache_invalidations,
             fabric_retraces=report.fabric_retraces,
             trace_counts=server.fabric.trace_counts,
             plan_launches=plans, expected_plan_launches=want_plans,
             library_loads=crossbar_loads(),
             token_digest=report.token_digest,
             cpu_reference={"tokens_per_s": ref.tokens_per_s,
                            "tick_p50_us": ref.tick_p50_us,
                            "steady_tick_p50_us": ref.steady_tick_p50_us,
                            "same_as_card": same,
                            "same_port_traffic": same_traffic})
        if not (all(same.values()) and same_traffic):
            raise AssertionError(f"serve_harness {name} on the card "
                                 f"disagrees with the CPU reference: {same}")
        if report.completions != report.n_streams:
            raise AssertionError(f"serve_harness {name}: not every stream "
                                 f"completed")
        if (report.fabric_retraces != 1
                or server.fabric.trace_counts["plan"] != 1):
            raise AssertionError(f"serve_harness {name}: the plan ran under "
                                 f"{server.fabric.trace_counts} signatures")
        if crossbar_loads() != 1:
            raise AssertionError("the crossbar library was loaded twice")
        if not 0 < plans == want_plans:
            raise AssertionError(f"serve_harness {name}: {plans} plan "
                                 f"launches, not {want_plans}")
        if storm and not (report.reconfigs == len(STORM_TICKS)
                          == report.plan_cache_invalidations):
            raise AssertionError(f"serve_harness {name}: "
                                 f"{report.plan_cache_invalidations} cache "
                                 f"invalidations for {report.reconfigs} "
                                 f"posts")
    if digests["steady_cache_on"] != digests["steady_cache_off"]:
        raise AssertionError("the plan cache changed the token digest")
    emit("serve_harness", seconds=time.perf_counter() - t0,
         kernels=launches)
    return launches


def manager_scenarios_phase(smi):
    """``run_scenario`` on the card (``fabric_backend="cuda"``): bursty,
    production on a ``ServerPool`` of 4 servers over 24 regions, and the
    adversarial scenario under ``adversarial_policy``, each held row for
    row to the same call on ``reference`` on the CPU; production is also
    recorded on the card and replayed through ``RecordedWorkload``.
    Returns the launches of the three card runs."""
    from repro_torch.manager import scenarios
    t0 = time.perf_counter()
    out_dir = os.path.join(HERE, "build", "manager")
    os.makedirs(out_dir, exist_ok=True)
    runs = (("bursty", {}, None),
            ("production", {"n_regions": 24, "n_servers": 4}, None),
            ("adversarial", {}, "adversarial_policy"))
    launches = {}
    for kind, kw, policy in runs:
        def policy_kw():
            return ({} if policy is None
                    else {"policy": getattr(scenarios, policy)()})
        record = (os.path.join(out_dir, f"{kind}.jsonl")
                  if kind == "production" else None)
        torch.cuda.synchronize()
        _reset_counts()
        t1 = time.perf_counter()
        res = scenarios.run_scenario(kind, seed=SEED, ticks=SCENARIO_TICKS,
                                     fabric_backend="cuda",
                                     record_path=record, **kw, **policy_kw())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = _counts()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        got = res.to_json()
        t1 = time.perf_counter()
        want = scenarios.run_scenario(kind, seed=SEED, ticks=SCENARIO_TICKS,
                                      fabric_backend="reference",
                                      device="cpu", **kw,
                                      **policy_kw()).to_json()
        cpu_wall = time.perf_counter() - t1
        rows_equal = sum(a == b for a, b in zip(got["trace"], want["trace"]))
        replay_equal = None
        if record is not None:
            replay = scenarios.run_scenario(
                scenarios.RecordedWorkload.load(record),
                fabric_backend="cuda", **policy_kw())
            replay_equal = replay.to_json() == got
        emit(f"manager_scenarios.{kind}", smi=smi, seed=SEED,
             ticks=SCENARIO_TICKS, n_servers=res.n_servers,
             wall_s=wall, cpu_reference_wall_s=cpu_wall,
             decisions=len(res.decisions), events=res.event_counts,
             rejected_events=res.rejected_events,
             completions=res.completions, max_queue=res.max_queue,
             final_utilization=res.final_utilization,
             slo_violations=res.slo_violations,
             fabric_retraces=res.fabric_retraces,
             plan_launches=counts["plan_multi"],
             library_loads=crossbar_loads(),
             trace_rows_equal=rows_equal, same_as_cpu=got == want,
             replay_equal=replay_equal)
        if got != want:
            raise AssertionError(f"manager_scenarios {kind} on the card "
                                 f"disagrees with the CPU reference "
                                 f"({rows_equal} of {len(want['trace'])} "
                                 f"rows equal)")
        if replay_equal is False:
            raise AssertionError(f"the replayed {kind} trace differs")
        if crossbar_loads() != 1:
            raise AssertionError("the crossbar library was loaded twice")
        if counts["plan_multi"] <= 0:
            raise AssertionError(f"manager_scenarios {kind} launched no "
                                 f"plan kernel")
    emit("manager_scenarios", seconds=time.perf_counter() - t0,
         kernels=launches)
    return launches


def closed_loop(engine, fabric_backend: str, prompts):
    """The paper's resource manager over one served tenant: Mixtral with 4
    modules in a 4-region shell of 80 GB regions, started on 1 region;
    ``slots_per_region=1`` makes each region one decode slot, and a
    ``Hysteresis`` manager ticks once per server tick (deciding every
    second).  The burst at tick 0 grows the tenant; the quiet stretch after
    it shrinks it again.  Returns (server, manager, placed regions per
    tick, wall ms per tick, wall seconds)."""
    from repro_torch.core.elastic import Region
    from repro_torch.core.module import ModuleFootprint
    from repro_torch.manager import Hysteresis, Manager
    from repro_torch.shell import Shell, Shrink
    from repro_torch.shell.server import ElasticServer, StreamRequest
    shell = Shell([Region(rid=i, n_chips=8, hbm_bytes=80 * GB)
                   for i in range(4)])
    shell.submit("mixtral", [ModuleFootprint(7 * GB, 2 * 3.2e9, 8192)] * 4,
                 app_id=0)
    shell.post(Shrink("mixtral", 1))
    server = ElasticServer(shell, n_slots=N_SLOTS, slots_per_region=1,
                           fabric_backend=fabric_backend)
    server.register_engine(0, engine)
    manager = Manager(shell, Hysteresis(), probes=[server.probe()],
                      interval=2)
    for p in prompts:
        server.submit(StreamRequest(app_id=0, prompt=p, max_new=MAX_NEW))
    placed, tick_ms = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LOOP_TICKS):
        t1 = time.perf_counter()
        server.step()
        manager.step()
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t1) * 1e3)
        placed.append(shell.state.find_tenant("mixtral").placed_count)
    return server, manager, placed, tick_ms, time.perf_counter() - t0


def loop_decisions(manager):
    return [(d.tick, d.kinds(), [dataclasses.astuple(e) for e in d.events],
             dataclasses.asdict(d.signals), len(d.rejected))
            for d in manager.decisions]


def manager_mixtral_phase(engine, smi):
    """The closed loop on the served Mixtral (the serve phase's engine, MoE
    on ``cuda_kernel``, server fabric on ``cuda``), then on the plain path
    on the card: token streams and decisions equal, a Grow then a Shrink,
    the placed region count following them, library loads 1.  Returns the
    launches of the kernel run."""
    from repro_torch.shell.server import ModelEngine
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, engine.cfg.vocab, PROMPT_LEN).astype(np.int32)
               for _ in range(LOOP_REQUESTS)]
    loads_before = crossbar_loads()
    _reset_counts()
    server, manager, placed, tick_ms, wall = closed_loop(engine, "cuda",
                                                         prompts)
    launches = _counts()
    plain = ModelEngine(dataclasses.replace(engine.cfg, kernel_mode="torch"),
                        max_len=engine.max_len, params=engine.params)
    ref_server, ref_manager, ref_placed, _, ref_wall = closed_loop(
        plain, "reference", prompts)
    comps = sorted(server.completions, key=lambda c: c.rid)
    ref_comps = sorted(ref_server.completions, key=lambda c: c.rid)
    same_tokens = ([(c.tokens, c.entry_port) for c in comps]
                   == [(c.tokens, c.entry_port) for c in ref_comps])
    decisions = loop_decisions(manager)
    same_decisions = decisions == loop_decisions(ref_manager)
    acted = [(d.tick, d.kinds()) for d in manager.decisions if d.events]
    kinds = [k for _, ks in acted for k in ks]
    follows = all(placed[t] - (placed[t - 1] if t else 1)
                  == ks.count("Grow") - ks.count("Shrink")
                  for t, ks in acted)
    # decode ticks: some slot active, nothing admitted on the tick
    busy = {t for c in comps for t in range(c.admitted_tick + 1,
                                            c.finished_tick + 1)}
    admits = {c.admitted_tick for c in comps}
    decode_ms = [tick_ms[t] for t in sorted(busy - admits)]
    tokens = sum(len(c.tokens) for c in comps)
    emit("manager_mixtral", smi=smi, model=engine.cfg.name,
         layers=engine.cfg.n_layers, requests=len(comps), ticks=LOOP_TICKS,
         tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
         decode_tick_ms_p50=statistics.median(decode_ms),
         decode_tick_ms_max=max(decode_ms), decode_ticks=len(decode_ms),
         decisions=acted, placed_regions=placed,
         epoch=server.shell.epoch, same_tokens=same_tokens,
         same_decisions=same_decisions, placed_follows=follows,
         plain_wall_s=ref_wall, plain_placed_equal=placed == ref_placed,
         fabric_retraces=server.fabric.trace_count, kernels=launches,
         library_loads=crossbar_loads(), seconds=time.perf_counter() - t0)
    if len(comps) != LOOP_REQUESTS or any(len(c.tokens) != MAX_NEW
                                          for c in comps):
        raise AssertionError("manager_mixtral: not every request completed")
    if not (same_tokens and same_decisions and placed == ref_placed):
        raise AssertionError("manager_mixtral disagrees with the plain path")
    if not ("Grow" in kinds and "Shrink" in kinds[kinds.index("Grow"):]):
        raise AssertionError(f"the manager did not grow and then shrink the "
                             f"tenant: {acted}")
    if not follows or max(placed) <= 1:
        raise AssertionError(f"the placed regions do not follow the "
                             f"decisions: {placed}")
    if any(launches[k] <= 0 for k in SERVE_KERNELS):
        raise AssertionError(f"a kernel was not launched in the closed "
                             f"loop: {launches}")
    if loads_before != 1 or crossbar_loads() != 1:
        raise AssertionError("the crossbar library was loaded twice")
    return launches


# ----------------------------------------------------------------------
# the recurrent families: SSD, RG-LRU and flash attention at head dim 256
# ----------------------------------------------------------------------
# SSD is held to the plain chunked version (``ssd_chunked``) and, at a small
# S, to the sequential oracle (``ssd_ref``): float32 within 2e-4 of the
# chunked version (the same algebra summed in another order) and 5e-4 of
# the oracle (the JAX package's tolerance for its kernel); bfloat16 within
# 5e-2 element-wise and 1e-2 relative L2 (x, B, C rounded to bf16 and y
# rounded once, in both).  The final state within 5e-4 absolute and 5e-3
# relative in both types.
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
SSD_ORACLE_TOL = 5e-4
SSD_REL_L2 = 1e-2
# RG-LRU sums sequentially within tiles and composes the tiles in order:
# within 1e-5 of the oracle, and 5e-5 of the doubling scan (the JAX
# package's tolerance for its kernel); h in bf16 also within one bf16 ulp
# of |h| (2^-7 |h| bounds it) of the plain version's.
RGLRU_TOL = 5e-5
RGLRU_ORACLE_TOL = 1e-5
BF16_ULP = 2.0 ** -7
PREFILL_SEQ = 32768          # prefill_32k's sequence length; batch 32 -> 1
RECURRENT_F32_SEQ = 512      # the float32 check's prompt
MAMBA = dict(H=48, P=64, N=128, chunk=256)
RGEMMA = dict(L=4096, H=16, Kv=1, D=256, window=2048)
# The end-to-end bf16 S=32768 last-token logits of a full-depth random model
# are held within this many times a control measured in the same run: how
# far the plain path's own logits move under a difference of rounding size
# (``rounding_controls``).  Every block is held to ``PREFILL_REL`` besides.
PREFILL_CONTROL_FACTOR = 3.0


def ssd_inputs(B, S, H, P, N, dtype, gen):
    """Model-layout inputs of the SSD scan: x [B,S,H,P], dt [B,S,H],
    A [H], B and C [B,S,N]."""
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = rn(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(rn(B, S, H) - 2.0)
    A = -torch.exp(rn(H) * 0.5)
    return x, dt, A, (rn(B, S, N) * 0.3).to(dtype), \
        (rn(B, S, N) * 0.3).to(dtype)


def ssd_check(name, S, dtype, gen, oracle=False):
    """The kernel (``ssd_scan`` on CUDA) against ``ssd_chunked`` and, when
    asked, ``ssd_ref``; returns the largest absolute error."""
    from repro_torch.fabric.interface import KernelMode
    from repro_torch.kernels.ssd import ref as sref
    from repro_torch.kernels.ssd.ops import ssd_scan
    from repro_torch.models.ssm import ssd_chunked
    H, P, N, chunk = (MAMBA[k] for k in ("H", "P", "N", "chunk"))
    x, dt, A, Bm, Cm = ssd_inputs(1, S, H, P, N, dtype, gen)
    y, h = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, mode=KernelMode.CUDA)
    yp, hp = ssd_chunked(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    tol = SSD_TOL[dtype]
    res = {"y": within(y, yp, tol), "h_last": bool(torch.isclose(
        h.double(), hp.double(), atol=5e-4, rtol=5e-3).all())}
    rel = rel_l2(y, yp)
    if dtype == torch.bfloat16:
        res["y_rel_l2"] = rel <= SSD_REL_L2
    out = {"vs_chunked": max(max_abs_err(y, yp), max_abs_err(h, hp))}
    if oracle:
        dth = dt.transpose(1, 2)
        yo, ho = sref.ssd_ref(x.transpose(1, 2), dth * A[None, :, None],
                              dth, Bm, Cm)
        yo = yo.transpose(1, 2)
        torch.cuda.synchronize()
        res["oracle"] = (within(y, yo, SSD_ORACLE_TOL)
                         and within(h, ho, SSD_ORACLE_TOL))
        out["vs_oracle"] = max(max_abs_err(y, yo), max_abs_err(h, ho))
    emit("ssd.check", case=name, B=1, S=S, H=H, P=P, N=N, chunk=min(chunk, S),
         dtype=str(dtype).replace("torch.", ""), max_abs_err=out,
         rel_l2=rel, tol={"y": tol, "oracle": SSD_ORACLE_TOL,
                          "rel_l2": SSD_REL_L2}, **res)
    if not all(res.values()):
        raise AssertionError(f"SSD kernel disagrees on {name}: {res}")
    return max(out.values())


def ssd_phase():
    """SSD at Mamba-2 780M's widths: bf16 at S=4096 and 32768, float32 at
    S=1024 (also against the oracle), and S=200, below the chunk; timings
    at S=32768 bf16."""
    from repro_torch.fabric.interface import KernelMode
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd import ref as sref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    bf16, f32 = torch.bfloat16, torch.float32
    err = max(ssd_check("mamba_4k", 4096, bf16, gen),
              ssd_check("mamba_32k", PREFILL_SEQ, bf16, gen),
              ssd_check("f32_1k", 1024, f32, gen, oracle=True),
              ssd_check("below_chunk_200", 200, f32, gen, oracle=True))
    H, P, N, Q = (MAMBA[k] for k in ("H", "P", "N", "chunk"))
    S = PREFILL_SEQ
    x, dt, A, Bm, Cm = ssd_inputs(1, S, H, P, N, bf16, gen)
    xh = x.transpose(1, 2).contiguous()
    dth = dt.transpose(1, 2).contiguous()
    dAh = dth * A[None, :, None]
    es = x.element_size()
    n_bytes = (2 * x.numel() * es + 2 * dth.numel() * 4
               + 2 * Bm.numel() * es + H * P * N * 4)
    nc = S // Q
    tri = Q * (Q + 1) // 2                     # causal half of a chunk
    n_ops = nc * (2 * tri * N                  # C.B^T, once per chunk
                  + H * (2 * tri * P           # G x
                         + 2 * 2 * Q * P * N))  # C.h and the state update
    b, by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
    t = dict(ms=time_ms(lambda: SK.ssd_call(xh, dAh, dth, Bm, Cm, chunk=Q,
                                            mode=KernelMode.CUDA), reps=10),
             plain_ms=time_ms(lambda: sref.ssd_call_ref(xh, dAh, dth, Bm, Cm,
                                                        Q), reps=3),
             library_ms=None, bound_ms=b, bound_by=by, bytes=n_bytes,
             ops=n_ops)
    emit("ssd.time", B=1, S=S, H=H, P=P, N=N, chunk=Q, dtype="bfloat16", **t)
    return err, t


def rglru_phase():
    """RG-LRU at RecurrentGemma-9B's width: the kernel against the
    doubling scan at B=1, S=32768, L=4096, against the oracle at S=4096,
    and through ``rglru_scan_kernel`` with an initial state against
    ``rglru_scan``; the model's entry on bf16 u and float32 a bit-equal to
    the float32 kernel on u.float() followed by the cast (with and without
    an initial state folded in first) and against the plain version on
    the same bf16 inputs, and one kernel a call; timings at S=32768."""
    from repro_torch.fabric.interface import KernelMode
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru import ref as rref
    from repro_torch.kernels.rglru.ops import rglru_scan_kernel
    from repro_torch.kernels.timing import device_profile
    from repro_torch.models.rglru import rglru_scan
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 4)
    L, S = RGEMMA["L"], PREFILL_SEQ
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    a = torch.sigmoid(rn(1, S, L) + 2.0) * 0.98 + 0.01
    b = rn(1, S, L) * 0.5
    cuda = KernelMode.CUDA
    h, hl = RK.rglru_call(a, b, mode=cuda)
    hp, hlp = rref.rglru_call_ref(a, b)
    ho, hlo = rref.rglru_ref(a[:, :4096], b[:, :4096])
    h0 = rn(1, L) * 0.3
    hk, hlk = rglru_scan_kernel(b, a, h0, mode=cuda)
    hs, hls = rglru_scan(b, a, h0)
    torch.cuda.synchronize()
    res = {"vs_scan": within(h, hp, RGLRU_TOL) and within(hl, hlp, RGLRU_TOL),
           "vs_oracle": within(h[:, :4096], ho, RGLRU_ORACLE_TOL),
           "with_h0": within(hk, hs, RGLRU_TOL) and within(hlk, hls,
                                                           RGLRU_TOL)}
    errs = {"vs_scan": max(max_abs_err(h, hp), max_abs_err(hl, hlp)),
            "vs_oracle": max_abs_err(h[:, :4096], ho),
            "with_h0": max(max_abs_err(hk, hs), max_abs_err(hlk, hls))}
    del hp, ho, hk, hs
    # the model's entry: u in bf16, h0 folded and h cast inside the kernel
    u = b.to(torch.bfloat16)
    entry_errs = {}
    for name, state in (("entry_bf16", None), ("entry_bf16_h0", h0)):
        he, hle = rglru_scan_kernel(u, a, state, mode=cuda)
        bf = u.float()
        if state is not None:
            bf = torch.cat([bf[:, :1] + a[:, :1] * state[:, None],
                            bf[:, 1:]], dim=1)
        hf, hlf = RK.rglru_call(a, bf, mode=cuda)
        torch.cuda.synchronize()
        res[name] = (torch.equal(he, hf.to(torch.bfloat16))
                     and torch.equal(hle, hlf))
        del hf, bf
        hp, hlp = rglru_scan(u, a, state)        # plain, on the same inputs
        torch.cuda.synchronize()
        diff = (he.double() - hp.double()).abs()
        res[name + "_vs_plain"] = (
            bool((diff <= RGLRU_TOL + BF16_ULP * hp.double().abs()).all())
            and within(hle, hlp, RGLRU_TOL))
        entry_errs[name + "_vs_plain"] = max(float(diff.max()),
                                             max_abs_err(hle, hlp))
        del he, hp, diff
    emit("rglru.check", B=1, S=S, L=L, dtype="float32", oracle_seq=4096,
         entry_dtypes={"u": "bfloat16", "a": "float32", "h": "bfloat16"},
         max_abs_err=errs, entry_max_abs_err=entry_errs,
         tol={"scan": RGLRU_TOL, "oracle": RGLRU_ORACLE_TOL,
              "entry": "bit-equal",
              "entry_vs_plain": f"{RGLRU_TOL} + {BF16_ULP} |h|"}, **res)
    if not all(res.values()):
        raise AssertionError(f"RG-LRU kernel disagrees: {res}")
    n_bytes = 3 * a.numel() * 4 + L * 4
    bnd, by = bound(n_bytes, 2 * a.numel(), F32_OPS_PER_S)
    entry = lambda: rglru_scan_kernel(u, a, mode=cuda)  # noqa: E731
    # a, u and h once each (4 + 2 + 2 bytes an element) and h_last
    entry_bound, _ = bound(8 * a.numel() + L * 4, 2 * a.numel(),
                           F32_OPS_PER_S)
    prof = device_profile(entry, calls=10, kernel="rglru_kernel")
    t = dict(ms=time_ms(lambda: RK.rglru_call(a, b, mode=cuda), reps=10),
             plain_ms=time_ms(lambda: rref.rglru_call_ref(a, b), reps=3),
             library_ms=None, bound_ms=bnd, bound_by=by, bytes=n_bytes,
             entry_ms=time_ms(entry, reps=10), entry_bound_ms=entry_bound,
             entry_device_ms=prof["device_ms"],
             kernels_per_call=prof["kernels"] + prof["memsets"],
             entry_kernels=prof["names"])
    emit("rglru.time", B=1, S=S, L=L, dtype="float32", **t)
    if t["kernels_per_call"] != 1:
        raise AssertionError(f"rglru_scan_kernel on bf16 u is not one "
                             f"kernel a call: {prof}")
    return max(errs.values()), t


def flash_d256_phase():
    """The flash forward at RecurrentGemma's attention shape (B=1, S=32768,
    H=16, Kv=1, D=256, window 2048, bf16, on the tensor-core kernel) against
    the plain version, run on query slices of 2048 rows with the keys they
    see (the whole [S, S] score matrix would take 68 GB); timed against the
    slices, against ``scaled_dot_product_attention`` with the window as a
    boolean mask (memory-efficient backend, kv head repeated for the 16
    query heads) and against the FMA kernel on the same inputs
    (``fma_ms``)."""
    from repro_torch.fabric.interface import KernelMode
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    S, H, Kv, D, W = PREFILL_SEQ, *(RGEMMA[k] for k in ("H", "Kv", "D",
                                                         "window"))
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = mk(1, S, H, D), mk(1, S, Kv, D), mk(1, S, Kv, D)
    kw = dict(causal=True, window=W, q_offset=0)
    o, lse = FK.flash_fwd(q, k, v, mode=KernelMode.CUDA, **kw)

    def plain():
        outs = []
        for r0 in range(0, S, 2048):
            k0 = max(0, r0 - W + 1)
            outs.append(ref.attention_fwd_ref(
                q[:, r0:r0 + 2048], k[:, k0:r0 + 2048], v[:, k0:r0 + 2048],
                causal=True, window=W, q_offset=r0 - k0))
        return (torch.cat([x[0] for x in outs], 1),
                torch.cat([x[1] for x in outs], 2))

    o_r, lse_r = plain()
    torch.cuda.synchronize()
    dt = torch.bfloat16
    f_tol, rel_tol, lse_tol = (FLASH_TOL[dt][0], FLASH_REL_L2[dt],
                               FLASH_LSE_ABS[dt])
    rel, lse_err = rel_l2(o, o_r), lse_abs_err(lse, lse_r)
    ok = (within(o, o_r, f_tol) and rel <= rel_tol and lse_err <= lse_tol)
    err = max(max_abs_err(o, o_r), lse_err)
    tiles = H * flash_live_tiles(S, S, True, W, 0, torch.bfloat16, D)
    pairs = H * flash_live_pairs(S, S, True, W, 0)
    emit("flash_d256.check", B=1, S=S, H=H, Kv=Kv, D=D, window=W,
         dtype="bfloat16", live_tiles=tiles, live_pairs=pairs,
         max_abs_err=err, rel_l2=rel,
         lse_abs_err=lse_err, tol={"forward": f_tol, "rel_l2": rel_tol,
                                   "lse": lse_tol}, forward=ok)
    if not ok:
        raise AssertionError("flash forward at head dim 256 disagrees")
    del o_r, lse_r
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + H * S * 4
    b, by = bound(n_bytes, 4 * D * pairs, BF16_OPS_PER_S)
    hm = [t.transpose(1, 2).expand(1, H, S, D) if t.shape[2] == 1
          else t.transpose(1, 2) for t in (q, k, v)]
    hm = [t.contiguous() for t in hm]
    pos = torch.arange(S, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def library():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(*hm, attn_mask=mask)

    t = dict(ms=time_ms(lambda: FK.flash_fwd(q, k, v, mode=KernelMode.CUDA,
                                             **kw), reps=5),
             plain_ms=time_ms(plain, reps=2, warmup=1),
             library_ms=time_ms(library, reps=5),
             bound_ms=b, bound_by=by,
             fma_ms=time_ms(lambda: FK.launch_fwd(q, k, v, kernel="fma",
                                                  **kw), reps=3, warmup=1))
    t["library_factor"] = t["ms"] / t["library_ms"]
    t["fma_factor"] = t["ms"] / t["fma_ms"]
    t["bound_share"] = t["bound_ms"] / t["ms"]
    emit("flash_d256.time", B=1, S=S, H=H, Kv=Kv, D=D, window=W,
         dtype="bfloat16", route=FK.route(torch.bfloat16, D), **t)
    return err, t


def recurrent_config(arch, **kw):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **{"dtype": "bfloat16",
                                                     **kw})


def smoke_widths_phase():
    """Every ported family's smoke config on the kernels against the plain
    path (``repro_torch.launch.smoke_widths``): the narrow widths that the
    full configs do not run.  Returns the launches of the kernel paths,
    summed over the configs."""
    from repro_torch.launch import smoke_widths
    t0 = time.perf_counter()
    launches = dict.fromkeys(_counts(), 0)
    bad = []
    for arch in smoke_widths.ARCHS:
        t1 = time.perf_counter()
        res = smoke_widths.check(arch, SEED)
        emit("smoke_widths.check", **res, seconds=time.perf_counter() - t1)
        for k, n in res["kernels"].items():
            launches[k] += n
        if not res["ok"]:
            bad.append(arch)
    emit("smoke_widths", kernels=launches, seconds=time.perf_counter() - t0)
    if bad:
        raise AssertionError(f"smoke configs disagree on the kernels: {bad}")
    _reset_counts()
    return launches


# the kernels each recurrent phase must launch on its main path
RECURRENT_KERNELS = {"mamba2_780m": ("plan_multi", "ssd"),
                     "recurrentgemma_9b": ("plan_multi", "rglru",
                                           "flash_fwd_d256")}


def serve_recurrent_phase(arch, phase, smi):
    """A full public model (every layer, bf16, random weights from the
    seed) behind ``ElasticServer`` on the ``cuda`` fabric, the requests and
    the ``Shell.post(Grow)`` of the Mixtral serve phase; then ``prefill``
    at S=32768, B=1.  Launches are counted over exactly the serve and the
    prefill.  Then the same requests and prefill on the plain path: token
    streams and port traffic equal, and each block of the bf16 prefill
    within ``PREFILL_REL`` of the plain path's on the same input
    (``blockwise_rel_l2``), and the end-to-end last-token logits within
    ``PREFILL_CONTROL_FACTOR`` times ``rounding_controls``: at full depth
    the random model carries a rounding-sized difference to a distance of
    the order of 1e-1 (PERF.md gives the readings), so a fixed limit would
    not hold, while a gross divergence still fails.  Then the float32
    check.  Returns the launches."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.shell.server import ModelEngine
    cfg = recurrent_config(arch)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, PROMPT_LEN).astype(np.int32)
               for _ in range(4)]
    t0 = time.perf_counter()
    engine = ModelEngine(cfg, max_len=PROMPT_LEN + MAX_NEW, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(engine.params))
    emit(f"{phase}.model", name=cfg.name, family=cfg.family,
         layers=cfg.n_layers, d_model=cfg.d_model, params=n_params,
         param_bytes=n_params * 2, init_seconds=time.perf_counter() - t0)
    engine.prefill(prompts[0])               # warm-up (cuBLAS, allocator)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, PREFILL_SEQ)).astype(np.int32)).cuda()
    model, params = engine.model, engine.params
    with torch.no_grad():
        model.prefill(params, {"tokens": tokens[:, :2048]})   # warm-up
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    server, shell, wall = serve(engine, "cuda", prompts)
    serve_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    with torch.no_grad():
        logits = model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    prefill_peak = torch.cuda.max_memory_allocated()
    launches = _counts()
    comps = sorted(server.completions, key=lambda c: c.rid)
    n_tok = sum(len(c.tokens) for c in comps)
    emit(phase, smi=smi, model=cfg.name, requests=len(comps),
         ticks=server.tick, wall_s=wall, tokens=n_tok,
         tokens_per_s=n_tok / wall, serve_max_memory_allocated=serve_peak,
         prefill_seq=PREFILL_SEQ, prefill_s=prefill_s,
         prefill_tokens_per_s=PREFILL_SEQ / prefill_s,
         prefill_max_memory_allocated=prefill_peak,
         completions=[{"rid": c.rid, "entry_port": c.entry_port,
                       "tokens": c.tokens} for c in comps],
         port_traffic=server.port_traffic.tolist(), kernels=launches,
         seconds=time.perf_counter() - t0)
    if len(comps) != 4 or any(len(c.tokens) != MAX_NEW for c in comps):
        raise AssertionError("not every request completed")
    if sorted({c.entry_port for c in comps}) != [0, 1]:
        raise AssertionError("the Grow did not re-route new admissions")
    missing = [k for k in RECURRENT_KERNELS[arch] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{phase}: not launched: {missing}")
    if "flash_fwd_d256" in RECURRENT_KERNELS[arch]:
        check_flash_route(launches, cfg.dtype, phase, ("flash_fwd_d256",))

    # the same requests and the same prefill on the plain path
    t0 = time.perf_counter()
    plain = ModelEngine(dataclasses.replace(cfg, kernel_mode="torch"),
                        max_len=PROMPT_LEN + MAX_NEW, params=params)
    ref_server, _, ref_wall = serve(plain, "reference", prompts)
    ref_comps = sorted(ref_server.completions, key=lambda c: c.rid)
    same_tokens = [c.tokens for c in comps] == [c.tokens for c in ref_comps]
    same_traffic = (server.port_traffic.tolist()
                    == ref_server.port_traffic.tolist())
    t1 = time.perf_counter()
    with torch.no_grad():
        ref_logits = plain.model.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        plain_prefill_s = time.perf_counter() - t1
        control_name, control = rounding_controls(plain.model, params,
                                                  tokens, ref_logits)
        blocks = blockwise_rel_l2(model, plain.model, params, tokens)
    rel = rel_l2(logits.float(), ref_logits.float())
    finite = bool(torch.isfinite(logits).all())
    ok = (same_tokens and same_traffic and finite
          and max(blocks) <= PREFILL_REL
          and rel <= PREFILL_CONTROL_FACTOR * control
          and tuple(logits.shape) == (1, cfg.vocab_padded))
    emit(f"{phase}.check", plain_wall_s=ref_wall, same_tokens=same_tokens,
         same_port_traffic=same_traffic, prefill_finite=finite,
         prefill_shape=list(logits.shape), prefill_rel_l2=rel,
         control=control_name, control_rel_l2=control,
         prefill_tol=PREFILL_CONTROL_FACTOR * control,
         block_rel_l2_max=max(blocks),
         block_rel_l2=blocks, block_tol=PREFILL_REL,
         plain_prefill_s=plain_prefill_s, seconds=time.perf_counter() - t0)
    if not ok:
        raise AssertionError(f"{phase} disagrees with the plain path")
    if "--profile" in sys.argv[1:]:
        with torch.no_grad():
            profile(f"{phase}.prefill_profile",
                    lambda: model.prefill(params, {"tokens": tokens}), 1)
    del engine, plain, model, params, server, ref_server, logits, ref_logits
    torch.cuda.empty_cache()
    recurrent_f32_check(arch, phase)
    return launches


def blockwise_rel_l2(model, plain_model, params, tokens):
    """Every block of the backbone, on the kernel path and on the plain
    path, fed the same input (the plain path's hidden state): the relative
    L2 distance of the two blocks' contributions (output minus input), one
    per block.  This holds every kernel call of the full-depth prefill at
    its real shape without the divergence that the random model's depth
    adds to the end-to-end logits (see ``rounding_controls``)."""
    x = model._inputs_embed(params, {"tokens": tokens})
    S = tokens.shape[1]
    out = []
    for blk, plain_blk in zip(model.blocks(params, S),
                              plain_model.blocks(params, S)):
        y, y_plain = blk(x), plain_blk(x)
        out.append(rel_l2((y.float() - x.float()),
                          (y_plain.float() - x.float())))
        x = y_plain
    return out


def rounding_controls(plain_model, params, tokens, ref_logits):
    """How far the plain path's own last-token logits move under a
    difference of the size of bf16 rounding, the scale of divergence that
    the random model's depth gives any two computations that round
    differently.  Returns (name, relative L2): for the SSM ``other_chunk``,
    the plain SSD scan at chunk 128 instead of 256 (the same function
    summed in another order, as the kernel sums it); for the hybrid
    ``one_ulp``, every element of the last token's embedding row moved by
    one bf16 ulp (restored after)."""
    cfg = plain_model.cfg
    if cfg.ssm is not None:
        other = type(plain_model)(dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=cfg.ssm.chunk // 2)),
            device=plain_model.device)
        return "other_chunk", rel_l2(
            other.prefill(params, {"tokens": tokens}).float(),
            ref_logits.float())
    bits = params["embed"][int(tokens[0, -1])].view(torch.int16)
    bits += 1
    try:
        nudged = plain_model.prefill(params, {"tokens": tokens})
    finally:
        bits -= 1
    return "one_ulp", rel_l2(nudged.float(), ref_logits.float())


def recurrent_f32_check(arch, phase):
    """A float32 copy of the model at full width, cut to its first 2
    layers (the hybrid to 3: one whole group, two recurrent blocks and the
    local-attention block), TF32 off: ``prefill`` logits and the ``loss``
    value on the kernel path against the plain path within 1e-4 relative
    (the scans sum in other orders), and ``prefill``'s greedy token equal
    to the token ``ModelEngine`` gets by replaying the same 512-token
    prompt through ``decode_step`` (the scan against the recurrence)."""
    from repro_torch.runtime.serve import greedy_tokens
    from repro_torch.shell.server import ModelEngine
    t0 = time.perf_counter()
    layers = 3 if arch == "recurrentgemma_9b" else 2
    cfg = recurrent_config(arch, n_layers=layers, dtype="float32")
    engine = ModelEngine(cfg, max_len=RECURRENT_F32_SEQ, seed=SEED + 1)
    model, params = engine.model, engine.params
    plain = type(model)(dataclasses.replace(cfg, kernel_mode="torch"))
    rng = np.random.default_rng(SEED + 1)
    prompt = rng.integers(0, cfg.vocab, RECURRENT_F32_SEQ).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, RECURRENT_F32_SEQ).astype(np.int32)
    batch = {"tokens": torch.from_numpy(prompt[None]).cuda(),
             "labels": torch.from_numpy(labels[None]).cuda()}
    out = {}
    with torch.no_grad():
        for name, m in (("kernel", model), ("plain", plain)):
            _reset_counts()
            out[name] = (m.prefill(params, batch), float(m.loss(params, batch)),
                         _counts())
    replay_tok, _ = engine.prefill(prompt)
    torch.cuda.synchronize()
    (lk, loss_k, ck), (lp, loss_p, cp) = out["kernel"], out["plain"]
    rel = rel_l2(lk, lp)
    tok = int(greedy_tokens(lk, cfg.vocab)[0])
    path = [k for k in RECURRENT_KERNELS[arch] if k != "plan_multi"]
    ok = (rel <= F32_REL and abs(loss_k - loss_p) <= F32_REL * abs(loss_p)
          and tok == replay_tok and all(ck[k] > 0 for k in path)
          and not any(cp.values()))
    emit(f"{phase}.f32_check", layers=layers, seq=RECURRENT_F32_SEQ,
         prefill_rel_l2=rel, loss_kernel=loss_k, loss_plain=loss_p,
         tol=F32_REL, prefill_token=tok, replay_token=replay_tok,
         kernel_launches=ck, plain_launches=cp,
         seconds=time.perf_counter() - t0)
    if not ok:
        raise AssertionError(f"{phase}: float32 prefill, loss or the "
                             f"replayed token disagree")
    if "flash_fwd_d256" in path:
        check_flash_route(ck, "float32", f"{phase}.f32_check",
                          ("flash_fwd_d256",))
    del engine, model, params
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# the paper's use case: multiplier -> Hamming(31,26) encoder -> decoder
# ----------------------------------------------------------------------
BULK_WORDS = 1 << 28           # 1 GiB of words: a storage tenant's bulk ECC pass
MUL_CONSTANTS = (3, 7, 2654435761, 2**32 - 1, -1, -3)
MUL_ROUNDS = 10
PLAN_SHAPES = ((512, 4, 64, 128), (300, 8, 32, 64), (1024, 16, 128, 256),
               (64, 4, 8, 128))        # (T, S, C, D): tests/test_kernels.py
PLAN_TIMED = (1 << 20, 16, 1 << 16)    # (T, S, C) of the timed plan
USECASE_KERNELS = ("mul_const", "hamming_encode", "hamming_decode")


def paper_model_report():
    """The paper's experiments on the port's copy of the hardware model,
    each number beside the paper's, as ``examples/paper_usecase.py`` prints
    them.  Milliseconds here are the model's (the FPGA at 250 MHz and the
    server, calibrated to the paper), not times of the card."""
    from repro_torch.core.hw.area import AreaModel
    from repro_torch.core.hw.crossbar import (CrossbarSim, MasterRequest,
                                              best_case_time_to_grant,
                                              request_completion_cc,
                                              worst_case_completion_cc,
                                              worst_case_time_to_grant)
    from repro_torch.core.hw.system import (ElasticUseCase, PAPER_CASE1_MS,
                                            PAPER_CASE3_MS)
    print("== Fig 5: elasticity use case (16 KB, 3 modules; model ms, not "
          "card time) ==")
    uc = ElasticUseCase()
    fig5 = uc.figure5()
    print(f"   case 1 (mult on FPGA):        {fig5[1]:6.2f} ms   "
          f"(paper: {PAPER_CASE1_MS})")
    print(f"   case 2 (+encoder):            {fig5[2]:6.2f} ms   "
          f"(paper: between)")
    print(f"   case 3 (all three on FPGA):   {fig5[3]:6.2f} ms   "
          f"(paper: {PAPER_CASE3_MS})")
    print("== §V-D: dynamic bandwidth allocation (quota 16 -> 128) ==")
    bw = uc.bandwidth_table()
    print(f"   1 accelerator: {100*bw[1]:.2f}%  (paper: 5.24%)")
    print(f"   3 accelerators: {100*bw[3]:.2f}%  (paper: 6%)")
    print(f"   calibration residuals: "
          f"{ {k: round(v, 4) for k, v in uc.calibration_residuals.items()} }")
    print("== §V-E: communication overhead (FPGA cycles) ==")
    print(f"   best-case time-to-grant:      {best_case_time_to_grant()} cc "
          f"(paper: 4)")
    print(f"   completion, 8 packages:       {request_completion_cc(8)} cc "
          f"(paper: 13)")
    print(f"   worst-case grant, 3 masters:  {worst_case_time_to_grant(3)} cc"
          f" (paper: 28)")
    print(f"   worst-case completion:        {worst_case_completion_cc(3)} cc"
          f" (paper: 37)")
    sim = CrossbarSim()
    for m in (0, 1, 2):
        sim.submit(MasterRequest(cycle=0, master=m, dst_onehot=0b1000,
                                 n_words=8))
    results = sim.run()
    grants = sorted(r.time_to_grant for r in results)
    completions = sorted(r.completion_latency for r in results)
    print(f"   cycle-sim check: grants={grants} completions={completions}")
    print("== Fig 6: worst-case latency vs contending PR regions ==")
    curve = AreaModel.worst_case_latency_curve(8)
    print("   " + "  ".join(f"{n}:{cc}cc" for n, cc in curve.items()))
    print("== Table II claims ==")
    m = AreaModel()
    print(f"   LUT saving vs NoC:  {100*m.lut_saving_vs_noc():.1f}% "
          f"(paper: 61%)")
    print(f"   FF saving vs NoC:   {100*m.ff_saving_vs_noc():.1f}% "
          f"(paper: 95%)")
    print(f"   power vs NoC:       {m.power_ratio_vs_noc():.0f}x "
          f"(paper: 80x)")
    print(f"   completion saving vs NoC (4-router path): "
          f"{100*m.latency_saving_vs_noc(4):.1f}% (paper headline: 69%)")
    emit("paper_model", model_ms={"fig5": fig5, "paper_case1": PAPER_CASE1_MS,
                                  "paper_case3": PAPER_CASE3_MS},
         bandwidth=bw, calibration_residuals=uc.calibration_residuals,
         cycles={"best_grant": best_case_time_to_grant(),
                 "completion_8": request_completion_cc(8),
                 "worst_grant_3": worst_case_time_to_grant(3),
                 "worst_completion_3": worst_case_completion_cc(3),
                 "sim_grants": grants, "sim_completions": completions},
         fig6=curve, table2={"lut_saving": m.lut_saving_vs_noc(),
                             "ff_saving": m.ff_saving_vs_noc(),
                             "power_ratio": m.power_ratio_vs_noc()})
    if (grants[0] != 4 or grants[-1] != 28 or completions[0] != 13
            or completions[-1] != 37 or abs(fig5[1] - PAPER_CASE1_MS) > 1e-6
            or abs(fig5[3] - PAPER_CASE3_MS) > 1e-6):
        raise AssertionError("the hardware model no longer reproduces the "
                             "paper's calibrated numbers")
    return uc


def usecase_path(uc):
    """The use case through the port's entry points: for k = 1, 2, 3 a
    ``Shell`` with k free regions admits one tenant whose footprints come
    from ``paper_chain``, and ``ModuleChain.apply`` runs the 16 KB on the
    placement (placed modules on the card's kernels, ``ON_SERVER`` ones on
    the CPU); then one tenant grows from 1 region to 3 without a rebuild.
    Every output must equal ``run_case(k).output``.  Returns the launches
    of exactly this path."""
    from repro_torch.core.elastic import ON_SERVER, Region
    from repro_torch.core.module import ModuleFootprint
    from repro_torch.kernels import build
    from repro_torch.kernels.hamming import kernel as HK
    from repro_torch.kernels.hamming.ops import paper_chain
    from repro_torch.shell import Shell
    t0 = time.perf_counter()
    data = np.random.default_rng(0).integers(0, 1 << 26, size=uc.n_words,
                                             dtype=np.uint32)
    x = torch.from_numpy(data.view(np.int32)).cuda().view(torch.uint32)
    chain = paper_chain(uc.constant)
    params = chain.init(torch.Generator().manual_seed(SEED))
    regions = lambda n: [Region(rid=i, n_chips=1, hbm_bytes=80 * GB)  # noqa: E731
                         for i in range(n)]
    names = [m.name for m in chain.modules]

    def run(placement, want):
        before = HK.launch_counts()
        out = chain.apply(params, x, placement)
        torch.cuda.synchronize()
        got = out.view(torch.int32).cpu().numpy().view(np.uint32)
        after = HK.launch_counts()
        on_card = {n: after[k] - before[k]
                   for n, k in zip(names, USECASE_KERNELS)}
        expect = {n: int(p != ON_SERVER) for n, p in zip(names, placement)}
        return {"placement": list(placement), "on_card": on_card,
                "equal": bool(np.array_equal(got, want)),
                "as_placed": out.device.type == "cuda" and on_card == expect}

    _reset_counts()
    cases = {}
    for k in (1, 2, 3):
        shell = Shell(regions(k))
        placement = shell.submit("usecase", chain)
        cases[k] = run(placement, uc.run_case(k).output)
        cases[k]["as_paper"] = placement == list(range(k)) + [ON_SERVER] * (
            3 - k)
    shell = Shell(regions(3))
    fp = ModuleFootprint(0, 1.0, 4)
    shell.submit("other", [fp, fp])
    grow = []
    for step in (lambda: shell.submit("usecase", chain),
                 lambda: shell.shrink("usecase", 1),
                 lambda: shell.release("other"),
                 lambda: shell.grow("usecase")):
        step()
        grow.append(run(shell.placement_of("usecase"),
                        uc.run_case(3).output))
    launches = _counts()
    loads = build.load_count[HK.LIB_NAME]
    emit("paper_usecase.path", words=uc.n_words, cases=cases, grow=grow,
         epoch=shell.epoch, hamming_library_loads=loads,
         kernels={k: launches[k] for k in USECASE_KERNELS},
         seconds=time.perf_counter() - t0)
    ok = (all(c["equal"] and c["as_placed"] and c["as_paper"]
              for c in cases.values())
          and all(g["equal"] and g["as_placed"] for g in grow)
          and grow[0]["placement"][1:] == [ON_SERVER, ON_SERVER]
          and ON_SERVER not in grow[-1]["placement"] and loads == 1
          and all(launches[k] > 0 for k in USECASE_KERNELS))
    if not ok:
        raise AssertionError("the use case disagrees with run_case, ran "
                             "where its placement does not say, or rebuilt")
    return launches


def hamming_check(name, x, constants=(3,)):
    """Each Hamming kernel against its plain version on ``x`` (int32);
    returns the largest difference (0 when bit-equal)."""
    from repro_torch.fabric.interface import KernelMode
    from repro_torch.kernels.hamming import kernel as HK, ref as href
    cuda = KernelMode.CUDA
    pairs = {"hamming_encode": (HK.hamming_encode(x, mode=cuda),
                                href.encode_ref(x))}
    dk, ck = HK.hamming_decode(x, mode=cuda)
    dr, cr = href.decode_ref(x)
    pairs["hamming_decode"] = (torch.stack([dk, ck]), torch.stack([dr, cr]))
    for c in constants:
        pairs[f"mul_const({c})"] = (HK.mul_const(x, c, mode=cuda),
                                    href.multiply_ref(x, c))
    torch.cuda.synchronize()
    res = {k: torch.equal(a, b) for k, (a, b) in pairs.items()}
    errs = {k: max_abs_err(a, b) for k, (a, b) in pairs.items()}
    emit("paper_usecase.check", case=name, words=x.numel(), **res)
    del pairs
    if not all(res.values()):
        raise AssertionError(f"a Hamming kernel disagrees on {name}: {res}")
    return {"hamming_encode": errs["hamming_encode"],
            "hamming_decode": errs["hamming_decode"],
            "mul_const": max(v for k, v in errs.items()
                             if k.startswith("mul_const"))}


def error_words(gen, n_per=4096):
    """Codewords with bit p flipped in block p (p = 0..31, bit 31 outside
    the codeword), then codewords with two distinct bits flipped."""
    from repro_torch.kernels.hamming import ref as href
    data = torch.randint(0, 1 << 26, (32 * n_per,), generator=gen,
                         device="cuda", dtype=torch.int32)
    code = href.encode_ref(data)
    pos = torch.arange(32, device="cuda").repeat_interleave(n_per)
    flip = (1 << pos) - ((pos == 31).long() << 32)         # bit 31 as int32
    single = code ^ flip.to(torch.int32)
    p1 = torch.randint(0, 31, code.shape, generator=gen, device="cuda")
    p2 = (p1 + torch.randint(1, 31, code.shape, generator=gen,
                             device="cuda")) % 31
    double = code ^ ((1 << p1) | (1 << p2)).to(torch.int32)
    return data, single, double, pos


def hamming_kernels():
    """The three kernels against their plain versions at the 16 KB of the
    use case, at 2^28 words (1 GiB) and 2^28 - 3, at every single-bit error
    position and at double-bit errors, and the multiplier at several
    constants; timings at 2^28 words."""
    from repro_torch.fabric.interface import KernelMode
    from repro_torch.kernels.hamming import kernel as HK, ref as href
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    words = lambda n: torch.randint(  # noqa: E731
        -(1 << 31), 1 << 31, (n,), generator=gen, device="cuda",
        dtype=torch.int64).to(torch.int32)
    errs = [hamming_check("16KB", words(4096), MUL_CONSTANTS)]
    data, single, double, pos = error_words(gen)
    errs.append(hamming_check("single_bit_errors", single))
    dk, ck = HK.hamming_decode(single, mode=KernelMode.CUDA)
    corrected = bool(torch.equal(dk, data)
                     and torch.equal(ck, (pos < 31).to(torch.int32)))
    errs.append(hamming_check("double_bit_errors", double))
    emit("paper_usecase.errors", every_position_corrected=corrected)
    if not corrected:
        raise AssertionError("a single-bit error was not corrected")
    errs.append(hamming_check("ragged_2^28-3", words(BULK_WORDS - 3)))
    x = words(BULK_WORDS)
    errs.append(hamming_check("bulk_2^28", x, MUL_CONSTANTS))
    cuda = KernelMode.CUDA
    n = x.numel()
    c = MUL_CONSTANTS[2]
    c32 = (c & 0xFFFFFFFF) - (1 << 32) * bool(c & (1 << 31))   # as int32
    mul = lambda: HK.mul_const(x, c, mode=cuda)  # noqa: E731
    library_mul = lambda: torch.mul(x, c32)  # noqa: E731
    out = {}
    for name, kernel, plain, n_bytes, library in (
            ("hamming_encode", lambda: HK.hamming_encode(x, mode=cuda),
             lambda: href.encode_ref(x), 8 * n, None),
            ("hamming_decode", lambda: HK.hamming_decode(x, mode=cuda),
             lambda: href.decode_ref(x), 12 * n, None),
            ("mul_const", mul, lambda: href.multiply_ref(x, c), 8 * n,
             library_mul)):
        b, by = bound(n_bytes, 0)
        out[name] = dict(
            ms=time_ms(kernel, reps=20), plain_ms=time_ms(plain, reps=3,
                                                          warmup=1),
            library_ms=None if library is None else time_ms(library, reps=20),
            bound_ms=b, bound_by=by, bytes=n_bytes)
    # mul_const against torch.mul in alternating rounds, each the median
    # of 20 calls: the two are within 1% of each other, less than one
    # timing moves
    rounds = []
    for r in range(MUL_ROUNDS):
        pair = (("mul_const", mul), ("torch.mul", library_mul))
        rounds.append({k: time_ms(fn, reps=20)
                       for k, fn in (pair if r % 2 == 0 else pair[::-1])})
    out["mul_const"]["mul_rounds"] = {
        "rounds": rounds,
        **{f"{k}_quartiles_ms": statistics.quantiles(
            [r[k] for r in rounds], n=4) for k in ("mul_const", "torch.mul")},
        **{f"{k}_median_ms": statistics.median(r[k] for r in rounds)
           for k in ("mul_const", "torch.mul")},
        "mul_const_won": sum(r["mul_const"] < r["torch.mul"] for r in rounds),
        "torch.mul_won": sum(r["torch.mul"] < r["mul_const"] for r in rounds)}
    emit("paper_usecase.time", words=n, constant=c, **out)
    del x
    torch.cuda.empty_cache()
    err = {k: max(e[k] for e in errs) for k in errs[0]}
    return err, out


def plan_inputs(T, S, C, gen, out_of_range=False):
    """One source's packets and register rows: isolation holes (at least
    one, and at least one open port), quota 0 = unlimited on every third
    port and C // 2 elsewhere, capacity C; with ``out_of_range``, 15% of the
    packets carry dst = -1, S or S + 3."""
    dst = torch.randint(0, S, (T,), generator=gen, device="cuda",
                        dtype=torch.int32)
    if out_of_range:
        bad = torch.rand((T,), generator=gen, device="cuda") < 0.15
        pick = torch.tensor([-1, S, S + 3], dtype=torch.int32, device="cuda")
        dst = torch.where(bad, pick[torch.randint(0, 3, (T,), generator=gen,
                                                  device="cuda")], dst)
    allowed = (torch.rand((S,), generator=gen, device="cuda") > 0.25).to(
        torch.int32)
    allowed[0], allowed[1] = 0, 1
    quota = torch.where(torch.arange(S, device="cuda") % 3 == 0, 0,
                        C // 2).to(torch.int32)
    cap = torch.full((S,), C, dtype=torch.int32, device="cuda")
    return dst, allowed, quota, cap


def plan_path():
    """The single-source plan kernel through the deprecated shims, one
    round each: ``crossbar_plan`` -> ``crossbar_dispatch`` ->
    ``crossbar_combine`` at the four shapes of ``tests/test_kernels.py``
    (and out-of-range ``dst`` at the first), the zero-packet round, and the
    timed shape.  Launches are counted over exactly these rounds; then each
    round's plan is held bit-equal to ``plan_ref`` and its slabs and
    combine to their plain versions, and the plan kernel is timed."""
    import warnings
    from repro_torch.fabric.interface import KernelMode
    from repro_torch.kernels import (crossbar_combine, crossbar_dispatch,
                                     crossbar_plan)
    from repro_torch.kernels.crossbar_dispatch import kernel as K, ref
    from repro_torch.kernels.timing import device_profile, host_us
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    T, S, C = PLAN_TIMED
    rounds = [("zero_packets", plan_inputs(0, 4, 8, gen), 8, 8)]
    for t, s, c, d in PLAN_SHAPES:
        rounds.append((f"T={t} S={s} C={c}", plan_inputs(t, s, c, gen), c, d))
    rounds.append(("out_of_range_dst", plan_inputs(512, 4, 64, gen, True),
                   64, 128))
    rounds.append((f"timed T={T} S={S} C={C}", plan_inputs(T, S, C, gen), C,
                   8))
    xs = [(torch.randn((dst.shape[0], d), generator=gen, device="cuda"),
           torch.rand((dst.shape[0],), generator=gen, device="cuda"))
          for _, (dst, *_), _, d in rounds]
    _reset_counts()
    outs = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for (name, (dst, allowed, quota, cap), c, d), (x, w) in zip(rounds,
                                                                    xs):
            p = crossbar_plan(dst, allowed, quota, cap)
            slabs = crossbar_dispatch(x, dst, p[0], p[1],
                                      n_ports=allowed.shape[0], capacity=c)
            outs.append((p, slabs, crossbar_combine(slabs, dst, p[0], p[1],
                                                    w)))
    torch.cuda.synchronize()
    launches = _counts()
    checks = {}
    err = 0.0
    for (name, (dst, allowed, quota, cap), c, d), (x, w), (p, slabs, back) in \
            zip(rounds, xs, outs):
        pr = ref.plan_ref(dst, allowed, quota, cap)
        sr = ref.scatter_ref(x, dst, pr[0], pr[1], allowed.shape[0], c)
        cr = ref.combine_ref(sr, dst, pr[0], pr[1], w)
        checks[name] = {
            "plan": all(torch.equal(a, b) for a, b in zip(p, pr)),
            "dispatch": torch.equal(slabs, sr),
            "combine": torch.equal(back, cr),
            "granted": int(p[0].sum()),
            "invalid_dest": int((p[2] == 1).sum())}
        err = max([err] + [max_abs_err(a, b) for a, b in zip(p, pr)])
    b, by = bound(16 * T, 0)
    dst, allowed, quota, cap = rounds[-1][1]
    cuda = KernelMode.CUDA
    call = lambda: K.plan(dst, allowed, quota, cap, mode=cuda)
    prof = device_profile(call)
    t = dict(ms=time_ms(call),
             plain_ms=time_ms(lambda: ref.plan_ref(dst, allowed, quota, cap),
                              reps=5),
             library_ms=None, bound_ms=b, bound_by=by, bytes=16 * T,
             device_ms=prof["device_ms"], kernels_per_call=prof["kernels"],
             memsets_per_call=prof["memsets"], host_us=host_us(call))
    emit("paper_usecase.plan", checks=checks,
         kernels={k: launches[k] for k in ("plan", "scatter", "combine")},
         T=T, S=S, C=C, seconds=time.perf_counter() - t0, **t)
    if not all(v["plan"] and v["dispatch"] and v["combine"]
               for v in checks.values()):
        raise AssertionError(f"the plan shims disagree with plan_ref: "
                             f"{checks}")
    if checks["out_of_range_dst"]["invalid_dest"] == 0 or launches["plan"] \
            != len(rounds) - 1:
        raise AssertionError("the plan path did not run as laid out")
    if t["memsets_per_call"]:
        raise AssertionError(f"the plan at T={T} clears memory: {t}")
    return launches, err, t


def paper_usecase_phase(smi):
    t0 = time.perf_counter()
    uc = paper_model_report()
    usecase_launches = usecase_path(uc)
    ham_err, ham_t = hamming_kernels()
    plan_launches, plan_err, plan_t = plan_path()
    emit("paper_usecase", smi=smi, seconds=time.perf_counter() - t0)
    return usecase_launches, plan_launches, ham_err, ham_t, plan_err, plan_t


def main() -> int:
    global SEED
    if "--seed" in sys.argv[1:]:
        SEED = int(sys.argv[sys.argv.index("--seed") + 1])
    # 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, nvidia_smi=smi, count=torch.cuda.device_count(),
         seed=SEED, torch=torch.__version__, cuda=torch.version.cuda,
         numpy=np.__version__)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 2. build --------------------------------------------------------
    from repro_torch.kernels import build
    from repro_torch.kernels.crossbar_dispatch import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.hamming import kernel as HK
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.ssd import kernel as SK
    t0 = time.perf_counter()
    libs = {K.LIB_NAME: K.SOURCES, FK.LIB_NAME: FK.SOURCES,
            SK.LIB_NAME: SK.SOURCES, RK.LIB_NAME: RK.SOURCES,
            HK.LIB_NAME: HK.SOURCES}
    build.build_libraries(libs)
    for mod in (K, FK, SK, RK, HK):
        mod.library()
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=dict(build.build_seconds),
         libraries=[build.library_path(n, srcs).name
                    for n, srcs in libs.items()])

    # 3. crossbar kernels ---------------------------------------------
    from repro_torch.models.moe import expert_capacity
    t0 = time.perf_counter()
    cfg = serving_config()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    d, E = cfg.d_model, cfg.moe.n_experts
    cap1, cap2 = expert_capacity(1, cfg.moe), expert_capacity(2, cfg.moe)
    big_c = expert_capacity(4096, cfg.moe)
    # the train step's groups: min(1024, B*S) tokens, top-2 (models/lm.py)
    train_g = min(1024, TRAIN_SEQ)
    served = [
        Case("moe_decode", 2, E, cap1, d, bf16, 1, gen, holes=False),
        Case("moe_prefill", 4, E, cap2, d, bf16, 1, gen, holes=False),
        Case("server_tick", N_SLOTS, 3, 8, 4, f32, 3, gen),
        Case("moe_train", train_g * cfg.moe.top_k, E,
             expert_capacity(train_g, cfg.moe), d, bf16, 1, gen, holes=False),
    ]
    large = [
        Case("large_bf16", 8192, E, big_c, d, bf16, E, gen),
        Case("large_f32", 8192, E, big_c, d, f32, E, gen),
        Case("ragged_bf16", 8189, E, big_c, d, bf16, E, gen),
        Case("plan_65536", 65536, 16, 4096, 8, f32, 16, gen),
    ]
    errs = {}
    for case in served + large:
        errs[case.name] = case.check()
    decode_t = served[0].timings()
    train_t = served[3].timings()
    train_shape = (f"T={served[3].T} S={served[3].S} C={served[3].C} "
                   f"D={served[3].D} bf16")
    large_t = large[0].timings()
    for case, t in (("moe_decode", decode_t), ("moe_train", train_t)):
        for name in ("scatter", "combine", "plan_multi", "plan_fabric",
                     "backend_plan"):
            if t[name]["kernels_per_call"] != 1 or t[name]["memsets_per_call"]:
                raise AssertionError(f"{name} at {case} is not one kernel "
                                     f"and no memset a call: {t[name]}")
    del served, large
    emit("kernels", seconds=time.perf_counter() - t0)

    # 4. flash attention ----------------------------------------------
    t0 = time.perf_counter()
    flash_err, flash_t = flash_phase()
    torch.cuda.empty_cache()
    emit("flash", seconds=time.perf_counter() - t0)

    # 4b. every family's smoke config on the kernels -------------------
    smoke_launches = smoke_widths_phase()
    torch.cuda.empty_cache()

    # 5. serve, and the closed control loop over the served tenant ------
    engine, serve_launches = serve_phase(cfg, smi)
    mixtral_launches = manager_mixtral_phase(engine, smi)

    # 6. train --------------------------------------------------------
    train_launches, step_ms = train_phase(engine, smi)
    del engine
    torch.cuda.empty_cache()
    f32_check(cfg)

    # 7. the recurrent families' kernels --------------------------------
    t0 = time.perf_counter()
    ssd_err, ssd_t = ssd_phase()
    rglru_err, rglru_t = rglru_phase()
    d256_err, d256_t = flash_d256_phase()
    torch.cuda.empty_cache()
    emit("recurrent_kernels", seconds=time.perf_counter() - t0)

    # 8. serve and prefill the recurrent families ----------------------
    ssm_launches = serve_recurrent_phase("mamba2_780m", "serve_ssm", smi)
    hybrid_launches = serve_recurrent_phase("recurrentgemma_9b",
                                            "serve_hybrid", smi)

    # 9. the paper's use case and the single-source plan ---------------
    (usecase_launches, plan_launches, ham_err, ham_t, plan_err,
     plan_t) = paper_usecase_phase(smi)

    # 10. the seeded serve harness and the manager's scenarios ----------
    harness_launches = serve_harness_phase(smi)
    scenario_launches = manager_scenarios_phase(smi)
    loads = dict(build.load_count)
    if any(n != 1 for n in loads.values()):
        raise AssertionError(f"a kernel library was loaded twice: {loads}")

    # 11. summary -----------------------------------------------------
    paths = {"serve": serve_launches, "train": train_launches,
             "serve_ssm": ssm_launches, "serve_hybrid": hybrid_launches,
             "paper_usecase": usecase_launches, "plan_shims": plan_launches,
             "smoke_widths": smoke_launches,
             "manager_mixtral": mixtral_launches,
             "serve_harness": harness_launches,
             "manager_scenarios": scenario_launches}

    def launch_keys(name):
        by_path = {p: c.get(name, 0) for p, c in paths.items()}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    replaces = {
        "plan_multi": "src/repro/kernels/crossbar_dispatch/kernel.py:196",
        "scatter": "src/repro/kernels/crossbar_dispatch/kernel.py:269",
        "combine": "src/repro/kernels/crossbar_dispatch/kernel.py:321",
        "flash_fwd": "src/repro/kernels/flash_attention/kernel.py:107",
        "flash_bwd": "src/repro/kernels/flash_attention/kernel.py:107",
        "flash_fwd_d256": "src/repro/kernels/flash_attention/kernel.py:107",
        "ssd": "src/repro/kernels/ssd/kernel.py:80",
        "rglru": "src/repro/kernels/rglru/kernel.py:63",
        "plan": "src/repro/kernels/crossbar_dispatch/kernel.py:90",
        "hamming_encode": "src/repro/kernels/hamming/kernel.py:109",
        "hamming_decode": "src/repro/kernels/hamming/kernel.py:114",
        "mul_const": "src/repro/kernels/hamming/kernel.py:119",
    }
    timing_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    src = "src/repro_torch/kernels/crossbar_dispatch/csrc/crossbar_dispatch.cu"
    rows = []
    for name in ("plan_multi", "scatter", "combine"):
        t = decode_t[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces[name], **launch_keys(name),
            "max_abs_err": max(e[name] for e in errs.values()),
            **t,
            "shape": "moe_decode T=2 S=8 C=8 D=4096 bf16",
            "train": {"shape": train_shape, **train_t[name]},
            "large": {"shape": "T=8192 S=8 C=1280 D=4096 bf16",
                      **large_t[name]},
        })
        if name == "plan_multi":
            # the fabric's plan entry, whose launches count as plan_multi's
            for entry in ("plan_fabric", "backend_plan"):
                rows[-1][entry] = {"decode": decode_t[entry],
                                   "train": train_t[entry],
                                   "large": large_t[entry]}
    src = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
    for name in ("flash_fwd", "flash_bwd"):
        t = flash_t[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces[name], **launch_keys(name),
            "max_abs_err": flash_err[name],
            **{k: t[k] for k in timing_keys}, "fma_ms": t["fma_ms"],
            "launches_by_route": {r: paths["train"][f"{name}_{r}"]
                                  for r in ("tc", "fma")},
            "shape": "B=1 S=4096 H=32 Kv=8 D=128 bf16 causal window=4096",
        })
    rows.append({
        "name": "flash_fwd_d256", "route": "cuda", "source": src,
        "replaces": replaces["flash_fwd_d256"], **launch_keys("flash_fwd_d256"),
        "max_abs_err": d256_err, **{k: d256_t[k] for k in timing_keys},
        "fma_ms": d256_t["fma_ms"],
        "launches_by_route": {r: paths["serve_hybrid"][f"flash_fwd_d256_{r}"]
                              for r in ("tc", "fma")},
        "shape": "B=1 S=32768 H=16 Kv=1 D=256 bf16 causal window=2048",
    })
    new_rows = (
        ("ssd", "src/repro_torch/kernels/ssd/csrc/ssd.cu", ssd_err, ssd_t,
         "B=1 S=32768 H=48 P=64 N=128 chunk=256 bf16"),
        ("rglru", "src/repro_torch/kernels/rglru/csrc/rglru.cu", rglru_err,
         rglru_t, "B=1 S=32768 L=4096 float32"),
        ("plan", "src/repro_torch/kernels/crossbar_dispatch/csrc/"
         "crossbar_dispatch.cu", plan_err, plan_t,
         f"T={PLAN_TIMED[0]} S={PLAN_TIMED[1]} C={PLAN_TIMED[2]} int32"),
    )
    ham_src = "src/repro_torch/kernels/hamming/csrc/hamming.cu"
    new_rows += tuple(
        (name, ham_src, ham_err[name], ham_t[name],
         f"{BULK_WORDS} words int32" + (
             f" constant={MUL_CONSTANTS[2]}" if name == "mul_const" else ""))
        for name in USECASE_KERNELS)
    for name, source, err, t, shape in new_rows:
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces[name], **launch_keys(name),
            "max_abs_err": err, **{k: t[k] for k in timing_keys},
            "shape": shape,
        })
        if name == "rglru":
            rows[-1].update({k: t[k] for k in (
                "entry_ms", "entry_bound_ms", "kernels_per_call")},
                entry_shape="B=1 S=32768 L=4096 u bf16, a float32, h bf16")
        if name == "mul_const":
            rows[-1]["mul_rounds"] = t["mul_rounds"]
        if name == "plan":
            rows[-1].update({k: t[k] for k in (
                "device_ms", "kernels_per_call", "memsets_per_call",
                "host_us")})
    if len(rows) != 12:
        raise AssertionError(f"{len(rows)} kernel rows, not 12")
    emit("done", seconds=time.perf_counter() - t_start,
         train_step_ms=step_ms)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def profile(phase: str, fn, steps: int) -> None:
    """Device time by kernel and the device's idle share over ``steps``
    warm calls of ``fn`` (``torch.profiler``), and a Chrome trace in
    ``build/profile/``."""
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel events only: an operator's row repeats its kernels' time
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    device_us = sum(e.self_device_time_total for e in rows)
    out_dir = os.path.join(HERE, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"{phase}_trace.json"))
    emit(phase, steps=steps, wall_ms_per_step=wall / steps * 1e3,
         device_ms_per_step=device_us / steps / 1e3,
         device_idle_share=1 - device_us / 1e6 / wall,
         top=[{"name": e.key[:80], "calls": e.count,
               "device_ms_per_step": e.self_device_time_total / steps / 1e3}
              for e in rows[:15]],
         # the port's own kernels, wherever they rank
         port_kernels=[{"name": e.key[:120], "calls": e.count,
                        "device_ms_per_step":
                        e.self_device_time_total / steps / 1e3}
                       for e in rows if is_port_kernel(e.key)])


def is_port_kernel(name: str) -> bool:
    """Is profiler row ``name`` one of the kernels of
    ``src/repro_torch/kernels/*/csrc/*.cu`` (each kept in an anonymous
    namespace there)?"""
    if not hasattr(is_port_kernel, "names"):
        src = os.path.join(HERE, "src", "repro_torch", "kernels")
        found = set()
        for d in os.listdir(src):
            csrc = os.path.join(src, d, "csrc")
            for f in os.listdir(csrc) if os.path.isdir(csrc) else ():
                with open(os.path.join(csrc, f)) as fh:
                    found |= set(re.findall(
                        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                        r"(\w+)", fh.read()))
        is_port_kernel.names = found
    head = name.split("(anonymous namespace)::", 1)[-1].removeprefix("tc::")
    return "(anonymous namespace)::" in name and "at::native" not in name \
        and re.split(r"[<(]", head)[0] in is_port_kernel.names


if __name__ == "__main__":
    sys.exit(main())
