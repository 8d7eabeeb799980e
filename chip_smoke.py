"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. device   needs ``torch.cuda.is_available()``; prints the card's name and
            power limit (``nvidia-smi``).
2. build    builds the crossbar and flash-attention kernel libraries from
            ``src/repro_torch`` (one ``nvcc`` each, started together).
3. kernels  holds ``plan_multi``, ``scatter`` and ``combine`` bit-equal
            (``torch.equal``) to their plain versions at the served shapes
            and at large shapes, and times kernel, plain version and one
            library call with CUDA events (median of 20 after warm-up).
4. flash    holds the flash-attention forward and backward kernels to
            their plain versions (autograd through ``attention_ref``) at
            five shapes, and times kernel, plain version and
            ``scaled_dot_product_attention`` at the train shape.
5. serve    a full-width Mixtral-8x7B (2 of 32 layers, bf16, random weights
            from a seed) behind ``ElasticServer`` on the ``cuda`` fabric,
            MoE on ``cuda_kernel``: 4 requests, one ``Shell.post(Grow)``
            midway.  Counts kernel launches on exactly this run, then serves
            the same requests through the plain versions on the card and
            requires identical token streams and port traffic.
6. train    3 AdamW steps of ``make_train_step`` on the served model's
            parameters (B=1, S=4096), counting kernel launches on exactly
            these steps; then the prefill logits of the kernel path against
            the plain path, and one float32 loss and backward of a 1-layer
            full-width model on the kernel path against the plain path.

``--profile`` adds a phase after serving and one after the train steps:
``torch.profiler`` over 8 warm decode steps of the served engine and over
one more train step, device time by kernel, the device's idle share, and
Chrome traces in ``build/profile/``.

The last line is ``{"ok": true, "device": {...}}``; any failure raises and
exits non-zero before it.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
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
    """Median device time of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


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
        }
        emit("kernels.check", case=self.name, T=self.T, S=self.S, C=self.C,
             D=self.D, dtype=str(self.dtype).replace("torch.", ""),
             granted=int(self.keep.sum()), max_abs_err=errs, **res)
        if not all(res.values()):
            raise AssertionError(f"kernel mismatch on {self.name}: {res}")
        return errs

    def timings(self):
        """(kernel, plain, library, bound, bound_by) per kernel, in ms."""
        from repro_torch.fabric.interface import KernelMode
        from repro_torch.kernels.crossbar_dispatch import kernel as K, ref
        T, S, C, D = self.T, self.S, self.C, self.D
        es = self.x.element_size()
        kept = int(self.keep.sum())
        cuda = KernelMode.CUDA
        out = {}
        b, by = bound(5 * T * 4 + 3 * S * S * 4, 0)
        out["plan_multi"] = dict(
            ms=time_ms(lambda: K.plan_multi(self.dst, self.src, self.allowed,
                                            self.quota_sd, mode=cuda)),
            plain_ms=time_ms(lambda: ref.plan_multi_ref(
                self.dst, self.src, self.allowed, self.quota_sd)),
            library_ms=None, bound_ms=b, bound_by=by)

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


def flash_live_tiles(Sq, Sk, causal, window, q_offset) -> int:
    """(q tile, k tile) pairs the kernels visit per (batch, head): the
    kernels' own tile skip (none above the causal diagonal, none wholly
    outside the window)."""
    from repro_torch.kernels.flash_attention.kernel import BLOCK_K, BLOCK_Q
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
             live_tiles=self.tiles, tol={"forward": f_tol, "backward": b_tol,
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
        its head-major layout, the same function at the train shape."""
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
        fwd_ops = 4 * D * self.tiles * 64 * 64       # QK^T and PV
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


def _counts():
    from repro_torch.kernels.crossbar_dispatch import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK
    return {**FK.launch_counts(), **K.launch_counts()}


def _reset_counts():
    from repro_torch.kernels.crossbar_dispatch import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK
    K.reset_launch_counts()
    FK.reset_launch_counts()


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
    if any(v <= 0 for v in launches.values()):
        raise AssertionError(f"a kernel was not launched while training: "
                             f"{launches}")
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
            and nonzero and all(v > 0 for v in ck.values())
            and not any(cp.values())):
        raise AssertionError("float32 loss or gradients disagree with the "
                             "plain path")


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
    if any(v <= 0 for v in launches.values()):
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


def main() -> int:
    # 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 2. build --------------------------------------------------------
    from repro_torch.kernels import build
    from repro_torch.kernels.crossbar_dispatch import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK
    t0 = time.perf_counter()
    libs = {K.LIB_NAME: K.SOURCES, FK.LIB_NAME: FK.SOURCES}
    build.build_libraries(libs)
    K.library()
    FK.library()
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
    served = [
        Case("moe_decode", 2, E, cap1, d, bf16, 1, gen, holes=False),
        Case("moe_prefill", 4, E, cap2, d, bf16, 1, gen, holes=False),
        Case("server_tick", N_SLOTS, 3, 8, 4, f32, 3, gen),
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
    large_t = large[0].timings()
    del served, large
    emit("kernels", seconds=time.perf_counter() - t0)

    # 4. flash attention ----------------------------------------------
    t0 = time.perf_counter()
    flash_err, flash_t = flash_phase()
    torch.cuda.empty_cache()
    emit("flash", seconds=time.perf_counter() - t0)

    # 5. serve --------------------------------------------------------
    engine, serve_launches = serve_phase(cfg, smi)

    # 6. train --------------------------------------------------------
    train_launches, step_ms = train_phase(engine, smi)
    del engine
    torch.cuda.empty_cache()
    f32_check(cfg)

    # 7. summary ------------------------------------------------------
    replaces = {
        "plan_multi": "src/repro/kernels/crossbar_dispatch/kernel.py:196",
        "scatter": "src/repro/kernels/crossbar_dispatch/kernel.py:269",
        "combine": "src/repro/kernels/crossbar_dispatch/kernel.py:321",
        "flash_fwd": "src/repro/kernels/flash_attention/kernel.py:107",
        "flash_bwd": "src/repro/kernels/flash_attention/kernel.py:107",
    }
    src = "src/repro_torch/kernels/crossbar_dispatch/csrc/crossbar_dispatch.cu"
    rows = []
    for name in ("plan_multi", "scatter", "combine"):
        t, tl = decode_t[name], large_t[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces[name],
            "launches": serve_launches[name] + train_launches[name],
            "launches_by_path": {"serve": serve_launches[name],
                                 "train": train_launches[name]},
            "max_abs_err": max(e[name] for e in errs.values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": "moe_decode T=2 S=8 C=8 D=4096 bf16",
            "large": {"shape": "T=8192 S=8 C=1280 D=4096 bf16", **tl},
        })
    src = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
    for name in ("flash_fwd", "flash_bwd"):
        t = flash_t[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces[name], "launches": train_launches[name],
            "launches_by_path": {"serve": 0, "train": train_launches[name]},
            "max_abs_err": flash_err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": "B=1 S=4096 H=32 Kv=8 D=128 bf16 causal window=4096",
        })
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
              for e in rows[:15]])


if __name__ == "__main__":
    sys.exit(main())
