"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device   needs ``torch.cuda.is_available()``; prints the card's name and
            power limit (``nvidia-smi``).
2. build    builds the crossbar kernel library from ``src/repro_torch``.
3. kernels  holds ``plan_multi``, ``scatter`` and ``combine`` bit-equal
            (``torch.equal``) to their plain versions at the served shapes
            and at large shapes, and times kernel, plain version and one
            library call with CUDA events (median of 20 after warm-up).
4. serve    a full-width Mixtral-8x7B (2 of 32 layers, bf16, random weights
            from a seed) behind ``ElasticServer`` on the ``cuda`` fabric,
            MoE on ``cuda_kernel``: 4 requests, one ``Shell.post(Grow)``
            midway.  Counts kernel launches on exactly this run, then serves
            the same requests through the plain versions on the card and
            requires identical token streams and port traffic.

``--profile`` adds a phase after serving: ``torch.profiler`` over a few
warm decode steps of the served engine, device time by kernel, the
device's idle share, and a Chrome trace in ``build/profile/``.

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


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
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

    # 2. build --------------------------------------------------------
    from repro_torch.kernels import build
    from repro_torch.kernels.crossbar_dispatch import kernel as K
    t0 = time.perf_counter()
    K.library()
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=build.build_seconds.get(K.LIB_NAME),
         library=str(build.library_path(K.LIB_NAME, K.SOURCES).name))

    # 3. kernels ------------------------------------------------------
    from repro_torch.models.moe import expert_capacity
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

    # 4. serve --------------------------------------------------------
    from repro_torch.shell.server import ModelEngine
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, PROMPT_LEN).astype(np.int32)
               for _ in range(4)]
    t0 = time.perf_counter()
    engine = ModelEngine(cfg, max_len=PROMPT_LEN + MAX_NEW, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(engine.params))
    emit("model", name=cfg.name, layers=cfg.n_layers, d_model=d,
         d_ff=cfg.d_ff, experts=E, params=n_params,
         init_seconds=time.perf_counter() - t0)

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
    plain_cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, kernel_mode="torch"))
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
         logits_finite=finite)
    if not (same_tokens and same_traffic and finite
            and tuple(logits.shape) == (1, cfg.vocab_padded)):
        raise AssertionError("served output disagrees with the plain path")

    if "--profile" in sys.argv[1:]:
        profile_decode(engine, prompts[0])

    # 5. summary ------------------------------------------------------
    replaces = {
        "plan_multi": "src/repro/kernels/crossbar_dispatch/kernel.py:196",
        "scatter": "src/repro/kernels/crossbar_dispatch/kernel.py:269",
        "combine": "src/repro/kernels/crossbar_dispatch/kernel.py:321",
    }
    src = "src/repro_torch/kernels/crossbar_dispatch/csrc/crossbar_dispatch.cu"
    rows = []
    for name in ("plan_multi", "scatter", "combine"):
        t, tl = decode_t[name], large_t[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(e[name] for e in errs.values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": "moe_decode T=2 S=8 C=8 D=4096 bf16",
            "large": {"shape": "T=8192 S=8 C=1280 D=4096 bf16", **tl},
        })
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def profile_decode(engine, prompt, steps: int = 8) -> None:
    """Device time by kernel and idle share over ``steps`` warm B=1 decode
    steps of the served engine (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile
    tok, state = engine.prefill(prompt)
    for _ in range(2):
        tok, state = engine.decode(tok, state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok, state = engine.decode(tok, state)
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
    prof.export_chrome_trace(os.path.join(out_dir, "decode_trace.json"))
    emit("serve.profile", steps=steps, wall_ms_per_step=wall / steps * 1e3,
         device_ms_per_step=device_us / steps / 1e3,
         device_idle_share=1 - device_us / 1e6 / wall,
         top=[{"name": e.key[:80], "calls": e.count,
               "device_ms_per_step": e.self_device_time_total / steps / 1e3}
              for e in rows[:12]])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
