"""Time the crossbar's plan on the card three ways, and the Mixtral decode
and train steps around it.

    PYTHONPATH=src python -m repro_torch.kernels.crossbar_dispatch.plan_bench

The same measurement of another tree's plan (for example a parent commit
unpacked into ``build/parent``), run as a file so that ``repro_torch``
comes from that tree:

    PYTHONPATH=build/parent/src python \\
        src/repro_torch/kernels/crossbar_dispatch/plan_bench.py

The card's name and power limit come first.  Then one JSON line per shape
of ``SHAPES`` (the served decode plan of ``chip_smoke.py``'s Mixtral,
T = 2 packets over S = 8 experts; the train step's, T = 2048; T = 8192;
and the single-source plan at 2^20 packets over 16 ports, with isolation
holes and quotas) with, for each call the tree has (``plan_multi``,
``plan_fabric``, ``backend_plan``: ``CudaBackend.plan``, the fabric's
whole plan; ``plan``):

* ``event_ms``: the median of 20 calls, each between two CUDA events with
  the card idle before it, so the host's path to the launch counts;
* ``device_ms``: the device time of what a call launches, from
  ``torch.profiler`` over 20 calls, with ``kernels`` and ``memsets`` (a
  memset or a fill kernel) per call and their ``names``;
* ``host_us``: host microseconds per call over 1,000 calls enqueued while
  the card is busy, so no call waits for the card

(the helpers of ``kernels/timing.py``).  Then, unless ``--no-step``, the
served Mixtral-8x7B of ``chip_smoke.py`` (2 of 32 layers, full width,
bf16, random weights from seed 0): ``decode``, one B=1 decode step's wall
ms (the median of 20 steps) and, under ``torch.profiler`` over 8 steps,
its wall and device ms and the device's idle share; ``train``, the wall ms
of 3 AdamW steps at B=1, S=4096 after a warm-up step.  With ``--sweep``
(a tree with ``PLAN_BLOCK_T`` only) last: the device ms of ``plan_multi``,
``plan_fabric`` and ``plan`` at several T for each packets-a-block limit
of ``BLOCK_TS``, the measurement that sets ``kernel.PLAN_BLOCK_T``.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.core.registers import CrossbarRegisters
from repro_torch.fabric.backends import CudaBackend
from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels.crossbar_dispatch import kernel as K

try:
    from repro_torch.kernels.timing import device_profile, event_ms, host_us
except ImportError:          # run as a file against a tree older than timing.py
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from timing import device_profile, event_ms, host_us

# (name, T, S, C): chip_smoke.py's moe_decode, moe_train and large plans
SHAPES = (("decode", 2, 8, 8), ("train", 2048, 8, 320),
          ("large", 8192, 8, 1280))
PLAN_TIMED = (1 << 20, 16, 1 << 16)          # chip_smoke.py's timed plan
BLOCK_TS = (1024, 2048, 4096, 8192)
SWEEP = ((2048, 8), (8192, 8), (16384, 8), (65536, 8), (1 << 20, 16))
STEP_PROMPT, STEP_WARM, STEP_REPS, STEP_PROFILED = 16, 4, 20, 8
TRAIN_SEQ, TRAIN_STEPS = 4096, 3


def measure(fn) -> dict:
    return {"event_ms": event_ms(fn), **device_profile(fn),
            "host_us": host_us(fn)}


def served_plan(T: int, S: int, C: int, gen: torch.Generator):
    """A served MoE plan's inputs: one source, random experts, every port
    open, no quota, capacity C."""
    dst = torch.randint(0, S, (T,), generator=gen, device="cuda",
                        dtype=torch.int32)
    src = torch.zeros((T,), dtype=torch.int32, device="cuda")
    return dst, src, CrossbarRegisters.create(S, capacity=C, device="cuda")


def plan_calls(T: int, S: int, C: int, gen: torch.Generator) -> dict:
    """The plan calls the tree has at one shape, as the fabric makes them."""
    dst, src, regs = served_plan(T, S, C, gen)
    allowed = (regs.allowed & ~regs.reset[:, None]
               & ~regs.reset[None, :]).to(torch.int32)
    cuda = KernelMode.CUDA
    backend = CudaBackend(kernel_mode=cuda)
    calls = {"plan_multi": lambda: K.plan_multi(dst, src, allowed,
                                                regs.quota.T, mode=cuda)}
    if hasattr(K, "plan_fabric"):
        calls["plan_fabric"] = lambda: K.plan_fabric(
            dst, src, regs.allowed, regs.reset, regs.quota, regs.capacity,
            mode=cuda)
    calls["backend_plan"] = lambda: backend.plan(dst, src, regs)
    return calls


def source_plan(T: int, S: int, C: int, gen: torch.Generator):
    """chip_smoke.py's timed single-source plan: isolation holes, quota 0
    (unlimited) on every third port and C // 2 elsewhere, capacity C."""
    dst = torch.randint(0, S, (T,), generator=gen, device="cuda",
                        dtype=torch.int32)
    allowed = (torch.rand((S,), generator=gen, device="cuda") > 0.25).to(
        torch.int32)
    allowed[0], allowed[1] = 0, 1
    quota = torch.where(torch.arange(S, device="cuda") % 3 == 0, 0,
                        C // 2).to(torch.int32)
    cap = torch.full((S,), C, dtype=torch.int32, device="cuda")
    return lambda: K.plan(dst, allowed, quota, cap, mode=KernelMode.CUDA)


def block_t_sweep(gen: torch.Generator) -> list:
    """Device ms of each plan at the T of ``SWEEP`` for each limit of
    ``BLOCK_TS`` packets a block."""
    rows, keep_t = [], K.PLAN_BLOCK_T
    try:
        for T, S in SWEEP:
            calls = plan_calls(T, S, T, gen)
            fns = {k: calls[k] for k in ("plan_multi", "plan_fabric")}
            fns["plan"] = source_plan(T, S, T, gen)
            for block_t in BLOCK_TS:
                K.PLAN_BLOCK_T = block_t
                rows.append({"T": T, "S": S, "block_t": block_t, **{
                    k: device_profile(f)["device_ms"]
                    for k, f in fns.items()}})
    finally:
        K.PLAN_BLOCK_T = keep_t
    return rows


def serving_config():
    from repro_torch.configs import get_config
    cfg = get_config("mixtral_8x7b")
    return dataclasses.replace(
        cfg, n_layers=2, dtype="bfloat16",
        moe=dataclasses.replace(cfg.moe, dispatch="cuda_kernel"))


def step_profile(fn, steps: int) -> dict:
    """Wall and device ms a step and the device's idle share over
    ``steps`` calls under ``torch.profiler`` (kernel events only)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"profiled_wall_ms": wall / steps * 1e3,
            "device_ms": device_us / steps / 1e3,
            "idle_share": 1 - device_us / 1e6 / wall}


def steps() -> dict:
    """The served Mixtral's decode step and the train step on its
    parameters."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamW
    from repro_torch.shell.server import ModelEngine
    cfg = serving_config()
    engine = ModelEngine(cfg, max_len=STEP_PROMPT + STEP_WARM + STEP_REPS
                         + STEP_PROFILED + 8, seed=0)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, STEP_PROMPT
                                               ).astype(np.int32)
    tok, state = engine.prefill(prompt)
    for _ in range(STEP_WARM):
        tok, state = engine.decode(tok, state)

    def decode():
        nonlocal tok, state
        tok, state = engine.decode(tok, state)

    walls = []
    for _ in range(STEP_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out = {"decode": {"wall_ms": statistics.median(walls),
                      **step_profile(decode, STEP_PROFILED)}}
    model, params = engine.model, engine.params
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        0, 0, 0, 1, 1, TRAIN_SEQ, cfg.vocab).items()}
    opt = AdamW(lr=1e-3)
    step = make_train_step(model, opt)
    opt_state = opt.init(params)
    walls = []
    for i in range(TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch)
        torch.cuda.synchronize()
        if i:
            walls.append((time.perf_counter() - t0) * 1e3)
    out["train"] = {"step_wall_ms": walls, "loss": float(loss)}
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("plan_bench needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    K.library()
    for name, T, S, C in SHAPES:
        print(json.dumps({"shape": name, "T": T, "S": S, "C": C, **{
            k: measure(f) for k, f in plan_calls(T, S, C, gen).items()}}),
            flush=True)
    T, S, C = PLAN_TIMED
    print(json.dumps({"shape": "plan_2^20", "T": T, "S": S, "C": C,
                      "plan": measure(source_plan(T, S, C, gen))}),
          flush=True)
    if "--no-step" not in sys.argv[1:]:
        print(json.dumps(steps()), flush=True)
    if "--sweep" in sys.argv[1:] and hasattr(K, "PLAN_BLOCK_T"):
        print(json.dumps({"block_t_sweep": block_t_sweep(gen)}), flush=True)


if __name__ == "__main__":
    main()
