"""Time the SSD backward on the card at Mamba-2 780M's train shape, and the
train step that runs it 48 times.

    PYTHONPATH=src python -m repro_torch.kernels.ssd.bwd_bench

The same measurement of another tree (for example a parent commit unpacked
into ``build/parent``), run as a file so that ``repro_torch`` comes from
that tree:

    PYTHONPATH=build/parent/src python src/repro_torch/kernels/ssd/bwd_bench.py

It prints the card's name and power limit, then one JSON line with:

* ``bwd_ms``: ``ssd_call_bwd`` on bf16 inputs (B=1, S=4096, H=48, P=64,
  N=128, chunk 256, an initial state and a cotangent of h_last), the median
  of 10 calls between two CUDA events with the card idle before each
  (``kernels/timing.py``, as ``chip_smoke.py`` times it); ``bwd_device_ms``
  and ``bwd_kernels``, the device time and kernels of a call
  (``torch.profiler``);
* ``step_wall_ms``: ``STEPS`` AdamW steps (lr 1e-3) of Mamba-2 780M at all
  48 layers, bf16, remat "dots", on one synthetic ``train_4k`` batch cut to
  B=1 (S=4096), weights from seed 0, each from its start to a
  ``torch.cuda.synchronize()``, after ``WARMUP`` steps; their median;
  ``step_host_ms``, each step's time until the step function returned,
  before the synchronize (near the wall when the host paces the step);
  ``peak_gb``, the largest allocation over the timed steps;
* ``step_device_ms`` and ``step_idle_share``: the second of two more steps
  under ``torch.profiler`` (the first warms it up), the device time of its
  kernels and the share of its wall time the card spent idle.

Compare two trees only within one call, in turns (parent, change, change,
parent), since cards and their hosts differ between calls.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels.ssd import kernel as SK
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import build_model
from repro_torch.optim.adamw import AdamW

try:
    from repro_torch.kernels.timing import device_profile, event_ms
except ImportError:          # run as a file against a tree older than timing.py
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from timing import device_profile, event_ms

B, S, H, P, N, CHUNK = 1, 4096, 48, 64, 128, 256
WARMUP, STEPS = 2, 5
LR = 1e-3


def bwd_reading() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(6)
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    bf = torch.bfloat16
    x, dy = rn(B, H, S, P).to(bf), rn(B, H, S, P).to(bf)
    dt = torch.nn.functional.softplus(rn(B, H, S))
    dA = dt * -torch.exp(rn(H) * 0.5)[None, :, None]
    Bm, Cm = (rn(B, S, N) * 0.3).to(bf), (rn(B, S, N) * 0.3).to(bf)
    h0, dhl = rn(B, H, P, N) * 0.3, rn(B, H, P, N)

    def call():
        return SK.ssd_call_bwd(x, dA, dt, Bm, Cm, dy, chunk=CHUNK, h0=h0,
                               dh_last=dhl, mode=KernelMode.CUDA)

    prof = device_profile(call, calls=10)
    return {"bwd_ms": event_ms(call, reps=10), "bwd_device_ms":
            prof["device_ms"], "bwd_kernels": prof["kernels"],
            "bwd_kernel_names": prof["names"]}


def step_reading() -> dict:
    from torch.profiler import ProfilerActivity, profile, schedule
    cfg = dataclasses.replace(get_config("mamba2_780m"), dtype="bfloat16")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        0, 0, 0, 1, B, S, cfg.vocab).items()}
    opt = AdamW(lr=LR)
    step = make_train_step(model, opt)
    state = opt.init(params)
    for _ in range(WARMUP):
        params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, hosts = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        hosts.append((t1 - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    got = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: got.extend(p.key_averages())
                 ) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            params, state, loss = step(params, state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.step()
    # the step's own annotation shows on the device timeline too
    device_us = sum(e.self_device_time_total for e in got
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.key.startswith("ProfilerStep"))
    return {"layers": cfg.n_layers, "remat": cfg.remat,
            "step_wall_ms": walls, "step_wall_ms_median":
            statistics.median(walls), "step_host_ms": hosts,
            "peak_gb": peak / 1e9, "loss": float(loss),
            "step_device_ms": device_us / 1e3,
            "step_idle_share": 1 - device_us / 1e6 / wall}


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    out = {"ssd_source": str(pathlib.Path(SK.__file__).parent),
           **bwd_reading(), **step_reading()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
