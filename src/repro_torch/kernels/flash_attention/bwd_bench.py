"""Time the two backward kernels of RecurrentGemma-9B's train step on the
card, and the step itself: the flash backward at head dim 256 and the
RG-LRU backward.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.bwd_bench

The same measurement of another tree (for example a parent commit unpacked
into ``build/parent``), run as a file so that ``repro_torch`` comes from
that tree:

    PYTHONPATH=build/parent/src python src/repro_torch/kernels/flash_attention/bwd_bench.py

It prints the card's name and power limit, then one JSON line with:

* ``flash``: ``flash_bwd`` on bf16 inputs at the train shape (B=1, S=4096,
  16 query heads on one kv head, head dim 256, causal, a window of 2048):
  ``ms``, the median of 30 calls between two CUDA events with the card
  idle before each (``kernels/timing.py``, as ``chip_smoke.py`` times it);
  ``device_ms`` and ``kernels``, the device time and kernels of a call;
  ``passes``, the device ms of each kernel a call launches
  (``torch.profiler``); ``host_us``, the host's microseconds a call,
  enqueued while the card is busy; ``digest``, a hash of the gradients'
  bytes, which shows whether two trees give the same bits;
* ``rglru``: ``rglru_scan_bwd`` at the train shape (B=1, S=4096, L=4096, u
  and dh bf16, an initial state and a cotangent of h_last, the forward
  kernel's carries), the same readings;
* ``step_wall_ms``: ``STEPS`` AdamW steps (lr 1e-3) of RecurrentGemma-9B
  cut to 2 of its 12 groups (6 blocks, as ``chip_smoke.py`` trains it),
  bf16, remat "dots", on one synthetic ``train_4k`` batch cut to B=1
  (S=4096), weights from seed 0, each from its start to a
  ``torch.cuda.synchronize()``, after ``WARMUP`` steps, and their median;
  ``step_device_ms``, ``step_idle_share`` and ``step_kernels`` (the port's
  kernels, device ms a step) from the second of two more steps under
  ``torch.profiler``.

With ``--no-step`` it leaves out the train step.  Compare two trees only
within one call, in turns (parent, change, change, parent), since cards
and their hosts differ between calls.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.rglru import kernel as RK
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import build_model
from repro_torch.optim.adamw import AdamW

try:
    from repro_torch.kernels.timing import (device_profile, event_ms, host_us,
                                            kernel_name, kernel_split)
except ImportError:          # run as a file against an older tree
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from timing import (device_profile, event_ms, host_us, kernel_name,
                        kernel_split)

S, H, KV, D, WINDOW, L = 4096, 16, 1, 256, 2048, 4096
LAYERS = 6                   # 2 of RecurrentGemma-9B's 12 groups
WARMUP, STEPS = 2, 5
LR = 1e-3
CUDA = KernelMode.CUDA


def port_kernels() -> set:
    """The names of the ``__global__`` functions in the measured tree's
    ``kernels/*/csrc`` sources."""
    names = set()
    for src in pathlib.Path(FK.__file__).parents[1].glob("*/csrc/*.cu"):
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
            src.read_text()))
    return names


def _kernel_rows(events, per: int) -> list:
    """Device ms (per ``per`` calls or steps) and launches of each kernel
    in ``events`` (``key_averages()`` rows); ``port`` marks the tree's own
    kernels."""
    ours = port_kernels()
    rows = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]
    rows.sort(key=lambda e: -e.self_device_time_total)
    return [{"name": kernel_name(e.key), "launches": e.count / per,
             "device_ms": e.self_device_time_total / per / 1e3,
             "port": re.split(r"[<(]", kernel_name(e.key).removeprefix(
                 "tc::"))[0] in ours} for e in rows]


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, to compare two trees' outputs."""
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def reading(fn) -> dict:
    prof = device_profile(fn, calls=10)
    return {"ms": event_ms(fn, reps=30), "device_ms": prof["device_ms"],
            "kernels": prof["kernels"], "passes": kernel_split(fn),
            "host_us": host_us(fn, calls=200, chunk=20),
            "digest": digest(fn())}


def flash_inputs(gen):
    bf = torch.bfloat16
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    q, k, v, do = (rn(1, S, H, D).to(bf), rn(1, S, KV, D).to(bf),
                   rn(1, S, KV, D).to(bf), rn(1, S, H, D).to(bf))
    kw = dict(causal=True, window=WINDOW, q_offset=0)
    o, lse = FK.flash_fwd(q, k, v, mode=CUDA, **kw)
    return (q, k, v, o, lse, do), kw


def rglru_inputs(gen):
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    a = torch.sigmoid(rn(1, S, L) + 2.0) * 0.98 + 0.01
    u = (rn(1, S, L) * 0.5).to(torch.bfloat16)
    h0, dhl = rn(1, L) * 0.3, rn(1, L)
    dh = rn(1, S, L).to(torch.bfloat16)
    _, _, carries = RK.rglru_scan(u, a, h0, mode=CUDA, save_carries=True)
    return (u, a, h0, dh, dhl, carries)


def kernel_readings() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(24)
    args, kw = flash_inputs(gen)
    out = {"flash": reading(lambda: FK.flash_bwd(*args, mode=CUDA, **kw))}
    del args
    rargs = rglru_inputs(gen)
    out["rglru"] = reading(lambda: RK.rglru_scan_bwd(*rargs, mode=CUDA))
    return out


def step_reading() -> dict:
    from torch.profiler import ProfilerActivity, profile, schedule
    cfg = dataclasses.replace(get_config("recurrentgemma_9b"),
                              dtype="bfloat16", n_layers=LAYERS)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        0, 0, 0, 1, 1, S, cfg.vocab).items()}
    opt = AdamW(lr=LR)
    step = make_train_step(model, opt)
    state = opt.init(params)
    for _ in range(WARMUP):
        params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
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
    rows = _kernel_rows(got, 1)
    device_ms = sum(r["device_ms"] for r in rows)
    port = [r for r in rows if r["port"]]
    return {"layers": cfg.n_layers, "remat": cfg.remat,
            "step_wall_ms": walls,
            "step_wall_ms_median": statistics.median(walls),
            "loss": float(loss), "step_device_ms": device_ms,
            "step_idle_share": 1 - device_ms / 1e3 / wall,
            "step_kernels": port}


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    out = {"source": str(pathlib.Path(FK.__file__).parents[1]),
           **kernel_readings()}
    if "--no-step" not in sys.argv[1:]:
        out.update(step_reading())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
