"""Time the SSD backward on the card at Mamba-2 780M's train shape, and the
train step that runs it 48 times; compare two trees in alternating rounds.

    PYTHONPATH=src python -m repro_torch.kernels.ssd.bwd_bench
    PYTHONPATH=src python -m repro_torch.kernels.ssd.bwd_bench \\
        --against build/parent/src --rounds 10

The same measurement of another tree (for example a parent commit unpacked
into ``build/parent``), run as a file so that ``repro_torch`` comes from
that tree:

    PYTHONPATH=build/parent/src python src/repro_torch/kernels/ssd/bwd_bench.py

Alone it prints the card's name and power limit, then one JSON line with:

* ``bwd_ms``: ``ssd_call_bwd`` on bf16 inputs (B=1, S=4096, H=48, P=64,
  N=128, chunk 256, an initial state and a cotangent of h_last), the median
  of 10 calls between two CUDA events with the card idle before each
  (``kernels/timing.py``, as ``chip_smoke.py`` times it); ``bwd_device_ms``
  and ``bwd_kernels``, the device time and kernels of a call
  (``torch.profiler``); ``passes``, the device ms of each kernel a call
  launches (``timing.kernel_split``); ``digest``, a hash of the
  gradients' bytes; ``rel_l2``, each gradient's relative L2 distance from
  the plain version's (``ref.ssd_bwd_ref``) on the same inputs;
* ``step_wall_ms``: ``STEPS`` AdamW steps (lr 1e-3) of Mamba-2 780M at all
  48 layers, bf16, remat "dots", on one synthetic ``train_4k`` batch cut to
  B=1 (S=4096), weights from seed 0, each from its start to a
  ``torch.cuda.synchronize()``, after ``WARMUP`` steps; their median;
  ``step_host_ms``, each step's time until the step function returned,
  before the synchronize (near the wall when the host paces the step);
  ``peak_gb``, the largest allocation over the timed steps;
  ``step_losses``, the loss of every step, warm-up ones included;
* ``step_device_ms`` and ``step_idle_share``: the second of two more steps
  under ``torch.profiler`` (the first warms it up), the device time of its
  kernels and the share of its wall time the card spent idle.

``--no-step`` leaves the step out.  With ``--against DIR`` it runs itself as
a file, without the step, once a tree per round (``kernels/timing.py``'s
``tree_rounds``: ``DIR`` is another tree's ``src``), in the order other,
this, this, other, ... for ``--rounds`` rounds, and prints both trees'
``bwd_ms`` and ``bwd_device_ms``, their medians, the rounds in which this
tree's reading was the lower, each tree's last ``passes`` and its digests;
then one run of each tree with the step (other, then this).  Compare two
trees only within one call, since cards and their hosts differ between
calls.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
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
from repro_torch.kernels.ssd import ref as sref
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import build_model
from repro_torch.optim.adamw import AdamW

try:
    from repro_torch.kernels.timing import device_profile, event_ms, kernel_split
except ImportError:          # run as a file against a tree older than timing.py
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from timing import device_profile, event_ms, kernel_split

B, S, H, P, N, CHUNK = 1, 4096, 48, 64, 128, 256
WARMUP, STEPS = 2, 5
LR = 1e-3
READINGS = ("bwd_ms", "bwd_device_ms")


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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
    got = call()
    plain = sref.ssd_bwd_ref(x, dA, dt, Bm, Cm, dy, CHUNK, h0, dhl)
    rel = {name: float((a.float() - b.float()).norm() / b.float().norm())
           for name, a, b in zip(("dx", "ddA", "ddt", "dB", "dC", "dh0"),
                                 got, plain)}
    return {"bwd_ms": event_ms(call, reps=10), "bwd_device_ms":
            prof["device_ms"], "bwd_kernels": prof["kernels"],
            "bwd_kernel_names": prof["names"], "passes": kernel_split(call),
            "digest": digest(got), "rel_l2": rel}


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
    losses = []
    for _ in range(WARMUP):
        params, state, loss = step(params, state, batch)
        losses.append(loss)
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
        losses.append(loss)
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
            losses.append(loss)
            prof.step()
    # the step's own annotation shows on the device timeline too
    device_us = sum(e.self_device_time_total for e in got
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.key.startswith("ProfilerStep"))
    return {"layers": cfg.n_layers, "remat": cfg.remat,
            "step_wall_ms": walls, "step_wall_ms_median":
            statistics.median(walls), "step_host_ms": hosts,
            "peak_gb": peak / 1e9, "loss": float(loss),
            "step_losses": [float(v) for v in losses],
            "step_device_ms": device_us / 1e3,
            "step_idle_share": 1 - device_us / 1e6 / wall}


def rounds(other: str, n: int) -> dict:
    """``n`` rounds of this file, without the step, against the tree
    ``other`` (``timing.tree_rounds``), each reading of both trees compared
    (``timing.compare``); then each tree once with the step."""
    from repro_torch.kernels.timing import compare, tree_rounds
    got = tree_rounds(__file__, other, n, ("--no-step",))
    out = {key: compare([x[key] for x in got["other"]],
                        [x[key] for x in got["this"]]) for key in READINGS}
    out["passes"] = {t: got[t][-1]["passes"] for t in ("other", "this")}
    out["digests"] = {t: sorted({x["digest"] for x in got[t]})
                      for t in ("other", "this")}
    step = {}
    for tree in ("other", "this"):
        env = {**os.environ, "PYTHONPATH": got["trees"][tree]}
        run = subprocess.run([sys.executable, __file__], env=env,
                             capture_output=True, text=True, check=True)
        step[tree] = json.loads(run.stdout.strip().splitlines()[-1])
    out["step"] = {t: {k: v for k, v in step[t].items()
                       if k.startswith("step_") or k in ("peak_gb", "loss")}
                   for t in step}
    out["rel_l2"] = {t: got[t][-1]["rel_l2"] for t in ("other", "this")}
    return {"trees": got["trees"], "rounds": n, "B": B, "S": S, "H": H,
            "P": P, "N": N, "chunk": CHUNK, **out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--no-step", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_bench runs on a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    if args.against:
        out = rounds(args.against, args.rounds)
    else:
        out = {"ssd_source": str(pathlib.Path(SK.__file__).parent),
               **bwd_reading(), **({} if args.no_step else step_reading())}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
