"""Time the RG-LRU kernel on the card at RecurrentGemma-9B's prefill shape
(B=1, S=32768, L=4096), through both entries, in alternating rounds.

    PYTHONPATH=src python -m repro_torch.kernels.rglru.scan_bench

The same measurement of another tree's kernel (for example a parent commit
unpacked into ``build/parent``), run as a file so that ``repro_torch``
comes from that tree:

    PYTHONPATH=build/parent/src python \\
        src/repro_torch/kernels/rglru/scan_bench.py

Each of ``ROUNDS`` rounds times, as the median of 10 calls between two CUDA
events with the card idle before each call (``kernels/timing.py``, as
``chip_smoke.py`` times every kernel):

* ``rglru_call``: the float32 contract, a and b float32;
* ``entry_bf16``: ``ops.rglru_scan_kernel(u, a)`` with u bfloat16 and a
  float32, everything the entry launches;
* ``entry_bf16_h0``: the same with an initial state;

and prints one JSON line.  A last line gives each one's median over the
rounds, its device time, kernels and memsets a call (counted per launch of
``rglru_kernel``) with the kernels' names, and its bound: 12 bytes an
element for ``rglru_call``, 8 for the entries, over 3.35 TB/s.  The card's
name and power limit are printed first.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

import torch

from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels.rglru import kernel as RK
from repro_torch.kernels.rglru.ops import rglru_scan_kernel

try:
    from repro_torch.kernels.timing import device_profile, event_ms
except ImportError:          # run as a file against a tree older than timing.py
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from timing import device_profile, event_ms

B, S, L = 1, 32768, 4096
ROUNDS = 5
REPS = 10
HBM_BYTES_PER_S = 3.35e12


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "B": B, "S": S, "L": L,
                      "rglru_source": str(pathlib.Path(RK.__file__).parent)}),
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    a = torch.sigmoid(torch.randn((B, S, L), generator=gen, device="cuda")
                      + 2.0) * 0.98 + 0.01
    b = torch.randn((B, S, L), generator=gen, device="cuda") * 0.5
    u = b.to(torch.bfloat16)
    h0 = torch.randn((B, L), generator=gen, device="cuda") * 0.3
    cuda = KernelMode.CUDA
    fns = {"rglru_call": lambda: RK.rglru_call(a, b, mode=cuda),
           "entry_bf16": lambda: rglru_scan_kernel(u, a, mode=cuda),
           "entry_bf16_h0": lambda: rglru_scan_kernel(u, a, h0, mode=cuda)}
    n = a.numel()
    bounds = {"rglru_call": 12 * n, "entry_bf16": 8 * n,
              "entry_bf16_h0": 8 * n}
    rounds = {k: [] for k in fns}
    for r in range(ROUNDS):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        row = {k: event_ms(fns[k], reps=REPS, warmup=2) for k in order}
        for k, v in row.items():
            rounds[k].append(v)
        print(json.dumps({"round": r, **{k: row[k] for k in fns}}),
              flush=True)
    summary = {k: {"median_of_rounds": statistics.median(v),
                   "bound_ms": bounds[k] / HBM_BYTES_PER_S * 1e3,
                   **device_profile(fns[k], calls=REPS,
                                    kernel="rglru_kernel")}
               for k, v in rounds.items()}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
