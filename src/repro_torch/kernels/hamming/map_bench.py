"""Time the word-stream kernels at 2^28 words on the card against
``torch.mul``, in alternating rounds.

    PYTHONPATH=src python -m repro_torch.kernels.hamming.map_bench

The same measurement of another tree's kernels (for example a parent commit
unpacked into ``build/parent``), run as a file so that ``repro_torch``
comes from that tree:

    PYTHONPATH=build/parent/src python \\
        src/repro_torch/kernels/hamming/map_bench.py

Each of ``ROUNDS`` rounds times ``mul_const``, ``torch.mul`` on the same
words and constant, ``hamming_encode`` and ``hamming_decode``, each as the
median of 20 calls between two CUDA events with the card idle before each
call (``kernels/timing.py``, as ``chip_smoke.py`` times every kernel, so
the host's path to the launch counts), and prints one JSON line; a last
line gives each one's median over the rounds, its device time from
``torch.profiler`` over 20 calls, and ``host_us``: host microseconds a call
over 1,000 calls on 4,096 words enqueued on a busy card, the host's share
of the event times.  The card's name and power limit are printed first.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

import torch

from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels.hamming import kernel as HK

try:
    from repro_torch.kernels.timing import device_profile, event_ms, host_us
except ImportError:          # run as a file against a tree older than timing.py
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from timing import device_profile, event_ms, host_us

WORDS = 1 << 28
CONSTANT = 2654435761
ROUNDS = 7
REPS = 20


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "words": WORDS, "constant": CONSTANT,
                      "hamming_source": str(pathlib.Path(HK.__file__).parent)}),
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randint(-(1 << 31), 1 << 31, (WORDS,), generator=gen,
                      device="cuda", dtype=torch.int64).to(torch.int32)
    c32 = (CONSTANT & 0xFFFFFFFF) - (1 << 32) * bool(CONSTANT & (1 << 31))
    cuda = KernelMode.CUDA
    fns = {"mul_const": lambda: HK.mul_const(x, CONSTANT, mode=cuda),
           "torch.mul": lambda: torch.mul(x, c32),
           "hamming_encode": lambda: HK.hamming_encode(x, mode=cuda),
           "hamming_decode": lambda: HK.hamming_decode(x, mode=cuda)}
    if not torch.equal(fns["mul_const"](), fns["torch.mul"]()):
        raise AssertionError("mul_const disagrees with torch.mul")
    rounds = {k: [] for k in fns}
    for r in range(ROUNDS):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        row = {k: event_ms(fns[k], reps=REPS) for k in order}
        for k, v in row.items():
            rounds[k].append(v)
        print(json.dumps({"round": r, **{k: row[k] for k in fns}}),
              flush=True)
    summary = {k: {"median_of_rounds": statistics.median(v),
                   "device_ms": device_profile(fns[k], calls=REPS)[
                       "device_ms"]} for k, v in rounds.items()}
    small = x[:4096]
    for k, fn in (("mul_const", lambda: HK.mul_const(small, CONSTANT)),
                  ("torch.mul", lambda: torch.mul(small, c32)),
                  ("hamming_encode", lambda: HK.hamming_encode(small)),
                  ("hamming_decode", lambda: HK.hamming_decode(small))):
        summary[k]["host_us"] = host_us(fn)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
