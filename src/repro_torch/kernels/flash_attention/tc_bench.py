"""Time the bf16 flash kernels at head dims 64 and 128 on the card, forward
and backward, at the four shapes ``chip_smoke.py`` times, and compare two
trees in alternating rounds.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.tc_bench
    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.tc_bench \\
        --against build/parent/src --rounds 10

Alone it prints the card's name and power limit, then one JSON line:
for each shape, ``fwd_ms`` and ``bwd_ms`` (``flash_fwd`` and
``flash_bwd`` on the ``tc`` route, the median of 30 calls between two
CUDA events with the card idle before each: ``kernels/timing.py``),
``fwd_host_us`` and ``bwd_host_us`` (the host's microseconds a call,
enqueued while the card is busy) and ``digest``, a hash of the outputs'
bytes; ``fwd_passes`` and ``bwd_passes``, the device ms of each kernel a
call launches (``torch.profiler``).  The
shapes: ``train`` (B=1, S=4096, 32 heads on 8 kv heads, head dim 128,
causal), ``llava_g7`` (56 heads on 8), ``whisper_encoder`` (1,500
frames, 16 heads of 64, non-causal) and ``whisper_cross`` (4,096 queries
on 1,500 keys).

With ``--against DIR`` it runs itself as a file once a tree per round,
with ``DIR`` (another tree's ``src``, for example a parent commit unpacked
into ``build/parent``) or this tree's ``src`` on ``PYTHONPATH``, in the
order other, this, this, other, ... for ``--rounds`` rounds, then prints
each shape's readings of both trees, their medians and the rounds in
which this tree's reading was the lower.  Each tree builds its own
library on its first round.  Compare trees only within one call.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import statistics
import subprocess
import sys

import torch

SHAPES = {   # B, Sq, Sk, H, Kv, D, causal
    "train": (1, 4096, 4096, 32, 8, 128, True),
    "llava_g7": (1, 4096, 4096, 56, 8, 128, True),
    "whisper_encoder": (1, 1500, 1500, 16, 16, 64, False),
    "whisper_cross": (1, 4096, 1500, 16, 16, 64, False),
}
READINGS = ("fwd_ms", "bwd_ms", "fwd_host_us", "bwd_host_us")


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def shape_reading(name: str, gen) -> dict:
    from repro_torch.fabric.interface import KernelMode
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.timing import event_ms, host_us, kernel_split
    B, Sq, Sk, H, Kv, D, causal = SHAPES[name]
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda"  # noqa: E731
                                ).bfloat16()
    q, k, v, do = mk(B, Sq, H, D), mk(B, Sk, Kv, D), mk(B, Sk, Kv, D), \
        mk(B, Sq, H, D)
    kw = dict(causal=causal, window=None, q_offset=0, mode=KernelMode.CUDA)
    fwd = lambda: FK.flash_fwd(q, k, v, **kw)  # noqa: E731
    o, lse = fwd()
    bwd = lambda: FK.flash_bwd(q, k, v, o, lse, do, **kw)  # noqa: E731
    return {"fwd_ms": event_ms(fwd, reps=30), "bwd_ms": event_ms(bwd, reps=30),
            "fwd_host_us": host_us(fwd, calls=200, chunk=20),
            "bwd_host_us": host_us(bwd, calls=200, chunk=20),
            "digest": digest([o, lse, *bwd()]),
            "fwd_passes": kernel_split(fwd), "bwd_passes": kernel_split(bwd)}


def one_tree() -> dict:
    from repro_torch.kernels.flash_attention import kernel as FK
    gen = torch.Generator(device="cuda").manual_seed(30)
    return {"source": str(pathlib.Path(FK.__file__).parents[2]),
            **{name: shape_reading(name, gen) for name in SHAPES}}


def rounds(other: str, n: int) -> dict:
    """``n`` rounds of this file as a process, ``other`` and this tree's
    ``src`` on ``PYTHONPATH`` in the order other, this, this, other, ..."""
    here = str(pathlib.Path(__file__).resolve().parents[3])
    trees = {"other": str(pathlib.Path(other).resolve()), "this": here}
    got = {"other": [], "this": []}
    for r in range(n):
        for tree in (("other", "this") if r % 2 == 0 else ("this", "other")):
            env = {**os.environ, "PYTHONPATH": trees[tree]}
            out = subprocess.run([sys.executable, __file__], env=env,
                                 capture_output=True, text=True, check=True)
            got[tree].append(json.loads(out.stdout.strip().splitlines()[-1]))
    summary = {}
    for name in SHAPES:
        summary[name] = {}
        for key in READINGS:
            a = [x[name][key] for x in got["other"]]
            b = [x[name][key] for x in got["this"]]
            summary[name][key] = {
                "other": a, "this": b, "other_median": statistics.median(a),
                "this_median": statistics.median(b),
                "this_less_rounds": sum(y < x for x, y in zip(a, b))}
        summary[name]["digests"] = {t: sorted({x[name]["digest"]
                                               for x in got[t]})
                                    for t in got}
    return {"trees": trees, "rounds": n, "shapes": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tc_bench runs on a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    out = rounds(args.against, args.rounds) if args.against else one_tree()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
