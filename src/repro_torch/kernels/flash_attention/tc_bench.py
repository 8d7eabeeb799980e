"""Time the bf16 flash kernels on the tensor-core route on the card,
forward and backward, at the shapes ``chip_smoke.py`` times, and compare
two trees in alternating rounds.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.tc_bench
    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.tc_bench \\
        --against build/parent/src --rounds 10 --shapes rgemma_prefill

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
frames, 16 heads of 64, non-causal), ``whisper_cross`` (4,096 queries
on 1,500 keys), and RecurrentGemma-9B's local attention at head dim 256
(16 heads on one kv head, causal, a window of 2,048): ``rgemma_prefill``
(S=32768) and ``rgemma_train`` (S=4096).  ``--shapes`` takes some of
them (all by default).

With ``--against DIR`` it runs itself as a file once a tree per round
(``kernels/timing.py``'s ``tree_rounds``: ``DIR`` is another tree's
``src``, for example a parent commit unpacked into ``build/parent``), in
the order other, this, this, other, ... for ``--rounds`` rounds, then
prints each shape's readings of both trees, their medians and the rounds
in which this tree's reading was the lower, the same for the backward's
device ms (``bwd_device_ms``, the sum of ``bwd_passes``), and each
backward kernel's median device ms over the rounds of each tree
(``bwd_passes``).  Compare trees only within one call.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys

import torch

SHAPES = {   # B, Sq, Sk, H, Kv, D, causal, window
    "train": (1, 4096, 4096, 32, 8, 128, True, None),
    "llava_g7": (1, 4096, 4096, 56, 8, 128, True, None),
    "whisper_encoder": (1, 1500, 1500, 16, 16, 64, False, None),
    "whisper_cross": (1, 4096, 1500, 16, 16, 64, False, None),
    "rgemma_prefill": (1, 32768, 32768, 16, 1, 256, True, 2048),
    "rgemma_train": (1, 4096, 4096, 16, 1, 256, True, 2048),
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
    B, Sq, Sk, H, Kv, D, causal, window = SHAPES[name]
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda"  # noqa: E731
                                ).bfloat16()
    q, k, v, do = mk(B, Sq, H, D), mk(B, Sk, Kv, D), mk(B, Sk, Kv, D), \
        mk(B, Sq, H, D)
    kw = dict(causal=causal, window=window, q_offset=0, mode=KernelMode.CUDA)
    fwd = lambda: FK.flash_fwd(q, k, v, **kw)  # noqa: E731
    o, lse = fwd()
    bwd = lambda: FK.flash_bwd(q, k, v, o, lse, do, **kw)  # noqa: E731
    return {"fwd_ms": event_ms(fwd, reps=30), "bwd_ms": event_ms(bwd, reps=30),
            "fwd_host_us": host_us(fwd, calls=200, chunk=20),
            "bwd_host_us": host_us(bwd, calls=200, chunk=20),
            "digest": digest([o, lse, *bwd()]),
            "fwd_passes": kernel_split(fwd), "bwd_passes": kernel_split(bwd)}


def one_tree(shapes) -> dict:
    from repro_torch.kernels.flash_attention import kernel as FK
    gen = torch.Generator(device="cuda").manual_seed(30)
    return {"source": str(pathlib.Path(FK.__file__).parents[2]),
            **{name: shape_reading(name, gen) for name in shapes}}


def pass_medians(readings) -> dict:
    """Each kernel's median device ms a call over rounds of
    ``kernel_split`` readings."""
    ms = {}
    for split in readings:
        for r in split:
            ms.setdefault(r["name"], []).append(r["device_ms"])
    return {name: statistics.median(v) for name, v in ms.items()}


def rounds(other: str, n: int, shapes) -> dict:
    """``n`` rounds of this file against the tree ``other``: each shape's
    readings of both trees compared (``timing.compare``) and their
    outputs' digests."""
    from repro_torch.kernels.timing import compare, tree_rounds
    got = tree_rounds(__file__, other, n, ["--shapes", *shapes])
    summary = {}
    for name in shapes:
        summary[name] = {key: compare([x[name][key] for x in got["other"]],
                                      [x[name][key] for x in got["this"]])
                         for key in READINGS}
        device = {t: [sum(r["device_ms"] for r in x[name]["bwd_passes"])
                      for x in got[t]] for t in ("other", "this")}
        summary[name]["bwd_device_ms"] = compare(device["other"],
                                                 device["this"])
        summary[name]["bwd_passes"] = {t: pass_medians(
            [x[name]["bwd_passes"] for x in got[t]])
            for t in ("other", "this")}
        summary[name]["digests"] = {t: sorted({x[name]["digest"]
                                               for x in got[t]})
                                    for t in ("other", "this")}
    return {"trees": got["trees"], "rounds": n, "shapes": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--shapes", nargs="+", choices=tuple(SHAPES),
                    default=list(SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tc_bench runs on a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    out = (rounds(args.against, args.rounds, args.shapes) if args.against
           else one_tree(args.shapes))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
