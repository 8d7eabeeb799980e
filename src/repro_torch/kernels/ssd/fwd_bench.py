"""Time the SSD forward on the card at Mamba-2 780M's prefill shape, and
compare two trees in alternating rounds.

    PYTHONPATH=src python -m repro_torch.kernels.ssd.fwd_bench
    PYTHONPATH=src python -m repro_torch.kernels.ssd.fwd_bench \\
        --against build/parent/src --rounds 10

Alone it prints the card's name and power limit, then one JSON line for
``ssd_call`` on bf16 inputs at B=1, S=32768, H=48, P=64, N=128, chunk 256
(``chip_smoke.py``'s ``ssd.time`` shape): ``fwd_ms``, the median of 20
calls between two CUDA events with the card idle before each;
``host_us``, the host's microseconds a call, enqueued while the card is
busy; ``passes`` and ``device_ms``, the device ms of each kernel a call
launches and their sum (``torch.profiler``); ``digest``, a hash of y's
and h_last's bytes.  Inputs come from a seeded generator on the card.

With ``--against DIR`` it runs itself as a file once a tree per round
(``kernels/timing.py``'s ``tree_rounds``: ``DIR`` is another tree's
``src``, for example a parent commit unpacked into ``build/parent``), in
the order other, this, this, other, ... for ``--rounds`` rounds, then
prints both trees' readings, their medians and the rounds in which this
tree's reading was the lower.  Compare trees only within one call.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys

import torch

SHAPE = dict(B=1, S=32768, H=48, P=64, N=128, chunk=256)
READINGS = ("fwd_ms", "host_us", "device_ms")


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def one_tree() -> dict:
    from repro_torch.fabric.interface import KernelMode
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.timing import event_ms, host_us, kernel_split
    B, S, H, P, N, Q = (SHAPE[k] for k in ("B", "S", "H", "P", "N", "chunk"))
    gen = torch.Generator(device="cuda").manual_seed(31)
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    x = rn(B, H, S, P).bfloat16()
    dt = torch.nn.functional.softplus(rn(B, H, S) - 2.0)
    dA = dt * (-torch.exp(rn(H) * 0.5))[None, :, None]
    Bm, Cm = (rn(B, S, N) * 0.3).bfloat16(), (rn(B, S, N) * 0.3).bfloat16()
    call = lambda: SK.ssd_call(x, dA, dt, Bm, Cm, chunk=Q,  # noqa: E731
                               mode=KernelMode.CUDA)
    passes = kernel_split(call)
    return {"source": str(pathlib.Path(SK.__file__).parents[3]), **SHAPE,
            "fwd_ms": event_ms(call, reps=20),
            "host_us": host_us(call, calls=200, chunk=20),
            "device_ms": sum(p["device_ms"] for p in passes),
            "passes": passes, "digest": digest(call())}


def rounds(other: str, n: int) -> dict:
    """``n`` rounds of this file against the tree ``other``, each reading
    of both trees compared (``timing.compare``), and their digests."""
    from repro_torch.kernels.timing import compare, tree_rounds
    got = tree_rounds(__file__, other, n)
    out = {key: compare([x[key] for x in got["other"]],
                        [x[key] for x in got["this"]]) for key in READINGS}
    out["passes"] = {t: got[t][-1]["passes"] for t in ("other", "this")}
    out["digests"] = {t: sorted({x["digest"] for x in got[t]})
                      for t in ("other", "this")}
    return {"trees": got["trees"], "rounds": n, **SHAPE, **out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fwd_bench runs on a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    out = rounds(args.against, args.rounds) if args.against else one_tree()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
