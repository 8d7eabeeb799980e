"""Time the plan's prefix pass three ways on the card, beside the whole
plan at the same shapes.

    PYTHONPATH=src python -m repro_torch.kernels.crossbar_dispatch.prefix_bench

``csrc/prefix_bench.cu`` includes ``crossbar_dispatch.cu`` and adds the
serial prefix pass (one thread per stream) that the block-per-stream scan
replaced.  The script builds it with ``nvcc`` into a temporary directory
(never cached, so it always holds the current ``crossbar_dispatch.cu``),
holds each variant against an exclusive cumsum, and prints one JSON line
per shape:

* ``prefix_us``: device microseconds per pass of each variant, from CUDA
  events around ``REPS`` passes launched back to back over a zeroed
  buffer (``serial``, ``block1024``, ``sized``; the library launches
  ``sized``);
* ``plan_ms``: the whole plan as ``chip_smoke.py`` times it (the median of
  20 calls, each between two CUDA events, so host time between launches
  counts), taken ``ROUNDS`` times to show how far it moves between rounds.

The card's name and power limit are printed first.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import tempfile

import torch

from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels import build
from repro_torch.kernels.crossbar_dispatch import kernel as K

SOURCE = pathlib.Path(__file__).parent / "csrc" / "prefix_bench.cu"
VARIANTS = ("serial", "block1024", "sized")
REPS = 200
ROUNDS = 5
# (name, plan, T, S): chip_smoke.py's served decode plan of the Mixtral
# (S = 8 experts) and its T = 8192 case, T = 65536, and the single-source
# plan at 2^20 packets over 16 ports.
SHAPES = (("decode", "plan_multi", 2, 8), ("large", "plan_multi", 8192, 8),
          ("64k", "plan_multi", 65536, 8),
          ("plan_2^20", "plan", 1 << 20, 16))


def load(out_dir: pathlib.Path) -> ctypes.CDLL:
    lib_path = out_dir / "prefix_bench.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(SOURCE)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.prefix_bench.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.prefix_bench.restype = ctypes.c_int
    return lib


def run_prefix(lib, hist: torch.Tensor, n_keys: int, n_blocks: int,
               variant: int, reps: int) -> None:
    build.check(lib.prefix_bench(hist.data_ptr(), n_keys, n_blocks, variant,
                                 reps, build.stream(hist.device)),
                "prefix_bench")


def check_variants(lib, n_keys: int, n_blocks: int, gen) -> None:
    """Each variant's one pass equals the exclusive cumsum along blocks."""
    hist = torch.randint(0, 4, (n_keys, n_blocks), generator=gen,
                         device="cuda", dtype=torch.int32)
    want = (hist.cumsum(1) - hist).to(torch.int32)
    for v, name in enumerate(VARIANTS):
        h = hist.T.contiguous() if v == 0 else hist.clone()
        run_prefix(lib, h, n_keys, n_blocks, v, 1)
        got = h.T if v == 0 else h
        if not torch.equal(got, want):
            raise AssertionError(f"prefix variant {name} disagrees at "
                                 f"[{n_keys}, {n_blocks}]")


def prefix_us(lib, n_keys: int, n_blocks: int, variant: int) -> float:
    hist = torch.zeros((n_keys, n_blocks), dtype=torch.int32, device="cuda")
    run_prefix(lib, hist, n_keys, n_blocks, variant, 3)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    run_prefix(lib, hist, n_keys, n_blocks, variant, REPS)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) * 1e3 / REPS


def median_call_ms(fn, reps: int = 20, warmup: int = 3) -> float:
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


def plan_call(which: str, T: int, S: int, gen):
    dst = torch.randint(0, S, (T,), generator=gen, device="cuda",
                        dtype=torch.int32)
    cuda = KernelMode.CUDA
    if which == "plan":
        ones = torch.ones((S,), dtype=torch.int32, device="cuda")
        zeros = torch.zeros_like(ones)
        cap = torch.full((S,), T, dtype=torch.int32, device="cuda")
        return lambda: K.plan(dst, ones, zeros, cap, mode=cuda)
    src = torch.randint(0, S, (T,), generator=gen, device="cuda",
                        dtype=torch.int32)
    allowed = torch.ones((S, S), dtype=torch.int32, device="cuda")
    quota = torch.zeros_like(allowed)
    return lambda: K.plan_multi(dst, src, allowed, quota, mode=cuda)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("prefix_bench needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        lib = load(pathlib.Path(tmp))
        for name, which, T, S in SHAPES:
            n_keys = S * S if which == "plan_multi" else S
            n_blocks = -(-T // K.PLAN_BLOCK)
            check_variants(lib, n_keys, n_blocks, gen)
            us = {v: prefix_us(lib, n_keys, n_blocks, i)
                  for i, v in enumerate(VARIANTS)}
            fn = plan_call(which, T, S, gen)
            plan_ms = [median_call_ms(fn) for _ in range(ROUNDS)]
            print(json.dumps({"shape": name, "plan": which, "T": T, "S": S,
                              "streams": n_keys, "token_blocks": n_blocks,
                              "prefix_us": us, "plan_ms": plan_ms}),
                  flush=True)


if __name__ == "__main__":
    main()
