"""Time the scatter and combine kernels on the card three ways, beside the
PyTorch call that computes the same function.

    PYTHONPATH=src python -m repro_torch.kernels.crossbar_dispatch.row_bench

The same measurement of another tree's kernels (for example a parent commit
unpacked into ``build/parent``), run as a file so that ``repro_torch``
comes from that tree:

    PYTHONPATH=build/parent/src python \\
        src/repro_torch/kernels/crossbar_dispatch/row_bench.py

For each shape of ``SHAPES`` (the served decode, the train step's and the
large case of ``chip_smoke.py``; bf16 rows of 4096, a plan with unique
slots per expert and capacity drops) it prints one JSON line with, for
``scatter``, ``index_copy_`` into a zeroed slab, ``combine`` and
``index_select`` x w:

* ``event_ms``: the median of 20 calls, each between two CUDA events with
  the card idle before it, so the host's path to the launch counts (as
  ``chip_smoke.py`` times every kernel);
* ``device_ms``: the device time of the kernels a call launches, from
  ``torch.profiler`` over 20 calls, with ``kernels`` and ``memsets`` (a
  memset or a fill kernel) per call;
* ``host_us``: host microseconds per call over 1,000 calls enqueued while
  the card is busy (``torch.cuda._sleep`` ahead of each 100), so no call
  waits for the card

(the helpers of ``kernels/timing.py``).

Where the tree has the two-pass scatter (``kernel.OWNER_PASS_T``) it also
prints ``decode_host_parts_us`` first (host us of a decode-shape scatter
call, of its slab's ``torch.empty`` and of its launch alone) and
``owner_pass`` last: the scatter's device time in one pass and in two at
T = 2048, 8192 and 65536.  The card's name and power limit come first.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import torch

from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels import build
from repro_torch.kernels.crossbar_dispatch import kernel as K

try:
    from repro_torch.kernels.timing import device_profile, event_ms, host_us
except ImportError:          # run as a file against a tree older than timing.py
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from timing import device_profile, event_ms, host_us

# (name, T, S, C, D): chip_smoke.py's moe_decode, moe_train and large_bf16
SHAPES = (("moe_decode", 2, 8, 8, 4096), ("moe_train", 2048, 8, 320, 4096),
          ("large_bf16", 8192, 8, 1280, 4096))
OWNER_SHAPES = ((2048, 8, 320, 4096, torch.bfloat16),
                (8192, 8, 1280, 4096, torch.bfloat16),
                (65536, 16, 4096, 8, torch.float32))


def measure(fn) -> dict:
    return {"event_ms": event_ms(fn), **device_profile(fn),
            "host_us": host_us(fn)}


def plan(T: int, S: int, C: int, gen: torch.Generator):
    """A served plan: random experts, slot = rank among the packets to the
    same expert, kept below capacity C."""
    dst = torch.randint(0, S, (T,), generator=gen, device="cuda",
                        dtype=torch.int32)
    oh = torch.nn.functional.one_hot(dst.long(), S)
    rank = ((oh.cumsum(0) - oh) * oh).sum(1)
    keep = rank < C
    slot = torch.where(keep, rank, 0).to(torch.int32)
    return dst, keep.to(torch.int32), slot


def calls(T: int, S: int, C: int, D: int, dtype, gen: torch.Generator):
    """The four calls at one shape, as chip_smoke.py's timings make them."""
    dst, keep, slot = plan(T, S, C, gen)
    x = torch.randn((T, D), generator=gen, device="cuda").to(dtype)
    y = torch.randn((S, C, D), generator=gen, device="cuda").to(dtype)
    w = torch.rand((T,), generator=gen, device="cuda")
    ok = keep > 0
    addr = torch.where(ok, dst * C + slot, S * C).long()
    flat = torch.zeros((S * C + 1, D), dtype=dtype, device="cuda")
    y_flat = y.reshape(S * C, D)
    w_lib = (w * ok).to(dtype)
    cidx = torch.where(ok, addr, 0)
    cuda = KernelMode.CUDA
    return {
        "scatter": lambda: K.scatter(x, dst, keep, slot, n_ports=S,
                                     capacity=C, mode=cuda),
        "index_copy_": lambda: flat.index_copy_(0, addr, x),
        "combine": lambda: K.combine(y, dst, keep, slot, w, mode=cuda),
        "index_select_x_w": lambda: y_flat.index_select(0, cidx)
        * w_lib[:, None],
    }


def host_parts(gen: torch.Generator) -> dict:
    """Host us per call of one scatter call at the decode shape and of two
    of its parts: the slab's allocation, and the launch alone (the ctypes
    call with its arguments ready)."""
    _, T, S, C, D = SHAPES[0]
    dst, keep, slot = plan(T, S, C, gen)
    x = torch.randn((T, D), generator=gen, device="cuda").to(torch.bfloat16)
    slabs = torch.empty(S, C, D, dtype=x.dtype, device="cuda")
    args = (x.data_ptr(), dst.data_ptr(), keep.data_ptr(), slot.data_ptr(),
            None, slabs.data_ptr(), T, S, C, D * x.element_size() // 16,
            build.stream(x.device))
    lib = K.library()
    return {
        "wrapper": host_us(lambda: K.scatter(x, dst, keep, slot, n_ports=S,
                                             capacity=C,
                                             mode=KernelMode.CUDA)),
        "allocation": host_us(lambda: torch.empty(S, C, D, dtype=x.dtype,
                                                  device="cuda")),
        "launch": host_us(lambda: lib.crossbar_scatter(*args)),
    }


def owner_pass(gen: torch.Generator) -> list:
    """The scatter's device time in one pass and in two."""
    rows, keep_t = [], K.OWNER_PASS_T
    try:
        for T, S, C, D, dtype in OWNER_SHAPES:
            fn = calls(T, S, C, D, dtype, gen)["scatter"]
            row = {"T": T, "S": S, "C": C, "D": D}
            for name, t in (("one_pass", 1 << 30), ("two_pass", 0)):
                K.OWNER_PASS_T = t
                row[name] = device_profile(fn)
            rows.append(row)
    finally:
        K.OWNER_PASS_T = keep_t
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("row_bench needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    K.library()
    new_tree = hasattr(K, "OWNER_PASS_T")      # this PR's scatter ABI
    if new_tree:
        print(json.dumps({"decode_host_parts_us": host_parts(gen)}),
              flush=True)
    for name, T, S, C, D in SHAPES:
        fns = calls(T, S, C, D, torch.bfloat16, gen)
        print(json.dumps({"shape": name, "T": T, "S": S, "C": C, "D": D,
                          **{k: measure(f) for k, f in fns.items()}}),
              flush=True)
    if new_tree:
        print(json.dumps({"owner_pass": owner_pass(gen)}), flush=True)


if __name__ == "__main__":
    main()
