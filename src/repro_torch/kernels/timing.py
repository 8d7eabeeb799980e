"""Timing of kernel calls on the card, shared by ``chip_smoke.py``, the card
tests and the kernels' bench scripts (``crossbar_dispatch/row_bench.py``,
``crossbar_dispatch/plan_bench.py``, ``rglru/scan_bench.py``,
``hamming/map_bench.py``, ``flash_attention/bwd_bench.py``).

* :func:`event_ms`: the median time of one call between two CUDA events,
  the card idle before each call, so the host's path to the launch counts.
* :func:`device_profile`: the device time of what a call launches, with
  the kernels and memsets a call, from ``torch.profiler``.
* :func:`kernel_split`: the same device time kernel by kernel.
* :func:`host_us`: host microseconds a call, enqueued while the card is
  busy, so no call waits for the card.
* :func:`tree_rounds` and :func:`compare`: a bench file run against
  another tree in alternating rounds (``flash_attention/tc_bench.py``,
  ``ssd/fwd_bench.py``, ``ssd/bwd_bench.py``).

It imports nothing of ``repro_torch``, so a bench run as a file against
another tree's package can load it from its own tree.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time
from typing import Optional, Sequence

import torch

HOST_CALLS, HOST_CHUNK = 1000, 100
SLEEP_CYCLES = 20_000_000          # some 10 ms of a busy card per chunk
# windows read before giving up: on one card host the profiler lost RG-LRU
# backward events in 5 windows in a row, twice, where another host lost none
PROFILE_TRIES = 10
PROFILE_PAUSE_S = 0.5                # between windows that lost events
# each profiled window opens with short sleep kernels (not reported): the
# profiler drops a window's first device events, on one card host one of
# them in every window, on another five
OPENING_SPINS = 16
SPIN_CYCLES = 125_000                # the 16 about a millisecond of the card


def event_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one call between two CUDA events, the card idle
    before each call."""
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


def device_profile(fn, calls: int = 20, kernel: Optional[str] = None
                   ) -> dict:
    """Device ms a call of the kernels and memsets ``fn`` launches, how many
    of each a call launches (``kernels``, ``memsets``) and their ``names``.

    The profiler drops device events at the start of its window (on the
    card, all 10 calls of a 30 us kernel, or 4 of 20 calls of 0.07 ms), so
    a warm-up step of ``calls`` calls runs first and only the second step
    is read, each opening with ``OPENING_SPINS`` sleep kernels (not
    reported) for the profiler to drop.  With ``kernel`` (part of a kernel's name) every count is taken
    per event of that kernel, so a call that launches it once and nothing
    else gives 1 even if an event is lost; without, the window is taken
    again until its events are a whole number a call.  A window that lost
    events is followed by a pause before the next: on the card, windows
    taken back to back could lose events three times in a row, where one
    taken after a pause did not."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        if attempt:
            time.sleep(PROFILE_PAUSE_S)
        # the step's own annotation shows on the device timeline too
        events = [e for e in _window(fn, calls, lambda p: p.events())
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith("ProfilerStep")
                  and "spin_kernel" not in e.name]   # the opening sleeps
        if kernel is not None:
            per = sum(kernel in e.name for e in events)
            if per:
                break
        elif events and len(events) % calls == 0:
            per = calls
            break
    else:
        raise RuntimeError(
            f"torch.profiler gave {len(events)} device events for {calls} "
            f"calls{'' if kernel is None else ', none of ' + kernel}, "
            f"{PROFILE_TRIES} times: {sorted({e.name for e in events})}")
    # a buffer cleared by torch.zeros shows as a fill kernel, not a memset
    memsets = [e for e in events
               if "memset" in e.name.lower() or "FillFunctor" in e.name]
    return {"device_ms": sum(e.device_time_total for e in events)
            / per / 1e3,
            "kernels": (len(events) - len(memsets)) / per,
            "memsets": len(memsets) / per,
            "names": sorted({e.name[:100] for e in events})}


def kernel_split(fn, calls: int = 5) -> list:
    """Device ms a call of each kernel ``fn`` launches and its launches a
    call (``name``, ``launches_per_call``, ``device_ms``), heaviest first,
    from the kernel rows of the second of two windows of ``calls`` calls,
    as :func:`device_profile` reads them, each opening with
    ``OPENING_SPINS`` sleep kernels (not reported), since the profiler can
    drop a window's first events; a window whose kernels do not come a
    whole number of times a call is taken again after a pause, and after
    ``PROFILE_TRIES`` windows it raises."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        if attempt:
            time.sleep(PROFILE_PAUSE_S)
        rows = [e for e in _window(fn, calls, lambda p: p.key_averages())
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0
                and not e.key.startswith("ProfilerStep")
                and "spin_kernel" not in e.key]   # the opening sleeps
        if rows and all(e.count % calls == 0 for e in rows):
            break
    else:
        raise RuntimeError(
            f"torch.profiler gave kernels not a whole number of times in "
            f"{calls} calls, {PROFILE_TRIES} times: "
            f"{ {kernel_name(e.key): e.count for e in rows} }")
    rows.sort(key=lambda e: -e.self_device_time_total)
    return [{"name": kernel_name(e.key), "launches_per_call": e.count // calls,
             "device_ms": e.self_device_time_total / calls / 1e3}
            for e in rows]


def kernel_name(key: str) -> str:
    """A kernel's name as the profiler keys it, without its arguments."""
    return re.split(r"\(", key.replace("(anonymous namespace)::", "")
                    .removeprefix("void "))[0]


def _window(fn, calls: int, read) -> list:
    """``read`` of a profile (its events or key averages) of the second of
    two windows of ``calls`` calls each, the first a warm-up; each window
    opens with ``OPENING_SPINS`` sleep kernels."""
    from torch.profiler import ProfilerActivity, profile, schedule
    got = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: got.extend(read(p))) as prof:
        for _ in range(2):
            for _ in range(OPENING_SPINS):
                torch.cuda._sleep(SPIN_CYCLES)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return got


def host_us(fn, calls: int = HOST_CALLS, chunk: int = HOST_CHUNK) -> float:
    """Host microseconds per call, enqueued while the card is busy."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // chunk):
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        for _ in range(chunk):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / calls * 1e6


def tree_rounds(script: str, other: str, n: int,
                args: Sequence[str] = ()) -> dict:
    """``n`` rounds of the bench file ``script`` run as a process with
    ``args``, another tree's ``src`` (``other``, for example a parent
    commit unpacked into ``build/parent``) or this tree's on
    ``PYTHONPATH``, in the order other, this, this, other, ...: the
    readings each run prints as JSON on its last line, by tree
    (``{"trees": ..., "other": [...], "this": [...]}``).  Each tree builds
    its own libraries on its first round.  Compare trees only within one
    call."""
    trees = {"other": str(pathlib.Path(other).resolve()),
             "this": str(pathlib.Path(__file__).resolve().parents[2])}
    got = {"other": [], "this": []}
    for r in range(n):
        for tree in (("other", "this") if r % 2 == 0 else ("this", "other")):
            env = {**os.environ, "PYTHONPATH": trees[tree]}
            out = subprocess.run([sys.executable, script, *args], env=env,
                                 capture_output=True, text=True, check=True)
            got[tree].append(json.loads(out.stdout.strip().splitlines()[-1]))
    return {"trees": trees, **got}


def compare(other: Sequence[float], this: Sequence[float]) -> dict:
    """Two trees' readings of one quantity from :func:`tree_rounds`: both
    lists, their medians, and the rounds in which this tree's was lower."""
    return {"other": list(other), "this": list(this),
            "other_median": statistics.median(other),
            "this_median": statistics.median(this),
            "this_less_rounds": sum(y < x for x, y in zip(other, this))}
