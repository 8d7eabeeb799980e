"""The profiler window of a traced run, after the port's
``repro_torch.kernels.timing`` (copied, so that the program cannot move
it): the window opens with short sleep kernels, since the profiler drops
a window's first device events on some hosts; a warm-up step of the same
work runs under the profiler first and only the second step is read; a
window whose device events lost a kernel that the caller counts on is
taken again after a pause, up to ``PROFILE_TRIES`` times.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Callable, List, Tuple

import torch

PROFILE_TRIES = 10
PROFILE_PAUSE_S = 0.5
OPENING_SPINS = 16
SPIN_CYCLES = 125_000            # the 16 about a millisecond of the card


def _sync() -> None:
    torch.cuda.synchronize()


def traced_window(work: Callable[[], None], units: int = 1
                  ) -> Tuple[list, list, float]:
    """Profile ``work`` twice and read the second call: (device ops as
    (name, start s, duration s), host annotations as (name, start s,
    end s), the window's host seconds).  ``work`` repeats one unit of
    work ``units`` times; a window in which some op does not come a whole
    number of times a unit lost events, and is taken again."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for attempt in range(PROFILE_TRIES):
        if attempt:
            time.sleep(PROFILE_PAUSE_S)
        got: list = []
        wall = [0.0]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: got.extend(p.events())) as prof:
            for _ in range(2):
                for _ in range(OPENING_SPINS):
                    torch.cuda._sleep(SPIN_CYCLES)
                _sync()
                t0 = time.perf_counter()
                work()
                _sync()
                wall[0] = time.perf_counter() - t0
                prof.step()
        device, host = split_events(got)
        counts = Counter(n for n, _, _ in device)
        if counts and all(c % units == 0 for c in counts.values()):
            return device, host, wall[0]
    raise RuntimeError(
        f"torch.profiler lost device events in {PROFILE_TRIES} windows of "
        f"{units} units: {dict(counts)}")


def split_events(events) -> Tuple[list, list]:
    """Device ops (kernels, copies, fills) and host annotations of a
    profile, times in seconds on the profiler's clock."""
    device: List[tuple] = []
    host: List[tuple] = []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the annotations show on the device's timeline too
            if (e.name.startswith(("ProfilerStep", "bench."))
                    or "spin_kernel" in e.name):
                continue
            t = e.time_range
            device.append((e.name, t.start / 1e6, (t.end - t.start) / 1e6))
        elif e.name.startswith("bench."):
            t = e.time_range
            host.append((e.name, t.start / 1e6, t.end / 1e6))
    # a window opens with the sleep kernels; the first op of the work
    # starts the span the window is read over
    device.sort(key=lambda x: x[1])
    return device, host
