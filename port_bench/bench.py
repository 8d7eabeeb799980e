"""The harness's core: the specs found by name, one run of one cell, its
spans, the traced window, the comparison's checks and the
result line.

A cell (``cells/<name>.json``) names its configuration
(``configs/<config>.json``), its driver (``drivers/<kind>.py``, a module
with ``run(bench)``) and its traffic parameters; a per-layer metric of
``BENCHMARK.json`` is read by ``metrics/<metric>.py`` (a module with
``read(bench)`` that returns a number or None).  Nothing here imports the
program: the drivers do.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import pathlib
import sys
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_spec(name: str) -> dict:
    return load_json(HERE / "cells" / f"{name}.json")


def config_spec(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def _module(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(
        "port_bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    return _module(HERE / "drivers" / f"{kind}.py")


def reader(metric: str):
    return _module(HERE / "metrics" / f"{metric}.py")


def forbidden_modules(names=None) -> List[str]:
    """Top-level names in ``sys.modules`` (or ``names``) that the
    benchmark may not load, compared whole (``repro_torch`` is not
    ``repro``)."""
    tops = {m.split(".")[0] for m in list(sys.modules if names is None
                                          else names)}
    return sorted(tops & set(FORBIDDEN))


def quantile(values: List[float], q: float) -> float:
    """The ``q`` quantile by linear interpolation between order
    statistics (``numpy.quantile``'s default)."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Bench:
    """One run of one cell: what the driver records, and the result."""

    def __init__(self, cell_name: str, cell: dict, config: dict, seed: int,
                 seconds: float, trace: bool, device, t_start: float):
        self.cell_name = cell_name
        self.cell = cell
        self.config = config
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_start = t_start
        self.tracing = False              # inside the traced window
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.work: Dict[str, Any] = {}
        self.e2e: Dict[str, float] = {}
        self.checks: Dict[str, tuple] = {}
        self.faults: List[str] = []
        self.attempted = 0
        self.failed = 0
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.peak_bytes = 0
        self.window_peak_bytes = 0
        self.device_ops: List[tuple] = []
        self.annotations: List[tuple] = []
        self.trace_window_s: Optional[float] = None

    # ---- spans --------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str):
        """Host seconds of a call into a layer, kept under ``name``; in
        the traced window also a profiler annotation ``bench.<name>``."""
        ctx = contextlib.nullcontext()
        if self.tracing:
            import torch
            ctx = torch.profiler.record_function("bench." + name)
        t0 = time.perf_counter()
        with ctx:
            yield
        if not self.tracing:
            self.spans[name].append(time.perf_counter() - t0)

    # ---- the window -----------------------------------------------------
    def _cuda(self) -> bool:
        return getattr(self.device, "type", str(self.device)) == "cuda"

    def sync(self) -> None:
        if self._cuda():
            import torch
            torch.cuda.synchronize()

    def begin_window(self) -> float:
        """End of set-up: the card idle, the peak so far kept, the spans of
        set-up dropped.  Returns the window's start."""
        self.sync()
        if self._cuda():
            import torch
            self.peak_bytes = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        self.spans.clear()
        now = time.perf_counter()
        self.setup_s = now - self.t_start
        self._window_t0 = now
        return now

    def deadline(self) -> float:
        return self._window_t0 + self.seconds

    def end_window(self) -> float:
        """The window's close (after a synchronise); its seconds."""
        self.sync()
        self.window_s = time.perf_counter() - self._window_t0
        if self._cuda():
            import torch
            self.window_peak_bytes = torch.cuda.max_memory_allocated()
            self.peak_bytes = max(self.peak_bytes, self.window_peak_bytes)
        return self.window_s

    def traced(self, work: Callable[[], None], units: int = 1):
        """With ``--trace 1`` on the card: ``work`` under the profiler
        (``timing.traced_window``), its device ops and annotations kept.
        A fixed amount of work, run after the measured window."""
        if not (self.trace and self._cuda()):
            return
        from port_bench import timing
        self.tracing = True
        try:
            ops, notes, wall = timing.traced_window(work, units)
        finally:
            self.tracing = False
        self.device_ops, self.annotations = ops, notes
        self.trace_window_s = wall
        if self._cuda():
            import torch
            self.peak_bytes = max(self.peak_bytes,
                                  torch.cuda.max_memory_allocated())

    # ---- the trace's sums ---------------------------------------------
    def busy_s(self) -> Optional[float]:
        """Seconds of the traced window in which a device op ran (the
        union of their intervals)."""
        if not self.device_ops:
            return None
        busy, end = 0.0, -math.inf
        for _, t0, dur in sorted(self.device_ops, key=lambda x: x[1]):
            t1 = t0 + dur
            if t1 <= end:
                continue
            busy += t1 - max(t0, end)
            end = t1
        return busy

    def breakdown(self) -> Optional[dict]:
        if not self.device_ops:
            return None
        by_name: Dict[str, float] = defaultdict(float)
        for n, _, d in self.device_ops:
            by_name[_short(n)] += d
        top = sorted(by_name.items(), key=lambda x: -x[1])[:10]
        ops = sorted(self.device_ops, key=lambda x: x[1])
        gaps = []
        for (_, a0, ad), (_, b0, _) in zip(ops, ops[1:]):
            if b0 > a0 + ad:
                gaps.append((a0 + ad, b0 - (a0 + ad)))
        gaps.sort(key=lambda g: -g[1])
        labelled = [[self._open_span(t), g] for t, g in gaps[:10]]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": labelled}

    def _open_span(self, t: float) -> str:
        """The innermost benchmark span open on the host at ``t``."""
        best = None
        for name, t0, t1 in self.annotations:
            if t0 <= t <= t1 and (best is None or t0 >= best[1]):
                best = (name, t0)
        return best[0].removeprefix("bench.") if best else "between spans"

    # ---- correctness --------------------------------------------------
    def check(self, name: str, value: float, limit: float) -> None:
        """A number compared with its limit: passes when ``value <=
        limit`` (and the value is a number)."""
        self.checks[name] = (float(value), float(limit))

    def fail(self, why: str) -> None:
        """A fault found outside the numbers (a missing answer, a
        non-finite loss): the run is not correct."""
        self.faults.append(why)

    @property
    def correct(self) -> bool:
        return (not self.faults and bool(self.checks)
                and all(v <= lim for v, lim in self.checks.values()))


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0][:120]

