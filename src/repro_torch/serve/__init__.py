"""``repro_torch.serve`` — seeded serving workloads over the elastic stack.

The control plane (``repro_torch.shell``), data plane
(``repro_torch.fabric``) and manager (``repro_torch.manager``) assemble
into a serving system; this package is the load side: deterministic
engines, seeded arrival schedules (front-loaded and heavy-tailed), mid-run
reconfiguration scripts, and a harness
that folds a run into one :class:`~repro_torch.serve.harness.ServeReport` —
tick-latency percentiles, admission percentiles, tokens/s, plan-cache
counters, and a completion digest for bit-identity checks.

``chip_smoke.py``'s ``serve_harness`` phase runs the steady-state and
reconfiguration-storm shapes of the JAX package's
``benchmarks/serve_bench.py`` from exactly these pieces on the card; tests
drive the same harness at smaller scale.
"""
from repro_torch.serve.harness import (  # noqa: F401
    ReconfigEvent, SeededEngine, ServeHarness, ServeReport, StreamSpec,
    dump_arrivals, front_loaded_arrivals, heavy_tailed_arrivals,
    load_arrivals)

__all__ = [
    "SeededEngine", "StreamSpec", "ReconfigEvent", "ServeHarness",
    "ServeReport", "front_loaded_arrivals", "heavy_tailed_arrivals",
    "dump_arrivals", "load_arrivals",
]
