"""Run one cell of the port's benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Finds ``cells/<cell>.json``, its configuration and its driver by name,
runs the program (``repro_torch`` from ``src/``) on the card, and prints
one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared, with its limit
(also the last lines on standard error).  Exits 2, printing no result,
without a card; 1 on any failure, also when a module of JAX or of the
JAX package ``repro`` is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _paths() -> None:
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # every cache of the run inside the checkout, at fixed paths
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(bench_obj, spec: dict) -> dict:
    """The result line of a finished run (``spec``: BENCHMARK.json)."""
    from port_bench import bench
    b = bench_obj
    name = b.cell_name
    metrics = {}
    if b.trace:
        for m in spec["per_layer"]:
            if name not in m.get("workloads", [name]):
                continue
            v = bench.reader(m["name"]).read(b)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            if name not in m.get("workloads", [name]):
                continue
            v = b.setup_s if m["name"] == "setup_s" else b.e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = device_info(b)
    out = {"correct": b.correct, "attempted": b.attempted,
           "failed": b.failed, "metrics": metrics, "device": device}
    if b.trace:
        bd = b.breakdown()
        if bd is not None:
            out["breakdown"] = bd
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in b.checks.items()}
    if b.faults:
        out["checks"]["faults"] = {"value": len(b.faults), "limit": 0,
                                   "what": b.faults}
    return out


def device_info(b) -> dict:
    import torch
    if getattr(b.device, "type", "") != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": int(b.cell.get("chips", 1)),
           "memory_peak_bytes": int(b.peak_bytes)}
    if b.trace:
        out["busy_s"] = b.busy_s()
        out["window_s"] = b.trace_window_s
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             cell: dict = None, config: dict = None, t_start: float = None):
    """One run of cell ``name`` on ``device``; returns the finished
    ``Bench``.  ``cell``/``config`` stand in for the files (tests)."""
    from port_bench import bench
    cell = cell if cell is not None else bench.cell_spec(name)
    config = config if config is not None else bench.config_spec(
        cell["config"])
    b = bench.Bench(name, cell, config, seed, seconds, trace, device,
                    T_START if t_start is None else t_start)
    bench.driver(cell["driver"]).run(b)
    return b


def main(argv=None) -> int:
    args = parse(argv)
    _paths()
    from port_bench import bench
    spec = bench.benchmark()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 1
    import torch
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    b = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0))
    found = bench.forbidden_modules()
    if found:
        print(f"modules of JAX or of its package loaded: {found}",
              file=sys.stderr)
        return 1
    out = measure(b, spec)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
