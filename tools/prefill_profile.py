"""Profile one bf16 prefill at S=32768 of the full Mamba-2 780M (48
layers) and RecurrentGemma-9B (38 layers) on the card, random weights
from seed 0, as ``chip_smoke.py --profile`` does in its serve phases: the
wall ms, the device ms, the device's idle share, the heaviest kernels and
the port's own kernels (those of ``src/repro_torch/kernels/*/csrc``, each
in an anonymous namespace) by device ms.

    PYTHONPATH=src python3 tools/prefill_profile.py
    PYTHONPATH=build/parent/src python3 tools/prefill_profile.py

With another tree's ``src`` on ``PYTHONPATH`` it profiles that tree
(compare trees only within one call).  It prints the card's name and
power limit, then one JSON line per model.
"""
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

ARCHS = ("mamba2_780m", "recurrentgemma_9b")
SEQ = 32768


def is_port_kernel(key: str) -> bool:
    return "(anonymous namespace)::" in key and "at::" not in key


def profile_prefill(arch: str) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.shell.server import ModelEngine
    cfg = dataclasses.replace(get_config(arch), dtype="bfloat16")
    engine = ModelEngine(cfg, max_len=64, seed=0)
    model, params = engine.model, engine.params
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, SEQ)).astype(np.int32)).cuda()
    with torch.no_grad():
        model.prefill(params, {"tokens": tokens[:, :2048]})    # warm-up
        model.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    device_us = sum(e.self_device_time_total for e in rows)
    row = lambda e: {"name": e.key[:100], "calls": e.count,  # noqa: E731
                     "device_ms": e.self_device_time_total / 1e3}
    return {"arch": arch, "layers": cfg.n_layers, "S": SEQ,
            "wall_ms": wall * 1e3, "device_ms": device_us / 1e3,
            "device_idle_share": 1 - device_us / 1e6 / wall,
            "top": [row(e) for e in rows[:10]],
            "port_kernels": [row(e) for e in rows if is_port_kernel(e.key)]}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("prefill_profile runs on a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    for arch in ARCHS:
        print(json.dumps(profile_prefill(arch)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
