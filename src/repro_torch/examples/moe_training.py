"""End to end: train a ~100M-parameter MoE LM for a few hundred
steps (the JAX package's ``examples/moe_training.py`` on the port).

The MoE layer routes tokens to experts under the paper's crossbar
mechanism: the WRR package quota is the expert capacity, the isolation
mask restricts which experts this tenant may use, and drop statistics
surface the paper's error codes.  Training runs the full substrate (data
pipeline with prefetching, AdamW with a cosine schedule, asynchronous
checkpoints, a step watchdog) and asserts that the loss falls.

The run is a tenant on a ``repro_torch.shell.Shell``: the step watchdog
is attached to the shell, so a blown deadline surfaces as a
``WatchdogTimeout`` event on the shell's log.

    PYTHONPATH=src python -m repro_torch.examples.moe_training [--steps 300] [--device cpu]

``--sharded`` instead shows expert parallelism: ``--devices`` ranks
(default 4), spawned with ``torch.multiprocessing`` over gloo (the JAX
script re-execs onto a forced device count), run the MoE layer through
the sharded fabric backend: experts partitioned across the ranks, tokens
crossing them in the global-WRR all-to-all, and a live ``Shell`` rewriting
the register file between steps with nothing rebuilt.  On the card every
rank uses ``cuda:0`` (NCCL refuses two ranks on one card).

    PYTHONPATH=src python -m repro_torch.examples.moe_training --sharded
"""
from __future__ import annotations

import argparse
import os
import pickle
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.elastic import Region
from repro_torch.core.module import ModuleFootprint
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.lm import build_model
from repro_torch.runtime.train import TrainLoop, TrainLoopConfig
from repro_torch.shell import Shell, Submit

GB = 1 << 30

# ~100M-param MoE: 8 layers, d=512, 8 experts (top-2), d_ff=1408.
MOE_100M = ModelConfig(
    name="moe-100m", family="moe", n_layers=8, d_model=512,
    n_heads=8, n_kv_heads=4, d_ff=1408, vocab=32000,
    attn_window=1024, moe=MoEConfig(n_experts=8, top_k=2),
    remat="nothing")

#: the sharded demo's layer: one expert port a rank, d=64, d_ff=128
SHARDED_D, SHARDED_FF, SHARDED_CAP = 64, 128, 256
SHARDED_TIMEOUT_S = 600.0


def default_ckpt_dir() -> str:
    """The checkpoint directory when none is given, under the temporary
    directory (``TMPDIR``)."""
    return os.path.join(tempfile.gettempdir(), "elastix_moe_ckpt")


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
def run(steps: int = 300, batch: int = 8, seq: int = 256,
        ckpt: Optional[str] = None, device=None, *,
        ckpt_every: int = 100) -> dict:
    """Train ``MOE_100M`` as a tenant of a shell on ``device`` (the card
    unless ``"cpu"``), printing the log; returns what was printed as a
    record (``loop``: the ``TrainLoop``; ``converged``: the check the
    script asserts)."""
    ckpt = ckpt or default_ckpt_dir()
    model = build_model(MOE_100M, device="meta")
    n_params = model.n_params()
    print(f"model: {MOE_100M.name}  params={n_params/1e6:.1f}M "
          f"({MOE_100M.moe.n_experts} experts, top-{MOE_100M.moe.top_k})")

    # Control plane: the training job is a tenant on the elastic shell;
    # the step watchdog posts WatchdogTimeout events here (no polling).
    shell = Shell([Region(rid=i, n_chips=16, hbm_bytes=8 * GB)
                   for i in range(2)])
    shell.post(Submit(
        tenant="moe-train",
        footprints=(ModuleFootprint(
            param_bytes=n_params * 4, flops_per_token=6e9,
            activation_bytes_per_token=MOE_100M.d_model * 4),),
        app_id=0))
    placement = shell.placement_of("moe-train")
    print(f"shell: tenant 'moe-train' placed at {placement}")

    cfg = TrainLoopConfig(steps=steps, global_batch=batch, seq_len=seq,
                          lr=6e-4, warmup=30, ckpt_every=ckpt_every,
                          log_every=10, seed=0)
    t0 = time.time()
    loop = TrainLoop(MOE_100M, cfg, ckpt_dir=Path(ckpt),
                     on_log=lambda r: print(
                         f"  step {r['step']:4d}  loss {r['loss']:.4f}  "
                         f"({r['step_s']:.2f}s)"),
                     shell=shell, device=device)
    hist = loop.run_loop()
    dt = time.time() - t0

    first = hist[0]["loss"]
    last = min(h["loss"] for h in hist[-3:])
    tok_s = steps * batch * seq / dt
    print(f"\nloss {first:.4f} -> {last:.4f} over {steps} steps "
          f"({dt:.0f}s, {tok_s:,.0f} tok/s on {loop.device.type})")
    ckpts = (sorted(p.name for p in Path(ckpt).iterdir())
             if Path(ckpt).is_dir() else [])
    print("checkpoints:", ckpts)
    timeouts = [e for e in shell.log
                if type(e.event).__name__ == "WatchdogTimeout"]
    print(f"shell log: {len(shell.log)} events "
          f"({len(timeouts)} watchdog timeouts)")
    return {"n_params": n_params, "placement": placement, "history": hist,
            "first": first, "last": last, "converged": last < first - 0.3,
            "seconds": dt, "tokens_per_s": tok_s, "checkpoints": ckpts,
            "ckpt_dir": ckpt, "loop": loop,
            "shell_log": [(type(e.event).__name__,
                           getattr(e.event, "tenant", None))
                          for e in shell.log],
            "watchdog_timeouts": len(timeouts)}


# ----------------------------------------------------------------------
# expert parallelism over ranks
# ----------------------------------------------------------------------
def sharded_inputs(n_devices: int, seed: int = 0):
    """The demo's layer parameters and tokens [2n, 32, d] (float32 numpy),
    drawn from ``seed``."""
    from repro_torch.models.common import init_params
    from repro_torch.models.moe import moe_defs
    moe = sharded_moe(n_devices)
    gen = torch.Generator().manual_seed(seed)
    params = init_params(moe_defs(SHARDED_D, SHARDED_FF, moe, "swiglu"), gen,
                         torch.float32, "cpu")
    x = torch.randn((n_devices * 2, 32, SHARDED_D), generator=gen)
    return {k: v.numpy() for k, v in params.items()}, x.numpy()


def sharded_moe(n_devices: int) -> MoEConfig:
    """One expert port a rank."""
    return MoEConfig(n_experts=n_devices, top_k=2, capacity_factor=2.0)


def sharded_demo(n_devices: int = 4, device=None, *, params=None, x=None,
                 timeout: float = SHARDED_TIMEOUT_S) -> dict:
    """Expert parallelism over ``n_devices`` gloo ranks (every rank on
    ``device``: the card's ``cuda:0`` unless ``"cpu"``); ``params`` and
    ``x`` default to :func:`sharded_inputs`.  Rank 0 prints; returns its
    record (every rank's must be the same)."""
    import torch.multiprocessing as mp
    from repro_torch.core.device import resolve_device
    dev = str(resolve_device(device))
    if params is None:
        params, x = sharded_inputs(n_devices)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _sharded_entry, args=(n_devices, tmp, dev, params, x),
            nprocs=n_devices, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0,
                                           deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"sharded ranks still running after "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        recs = []
        for r in range(n_devices):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                recs.append(pickle.load(f))
    for r, rec in enumerate(recs[1:], 1):
        if not all(np.array_equal(a[k], b[k])
                   for a, b in zip(rec["events"], recs[0]["events"])
                   for k in a):
            raise AssertionError(f"rank {r}'s stats differ from rank 0's")
    return recs[0]


def _sharded_entry(rank, n, tmp, device, params, x):
    import torch.distributed as dist
    torch.set_num_threads(1)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        tmp, "store"), rank=rank, world_size=n)
    try:
        rec = _sharded_rank(rank, n, device, params, x)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(rec, f)


def _sharded_rank(rank, n, device, params_np, x_np) -> dict:
    from repro_torch.kernels import build
    from repro_torch.models.moe import moe_fabric, moe_forward_sharded
    from repro_torch.shell import FailRegion, Grow
    say = print if rank == 0 else (lambda *a, **k: None)
    dev = torch.device(device)
    E = n                                   # one expert port a rank
    moe = sharded_moe(n)
    params = {k: torch.as_tensor(v, device=dev) for k, v in params_np.items()}
    x = torch.as_tensor(x_np, device=dev)

    # Control plane: E crossbar ports = host + (E-1) regions; the MoE's
    # experts ride the shell's own register file.
    shell = Shell([Region(rid=i, n_chips=8, hbm_bytes=8 * GB)
                   for i in range(E - 1)], capacity=SHARDED_CAP)
    shell.submit("moe", [ModuleFootprint(GB, 1e9, 4096)] * (E - 1),
                 app_id=0)
    fabric = moe_fabric(E, SHARDED_CAP, "sharded", device=dev)

    def step():
        with torch.no_grad():
            _, stats = moe_forward_sharded(params, x, moe, "swiglu",
                                           registers=shell.registers,
                                           capacity=SHARDED_CAP)
        fabric.account_stats(stats)
        return {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                for k, v in stats.items() if k != "aux_loss"}

    events = []
    say(f"== sharded MoE: {E} experts across {n} ranks ({device}) ==")
    events.append(step())
    t0 = fabric.trace_count
    loads = dict(build.load_count)
    st = events[-1]
    say(f"   step 0: granted={int(st['granted_packets'])} "
        f"remote={int(st['remote_packets'])} "
        f"local={int(st['local_packets'])} traces={t0}")

    shell.post(FailRegion(rid=0))        # expert port 1 held in reset
    events.append(step())
    st = events[-1]
    say(f"   after FailRegion(0): expert-port grants="
        f"{st['counts'].tolist()} dropped={int(st['dropped'])} "
        f"traces={fabric.trace_count}")

    shell.post(Grow(tenant="moe"))       # no-op grow (already full) + heal
    shell.heal_region(0)
    events.append(step())
    st = events[-1]
    say(f"   after HealRegion(0): dropped={int(st['dropped'])} "
        f"traces={fabric.trace_count}")
    if fabric.trace_count != t0:
        raise AssertionError("reconfiguration must not retrace")
    if dict(build.load_count) != loads or (
            dev.type == "cuda" and any(v != 1 for v in loads.values())):
        raise AssertionError(f"reconfiguration must not rebuild: kernel "
                             f"library loads {loads} -> "
                             f"{dict(build.load_count)}")
    say(f"   register epochs seen: {shell.epoch + 1}, retraces: {t0} "
        f"(zero per reconfiguration)")
    say(f"   cumulative fabric counters: offered="
        f"{fabric.offered_packets} granted={fabric.granted_packets} "
        f"remote={fabric.remote_packets} local={fabric.local_packets}")
    return {"events": events, "traces": t0,
            "traces_after": fabric.trace_count, "epoch": shell.epoch,
            "library_loads": dict(build.load_count),
            "cumulative": {"offered": fabric.offered_packets,
                           "granted": fabric.granted_packets,
                           "remote": fabric.remote_packets,
                           "local": fabric.local_packets}}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: elastix_moe_ckpt "
                         "under the temporary directory)")
    ap.add_argument("--sharded", action="store_true",
                    help="run the expert-parallelism demo over gloo ranks "
                         "instead of the training loop")
    ap.add_argument("--devices", type=int, default=4,
                    help="ranks of the --sharded demo")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is named")
    args = ap.parse_args(argv)

    if args.sharded:
        sharded_demo(args.devices, args.device)
        return 0
    rec = run(args.steps, args.batch, args.seq, args.ckpt, args.device)
    if not rec["converged"]:
        raise AssertionError("training did not converge")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
