"""Quickstart: the paper's mechanism in five minutes (the JAX package's
``examples/quickstart.py`` on the port).

1. Build a crossbar register file (Table III).
2. Route packets through ``repro_torch.fabric.Fabric``: the
   quota-arbitrated, isolation-checked dispatch behind one API, with the
   backend (the plain reference vs the ``cuda`` backend, whose plans run
   on the crossbar kernels on the card) a constructor argument.
3. Reconfigure bandwidth at runtime by rewriting registers, with no
   rebuild (``fabric.trace_counts`` shows it).
4. Run the paper's own three modules (multiplier -> Hamming encoder ->
   decoder) through the Hamming kernels, end to end, bit-exactly.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.registers import CrossbarRegisters, ErrorCode
from repro_torch.fabric import Fabric
from repro_torch.kernels.hamming.ops import (hamming_decode, hamming_encode,
                                             multiply_const)


def run(device=None) -> dict:
    """Run the four steps on ``device`` (the card unless ``"cpu"``),
    printing each; returns what was printed as a record."""
    dev = resolve_device(device)
    rec = {}
    print("== 1. A 4-port crossbar register file (Table III) ==")
    regs = CrossbarRegisters.create(n_ports=4, capacity=16, device=dev)
    # Tenant isolation: port 1 may only talk to ports 1 and 2 (one-hot AND).
    regs = regs.with_isolation(src=1, allowed_dsts=[1, 2])
    # Bandwidth allocation: master 0 may send at most 4 packages to slave 2.
    regs = regs.with_quota(dst=2, src=0, packages=4)
    rec["version"] = int(regs.version)
    rec["registers"] = {k: v.cpu().numpy() for k, v in vars(regs).items()}
    print(f"   version={rec['version']} (each ERM write bumps it)")

    print("== 2. One data-plane API, pluggable backends ==")
    T, D = 32, 8
    x = torch.arange(T * D, dtype=torch.float32, device=dev).reshape(T, D)
    dst = torch.tensor([2] * 8 + [3] * 8 + [2] * 8 + [0] * 8,
                       dtype=torch.int32, device=dev)
    src = torch.tensor([0] * 16 + [1] * 16, dtype=torch.int32, device=dev)
    live = {"regs": regs}
    fabric = Fabric(lambda: live["regs"], backend="reference", capacity=16,
                    device=dev)
    plan = fabric.plan(dst, src)
    drops = plan.drops.cpu().numpy()
    rec["granted"] = int(plan.keep.sum())
    rec["invalid_dest"] = int(drops[ErrorCode.INVALID_DEST])
    rec["grant_timeout"] = int(drops[ErrorCode.GRANT_TIMEOUT])
    print(f"   granted={rec['granted']}/{T}  "
          f"errors: INVALID_DEST={rec['invalid_dest']} "
          f"GRANT_TIMEOUT={rec['grant_timeout']}")
    # src 0 -> dst 2 is quota-limited to 4; src 1 -> dst 3 violates isolation.
    kernels = Fabric(lambda: live["regs"], backend="cuda", capacity=16,
                     device=dev)
    rec["plan_identical"] = bool(
        (kernels.plan(dst, src).slot == plan.slot).all())
    print(f"   cuda backend plan-identical: {rec['plan_identical']}")

    print("== 3. Reconfigure at runtime (the ERM write path) ==")
    double = lambda slabs: slabs * 2.0                        # noqa: E731
    fabric.transfer(x, dst, src, apply_fn=double)             # build once
    traces = fabric.trace_counts["transfer"]
    live["regs"] = regs.with_quota(dst=2, src=0, packages=0)  # 0 = unlimited
    y, plan2 = fabric.transfer(x, dst, src, apply_fn=double)  # same program
    rec["granted_after_lift"] = int(plan2.keep.sum())
    rec["transfer_retraces"] = fabric.trace_counts["transfer"] - traces
    print(f"   after quota lift: granted={rec['granted_after_lift']}/{T}  "
          f"(transfer retraces during reconfig: "
          f"{rec['transfer_retraces']})")
    # the fused round-trip returned module results in packet order
    rec["round_trip_exact"] = bool(torch.allclose(
        y, x * 2.0 * plan2.keep[:, None]))
    print(f"   transfer round-trip exact: {rec['round_trip_exact']}")

    print("== 4. The paper's module chain on the Hamming kernels ==")
    data = np.random.default_rng(0).integers(
        0, 1 << 26, size=4096, dtype=np.uint32)           # 16 KB (§V-C)
    words = torch.from_numpy(data.view(np.int32)).to(dev).view(torch.uint32)
    out = multiply_const(words, 3)
    out = hamming_encode(out)
    decoded, corrected = hamming_decode(out)
    expect = (data.astype(np.uint64) * 3).astype(np.uint32) \
        & np.uint32((1 << 26) - 1)
    got = decoded.view(torch.int32).cpu().numpy().view(np.uint32)
    rec["chain_bit_exact"] = bool(np.array_equal(got, expect))
    rec["spurious_corrections"] = int(
        corrected.view(torch.int32).cpu().numpy().sum())
    print(f"   16 KB through multiply->encode->decode: "
          f"bit-exact={rec['chain_bit_exact']}, "
          f"spurious corrections={rec['spurious_corrections']}")
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is named")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
