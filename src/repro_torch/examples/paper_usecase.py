"""Reproduce the paper's experiments end to end (Fig 5, §V-D, §V-E, Fig 6;
the JAX package's ``examples/paper_usecase.py`` on the port).

Runs the calibrated full-system model, prints each reproduced number next
to the paper's, and cross-checks the data path against the Hamming
kernels.  Milliseconds and cycles are the model's (the FPGA at 250 MHz and
the server, calibrated to the paper), not times of the card.

    PYTHONPATH=src python -m repro_torch.examples.paper_usecase [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.hw.area import AreaModel
from repro_torch.core.hw.crossbar import (CrossbarSim, MasterRequest,
                                          best_case_time_to_grant,
                                          request_completion_cc,
                                          worst_case_completion_cc,
                                          worst_case_time_to_grant)
from repro_torch.core.hw.system import (ElasticUseCase, PAPER_CASE1_MS,
                                        PAPER_CASE3_MS)
from repro_torch.kernels.hamming.ops import (hamming_decode, hamming_encode,
                                             multiply_const)


def run(device=None) -> dict:
    """Print the paper's numbers beside the model's and run the data-path
    cross-check on ``device`` (the card unless ``"cpu"``); returns what
    was printed as a record (``use_case``: the ``ElasticUseCase``)."""
    dev = resolve_device(device)
    print("== Fig 5: elasticity use case (16 KB, 3 modules) ==")
    uc = ElasticUseCase()
    fig5 = uc.figure5()
    print(f"   case 1 (mult on FPGA):        {fig5[1]:6.2f} ms   "
          f"(paper: {PAPER_CASE1_MS})")
    print(f"   case 2 (+encoder):            {fig5[2]:6.2f} ms   "
          f"(paper: between)")
    print(f"   case 3 (all three on FPGA):   {fig5[3]:6.2f} ms   "
          f"(paper: {PAPER_CASE3_MS})")

    print("\n== §V-D: dynamic bandwidth allocation (quota 16 -> 128) ==")
    bw = uc.bandwidth_table()
    print(f"   1 accelerator: {100*bw[1]:.2f}%  (paper: 5.24%)")
    print(f"   3 accelerators: {100*bw[3]:.2f}%  (paper: 6%)")
    print(f"   calibration residuals: "
          f"{ {k: round(v, 4) for k, v in uc.calibration_residuals.items()} }")

    print("\n== §V-E: communication overhead ==")
    cycles = {"best_grant": best_case_time_to_grant(),
              "completion_8": request_completion_cc(8),
              "worst_grant_3": worst_case_time_to_grant(3),
              "worst_completion_3": worst_case_completion_cc(3)}
    print(f"   best-case time-to-grant:      {cycles['best_grant']} cc "
          f"(paper: 4)")
    print(f"   completion, 8 packages:       {cycles['completion_8']} cc "
          f"(paper: 13)")
    print(f"   worst-case grant, 3 masters:  {cycles['worst_grant_3']} cc"
          f" (paper: 28)")
    print(f"   worst-case completion:        "
          f"{cycles['worst_completion_3']} cc (paper: 37)")

    sim = CrossbarSim()
    for m in (0, 1, 2):
        sim.submit(MasterRequest(cycle=0, master=m, dst_onehot=0b1000,
                                 n_words=8))
    results = sim.run()
    cycles["sim_grants"] = sorted(r.time_to_grant for r in results)
    cycles["sim_completions"] = sorted(r.completion_latency for r in results)
    print(f"   cycle-sim check: grants={cycles['sim_grants']}"
          f" completions={cycles['sim_completions']}")

    print("\n== Fig 6: worst-case latency vs contending PR regions ==")
    curve = AreaModel.worst_case_latency_curve(8)
    print("   " + "  ".join(f"{n}:{cc}cc" for n, cc in curve.items()))

    print("\n== Table II claims ==")
    m = AreaModel()
    table2 = {"lut_saving": m.lut_saving_vs_noc(),
              "ff_saving": m.ff_saving_vs_noc(),
              "power_ratio": m.power_ratio_vs_noc(),
              "latency_saving_4": m.latency_saving_vs_noc(4)}
    print(f"   LUT saving vs NoC:  {100*table2['lut_saving']:.1f}% "
          f"(paper: 61%)")
    print(f"   FF saving vs NoC:   {100*table2['ff_saving']:.1f}% "
          f"(paper: 95%)")
    print(f"   power vs NoC:       {table2['power_ratio']:.0f}x "
          f"(paper: 80x)")
    print(f"   completion saving vs NoC (4-router path): "
          f"{100*table2['latency_saving_4']:.1f}% (paper headline: 69%)")

    print("\n== data-path cross-check: cycle sim vs Hamming kernels ==")
    res = uc.run_case(3)
    data = np.random.default_rng(0).integers(0, 1 << 26, size=uc.n_words,
                                             dtype=np.uint32)
    x = torch.from_numpy(data.view(np.int32)).to(dev).view(torch.uint32)
    x = multiply_const(x, uc.constant)
    x = hamming_encode(x)
    x, _ = hamming_decode(x)
    got = x.view(torch.int32).cpu().numpy().view(np.uint32)
    identical = bool(np.array_equal(got, res.output))
    print(f"   identical output: {identical}")
    return {"use_case": uc, "fig5": fig5, "paper_case1": PAPER_CASE1_MS,
            "paper_case3": PAPER_CASE3_MS, "bandwidth": bw,
            "calibration_residuals": dict(uc.calibration_residuals),
            "cycles": cycles, "fig6": curve, "table2": table2,
            "identical": identical}


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
