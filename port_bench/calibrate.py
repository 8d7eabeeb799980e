"""The readings that a cell's limits are set from, on the card: for each
seed, the program's numbers as a run compares them (a run of the cell's
driver with a short window); on the first ``--controls`` of the seeds
(default: all) the control's (the reference in float8 in the program's
place, against the same float32 reference) and, with ``--faults``, the
program's with a fault planted underneath.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--controls 2] [--seconds 1] [--faults half_tokens] > readings.jsonl

One JSON line a seed and reading.  The benchmark's own runs never run
this.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def control(b, kind: str) -> dict:
    """The control's readings against the float32 reference the run kept
    (``b.work["ref_out"]``)."""
    import torch

    from port_bench import bench, program, traffic, weights
    from port_bench.reference import mixtral as ref
    cfg, dev = b.config, b.device
    if kind == "train":
        t = b.cell["traffic"]
        B, S, V = t["batch"], t["seq_len"], cfg["vocab_size"]
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                    traffic.train_tokens(b.seed, s, B, S, V).items()}
                   for s in range(3)]
        c_losses, c_first, c_change, _, c_first_at = ref.adamw_steps(
            weights.make(cfg, b.seed, dev), batches, cfg, t["optimizer"],
            b.work["sample"], quant="fp8")
        out = bench.driver("train").compare(
            c_losses, c_first, c_change, c_first_at, *b.work["ref_out"])
        out["losses"] = c_losses
        return out
    params = weights.make(cfg, b.seed, dev)
    out, lengths = {}, {}
    for i, (n, want) in b.work["ref_out"].items():
        x = torch.from_numpy(traffic.prompt(b.seed, i, n, cfg["vocab_size"]
                                            )).to(dev)
        with ref.tf32_off():
            got = ref.logits_at(params, x, cfg, quant="fp8")[0]
        out[str(i)], lengths[i] = program.rel_l2(got.float().cpu(), want), n
    mins = bench.driver("prefill").per_length(out, lengths)
    out.update({f"min.{n}": v for n, v in mins.items()})
    out["least_min"] = min(mins.values())
    del params
    program.free()
    return out


def plant(fault: str):
    """Plant ``fault`` under the program; returns the undo."""
    if fault == "half_tokens":
        from repro_torch.models import lm
        sound = lm.chunked_lm_loss

        def half(h, w_head, labels, true_vocab, chunk=512):
            n = h.shape[1] // 2
            return sound(h[:, n:], w_head, labels[:, n:], true_vocab, chunk)
        lm.chunked_lm_loss = half
        return lambda: setattr(lm, "chunked_lm_loss", sound)
    raise ValueError(fault)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--controls", type=int, default=None)
    ap.add_argument("--faults", default="")
    args = ap.parse_args()
    import torch

    from port_bench import bench
    from port_bench.run import run_cell
    dev = torch.device("cuda", 0)
    kind = bench.cell_spec(args.workload)["driver"]
    seeds = [int(s) for s in args.seeds.split(",")]
    control_seeds = seeds[:args.controls]
    for seed in seeds:
        t0 = time.perf_counter()
        b = run_cell(args.workload, seed, args.seconds, False, dev,
                     t_start=time.perf_counter())
        line = {"seed": seed, "what": "program",
                "readings": {k: v for k, v in b.work["readings"].items()},
                "margins": b.work.get("margins"),
                "correct": b.correct, "e2e": b.e2e, "setup_s": b.setup_s,
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if seed in control_seeds:
            t0 = time.perf_counter()
            line = {"seed": seed, "what": "control",
                    "readings": control(b, kind),
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
        del b
        faults = args.faults.split(",") if seed in control_seeds else []
        for fault in filter(None, faults):
            undo = plant(fault)
            try:
                f = run_cell(args.workload, seed, args.seconds, False, dev,
                             t_start=time.perf_counter())
            finally:
                undo()
            print(json.dumps({"seed": seed, "what": fault,
                              "readings": f.work["readings"]}), flush=True)
            del f
    return 0


if __name__ == "__main__":
    sys.exit(main())
