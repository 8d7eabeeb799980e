"""Step 1's gradients of ``chip_smoke.py``'s Mixtral train cell against a
float32 reference, on the kernel path and the plain path.

    python -m repro_torch.launch.grad_accuracy [--seed 0]

The cell is the train phase's: a full-width Mixtral-8x7B cut to 2 layers,
bf16, the MoE on the crossbar kernels, remat "nothing", B=1, S=4096, the
weights and the ``synthetic_batch`` from ``--seed``.  The loss and every
gradient leaf of the first step are computed three ways:

* ``kernel``: the model as it trains (bf16, the flash and crossbar
  kernels);
* ``plain``: the same bf16 parameters on the plain path (attention and
  the crossbar on their plain versions);
* the reference: the plain path on the same parameters cast to float32,
  TF32 off.

AdamW's first update is lr * m / sqrt(v) = lr * sign(g) for every element
(bar its epsilon), so the step moves each weight by the sign of its
gradient; a sign set by bf16 rounding moves the weight as far as one set
by the data.  For each bf16 path and each leaf the script prints the
relative L2 distance from the reference, the share of elements whose sign
agrees with it (``sign_agree``), and the same share among the elements
whose reference magnitude is at least the leaf's RMS (``sign_agree_large``):
rounding noise flips small elements, while a kernel whose gradients lean
away from the exact ones also flips large ones.  One JSON line per path,
then a summary line.  Runs on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.data.pipeline import synthetic_batch
from repro_torch.launch.loss_seeds import SEQ, train_config
from repro_torch.launch.steps import _value_and_grad
from repro_torch.models.common import leaf_names, tree_leaves, tree_map
from repro_torch.models.lm import DenseLM

CHUNK = 1 << 24          # elements a leaf is read in (expert leaves: 470 M)


def leaf_reading(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Relative L2 of ``got`` from ``ref`` (float32) and the shares of
    elements whose signs agree, all and those with |ref| >= RMS(ref)."""
    chunks = list(zip(got.reshape(-1).split(CHUNK),
                      ref.reshape(-1).split(CHUNK)))
    den = sum(float(r.double().square().sum()) for _, r in chunks)
    rms = (den / ref.numel()) ** 0.5
    num = n_same = n_large = n_same_large = 0
    for g, r in chunks:
        g = g.float()
        num += float((g - r).double().square().sum())
        same = torch.sign(g) == torch.sign(r)
        large = r.abs() >= rms
        n_same += int(same.sum())
        n_large += int(large.sum())
        n_same_large += int((same & large).sum())
    return {"rel_l2": (num / den) ** 0.5 if den else float("inf"),
            "sign_agree": n_same / ref.numel(),
            "sign_agree_large": n_same_large / n_large if n_large else 1.0,
            "n": ref.numel(), "n_large": n_large}


def summary(rows: list) -> dict:
    """Element-weighted sign agreement and the worst leaves of ``rows``."""
    n = sum(r["n"] for r in rows)
    nl = sum(r["n_large"] for r in rows)
    worst = max(rows, key=lambda r: r["rel_l2"])
    least = min(rows, key=lambda r: r["sign_agree"])
    return {"sign_agree": sum(r["sign_agree"] * r["n"] for r in rows) / n,
            "sign_agree_large": sum(r["sign_agree_large"] * r["n_large"]
                                    for r in rows) / max(nl, 1),
            "worst_rel_l2": [worst["leaf"], worst["rel_l2"]],
            "least_sign_agree": [least["leaf"], least["sign_agree"]],
            "median_rel_l2": sorted(r["rel_l2"] for r in rows)[len(rows) // 2]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("grad_accuracy runs on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = dataclasses.replace(train_config(), remat="nothing")
    model = DenseLM(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    params = model.init(gen)
    names = leaf_names(params)
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        args.seed, 0, 0, 1, 1, SEQ, cfg.vocab).items()}

    ref_model = DenseLM(dataclasses.replace(cfg, dtype="float32",
                                            kernel_mode="torch"))
    p32 = tree_map(lambda p: p.detach().float(), params)
    loss32, g32 = _value_and_grad(ref_model, p32, batch)
    g32 = [g.detach() for g in tree_leaves(g32)]
    del p32, ref_model
    torch.cuda.empty_cache()
    loss32 = float(loss32)

    out = {"seed": args.seed, "layers": cfg.n_layers, "seq": SEQ,
           "loss_f32": loss32, "device": torch.cuda.get_device_name(0)}
    paths = (("kernel", model),
             ("plain", DenseLM(dataclasses.replace(cfg, kernel_mode="torch"))))
    for name, m in paths:
        loss, grads = _value_and_grad(m, params, batch)
        rows = [{"leaf": n, **leaf_reading(g.detach(), r)}
                for n, g, r in zip(names, tree_leaves(grads), g32)]
        del grads
        torch.cuda.empty_cache()
        out[name] = {"loss": float(loss), **summary(rows)}
        print(json.dumps({"path": name, "seed": args.seed,
                          "loss": float(loss), "loss_f32": loss32,
                          "leaves": rows}), flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
