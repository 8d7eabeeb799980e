"""Three AdamW steps of ``chip_smoke.py``'s train cell at several seeds.

    python -m repro_torch.launch.loss_seeds [--seeds 0 1 2 3] [--plain]

The cell: a full-width Mixtral-8x7B cut to 2 layers, bf16, B=1, S=4096,
AdamW at a constant learning rate of 1e-3, one ``synthetic_batch`` repeated;
the model's weights and the batch come from each seed, as ``chip_smoke.py
--seed`` draws them.  Prints one JSON line per seed and path: the three
losses and whether the third is below the first, which is what the train
phase of ``chip_smoke.py`` requires at its seed.  ``--plain`` adds the same
steps on the plain path (attention and the crossbar on their plain
versions), so a kernel change can be read against how much the trajectory
moves from rounding alone.  Runs on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models.common import tree_map
from repro_torch.models.lm import DenseLM
from repro_torch.optim.adamw import AdamW
from repro_torch.shell.server import ModelEngine

SEQ, STEPS, LR = 4096, 3, 1e-3


def train_config():
    cfg = get_config("mixtral_8x7b")
    return dataclasses.replace(
        cfg, n_layers=2, dtype="bfloat16",
        moe=dataclasses.replace(cfg.moe, dispatch="cuda_kernel"))


def losses(model, params, batch):
    params = tree_map(lambda p: p.clone(), params)
    opt = AdamW(lr=LR)
    state = opt.init(params)
    step = make_train_step(model, opt)
    out = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, batch)
        out.append(float(loss))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--plain", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("loss_seeds runs on a CUDA device")
    cfg = train_config()
    for seed in args.seeds:
        engine = ModelEngine(cfg, max_len=24, seed=seed)
        batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
            seed, 0, 0, 1, 1, SEQ, cfg.vocab).items()}
        paths = [("kernel", engine.model)]
        if args.plain:
            paths.append(("plain", DenseLM(dataclasses.replace(
                cfg, kernel_mode="torch"))))
        for name, model in paths:
            out = losses(model, engine.params, batch)
            print(json.dumps({"seed": seed, "path": name, "losses": out,
                              "third_below_first": out[2] < out[0],
                              "device": torch.cuda.get_device_name(0)}),
                  flush=True)
            torch.cuda.empty_cache()
        del engine
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
