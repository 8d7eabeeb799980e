"""Three AdamW steps of ``chip_smoke.py``'s train cells at several seeds.

    python -m repro_torch.launch.loss_seeds [--seeds 0 1 2 3] [--plain]
        [--arch mixtral_8x7b|llava_next_34b] [--lrs 1e-3 ...]

The cells: a full-width Mixtral-8x7B (the default) or LLaVA-NeXT-34B
(with 2,880 patches from N(0, 0.02)) cut to 2 layers, bf16, B=1, S=4096,
AdamW at a constant learning rate (1e-3 unless ``--lrs`` names others),
one ``synthetic_batch`` repeated; the model's weights and the batch come
from each seed, as ``chip_smoke.py --seed`` draws them.  Prints one JSON
line per seed, learning rate and path: the three losses and whether the
third is below the first, which is what the train phases of
``chip_smoke.py`` require at their seed.  ``--plain`` adds the same steps
on the plain path (attention and the crossbar on their plain versions),
so a kernel change can be read against how much the trajectory moves from
rounding alone.  Runs on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models.common import tree_map
from repro_torch.models.lm import DenseLM
from repro_torch.optim.adamw import AdamW
from repro_torch.shell.server import ModelEngine

SEQ, STEPS, LR = 4096, 3, 1e-3


def train_config(arch: str = "mixtral_8x7b"):
    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="bfloat16")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch="cuda_kernel"))
    return cfg


def losses(model, params, batch, lr: float = LR):
    params = tree_map(lambda p: p.clone(), params)
    opt = AdamW(lr=lr)
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
    ap.add_argument("--arch", default="mixtral_8x7b",
                    choices=("mixtral_8x7b", "llava_next_34b"))
    ap.add_argument("--lrs", type=float, nargs="+", default=[LR])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("loss_seeds runs on a CUDA device")
    cfg = train_config(args.arch)
    for seed in args.seeds:
        engine = ModelEngine(cfg, max_len=24, seed=seed)
        batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
            seed, 0, 0, 1, 1, SEQ, cfg.vocab).items()}
        if cfg.n_vision_patches:       # as chip_smoke.py's family_input
            x = np.random.default_rng(seed).normal(
                0, 0.02, (1, cfg.n_vision_patches, cfg.d_model))
            batch["patches"] = torch.from_numpy(
                x.astype(np.float32)).cuda().to(engine.model.dtype)
        paths = [("kernel", engine.model)]
        if args.plain:
            paths.append(("plain", DenseLM(dataclasses.replace(
                cfg, kernel_mode="torch"))))
        for lr in args.lrs:
            for name, model in paths:
                out = losses(model, engine.params, batch, lr)
                print(json.dumps({"arch": args.arch, "seed": seed, "lr": lr,
                                  "path": name, "losses": out,
                                  "third_below_first": out[2] < out[0],
                                  "device": torch.cuda.get_device_name(0)}),
                      flush=True)
                torch.cuda.empty_cache()
        del engine
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
