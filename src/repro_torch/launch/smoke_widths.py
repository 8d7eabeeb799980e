"""Every ported family's smoke config on the kernels, against the plain path.

    python -m repro_torch.launch.smoke_widths [--seed N]

The smoke configs run the narrow widths: attention head dims 8 (granite,
tinyllama, llava-next), 12 (command-r-plus) and 16 (both Mixtrals,
qwen2.5, recurrentgemma, whisper: its encoder's and cross-attention's
non-causal calls too), and Mamba-2's SSD at (P, N, chunk) = (16, 16, 16).  Under
the default ``kernel_mode="auto"`` CUDA tensors go to the kernels, so each
config runs ``prefill`` and ``loss`` on the kernels and on the plain path
(``kernel_mode="torch"``) with the same random weights and tokens:

- bf16 ``prefill``: last-token logits within relative L2 2e-2 (bf16 rounds
  at other places in the two attentions);
- float32 ``loss`` and every gradient leaf within 1e-4 of the leaf's
  largest value (the same arithmetic summed in another order; TF32 off);
  the SSM and hybrid gradients run the SSD and RG-LRU backward kernels;
- float32 ``prefill`` logits of the SSM and hybrid families within 1e-4
  relative.

The MoE configs dispatch through the crossbar kernels (``cuda_kernel``);
the vlm's batch carries patches and the encoder-decoder's frames, drawn
from N(0, 0.02) as the tokens are drawn, from the seed.
Each check counts the launches of the kernel path only and requires the
family's kernels among them.  Prints one JSON line per config; exits 1 if
any check fails.  Runs on the card (``chip_smoke.py`` runs it as its
``smoke_widths`` phase, ``tests/test_torch_kernels_cuda.py`` per config).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.crossbar_dispatch import kernel as K
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.rglru import kernel as RK
from repro_torch.kernels.ssd import kernel as SK
from repro_torch.models.common import tree_leaves
from repro_torch.models.lm import build_model

ARCHS = ("mixtral_8x7b", "mixtral_8x22b", "command_r_plus_104b",
         "granite_3_2b", "qwen2_5_3b", "tinyllama_1_1b", "mamba2_780m",
         "recurrentgemma_9b", "whisper_medium", "llava_next_34b")
SEQ = 64             # a multiple of the SSM smoke chunk; past every window
PREFILL_REL = 2e-2   # bf16 last-token logits, relative L2
F32_REL = 1e-4       # float32 loss, gradient leaves, SSM/hybrid logits
# the kernels each family's kernel path must launch (forward and backward)
FAMILY_KERNELS = {
    "dense": ("flash_fwd", "flash_bwd"),
    "moe": ("flash_fwd", "flash_bwd", "plan_multi", "scatter", "combine"),
    "ssm": ("ssd", "ssd_bwd"),
    "hybrid": ("rglru", "rglru_bwd", "flash_fwd", "flash_bwd"),
    "encdec": ("flash_fwd", "flash_bwd"),
    "vlm": ("flash_fwd", "flash_bwd"),
}
_MODULES = (FK, K, SK, RK)


def _reset():
    for m in _MODULES:
        m.reset_launch_counts()


def _counts() -> dict:
    return {k: v for m in _MODULES for k, v in m.launch_counts().items()}


def smoke_config(arch: str, dtype: str, kernel_mode: str = "auto"):
    cfg = get_config(arch, smoke=True)
    kw = dict(dtype=dtype, kernel_mode=kernel_mode)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, dispatch="cuda_kernel")
    return dataclasses.replace(cfg, **kw)


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _pair(arch: str, dtype: str, seed: int):
    """The kernel-path and plain-path models of ``arch`` with one set of
    random weights, and a batch of ``SEQ`` tokens (with the vlm's patches
    or the encoder-decoder's frames)."""
    kern = build_model(smoke_config(arch, dtype), device="cuda")
    plain = build_model(smoke_config(arch, dtype, "torch"), device="cuda")
    gen = torch.Generator(device=kern.device)
    gen.manual_seed(seed)
    params = kern.init(gen)
    cfg = kern.cfg
    rng = np.random.default_rng(seed)
    cu = lambda a: torch.from_numpy(a[None]).to(kern.device)
    batch = {"tokens": cu(rng.integers(0, cfg.vocab, SEQ).astype(np.int32)),
             "labels": cu(rng.integers(0, cfg.vocab, SEQ).astype(np.int32))}
    rows = {"vlm": ("patches", cfg.n_vision_patches),
            "encdec": ("frames", cfg.encoder_len)}.get(cfg.family)
    if rows:
        x = rng.normal(0, 0.02, (rows[1], cfg.d_model)).astype(np.float32)
        batch[rows[0]] = cu(x).to(kern.dtype)
    return kern, plain, params, batch


def check(arch: str, seed: int = 0) -> dict:
    """Run ``arch``'s smoke config on the kernels and the plain path; the
    readings, the kernel path's launches and ``ok`` (every limit held and
    every kernel of the family launched)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    family = get_config(arch, smoke=True).family
    out = {"arch": arch, "family": family}
    launches = dict.fromkeys(_counts(), 0)

    def on_kernels(fn):
        _reset()
        res = fn()
        torch.cuda.synchronize()
        for k, v in _counts().items():
            launches[k] += v
        return res

    # bf16 prefill
    kern, plain, params, batch = _pair(arch, "bfloat16", seed)
    with torch.no_grad():
        lk = on_kernels(lambda: kern.prefill(params, batch))
        lp = plain.prefill(params, batch)
    out["bf16_prefill_rel_l2"] = _rel_l2(lk, lp)
    ok = {"bf16_prefill": bool(torch.isfinite(lk).all())
          and out["bf16_prefill_rel_l2"] <= PREFILL_REL}

    # float32 loss and gradients
    kern, plain, params, batch = _pair(arch, "float32", seed + 1)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss_p = plain.loss(params, batch)
    loss_k = on_kernels(lambda: kern.loss(params, batch))
    lk32, lp32 = float(loss_k.detach()), float(loss_p.detach())
    out["f32_loss_kernel"], out["f32_loss_plain"] = lk32, lp32
    ok["f32_loss"] = abs(lk32 - lp32) <= F32_REL * abs(lp32)
    gp = torch.autograd.grad(loss_p, leaves)
    gk = on_kernels(lambda: torch.autograd.grad(loss_k, leaves))
    rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(gk, gp)]
    out["f32_grad_leaves"], out["f32_grad_rel_max"] = len(rel), max(rel)
    ok["f32_grads"] = max(rel) <= F32_REL
    if family in ("ssm", "hybrid"):
        with torch.no_grad():
            pk = on_kernels(lambda: kern.prefill(params, batch))
            pp = plain.prefill(params, batch)
        out["f32_prefill_rel_l2"] = _rel_l2(pk, pp)
        ok["f32_prefill"] = out["f32_prefill_rel_l2"] <= F32_REL
    missing = [k for k in FAMILY_KERNELS[family] if launches[k] <= 0]
    ok["kernels_launched"] = not missing
    out.update(kernels={k: v for k, v in launches.items() if v},
               tol={"bf16_prefill_rel_l2": PREFILL_REL, "f32": F32_REL},
               checks=ok, ok=all(ok.values()))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("smoke_widths: needs a CUDA device", file=sys.stderr)
        return 1
    results = [check(arch, args.seed) for arch in ARCHS]
    for r in results:
        print(json.dumps(r), flush=True)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
