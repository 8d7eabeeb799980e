"""Dry run: cost one (arch x shape) cell on the ``meta`` device, with no
card, and record its roofline inputs (the JAX package's
``launch/dryrun.py``, which compiles on a forced 512-device mesh).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2_780m \\
        --shape train_4k --mesh card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Outputs one JSON per cell under ``build/dryrun/``.  On the ``card`` mesh
(one H100) a cell's FLOPs and bytes come from ``costfit.fit_cell`` and its
peak memory from the step run on ``meta`` at two depths
(``extrapolated_costs``); ``fits_hbm`` holds it to :data:`HBM_BUDGET`.  On
the production meshes (``pod``, ``multipod``) the same numbers are one
device's: ``lower_step`` records rank (0, ..., 0) of the mesh with
described groups (``models/parallel.py``), so the record also carries
its collectives, for every family.  Each device's parameter and optimizer
bytes come from ``param_specs`` through ``NamedSharding.shard_shape``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \
        tinyllama_1_1b --shape train_4k --mesh pod
"""
from __future__ import annotations

import argparse
import dataclasses as dc
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import Union

from repro_torch.models.config import ShapeConfig

HBM_BUDGET = 0.95 * 80e9        # one H100: 80 GB of HBM, 5% reserve

# keys of the JAX package's record that only its real-config compile
# yields; the port's record leaves them out (the fit and the two-depth
# peak stand in for it)
COMPILE_ONLY_KEYS = ("compile_s", "raw_uncorrected", "memory_analysis")


def scaled_depths(cfg):
    """Two reduced-depth configs for affine extrapolation in depth: all
    the models are homogeneous stacks, so cost(L) = a + b*L; measure at two
    small depths, solve for (a, b), evaluate at the real L.  Hybrid counts
    (rec, rec, attn) groups with the trail held fixed; enc-dec scales
    encoder and decoder together.
    Returns (cfg_small, units_small, cfg_large, units_large, units_real)."""
    if cfg.family == "hybrid":
        per = cfg.hybrid.pattern_rec + 1
        groups = cfg.n_layers // per
        trail = cfg.n_layers - groups * per
        mk = lambda g: dc.replace(cfg, n_layers=g * per + trail)
        return mk(2), 2, mk(4), 4, groups
    if cfg.family == "encdec":
        ratio = cfg.n_encoder_layers / cfg.n_layers
        mk = lambda L: dc.replace(cfg, n_layers=L,
                                  n_encoder_layers=max(1, round(L * ratio)))
        return mk(2), 2, mk(4), 4, cfg.n_layers
    mk = lambda L: dc.replace(cfg, n_layers=L)
    return mk(2), 2, mk(4), 4, cfg.n_layers


def _cell_costs(cfg, shape, mesh, multi_pod, microbatches):
    """(flops, bytes, colls, peak_mem) of one config's step on ``meta``."""
    from repro_torch.launch.roofline import extract
    from repro_torch.launch.steps import build_step, lower_step
    bundle = build_step(cfg, shape, mesh, multi_pod=multi_pod,
                        microbatches=microbatches, device="meta")
    return extract(lower_step(bundle, mesh))


def extrapolated_costs(cfg, shape, mesh, multi_pod, microbatches):
    """Depth-corrected (flops, bytes, collective_moved, per_kind, peak_est)
    from the step at two depths."""
    c_s, u_s, c_l, u_l, u_real = scaled_depths(cfg)
    f1, b1, k1, m1 = _cell_costs(c_s, shape, mesh, multi_pod, microbatches)
    f2, b2, k2, m2 = _cell_costs(c_l, shape, mesh, multi_pod, microbatches)

    def affine(v1, v2):
        slope = (v2 - v1) / (u_l - u_s)
        return v1 + slope * (u_real - u_s)

    per_kind = {}
    coll = 0.0
    for k in set(k1) | set(k2):
        moved = affine(k1.get(k, {}).get("moved", 0.0),
                       k2.get(k, {}).get("moved", 0.0))
        per_kind[k] = {"count": round(affine(k1.get(k, {}).get("count", 0),
                                             k2.get(k, {}).get("count", 0)),
                                      1),
                       "moved": moved,
                       "bytes": affine(k1.get(k, {}).get("bytes", 0.0),
                                       k2.get(k, {}).get("bytes", 0.0))}
        coll += moved
    return (affine(f1, f2), affine(b1, b2), coll, per_kind,
            affine(m1 or 0.0, m2 or 0.0))


def _shape(shape: Union[str, ShapeConfig]) -> ShapeConfig:
    from repro_torch.models.config import LM_SHAPES
    if isinstance(shape, ShapeConfig):
        return shape
    return next(s for s in LM_SHAPES if s.name == shape)


def state_bytes(model, mesh, multi_pod: bool):
    """(parameter bytes, AdamW state bytes) one device of ``mesh`` holds,
    each leaf's block from ``param_specs`` through ``shard_shape``.  The
    optimizer's are its float32 moments: the port keeps AdamW's step
    counter on the host."""
    from repro_torch.launch.steps import NamedSharding
    from repro_torch.models.common import tree_leaves
    shapes = tree_leaves(model.param_shapes())
    specs = tree_leaves(model.param_specs(multi_pod))
    blocks = [math.prod(NamedSharding(mesh, spec).shard_shape(t.shape))
              for t, spec in zip(shapes, specs)]
    return (sum(n * t.element_size() for n, t in zip(blocks, shapes)),
            2 * 4 * sum(blocks))


def _write(rec: dict, out_dir: Path, tag: str) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))


def run_cell(arch: str, shape: Union[str, ShapeConfig], mesh: str = "card",
             out_dir: Path = Path("build/dryrun"), overrides=None,
             microbatches: int = 0, smoke: bool = False) -> dict:
    """One (arch x shape x mesh) cell; ``shape`` is a name of
    ``LM_SHAPES`` or a ``ShapeConfig`` (a cut shape the card runs);
    ``smoke`` takes the arch's smoke config.

    ``microbatches=0`` fits the gradient-accumulation factor for train
    shapes so the estimated peak lands under :data:`HBM_BUDGET`; >= 1
    forces a value (1 = no accumulation).  Writes and returns the record
    (the JAX package's keys less :data:`COMPILE_ONLY_KEYS`, plus
    ``param_bytes``/``opt_state_bytes`` a device)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.costfit import fit_cell
    from repro_torch.launch.mesh import MESH_NAMES, mesh_for
    from repro_torch.launch.roofline import (RooflineTerms, model_bytes_for,
                                             model_flops_for)
    from repro_torch.models.config import skipped_shapes_for
    from repro_torch.models.lm import build_model

    cfg = get_config(arch, smoke=smoke)
    if overrides:
        cfg = dc.replace(cfg, **overrides)
    shape = _shape(shape)
    tag = f"{arch}_{shape.name}_{mesh}"
    if shape in skipped_shapes_for(cfg):
        rec = {"arch": arch, "shape": shape.name, "mesh": mesh,
               "skipped": True,
               "reason": "full-attention arch: long_500k requires "
                         "sub-quadratic attention (DESIGN.md §5)"}
        _write(rec, out_dir, tag)
        return rec

    multi_pod = MESH_NAMES[mesh]
    spec = mesh_for(mesh)
    chips = spec.size
    model = build_model(cfg, device="meta")
    param_bytes, opt_bytes = state_bytes(model, spec, multi_pod)
    t0 = time.time()

    # --- the gradient-accumulation factor (train only) -------------------
    mb = max(1, microbatches)
    if microbatches == 0 and shape.kind == "train":
        while mb < shape.global_batch:
            *_, peak_est = extrapolated_costs(cfg, shape, spec, multi_pod, mb)
            if peak_est <= HBM_BUDGET:
                break
            over = peak_est / HBM_BUDGET
            mb = min(shape.global_batch,
                     max(2 * mb, 1 << int(math.ceil(math.log2(
                         max(2.0, mb * over))))))

    # --- FLOPs and bytes: the fit at small depths and lengths -------------
    fitted = fit_cell(cfg, shape, spec, multi_pod)
    flops, byts = fitted.flops, fitted.bytes
    if mb > 1:
        # the fit runs at mb=1 (same math, same tokens); each extra
        # microbatch re-reads the weights for its forward and backward and
        # round-trips the float32 gradient accumulator
        n_dev = model.n_params() / chips
        byts += (mb - 1) * 2 * n_dev * 2.0
        byts += mb * 2 * n_dev * 4.0
    *_, peak_est = extrapolated_costs(cfg, shape, spec, multi_pod, mb)
    t1 = time.time()

    n_active = None
    if cfg.moe is not None:
        total = model.n_params()
        expert = cfg.n_layers * cfg.moe.n_experts * 3 * cfg.d_model * cfg.d_ff
        n_active = total - expert + expert * cfg.moe.top_k / cfg.moe.n_experts
    terms = RooflineTerms(
        arch=arch, shape=shape.name, mesh=mesh, chips=chips,
        flops_per_device=flops, bytes_per_device=byts,
        collective_bytes_per_device=fitted.coll_moved,
        collectives=fitted.per_kind, peak_memory_bytes=None,
        model_flops=model_flops_for(cfg, shape, model.n_params(), n_active),
        # a MoE decode at batch >= n_experts touches every expert; only a
        # single-sequence decode streams just the active experts
        model_bytes=model_bytes_for(
            cfg, shape,
            (n_active if (n_active and shape.global_batch < cfg.moe.n_experts)
             else model.n_params()), model),
        kind=shape.kind)
    rec = terms.to_dict()
    rec.update(lower_s=t1 - t0, n_params=model.n_params(), microbatches=mb,
               peak_memory_est=peak_est,
               fits_hbm=bool(peak_est <= HBM_BUDGET),
               holdout_rel_err=fitted.holdout_rel_err,
               param_bytes=param_bytes,
               opt_state_bytes=opt_bytes if shape.kind == "train" else 0,
               seq_len=shape.seq_len, global_batch=shape.global_batch)
    _write(rec, out_dir, tag)
    print(f"[dryrun] {tag}: lower={t1 - t0:.1f}s flops/dev={flops:.3e} "
          f"bytes/dev={byts:.3e} peak={peak_est:.3e} "
          f"fits_hbm={rec['fits_hbm']} bottleneck={terms.bottleneck} "
          f"roofline_frac={terms.roofline_fraction and round(terms.roofline_fraction, 3)}",
          flush=True)
    return rec


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.mesh import MESH_NAMES
    from repro_torch.models.config import LM_SHAPES
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=[*MESH_NAMES, "both"], default="card")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = ([s.name for s in LM_SHAPES] if (args.all or not args.shape)
              else [args.shape])
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    out = Path(args.out)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                try:
                    run_cell(arch, shape, mesh, out)
                except Exception as e:
                    failures.append((arch, shape, mesh, repr(e)))
                    traceback.print_exc()
    if failures:
        print("FAILURES:", *failures, sep="\n  ")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
