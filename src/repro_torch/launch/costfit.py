"""Roofline costs of a real cell from small counted ones (the JAX
package's ``launch/costfit.py``, on the port's counts).

A count on the ``meta`` device (``launch.steps.lower_step``) is exact at
any size, unlike XLA's ``cost_analysis``, which counts a loop body once;
but its Python cost grows with layers x attention chunks.  The fit keeps
a 60-layer, S=32768 cell to seconds.  This module:

1. counts each cell at five small points: (L_small, S_a), (L_big, S_a),
   (L_small, S_b), (L_big, S_b) and (L_small, S_c), every width, the batch
   and the mesh at the cell's real values;
2. fits the JAX package's structural model, exact by construction for a
   homogeneous stack, with one more term, ``w``:

       cost(L, S) = a0 + a1*S + L * (w + u*S + v*area(S))

   (a*: embedding, head, loss and optimizer; w: per-layer work that does
   not grow with S, such as a layer's weight reads and the encoder's
   frames, which the port's byte count sees; u: token-linear per-layer
   work; v: attention cost per executed (q, k) pair; area: the executed
   tile area of the chunked attention, :func:`attn_area`).  The fifth
   point determines ``w``.  For decode, slots replace S and the per-layer
   term is affine in slots;
3. evaluates the model at the real (L, S) with the executed tile area of
   the real chunked or banded attention;
4. counts a held-out sixth point (L_big, S_h) and records the fit's
   relative error there (``holdout_rel_err``): near 0 on a homogeneous
   stack, so a large value means the model misses a term.

The validation lengths are multiples of the plain path's chunks (the
attention's ``KV_CHUNK``, the SSD chunk, the RG-LRU scan's 2048 steps),
so the chunk sizes, and with them the shape of every cost, are those of
the real cell.
"""
from __future__ import annotations

import dataclasses as dc
import math
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.models.config import ModelConfig, ShapeConfig

Q_CHUNK, KV_CHUNK = 512, 1024      # attention_prefill's defaults
RGLRU_CHUNK = 2048                 # the plain RG-LRU scan's chunk


# ----------------------------------------------------------------------
# executed attention tile area (mirrors models/attention.py's
# _attention_chunked)
# ----------------------------------------------------------------------
def attn_area(S: int, *, causal: bool = True,
              window: Optional[int] = None) -> float:
    """Executed (query, key) pairs per sequence for the chunked attention,
    in the JAX package's model of it, with the chunks of the port's
    ``_attention_chunked`` (q 512, kv 1024: JAX's too)."""
    q_chunk = min(Q_CHUNK, S)
    kv_chunk = min(KV_CHUNK, S)
    nq = math.ceil(S / q_chunk)
    nk = math.ceil(S / kv_chunk)
    if window is not None and causal:
        kv_per_q = min(nk, (window + q_chunk) // kv_chunk + 2)
        return nq * kv_per_q * q_chunk * kv_chunk
    if causal:
        tiles = 0
        for qi in range(nq):
            q_last = (qi + 1) * q_chunk - 1
            tiles += min(nk, math.ceil((q_last + 1) / kv_chunk))
        return tiles * q_chunk * kv_chunk
    return nq * nk * q_chunk * kv_chunk


def _family_depths(cfg: ModelConfig) -> Tuple:
    """(make(L_units) -> cfg, units_small, units_big, units_real)."""
    extra = {}
    if cfg.n_vision_patches:
        # patch embeddings replace token embeddings 1:1 (the same cost per
        # position); the patch count is clamped for the fit configs only
        extra["n_vision_patches"] = min(cfg.n_vision_patches, 64)
    if cfg.family == "hybrid":
        per = cfg.hybrid.pattern_rec + 1
        groups = cfg.n_layers // per
        trail = cfg.n_layers - groups * per
        mk = lambda g: dc.replace(cfg, n_layers=g * per + trail, **extra)
        return mk, 2, 4, groups
    if cfg.family == "encdec":
        ratio = cfg.n_encoder_layers / cfg.n_layers
        mk = lambda L: dc.replace(cfg, n_layers=L,
                                  n_encoder_layers=max(1, round(L * ratio)),
                                  **extra)
        return mk, 2, 4, cfg.n_layers
    mk = lambda L: dc.replace(cfg, n_layers=L, **extra)
    return mk, 2, 4, cfg.n_layers


def _val_seqs(cfg: ModelConfig, shape: ShapeConfig
              ) -> Tuple[int, int, int, int]:
    """(S_a, S_b, S_c, S_holdout): multiples of the plain path's chunks."""
    step = RGLRU_CHUNK if cfg.family == "hybrid" else KV_CHUNK
    if cfg.ssm is not None:
        step = math.lcm(step, cfg.ssm.chunk)
    return step, 2 * step, 3 * step, 4 * step


def _real_slots(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Decode: the per-layer cost scales with *cache slots*, not S."""
    win = cfg.attn_window
    if cfg.family == "hybrid":
        win = cfg.hybrid.attn_window
    return min(win, shape.seq_len) if win else shape.seq_len


@dc.dataclass
class FittedCosts:
    flops: float
    bytes: float
    coll_moved: float
    per_kind: Dict[str, Dict[str, float]]
    holdout_rel_err: Dict[str, float]
    val_points: int


def _measure(cfg, shape, mesh, multi_pod) -> Tuple[float, float, float, Dict]:
    from repro_torch.launch.roofline import extract
    from repro_torch.launch.steps import build_step, lower_step
    bundle = build_step(cfg, shape, mesh, multi_pod=multi_pod,
                        microbatches=1, device="meta")
    flops, byts, colls, _ = extract(lower_step(bundle, mesh))
    moved = sum(c["moved"] for c in colls.values())
    return flops, byts, moved, colls


def _solve_layer(S_pts, b_pts, basis) -> Tuple[float, ...]:
    """Coefficients of ``basis`` (functions of S) through the points
    (S, b(S)); a basis function collinear with the others at these
    points is dropped (coefficient 0)."""
    A = np.array([[f(S) for f in basis] for S in S_pts], np.float64)
    scale = np.abs(A).max(axis=0)
    A = A / scale
    rank = np.linalg.matrix_rank(A, tol=1e-9)
    if rank < len(basis):
        coef = np.zeros(len(basis))
        coef[:rank] = np.linalg.lstsq(A[:rank + 1, :rank],
                                      np.array(b_pts[:rank + 1]),
                                      rcond=None)[0]
    else:
        coef = np.linalg.solve(A, np.array(b_pts, np.float64))
    return tuple(coef / scale)


def fit_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, multi_pod: bool
             ) -> FittedCosts:
    """The cell's FLOPs, bytes and collective bytes a device from the fit
    (see the module doc)."""
    mk, u_s, u_l, u_real = _family_depths(cfg)
    S_a, S_b, S_c, S_h = _val_seqs(cfg, shape)
    window = cfg.hybrid.attn_window if cfg.family == "hybrid" \
        else cfg.attn_window
    grid = [(u_s, S_a), (u_l, S_a), (u_s, S_b), (u_l, S_b), (u_s, S_c),
            (u_l, S_h)]
    pts = {(L, S): _measure(mk(L), dc.replace(shape, seq_len=S), mesh,
                            multi_pod)
           for (L, S) in grid}
    decode = shape.kind == "decode"
    # one area function at the validation points and the real cell: the
    # port's causal attention runs every kv chunk of a q chunk, whose
    # pairs the triangle's area and S span at lengths that are multiples
    # of KV_CHUNK; banded, it runs the band's chunks, less a few at the
    # end that a layer's constant absorbs
    area = lambda S: attn_area(S, causal=True, window=window)

    def fit_metric(idx, linear: bool = False) -> Tuple[float, float]:
        m = {k: v[idx] for k, v in pts.items()}
        b = {S: (m[(u_l, S)] - m[(u_s, S)]) / (u_l - u_s)
             for S in (S_a, S_b)}
        a = {S: m[(u_s, S)] - u_s * b[S] for S in (S_a, S_b)}
        # intercept: a(S) = a0 + a1*S
        a1 = (a[S_b] - a[S_a]) / (S_b - S_a)
        a0 = a[S_a] - a1 * S_a
        b[S_c] = (m[(u_s, S_c)] - a0 - a1 * S_c) / u_s
        # per-layer: b(S) = w + u*S + v*area(S)   (decode and collectives:
        # affine in S, slots for decode; attention-free: no area term)
        if decode or linear or cfg.attention_free:
            w, u = _solve_layer((S_a, S_b), (b[S_a], b[S_b]),
                                (lambda S: 1.0, lambda S: float(S)))
            v = 0.0
        else:
            w, u, v = _solve_layer(
                (S_a, S_b, S_c), (b[S_a], b[S_b], b[S_c]),
                (lambda S: 1.0, lambda S: float(S), area))
            v = max(v, 0.0)
        pred = lambda L, S: a0 + a1 * S + L * (w + u * S + v * area(S))
        meas_h = m[(u_l, S_h)]
        rel_err = abs(pred(u_l, S_h) - meas_h) / max(abs(meas_h), 1e-9)
        S_eval = _real_slots(cfg, shape) if decode else shape.seq_len
        return float(max(pred(u_real, S_eval), 0.0)), float(rel_err)

    flops, err_f = fit_metric(0)
    byts, err_b = fit_metric(1)
    moved, err_c = fit_metric(2, linear=True)

    # per-kind collectives: affine in L at S_a (token terms scaled by S)
    per_kind = {}
    k_s = pts[(u_s, S_a)][3]
    k_l = pts[(u_l, S_a)][3]
    scale_S = shape.seq_len / S_a if not decode else 1.0
    for kind in set(k_s) | set(k_l):
        ms = k_s.get(kind, {}).get("moved", 0.0)
        ml = k_l.get(kind, {}).get("moved", 0.0)
        slope = (ml - ms) / (u_l - u_s)
        a = ms - u_s * slope
        per_kind[kind] = {
            "moved": max(0.0, (a + slope * u_real) * scale_S),
            "count": round(
                (k_s.get(kind, {}).get("count", 0)
                 + (u_real - u_s)
                 * (k_l.get(kind, {}).get("count", 0)
                    - k_s.get(kind, {}).get("count", 0)) / (u_l - u_s)), 1),
        }

    return FittedCosts(flops=flops, bytes=byts, coll_moved=moved,
                       per_kind=per_kind,
                       holdout_rel_err={"flops": err_f, "bytes": err_b,
                                        "collective": err_c},
                       val_points=len(grid) - 1)
