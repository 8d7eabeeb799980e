"""Error-feedback int8 gradient compression for the cross-pod (DP) axis
(the JAX package's ``optim/compress.py``).

Gradients are compressed to int8 with a per-tensor scale before a
cross-pod all-reduce and the quantisation error is carried into the next
round (error feedback keeps SGD/Adam unbiased to first order: Seide et al.
2014; Karimireddy et al. 2019).

Usage (inside the train step, pod axis only):

    g_q, scale, err = compress_int8(g + err_prev)
    g_sum = all_reduce(decompress_int8(g_q, scale))   # 4x fewer bytes
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.common import tree_map


def compress_int8(g: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (int8 values, float32 scale, residual error)."""
    gf = g.float()
    scale = gf.abs().max().clamp_min(1e-12) / 127.0
    q = torch.round(gf / scale).clamp(-127, 127).to(torch.int8)
    err = gf - q.float() * scale
    return q, scale, err


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def error_feedback_update(grads, errors):
    """Fold the previous round's quantisation error into this round's
    grads."""
    if errors is None:
        return grads
    return tree_map(lambda g, e: g + e.to(g.dtype), grads, errors)
