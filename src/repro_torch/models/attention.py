"""GQA attention for the decode path: the KV-cache write and single-token
attention against the cache.  (``attention_prefill`` is not ported:
``ModelEngine`` prefills by replaying ``decode_step``.)"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.common import apply_rope  # noqa: F401  (layer code)

NEG_INF = -1e30


def cache_write(cache_k: torch.Tensor, cache_v: torch.Tensor,
                positions: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Write one token's K/V at slot ``pos % slots`` (a ring for SWA).

    cache_k/v: [B, S, Kv, D]; k_new/v_new: [B, 1, Kv, D]; pos: int.
    Updates the caches **in place** (each decode slot owns its state, so
    nothing else reads the old values) and returns them with the slot
    positions that include this token.
    """
    slot = pos % cache_k.shape[1]
    cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)
    pp = positions.clone()
    pp[:, slot] = pos
    return cache_k, cache_v, pp


def attention_decode(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, slot_positions: torch.Tensor,
                     pos: int, window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention against the cache.

    q: [B, 1, H, D]; cache_k/v: [B, S, Kv, D]; slot_positions: [B, S].
    Returns [B, 1, H, D] in q.dtype (scores and softmax in float32).
    """
    B, _, H, D = q.shape
    Kv = cache_k.shape[2]
    G = H // Kv
    qf = q.reshape(B, Kv, G, D) * (D ** -0.5)
    s = torch.einsum("bkgd,bskd->bkgs", qf.float(), cache_k.float())
    valid = (slot_positions >= 0) & (slot_positions <= pos)
    if window is not None:
        valid &= slot_positions > pos - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, cache_v.float())
    return out.reshape(B, 1, H, D).to(q.dtype)
