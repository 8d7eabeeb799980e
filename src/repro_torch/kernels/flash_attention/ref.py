"""Plain PyTorch versions of the flash-attention kernels.

Naive materialised-score attention (O(S^2) memory), independent of both
the kernel and the chunked path in ``repro_torch.models.attention``, so the
three cross-check.  The CPU path of the wrappers in ``kernel.py`` and the
reference the kernels are held against on the card; the backward's plain
version is autograd through :func:`attention_ref`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _scores(q, k, *, causal: bool, window: Optional[int], q_offset: int):
    """Masked float32 scores [B, H, Sq, Sk] and the mask [Sq, Sk]."""
    B, Sq, H, D = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // Kv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * D ** -0.5
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return torch.where(mask, s, NEG_INF), mask


def attention_fwd_ref(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, q_offset: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's outputs: (o [B, Sq, H, D] in q.dtype, row
    log-sum-exp [B, H, Sq] float32, ``-inf`` on rows whose keys are all
    masked)."""
    H, Kv = q.shape[2], k.shape[2]
    s, mask = _scores(q, k, causal=causal, window=window, q_offset=q_offset)
    p = torch.softmax(s, dim=-1)
    vf = v.float().repeat_interleave(H // Kv, dim=2)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    lse = torch.where(mask.any(-1), torch.logsumexp(s, dim=-1), -torch.inf)
    return o, lse


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, D]; k, v: [B, Sk, Kv, D] -> [B, Sq, H, D] in q.dtype."""
    return attention_fwd_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)[0]


def attention_bwd_ref(q, k, v, do, *, causal: bool, window: Optional[int],
                      q_offset: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`attention_ref` for the output cotangent
    ``do``, by autograd."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out = attention_ref(qq, kk, vv, causal=causal, window=window,
                            q_offset=q_offset)
        return torch.autograd.grad(out, (qq, kk, vv), do)
