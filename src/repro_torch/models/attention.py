"""GQA attention: the prefill/train path and the cached decode path.

``attention_prefill`` runs the flash-attention CUDA kernel
(``repro_torch.kernels.flash_attention``) for CUDA tensors, forward and
backward.  For CPU tensors, or when ``KernelMode.TORCH`` is asked for, it
runs the plain path: the JAX package's chunked online-softmax attention
(the same ``q_chunk``/``kv_chunk`` banding, so sliding-window attention
visits only the banded kv chunks), with the chunk loops written out in
Python.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.device import resolve_device
from repro_torch.fabric.interface import use_kernel
from repro_torch.models.common import apply_rope  # noqa: F401  (layer code)

NEG_INF = -1e30


def attention_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_chunk: int = 512, kv_chunk: int = 1024,
                      q_offset: int = 0, kernel_mode=None) -> torch.Tensor:
    """q: [B, Sq, H, D]; k, v: [B, Sk, Kv, D] with H = Kv * G (GQA).

    ``window``: attend to keys in (pos - window, pos]; ``q_offset``:
    absolute position of q[0] relative to k[0] (cross-chunk prefill
    continuation).  Returns [B, Sq, H, D] in q.dtype.  ``kernel_mode``
    (a ``KernelMode`` or alias) picks kernel or plain path as the kernel
    wrappers do; ``q_chunk``/``kv_chunk`` shape the plain path only."""
    if use_kernel(kernel_mode, q, k, v):
        from repro_torch.kernels.flash_attention.ops import flash_attention
        return flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    return _attention_chunked(q, k, v, causal=causal, window=window,
                              q_chunk=q_chunk, kv_chunk=kv_chunk,
                              q_offset=q_offset)


def _attention_chunked(q, k, v, *, causal, window, q_chunk, kv_chunk,
                       q_offset) -> torch.Tensor:
    """Chunked online-softmax attention (``repro.models.attention``'s
    ``attention_prefill``); peak memory O(q_chunk x kv_chunk)."""
    B, Sq, H, D = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    pq, pk = (-Sq) % q_chunk, (-Sk) % kv_chunk
    pad = torch.nn.functional.pad
    qp = pad(q, (0, 0, 0, 0, 0, pq)) if pq else q
    kp = pad(k, (0, 0, 0, 0, 0, pk)) if pk else k
    vp = pad(v, (0, 0, 0, 0, 0, pk)) if pk else v
    nq, nk = qp.shape[1] // q_chunk, kp.shape[1] // kv_chunk
    qp = qp.reshape(B, nq, q_chunk, Kv, G, D) * D ** -0.5   # in q.dtype
    kp = kp.reshape(B, nk, kv_chunk, Kv, D)
    vp = vp.reshape(B, nk, kv_chunk, Kv, D)
    banded = window is not None and causal
    # A q chunk only sees the kv chunks covering (q_start - window, q_end].
    kv_per_q = min(nk, (window + q_chunk) // kv_chunk + 2) if banded else nk
    dev = q.device
    outs = []
    for qi in range(nq):
        qc = qp[:, qi].float()                           # [B, qc, Kv, G, D]
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, Kv, G, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, Kv, G, q_chunk), device=dev)
        acc = torch.zeros((B, Kv, G, q_chunk, D), device=dev)
        first = 0
        if banded:
            first = max((q_offset + qi * q_chunk - (window - 1)) // kv_chunk,
                        0)
        # chunks past the end are fully masked: they would change nothing
        for kj in range(first, min(first + kv_per_q, nk)):
            k_pos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqkgd,bskd->bkgqs", qc, kp[:, kj].float())
            mask = k_pos[None, :] < Sk
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window is not None:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vp[:, kj].float())
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)[..., None]).to(q.dtype))
    out = torch.stack(outs, dim=1)                       # [B,nq,Kv,G,qc,D]
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, nq * q_chunk, H, D)
    return out[:, :Sq]


# ----------------------------------------------------------------------
# KV cache + decode
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class KVCache:
    """Per-layer-stacked KV cache.  ``positions`` holds the absolute
    position stored in each slot (-1 = empty); sliding-window archs use a
    ring buffer of ``window`` slots."""

    k: torch.Tensor           # [L, B, S, Kv, D]  (post-rope keys)
    v: torch.Tensor           # [L, B, S, Kv, D]
    positions: torch.Tensor   # [B, S] int32
    length: torch.Tensor      # [] int32, tokens absorbed so far


def init_cache(n_layers: int, batch: int, max_len: int, n_kv: int,
               head_dim: int, *, window: Optional[int] = None,
               dtype=torch.bfloat16, device=None) -> KVCache:
    """An empty cache on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    slots = min(window, max_len) if window else max_len
    shape = (n_layers, batch, slots, n_kv, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        positions=torch.full((batch, slots), -1, dtype=torch.int32,
                             device=device),
        length=torch.zeros((), dtype=torch.int32, device=device))


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
