"""Plain PyTorch versions of the crossbar-dispatch kernels.

The CPU path of every wrapper in ``kernel.py``, and the reference the
kernels are held against on the card (bit-equal: integer plans, pure row
moves, and one product with one rounding in the combine).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.arbiter import _error_codes, _stream_ranks, bincount_i32
from repro_torch.core.registers import ErrorCode

I32 = torch.int32


def plan_ref(dst: torch.Tensor, allowed_row: torch.Tensor,
             quota_row: torch.Tensor, capacity: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
    """One source region's plan, capacity applied.

    ``dst`` [T] (pad rows carry ``dst = -1``; any ``dst`` outside
    ``[0, S)`` fails isolation); ``allowed_row``, ``quota_row`` and
    ``capacity`` [S], this source's register rows.  A packet's rank is the
    number of earlier isolation-passing packets to its ``dst``, so a quota
    or capacity drop still takes up a rank.  Returns (keep [T] i32,
    slot [T] i32: the rank where kept, else 0, err [T] i32: INVALID_DEST
    over GRANT_TIMEOUT over ACK_TIMEOUT over OK, counts [S] i32: kept
    packets per ``dst``).  A quota of 0 means unlimited.
    """
    S = allowed_row.shape[0]
    dst = dst.to(I32)
    dstc = dst.clamp(0, S - 1).long()
    iso_ok = (dst >= 0) & (dst < S) & (allowed_row.to(I32)[dstc] > 0)
    dst_oh = torch.nn.functional.one_hot(dstc, S).to(I32)
    live = dst_oh * iso_ok[:, None]
    # the running count per dst, scanned along the contiguous axis of [S, T]
    ahead = torch.cumsum(live.T.contiguous(), 1, dtype=I32).T - live
    rank = ahead.gather(1, dstc[:, None])[:, 0]
    quota = quota_row.to(I32)[dstc]
    quota_ok = (quota == 0) | (rank < quota)
    cap_ok = rank < capacity.to(I32)[dstc]
    keep = iso_ok & quota_ok & cap_ok
    err = _error_codes(iso_ok, quota_ok, cap_ok)
    counts = (dst_oh * keep[:, None]).sum(0, dtype=I32)
    return keep.to(I32), torch.where(keep, rank, 0), err, counts


def plan_multi_ref(dst: torch.Tensor, src: torch.Tensor,
                   allowed_sd: torch.Tensor, quota_sd: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Fused multi-source grant sweep, capacity not applied.

    ``dst``/``src`` [T] int32 (pad rows carry ``dst = -1``);
    ``allowed_sd``/``quota_sd`` [S, S] indexed [src, dst] (reset folded
    into ``allowed_sd``).  Returns (keep [T] i32: iso and quota,
    rank [T] i32: exclusive rank among the iso-passing packets of the
    packet's (src, dst) stream, 0 where isolation fails, err [T] i32:
    INVALID_DEST over GRANT_TIMEOUT over OK, granted [S, S] i32: kept
    packets per pair).  A quota of 0 means unlimited.
    """
    n = allowed_sd.shape[0]
    dst = dst.to(I32)
    src = src.to(I32)
    valid = (dst >= 0) & (dst < n) & (src >= 0) & (src < n)
    pair = src.clamp(0, n - 1) * n + dst.clamp(0, n - 1)
    allowed = allowed_sd.reshape(-1).to(I32)
    quota = quota_sd.reshape(-1).to(I32)
    iso_ok = valid & (allowed[pair.long()] > 0)
    rank = _stream_ranks(pair, iso_ok, n * n)
    quota_t = quota[pair.long()]
    quota_ok = (quota_t == 0) | (rank < quota_t)
    keep = iso_ok & quota_ok
    err = torch.where(~iso_ok, ErrorCode.INVALID_DEST,
                      torch.where(~quota_ok, ErrorCode.GRANT_TIMEOUT,
                                  ErrorCode.OK)).to(I32)
    granted = bincount_i32(pair, keep, n * n).reshape(n, n)
    return keep.to(I32), rank, err, granted


def _row_ok(dst: torch.Tensor, keep: torch.Tensor, slot: torch.Tensor,
            n_ports: int, capacity: int) -> torch.Tensor:
    """Kept packets whose (dst, slot) address lies inside the slabs."""
    return ((keep > 0) & (dst >= 0) & (dst < n_ports)
            & (slot >= 0) & (slot < capacity))


def scatter_ref(x: torch.Tensor, dst: torch.Tensor, keep: torch.Tensor,
                slot: torch.Tensor, n_ports: int,
                capacity: int) -> torch.Tensor:
    """Granted packets [T, D] into zeroed slabs [S, C, D] at row ``slot``
    of slab ``dst``; out-of-range packets write nothing."""
    T, D = x.shape
    ok = _row_ok(dst, keep, slot, n_ports, capacity)
    slabs = torch.zeros((n_ports * capacity, D), dtype=x.dtype,
                        device=x.device)
    addr = (dst.long() * capacity + slot.long())[ok]
    slabs[addr] = x[ok]
    return slabs.reshape(n_ports, capacity, D)


def combine_ref(y: torch.Tensor, dst: torch.Tensor, keep: torch.Tensor,
                slot: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Slabs [S, C, D] back to packets [T, D]:
    ``out[t] = (f32(w[t]) * f32(y[dst, slot])).to(y.dtype)`` for kept,
    in-range packets, zeros for the rest."""
    S, C, D = y.shape
    ok = _row_ok(dst, keep, slot, S, C)
    addr = torch.where(ok, dst.long() * C + slot.long(), 0)
    rows = y.reshape(S * C, D).index_select(0, addr).float()
    out = weights.float()[:, None] * rows
    return torch.where(ok[:, None], out, 0.0).to(y.dtype)


# ----------------------------------------------------------------------
# dense one-hot oracles of the backward rules in ``ops.py`` (test-only)
# ----------------------------------------------------------------------
def _plan_sel(dst: torch.Tensor, keep: torch.Tensor, slot: torch.Tensor,
              n_ports: int, capacity: int, dtype) -> torch.Tensor:
    """[T, S, C] plan-gated selection tensor shared by the bwd oracles."""
    ok = _row_ok(dst, keep, slot, n_ports, capacity)
    ports = torch.arange(n_ports, device=dst.device)
    slots = torch.arange(capacity, device=dst.device)
    dst_oh = (dst.long().clamp(0, n_ports - 1)[:, None] == ports).to(dtype)
    slot_oh = (slot.long()[:, None] == slots).to(dtype)
    return dst_oh[:, :, None] * slot_oh[:, None, :] * ok[:, None, None].to(
        dtype)


def dispatch_bwd_ref(g: torch.Tensor, dst: torch.Tensor, keep: torch.Tensor,
                     slot: torch.Tensor, n_ports: int,
                     capacity: int) -> torch.Tensor:
    """Oracle for the scatter's backward: ``d_x[t]`` reads the slab
    cotangent row the packet scattered to (zero when dropped)."""
    sel = _plan_sel(dst, keep, slot, n_ports, capacity, g.dtype)
    return torch.einsum("tsc,scd->td", sel, g)


def combine_bwd_ref(g: torch.Tensor, y: torch.Tensor, dst: torch.Tensor,
                    keep: torch.Tensor, slot: torch.Tensor,
                    weights: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle for the combine's backward: (d_y, d_weights) of the weighted
    gather, the weighted cotangent scattered back along the same route and
    a row dot for the weight cotangent."""
    S, C, D = y.shape
    sel = _plan_sel(dst, keep, slot, S, C, torch.float32)
    gf = g.float()
    d_y = torch.einsum("tsc,td->scd", sel, gf * weights.float()[:, None])
    rows = torch.einsum("tsc,scd->td", sel, y.float())
    d_w = torch.einsum("td,td->t", gf, rows)
    return d_y.to(y.dtype), d_w.to(weights.dtype)
