"""Vectorised WRR arbitration: the grant plan and the scatter data plane.

The same grant order as the rotating-priority hardware arbiter, computed
in one shot over a batch of packets:

- **isolation**: a packet is valid iff ``allowed[src, dst]`` and neither
  port is held in reset;
- **quota**: a packet's rank within its (src, dst) stream must be below
  the quota for that pair (0 == unlimited);
- **WRR order**: :func:`wrr_slots` places each granted packet at its
  lexicographic (round, source) position at its destination;
- **capacity**: a destination accepts ``capacity[dst]`` packets; the error
  codes are INVALID_DEST, GRANT_TIMEOUT and ACK_TIMEOUT per packet.

Data moves by scatter: ``dispatch`` writes granted packets into the flat
``dst * capacity + slot`` row of the receive slab (dropped packets go to a
trash row that is sliced off) and ``combine`` gathers them back.  The dense
one-hot forms :func:`dispatch_dense` / :func:`combine_dense` and the
backward oracles ``*_at_bwd_ref`` are test oracles only; ``dispatch_at``
and ``combine_at`` differentiate through PyTorch's autograd of
``index_add_`` and ``index_select``.  Everything here is plain PyTorch on
any device; it is also the oracle for the ``crossbar_dispatch`` kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.registers import CrossbarRegisters, ErrorCode

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """Per-packet grant decisions for one dispatch round."""

    keep: torch.Tensor        # [T] bool, packet granted a slot
    slot: torch.Tensor        # [T] int32, destination-local slot
    dst: torch.Tensor         # [T] int32, destination port
    error: torch.Tensor       # [T] int32, ErrorCode per packet
    counts: torch.Tensor      # [S] int32, granted packets per destination
    drops: torch.Tensor       # [4] int32, histogram over error codes


def bincount_i32(idx: torch.Tensor, weights: torch.Tensor | None,
                 n: int) -> torch.Tensor:
    """Exact int32 histogram of ``idx`` (in ``[0, n)``) over ``n`` bins."""
    out = torch.zeros((n,), dtype=I32, device=idx.device)
    src = (torch.ones_like(idx, dtype=I32) if weights is None
           else weights.to(I32))
    return out.index_add_(0, idx.long(), src)


def wrr_slots(rank: torch.Tensor, granted: torch.Tensor, dstc: torch.Tensor,
              src_index) -> torch.Tensor:
    """Closed-form WRR interleave shared by every plan implementation.

    Position of (``rank``, source) in the lexicographic (round, source)
    grant order of each packet's destination, given ``granted[src, dst]``
    iso+quota-passing counts.  ``src_index`` is a [1, T] source array or a
    scalar source index.
    """
    n = granted.shape[0]
    g_at = granted[:, dstc.long()]                              # [n, T]
    slot = torch.minimum(rank[None, :], g_at).sum(0, dtype=I32)
    ahead = ((torch.arange(n, device=rank.device)[:, None] < src_index)
             & (g_at > rank[None, :]))
    return slot + ahead.sum(0, dtype=I32)


def _stream_ranks(pair: torch.Tensor, alive: torch.Tensor,
                  n_streams: int) -> torch.Tensor:
    """Exclusive rank of each packet within its ``pair`` stream.

    One stable sort: packets ordered by stream id (dead packets sink into
    an overflow bucket), each packet's rank is its distance from the start
    of its run, scattered back to packet order.  int32 throughout.
    """
    T = pair.shape[0]
    bucket = torch.where(alive, pair, torch.full_like(pair, n_streams))
    order = torch.argsort(bucket, stable=True)
    sorted_bucket = bucket[order]
    t_ix = torch.arange(T, dtype=I32, device=pair.device)
    is_start = torch.ones((T,), dtype=torch.bool, device=pair.device)
    is_start[1:] = sorted_bucket[1:] != sorted_bucket[:-1]
    run_start = torch.cummax(torch.where(is_start, t_ix, 0), 0).values
    rank = torch.zeros((T,), dtype=I32, device=pair.device)
    rank[order] = t_ix - run_start
    return torch.where(alive, rank, 0)


def _error_codes(iso_ok, quota_ok, cap_ok) -> torch.Tensor:
    return torch.where(
        ~iso_ok, ErrorCode.INVALID_DEST,
        torch.where(~quota_ok, ErrorCode.GRANT_TIMEOUT,
                    torch.where(~cap_ok, ErrorCode.ACK_TIMEOUT,
                                ErrorCode.OK))).to(I32)


def wrr_dispatch_plan(dst: torch.Tensor, src: torch.Tensor,
                      regs: CrossbarRegisters) -> DispatchPlan:
    """Grants and slots for packets ``t`` with ``src[t] -> dst[t]``.

    Out-of-range ports (the padding convention is ``dst = -1``) are
    isolation drops: INVALID_DEST, no slot, no stream rank.
    """
    n = regs.n_ports
    dst = dst.to(I32)
    src = src.to(I32)
    in_range = (dst >= 0) & (dst < n) & (src >= 0) & (src < n)
    dstc = dst.clamp(0, n - 1).long()
    srcc = src.clamp(0, n - 1).long()

    iso_ok = (in_range & regs.allowed[srcc, dstc]
              & ~regs.reset[srcc] & ~regs.reset[dstc])
    pair = (srcc * n + dstc).to(I32)
    rank_sd = _stream_ranks(pair, iso_ok, n * n)

    quota = regs.quota[dstc, srcc]
    quota_ok = (quota == 0) | (rank_sd < quota)
    granted_pre = iso_ok & quota_ok

    granted = bincount_i32(pair, granted_pre, n * n).reshape(n, n)
    slot = wrr_slots(rank_sd, granted, dstc, srcc[None, :])

    cap_ok = slot < regs.capacity[dstc]
    keep = granted_pre & cap_ok
    error = _error_codes(iso_ok, quota_ok, cap_ok)
    counts = bincount_i32(dstc, keep, n)
    drops = bincount_i32(error, None, 4)
    return DispatchPlan(keep=keep, slot=torch.where(keep, slot, 0), dst=dst,
                        error=error, counts=counts, drops=drops)


def empty_plan(dst: torch.Tensor, n_ports: int) -> DispatchPlan:
    """The zero-packet plan: no grants, empty histogram."""
    z = torch.zeros((dst.shape[0],), dtype=I32, device=dst.device)
    return DispatchPlan(keep=z.bool(), slot=z, dst=dst.to(I32), error=z,
                        counts=torch.zeros((n_ports,), dtype=I32,
                                           device=dst.device),
                        drops=torch.zeros((4,), dtype=I32, device=dst.device))


def flat_slot_addr(plan: DispatchPlan, n_ports: int,
                   capacity: int) -> torch.Tensor:
    """Per-packet flat receive-slab row ``dst * capacity + slot``; dropped
    packets and slots at or beyond ``capacity`` point at the trash row
    ``n_ports * capacity``."""
    dstc = plan.dst.clamp(0, n_ports - 1)
    ok = plan.keep & (plan.slot < capacity)
    return torch.where(ok, dstc * capacity + plan.slot,
                       n_ports * capacity).to(I32)


def dispatch_at(x: torch.Tensor, daddr: torch.Tensor, n_ports: int,
                capacity: int) -> torch.Tensor:
    """Scatter packets [T, D] into slabs [n_ports, capacity, D] at
    precomputed flat addresses (``flat_slot_addr``)."""
    D = x.shape[1]
    slab = torch.zeros((n_ports * capacity + 1, D), dtype=x.dtype,
                       device=x.device)
    slab.index_add_(0, daddr.long(), x)
    return slab[:n_ports * capacity].reshape(n_ports, capacity, D)


def dispatch(x: torch.Tensor, plan: DispatchPlan, n_ports: int,
             capacity: int) -> torch.Tensor:
    """Scatter packets [T, D] into destination slabs [S, C, D].  Granted
    slots are unique per destination, so the add is an exact scatter."""
    return dispatch_at(x, flat_slot_addr(plan, n_ports, capacity),
                       n_ports, capacity)


def combine_addr(plan: DispatchPlan, n_ports: int,
                 capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-packet gather address into a flat [S * C, D] slab plus its
    validity mask."""
    ok = plan.keep & (plan.slot < capacity)
    addr = (plan.dst.clamp(0, n_ports - 1) * capacity
            + torch.where(ok, plan.slot, 0))
    return addr.to(I32), ok


def combine_at(y: torch.Tensor, caddr: torch.Tensor, cmask: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """Gather slab rows at precomputed addresses back to packet order,
    weighted, with dropped packets masked to zero."""
    S, C, D = y.shape
    out = y.reshape(S * C, D).index_select(0, caddr.long())
    return out * (cmask.to(y.dtype) * weights)[:, None]


def dispatch_at_bwd_ref(g: torch.Tensor, daddr: torch.Tensor, n_ports: int,
                        capacity: int) -> torch.Tensor:
    """Dense one-hot oracle for the gradient of :func:`dispatch_at` (an
    explicit [T, S*C] routing matrix; test-only)."""
    rows = n_ports * capacity
    oh = (daddr.long()[:, None]
          == torch.arange(rows, device=g.device)[None, :]).to(g.dtype)
    return torch.einsum("tr,rd->td", oh, g.reshape(rows, -1))


def combine_at_bwd_ref(g: torch.Tensor, y: torch.Tensor, caddr: torch.Tensor,
                       cmask: torch.Tensor, weights: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense one-hot oracle for the gradient of :func:`combine_at`:
    (d_y, d_weights) through an explicit [T, S*C] routing matrix
    (test-only)."""
    S, C, D = y.shape
    rows = S * C
    oh = (caddr.long()[:, None]
          == torch.arange(rows, device=g.device)[None, :]).to(g.dtype)
    oh = oh * cmask.to(g.dtype)[:, None]
    d_y = torch.einsum("tr,td->rd", oh, g * weights[:, None].to(g.dtype))
    d_w = torch.einsum("td,td->t", g,
                       torch.einsum("tr,rd->td", oh, y.reshape(rows, D)))
    return d_y.reshape(S, C, D).to(y.dtype), d_w.to(weights.dtype)


def combine(y: torch.Tensor, plan: DispatchPlan,
            weights: torch.Tensor) -> torch.Tensor:
    """Gather destination slabs [S, C, D] back to packets [T, D],
    weighted; dropped packets receive zeros."""
    S, C, _ = y.shape
    caddr, cmask = combine_addr(plan, S, C)
    return combine_at(y, caddr, cmask, weights)


# ----------------------------------------------------------------------
# dense one-hot formulations: test-only semantics oracles
# ----------------------------------------------------------------------
def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """One-hot that leaves out-of-range indices all-zero (like
    ``jax.nn.one_hot``)."""
    return (idx.long()[:, None]
            == torch.arange(n, device=idx.device)[None, :]).to(dtype)


def dispatch_dense(x: torch.Tensor, plan: DispatchPlan, n_ports: int,
                   capacity: int) -> torch.Tensor:
    """Dense one-hot oracle for :func:`dispatch`."""
    comb = (_one_hot(plan.dst, n_ports, x.dtype)[:, :, None]
            * _one_hot(plan.slot, capacity, x.dtype)[:, None, :])
    comb = comb * plan.keep[:, None, None].to(x.dtype)
    return torch.einsum("tsc,td->scd", comb, x)


def combine_dense(y: torch.Tensor, plan: DispatchPlan,
                  weights: torch.Tensor) -> torch.Tensor:
    """Dense one-hot oracle for :func:`combine`."""
    S, C, _ = y.shape
    comb = (_one_hot(plan.dst, S, y.dtype)[:, :, None]
            * _one_hot(plan.slot, C, y.dtype)[:, None, :])
    comb = comb * (plan.keep.to(y.dtype) * weights)[:, None, None]
    return torch.einsum("tsc,scd->td", comb, y)
