"""Pluggable placement policies (the ERM's allocation strategy, §IV-A).

A policy answers one pure question — "which free region should this module
footprint take?" — and may optionally propose compaction moves after the
planner has settled promotions.  Policies never touch state; they only read
``PoolState`` and return region ids, so swapping the policy at shell
construction changes placement behaviour with zero changes to the event
machinery.

Built-ins:

- ``first_fit`` — lowest-rid free region that fits.  Exactly the seed
  ``ElasticResourceManager`` behaviour (its dict-ordered scan), so the legacy
  wrapper defaults to it.
- ``best_fit``  — smallest-HBM free region that fits (ties broken by rid).
  Keeps big regions open for big modules under mixed footprints.
- ``defrag``    — first-fit placement plus a compaction pass: after each
  plan, placed modules migrate down to the lowest-rid free region that fits,
  packing tenants toward the bottom of the pool (the PR-region analogue of
  defragmenting the floorplan so large bitstreams find contiguous space).
"""
from __future__ import annotations

from typing import Dict, Optional, Protocol, Tuple, runtime_checkable

from repro_torch.core.module import ModuleFootprint
from repro_torch.shell.state import ON_SERVER, PoolState

# A compaction move: (tenant, module_idx, src_rid, dst_rid).
Move = Tuple[str, int, int, int]


@runtime_checkable
class PlacementPolicy(Protocol):
    """Strategy seam for the pure planner."""

    name: str

    def choose(self, state: PoolState, fp: ModuleFootprint) -> Optional[int]:
        """Region id to place ``fp`` on, or ``None`` to leave it on-server."""
        ...

    def compaction_moves(self, state: PoolState) -> Tuple[Move, ...]:
        """Relocations to apply after promotions (may be empty)."""
        ...


class FirstFit:
    name = "first_fit"

    def choose(self, state: PoolState, fp: ModuleFootprint) -> Optional[int]:
        for r in state.free_regions():          # regions are rid-sorted
            if fp.fits(r.hbm_bytes):
                return r.rid
        return None

    def compaction_moves(self, state: PoolState) -> Tuple[Move, ...]:
        return ()


class BestFit:
    name = "best_fit"

    def choose(self, state: PoolState, fp: ModuleFootprint) -> Optional[int]:
        fits = [r for r in state.free_regions() if fp.fits(r.hbm_bytes)]
        if not fits:
            return None
        return min(fits, key=lambda r: (r.hbm_bytes, r.rid)).rid

    def compaction_moves(self, state: PoolState) -> Tuple[Move, ...]:
        return ()


class Defrag:
    """First-fit placement + pack placed modules toward low rids."""

    name = "defrag"

    def __init__(self, inner: Optional[PlacementPolicy] = None):
        self._inner = inner or FirstFit()

    def choose(self, state: PoolState, fp: ModuleFootprint) -> Optional[int]:
        return self._inner.choose(state, fp)

    def compaction_moves(self, state: PoolState) -> Tuple[Move, ...]:
        moves = []
        # One settled pass: walk placed modules in (tenant, module) order and
        # migrate each to the lowest free rid below its current home.  The
        # planner applies moves sequentially, so each move frees its source
        # region for later candidates in the same pass.
        free = sorted(r.rid for r in state.free_regions())
        hbm = {r.rid: r.hbm_bytes for r in state.regions}
        for t in sorted(state.tenants, key=lambda t: t.name):
            for i, p in enumerate(t.placement):
                if p == ON_SERVER:
                    continue
                fp = t.footprints[i]
                dst = next((rid for rid in free
                            if rid < p and fp.fits(hbm[rid])), None)
                if dst is None:
                    continue
                free.remove(dst)
                free.append(p)
                free.sort()
                moves.append((t.name, i, p, dst))
        return tuple(moves)


_REGISTRY: Dict[str, type] = {
    FirstFit.name: FirstFit,
    BestFit.name: BestFit,
    Defrag.name: Defrag,
}


def get_policy(policy) -> PlacementPolicy:
    """Resolve a policy instance from a name or pass an instance through."""
    if isinstance(policy, str):
        try:
            return _REGISTRY[policy]()
        except KeyError:
            raise ValueError(
                f"unknown placement policy {policy!r}; "
                f"known: {sorted(_REGISTRY)}") from None
    return policy


def register_policy(cls) -> type:
    """Register a custom placement policy under its ``name``
    (decorator-friendly); ``Shell(regions, policy=name)`` then resolves it
    by string.

    >>> from repro_torch.shell import register_policy, get_policy
    >>> from repro_torch.shell.policy import FirstFit
    >>> @register_policy
    ... class RoomiestFit(FirstFit):
    ...     name = "roomiest_fit"
    ...     def choose(self, state, fp):
    ...         fits = [r for r in state.free_regions()
    ...                 if fp.fits(r.hbm_bytes)]
    ...         if not fits:
    ...             return None
    ...         return max(fits, key=lambda r: r.hbm_bytes).rid
    >>> get_policy("roomiest_fit").name
    'roomiest_fit'
    """
    _REGISTRY[cls.name] = cls
    return cls
