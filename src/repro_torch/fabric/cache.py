"""Epoch-keyed plan/address cache — the fabric's steady-state fast path.

The shell only rewrites the register file when a PR region is actually
reconfigured; between reconfigurations the crossbar serves traffic on an
unchanged routing table (the paper's slow-reconfiguration / fast-serving
split).  A decode tick that offers the *same packets* under the *same
register epoch* must therefore get the same ``DispatchPlan`` — so
:class:`PlanCache` memoizes plans (and the scatter address vectors derived
from them) per ``(register_epoch, offered-packet-bytes)`` key and flushes
itself the moment the epoch the shell maintains moves on.

Keys are **epoch-scoped by construction**: every public operation takes the
caller's current epoch and a differing epoch empties the cache before any
lookup — a stale entry cannot be served across a ``Shell.post``
.  Within an epoch the key is the exact bytes of the
offered ``dst``/``src`` vectors (shape + dtype + contents), so two offers
only share an entry when the arbiter would provably produce the identical
plan.

The cache is a host-side object: :class:`repro_torch.fabric.Fabric`
consults it only for offers against its *bound* register file.
Hit/miss/invalidation counters are read by the fabric's telemetry.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = ["PlanCache", "CacheEntry", "plan_key"]


def _host(v) -> np.ndarray:
    if hasattr(v, "detach"):                     # a torch tensor
        return v.detach().cpu().numpy()
    return np.asarray(v)


def plan_key(dst_v, src_v) -> Tuple:
    """Content key for one offered packet vector pair.

    Shape, dtype and raw bytes of both vectors — byte-equal offers (and
    only those) collide, so a hit is bit-identical to recomputation by
    construction.  Works on numpy arrays and on tensors (a CUDA tensor is
    copied to the host for its key).
    """
    d = _host(dst_v)
    s = _host(src_v)
    return (d.shape, str(d.dtype), d.tobytes(),
            s.shape, str(s.dtype), s.tobytes())


class CacheEntry:
    """One memoized plan plus everything derivable from it.

    ``daddr``/``caddr``/``cmask`` (the flat dispatch scatter address, the
    combine gather address and its validity mask) and ``acct`` (the
    host-side accounting tuple: counts, offered, granted, and the
    per-source masked/dropped attribution pair when a source vector was
    known) are filled lazily on first use — a plan-only workload (the
    ``ElasticServer`` tick) never pays for addresses it does not read.
    """

    __slots__ = ("plan", "src", "daddr", "caddr", "cmask", "acct")

    def __init__(self, plan, src=None):
        self.plan = plan
        self.src = src
        self.daddr = None
        self.caddr = None
        self.cmask = None
        self.acct: Optional[Tuple[np.ndarray, int, int, Any]] = None


class PlanCache:
    """LRU of :class:`CacheEntry` keyed by offered bytes, scoped to one
    register epoch at a time.

    ``hits``/``misses``/``invalidations`` are cumulative counters (an
    invalidation is one epoch move that flushed live entries);
    ``reset_stats`` zeroes the counters without dropping entries so a
    telemetry window can restart cleanly.
    """

    def __init__(self, maxsize: int = 128):
        if maxsize < 1:
            raise ValueError(f"plan cache needs maxsize >= 1, got {maxsize}")
        self.maxsize = int(maxsize)
        self._entries: "collections.OrderedDict[Tuple, CacheEntry]" = \
            collections.OrderedDict()
        self._by_plan_id: Dict[int, CacheEntry] = {}
        self._epoch: Optional[int] = None
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def __len__(self) -> int:
        return len(self._entries)

    # ---- epoch scoping -------------------------------------------------
    def _sync(self, epoch_v: int) -> None:
        """Flush everything when the register epoch moved since last use."""
        if epoch_v != self._epoch:
            if self._entries:
                self.invalidations += 1
                self._entries.clear()
                self._by_plan_id.clear()
            self._epoch = epoch_v

    # ---- lookup / store ------------------------------------------------
    def lookup(self, epoch_v: int, key: Tuple) -> Optional[CacheEntry]:
        self._sync(epoch_v)
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry

    def store(self, epoch_v: int, key: Tuple, new_plan,
              src_v=None) -> CacheEntry:
        self._sync(epoch_v)
        old = self._entries.pop(key, None)
        if old is not None:
            self._by_plan_id.pop(id(old.plan), None)
        entry = CacheEntry(new_plan, src_v)
        self._entries[key] = entry
        self._by_plan_id[id(entry.plan)] = entry
        while len(self._entries) > self.maxsize:
            _, evicted = self._entries.popitem(last=False)
            self._by_plan_id.pop(id(evicted.plan), None)
        return entry

    def entry_for_plan(self, epoch_v: int, plan_obj) -> Optional[CacheEntry]:
        """The live entry whose memoized plan *is* ``plan_obj`` (identity
        match — the object a ``lookup`` hit handed back), else None.  Lets
        ``Fabric.account``/``combine`` reuse per-plan derived values
        without recomputing the content key."""
        self._sync(epoch_v)
        return self._by_plan_id.get(id(plan_obj))

    # ---- telemetry -----------------------------------------------------
    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def reset_stats(self) -> None:
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def reset(self) -> None:
        """Cold reset: drop every entry AND zero the counters (without
        charging an invalidation — nothing was live to invalidate from
        the next run's point of view).  This is the record→replay teardown:
        ``reset_stats`` alone leaves entries warm, so a replayed scenario's
        first offers would *hit* where the recorded run *missed* and its
        ``plan_cache_hit_rate`` would diverge bit-from-bit from the
        recording.  ``Fabric.reset_accounting(cold_cache=True)`` calls this."""
        self._entries.clear()
        self._by_plan_id.clear()
        self._epoch = None
        self.reset_stats()

    def stats(self) -> Dict[str, Any]:
        """The cache's counters as one mapping."""
        return {
            "plan_cache_hits": self.hits,
            "plan_cache_misses": self.misses,
            "plan_cache_invalidations": self.invalidations,
            "plan_cache_entries": len(self._entries),
        }
