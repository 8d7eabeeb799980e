"""``Fabric``: one data-plane object over the crossbar register file.

One object binds a register file (or a live ``Shell``) to a dispatch
backend and a device, and exposes the whole packet round-trip:

    fabric = Fabric(regs, backend="cuda", capacity=64)
    plan          = fabric.plan(dst, src)
    slabs, plan   = fabric.dispatch(x, dst, src)
    y             = fabric.combine(slabs, plan)
    y, plan       = fabric.transfer(x, dst, src, apply_fn=module_fn)

**Epoch awareness is the point.**  A fabric bound to a ``Shell`` re-reads
``shell.registers`` on every call, so ``shell.post(Grow(...))`` re-routes
the very next call.  Registers are kernel arguments, never compile-time
constants, so no kernel is rebuilt: the kernel library's load count
(``repro_torch.kernels.build.load_count``) stays at 1 across
reconfigurations.  The register file
is moved to the fabric's device once per register object, i.e. once per
epoch, never on every call.

``trace_count`` is the JAX package's retrace counter in the port's terms.
JAX traces an entry point once per new argument signature; the port does
not trace, so it counts the distinct (entry point, argument shapes,
dtypes) signatures its entry points have run, with 64-bit types counted
as their 32-bit forms as JAX does by default.  Those are the keys under
which ``jax.jit`` would have traced, so on the same calls the counts are
the JAX package's.  A plan-cache hit runs no entry point and counts
nothing, as in JAX.  On the card the zero-rebuild pin is the kernel
library's load count; ``trace_count`` is the same integer on every
backend and device.

Entry points run on ``device`` (the card unless ``"cpu"`` is asked for).
The sanitizer of the JAX package (``debug=``) is not ported: ``debug``
accepts only ``False``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import arbiter
from repro_torch.core.arbiter import DispatchPlan
from repro_torch.core.device import resolve_device
from repro_torch.core.registers import CrossbarRegisters, ErrorCode
from repro_torch.fabric.backends import get_backend
from repro_torch.fabric.cache import PlanCache, plan_key
from repro_torch.fabric.interface import KernelMode, resolve_kernel_mode

ApplyFn = Callable[[torch.Tensor], torch.Tensor]


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


# JAX's default (x64 off) canonicalizes 64-bit arguments to 32 bits before
# it looks for a trace, so such arguments share one signature.
_CANONICAL = {torch.int64: torch.int32, torch.float64: torch.float32,
              torch.complex128: torch.complex64}


@functools.lru_cache(maxsize=None)
def _np_dtype(dt: np.dtype):
    """A numpy dtype as the (canonical) torch dtype a tensor of it has, so
    a numpy array and a tensor of one shape and type share a signature."""
    try:
        out = torch.from_numpy(np.empty(0, dt)).dtype
    except TypeError:
        return dt.name
    return _CANONICAL.get(out, out)


@functools.lru_cache(maxsize=None)
def _field_names(cls) -> Optional[Tuple[str, ...]]:
    if not dataclasses.is_dataclass(cls):
        return None
    return tuple(f.name for f in dataclasses.fields(cls))


def _signature(v):
    """The abstract value ``jax.jit`` keys a trace on: shapes and
    (canonical) dtypes of every array leaf, recursing into the register
    file and plan records; other values (``apply_fn``) by identity."""
    if isinstance(v, torch.Tensor):
        return (v.shape, _CANONICAL.get(v.dtype, v.dtype))
    if isinstance(v, np.ndarray):
        return (torch.Size(v.shape), _np_dtype(v.dtype))
    if v is None:
        return None
    if isinstance(v, (bool, int, float)):
        return ((), type(v).__name__, "weak")
    names = None if isinstance(v, type) else _field_names(type(v))
    if names is not None:
        return tuple(_signature(getattr(v, n)) for n in names)
    return v


class Fabric:
    """Register-gated packet transfer with a pluggable dispatch backend.

    Parameters
    ----------
    registers:
        A ``CrossbarRegisters``, a live ``Shell`` (every call reads the
        shell's current file), or a zero-arg callable returning registers.
    backend:
        ``"reference"`` | ``"cuda"`` (alias ``"pallas"``) |
        ``"cuda_kernel"`` | a backend instance; ``backend_kw`` feed the
        named factory (e.g. ``data_plane=``).
    capacity:
        Receive-slab depth.  Grants use ``min(registers.capacity,
        capacity)``.  Defaults to the bound file's largest capacity.
    plan_cache:
        ``True`` (a default-sized LRU), an int (its size), or ``False``.
        Memoizes plans and scatter addresses per (register epoch, offered
        bytes) for calls against the bound register file.
    kernel_mode:
        :class:`KernelMode` or an alias; ``None``/``"auto"`` resolves from
        the device.
    device:
        Where plans and data live; ``None`` is the card.
    """

    def __init__(self, registers, *, backend: Union[str, Any] = "reference",
                 capacity: Optional[int] = None, debug=False,
                 plan_cache: Union[bool, int, None] = False,
                 kernel_mode: Union[str, KernelMode, None] = None,
                 device=None, **backend_kw):
        if debug not in (False, None):
            raise NotImplementedError(
                "the fabric sanitizer is not ported; debug must be False")
        self.device = resolve_device(device)
        if isinstance(registers, CrossbarRegisters):
            regs0 = registers
            self._regs_fn = lambda: regs0
            version = int(regs0.version)
            self._epoch_fn = lambda: version
        elif hasattr(registers, "registers"):
            # duck-typed Shell: live property, re-read on every call
            self._regs_fn = lambda: registers.registers
            if hasattr(registers, "epoch"):
                self._epoch_fn = lambda: int(registers.epoch)
            else:
                self._epoch_fn = lambda: int(self._regs_fn().version)
        elif callable(registers):
            self._regs_fn = registers
            self._epoch_fn = lambda: int(self._regs_fn().version)
        else:
            raise TypeError(f"cannot bind fabric to {type(registers)!r}")
        self.backend = get_backend(backend, **backend_kw)
        self.kernel_mode = resolve_kernel_mode(kernel_mode, self.device)
        bind_mode = getattr(self.backend, "apply_kernel_mode", None)
        if bind_mode is not None:
            bind_mode(self.kernel_mode)
        if capacity is None:
            capacity = int(self.registers.capacity.max())
        self.capacity = int(capacity)
        n = self.registers.n_ports
        # Host-side cumulative traffic counters, fed by ``account(plan)``
        # and ``account_stats``; ``FabricProbe`` samples them.
        self.port_traffic = np.zeros(n, np.int64)
        self.offered_packets = 0
        self.granted_packets = 0
        # Grants into another shard's ports vs the source's own, in total
        # and per destination port (fed by ``account_stats``).
        self.remote_packets = 0
        self.local_packets = 0
        self.remote_port_traffic = np.zeros(n, np.int64)
        self.local_port_traffic = np.zeros(n, np.int64)
        # Per-source attribution of masked (INVALID_DEST) and non-granted
        # offers; filled only by ``account(plan, src)``.
        self.masked_by_src = np.zeros(n, np.int64)
        self.dropped_by_src = np.zeros(n, np.int64)
        self._shared_scatter = bool(getattr(self.backend,
                                            "uses_shared_scatter", False))
        self._trace_counts = {"plan": 0, "dispatch": 0, "combine": 0,
                              "transfer": 0}
        self._signatures = set()
        self._sig_regs: Optional[CrossbarRegisters] = None
        self._regs_signature = None
        if plan_cache:
            size = 128 if plan_cache is True else int(plan_cache)
            self.plan_cache: Optional[PlanCache] = PlanCache(maxsize=size)
            self._trace_counts.update(addrs=0, dispatch_cached=0,
                                      combine_cached=0, transfer_cached=0)
        else:
            self.plan_cache = None
        self._dev_src: Optional[CrossbarRegisters] = None
        self._dev_regs: Optional[CrossbarRegisters] = None
        self.register_moves = 0

    # ---- live views ---------------------------------------------------
    @property
    def registers(self) -> CrossbarRegisters:
        """The register file read *now* (live when bound to a shell)."""
        return self._regs_fn()

    @property
    def epoch(self) -> int:
        return self._epoch_fn()

    @property
    def n_ports(self) -> int:
        return self.registers.n_ports

    @property
    def trace_count(self) -> int:
        """Distinct call signatures run over every entry point (the JAX
        package's retrace count on the same calls; reconfigurations must
        not increase it)."""
        return sum(self._trace_counts.values())

    @property
    def trace_counts(self):
        return dict(self._trace_counts)

    def _run(self, entry: str, regs: CrossbarRegisters, *args) -> None:
        """Count ``entry``'s call on ``regs`` and ``args`` if its signature
        is new (a register file's signature is taken once per object)."""
        if regs is not None and regs is not self._sig_regs:
            self._sig_regs = regs
            self._regs_signature = _signature(regs)
        key = (entry, None if regs is None else self._regs_signature) + \
            tuple(_signature(a) for a in args)
        if key not in self._signatures:
            self._signatures.add(key)
            self._trace_counts[entry] += 1

    def probe(self):
        """A ``repro_torch.manager`` telemetry probe over this fabric
        (epoch, the signature counters and whatever traffic ``account``
        and ``account_stats`` have accumulated)."""
        from repro_torch.manager.telemetry import FabricProbe
        return FabricProbe(self)

    def _on_device(self, regs: CrossbarRegisters) -> CrossbarRegisters:
        """``regs`` on this fabric's device with capacities clamped to the
        slab depth, moved once per register object (registers are
        immutable: a rewrite is a new object, i.e. a new epoch)."""
        if regs is not self._dev_src:
            moved = regs.to(self.device)
            self._dev_regs = dataclasses.replace(
                moved, capacity=moved.capacity.clamp(max=self.capacity))
            self._dev_src = regs
            self.register_moves += 1
        return self._dev_regs

    def _tensor(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(self.device)
        return torch.as_tensor(np.asarray(v), device=self.device)

    # ---- accounting ---------------------------------------------------
    def reset_accounting(self, *, cold_cache: bool = False) -> None:
        """Zero every cumulative traffic counter (and the plan cache's
        stats; ``cold_cache=True`` also drops its entries)."""
        self.port_traffic = np.zeros_like(self.port_traffic)
        self.remote_port_traffic = np.zeros_like(self.remote_port_traffic)
        self.local_port_traffic = np.zeros_like(self.local_port_traffic)
        self.masked_by_src = np.zeros_like(self.masked_by_src)
        self.dropped_by_src = np.zeros_like(self.dropped_by_src)
        self.offered_packets = 0
        self.granted_packets = 0
        self.remote_packets = 0
        self.local_packets = 0
        if self.plan_cache is not None:
            if cold_cache:
                self.plan_cache.reset()
            else:
                self.plan_cache.reset_stats()

    def account(self, plan: DispatchPlan, src=None) -> None:
        """Fold one ``DispatchPlan`` into the host-side traffic counters:
        per-destination grants, offered (``dst >= 0``) and granted packets,
        and, given the [T] ``src`` vector, per-source masked and dropped
        offers.  Plans handed back by the plan cache replay the host values
        memoized on their first accounting, with no device round-trip."""
        cache = self.plan_cache
        entry = (cache.entry_for_plan(self.epoch, plan)
                 if cache is not None else None)
        if entry is not None and entry.acct is None:
            entry.acct = self._acct(plan, src if src is not None
                                    else entry.src)
        counts, offered, granted, by_src = (
            entry.acct if entry is not None else self._acct(plan, src))
        self._add_counts(counts)
        self.offered_packets += offered
        self.granted_packets += granted
        if by_src is not None:
            masked, dropped = by_src
            self.masked_by_src = self._grow_to(self.masked_by_src,
                                               masked.shape[0])
            self.dropped_by_src = self._grow_to(self.dropped_by_src,
                                                dropped.shape[0])
            self.masked_by_src[:masked.shape[0]] += masked
            self.dropped_by_src[:dropped.shape[0]] += dropped

    def account_stats(self, stats) -> None:
        """Fold a sharded-MoE ``stats`` mapping (``counts``,
        ``offered_packets``, ``granted_packets``, ``remote_packets``,
        ``local_packets`` and the per-port ``local_counts`` /
        ``remote_counts``; any may be missing) into the same cumulative
        counters ``account`` maintains."""
        if "counts" in stats:
            self._add_counts(_np(stats["counts"]).astype(np.int64))
        self.offered_packets += int(stats.get("offered_packets", 0))
        self.granted_packets += int(stats.get("granted_packets", 0))
        self.remote_packets += int(stats.get("remote_packets", 0))
        self.local_packets += int(stats.get("local_packets", 0))
        if "local_counts" in stats or "remote_counts" in stats:
            n = self.port_traffic.shape[0]
            self._add_split_counts(
                _np(stats.get("local_counts", np.zeros(n))).astype(np.int64),
                _np(stats.get("remote_counts", np.zeros(n))).astype(np.int64))

    @staticmethod
    def _acct(plan: DispatchPlan, src):
        counts = _np(plan.counts).astype(np.int64)
        dst = _np(plan.dst)
        keep = _np(plan.keep).astype(bool)
        by_src = None
        if src is not None:
            n = counts.shape[0]
            offered = dst >= 0
            srcc = np.clip(_np(src), 0, n - 1)
            masked = offered & (_np(plan.error) == ErrorCode.INVALID_DEST)
            dropped = offered & ~keep
            by_src = (np.bincount(srcc[masked], minlength=n)[:n].astype(np.int64),
                      np.bincount(srcc[dropped], minlength=n)[:n].astype(np.int64))
        return counts, int((dst >= 0).sum()), int(keep.sum()), by_src

    @staticmethod
    def _grow_to(vec: np.ndarray, n: int) -> np.ndarray:
        if n <= vec.shape[0]:
            return vec
        grown = np.zeros(n, np.int64)
        grown[:vec.shape[0]] = vec
        return grown

    def _add_counts(self, counts: np.ndarray) -> None:
        self.port_traffic = self._grow_to(self.port_traffic, counts.shape[0])
        self.port_traffic[:counts.shape[0]] += counts

    def _add_split_counts(self, local_counts: np.ndarray,
                          remote_counts: np.ndarray) -> None:
        n = max(local_counts.shape[0], remote_counts.shape[0])
        self.local_port_traffic = self._grow_to(self.local_port_traffic, n)
        self.remote_port_traffic = self._grow_to(self.remote_port_traffic, n)
        self.local_port_traffic[:local_counts.shape[0]] += local_counts
        self.remote_port_traffic[:remote_counts.shape[0]] += remote_counts

    # ---- plan cache plumbing ------------------------------------------
    def _cache_lookup(self, dst, src):
        if self.plan_cache is None:
            return None
        return self.plan_cache.lookup(self.epoch, plan_key(dst, src))

    def _cache_store(self, dst, src, new_plan, src_t) -> None:
        if self.plan_cache is None:
            return
        self.plan_cache.store(self.epoch, plan_key(dst, src), new_plan, src_t)

    def _cache_addrs(self, entry):
        """The entry's memoized scatter/gather addresses, filled on first
        data-plane use."""
        if entry.daddr is None:
            n = entry.plan.counts.shape[0]
            entry.daddr = arbiter.flat_slot_addr(entry.plan, n, self.capacity)
            entry.caddr, entry.cmask = arbiter.combine_addr(
                entry.plan, n, self.capacity)
        return entry

    # ---- public API ---------------------------------------------------
    def _plan(self, dst, src):
        regs = self._on_device(self.registers)
        dst_t, src_t = self._tensor(dst), self._tensor(src)
        return self.backend.plan(dst_t, src_t, regs), regs, src_t

    def plan(self, dst, src) -> DispatchPlan:
        """Grant decisions for packets ``src[t] -> dst[t]`` under the
        current register values (``dst = -1`` marks padding): ``keep``,
        ``slot`` (global WRR receive slot), ``error``, ``counts`` and
        ``drops``."""
        entry = self._cache_lookup(dst, src)
        if entry is not None:
            return entry.plan
        self._run("plan", self.registers, dst, src)
        plan, _, src_t = self._plan(dst, src)
        self._cache_store(dst, src, plan, src_t)
        return plan

    def _dispatch(self, x: torch.Tensor, dst, src, entry
                  ) -> Tuple[torch.Tensor, DispatchPlan]:
        if entry is not None:
            plan = entry.plan
            if self._shared_scatter:
                self._cache_addrs(entry)
                slabs = arbiter.dispatch_at(x, entry.daddr,
                                            plan.counts.shape[0],
                                            self.capacity)
            else:
                slabs = self.backend.dispatch(
                    x, plan, self._on_device(self.registers), self.capacity)
            return slabs, plan
        plan, regs, src_t = self._plan(dst, src)
        slabs = self.backend.dispatch(x, plan, regs, self.capacity)
        self._cache_store(dst, src, plan, src_t)
        return slabs, plan

    def dispatch(self, x: torch.Tensor, dst, src
                 ) -> Tuple[torch.Tensor, DispatchPlan]:
        """Plan + scatter packets ``x`` [T, D] into destination receive
        slabs [n_ports, C, D]; dropped packets land nowhere."""
        entry = self._cache_lookup(dst, src)
        if entry is not None:
            self._run("addrs", None, entry.plan)
            self._run("dispatch_cached", self.registers, x, entry.plan, src)
        else:
            self._run("dispatch", self.registers, x, dst, src)
        return self._dispatch(x, dst, src, entry)

    def _combine(self, y: torch.Tensor, plan: DispatchPlan,
                 weights: torch.Tensor) -> torch.Tensor:
        entry = None
        if self.plan_cache is not None:
            entry = self.plan_cache.entry_for_plan(self.epoch, plan)
        if (entry is not None and self._shared_scatter
                and tuple(y.shape[:2]) == (plan.counts.shape[0],
                                           self.capacity)):
            self._cache_addrs(entry)
            return arbiter.combine_at(y, entry.caddr, entry.cmask, weights)
        return self.backend.combine(y, plan, weights)

    def combine(self, y: torch.Tensor, plan: DispatchPlan,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Gather result slabs back to packet order ([T, D]), scaled by
        ``weights``; dropped packets get zeros."""
        if weights is None:
            weights = torch.ones(plan.keep.shape, dtype=y.dtype,
                                 device=y.device)
        if (self.plan_cache is not None and self.plan_cache.entry_for_plan(
                self.epoch, plan) is not None):
            self._run("addrs", None, plan)
            self._run("combine_cached", self.registers, y, plan, weights)
        else:
            self._run("combine", self.registers, y, plan, weights)
        return self._combine(y, plan, weights)

    def transfer(self, x: torch.Tensor, dst, src,
                 apply_fn: Optional[ApplyFn] = None,
                 weights: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, DispatchPlan]:
        """Round-trip: plan -> dispatch -> ``apply_fn`` on the slabs ->
        combine.  Each new ``apply_fn`` object is a new signature (as a
        static argument of ``jax.jit`` is): pass a stable function."""
        if weights is None:
            weights = torch.ones(tuple(dst.shape), dtype=x.dtype,
                                 device=x.device)
        entry = self._cache_lookup(dst, src)
        if entry is not None:
            self._run("addrs", None, entry.plan)
            self._run("transfer_cached", self.registers, x, entry.plan, src,
                      weights, apply_fn)
        else:
            self._run("transfer", self.registers, x, dst, src, weights,
                      apply_fn)
        slabs, plan = self._dispatch(x, dst, src, entry)
        y = slabs if apply_fn is None else apply_fn(slabs)
        return self._combine(y, plan, weights), plan


def fabric_for_shell(shell, *, backend="reference", capacity=None,
                     **backend_kw) -> Fabric:
    """A fabric tracking ``shell.registers`` across epochs (the
    implementation behind ``Shell.fabric``)."""
    if capacity is None:
        capacity = getattr(shell, "capacity", None)
    return Fabric(shell, backend=backend, capacity=capacity, **backend_kw)
