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

Entry points run on ``device`` (the card unless ``"cpu"`` is asked for).
The sanitizer of the JAX package (``debug=``) and the telemetry probe are
not ported: ``debug`` accepts only ``False``.
"""
from __future__ import annotations

import dataclasses
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
        # Host-side cumulative traffic counters, fed by ``account(plan)``.
        self.port_traffic = np.zeros(n, np.int64)
        self.offered_packets = 0
        self.granted_packets = 0
        # Per-source attribution of masked (INVALID_DEST) and non-granted
        # offers; filled only by ``account(plan, src)``.
        self.masked_by_src = np.zeros(n, np.int64)
        self.dropped_by_src = np.zeros(n, np.int64)
        self._shared_scatter = bool(getattr(self.backend,
                                            "uses_shared_scatter", False))
        if plan_cache:
            size = 128 if plan_cache is True else int(plan_cache)
            self.plan_cache: Optional[PlanCache] = PlanCache(maxsize=size)
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
        self.masked_by_src = np.zeros_like(self.masked_by_src)
        self.dropped_by_src = np.zeros_like(self.dropped_by_src)
        self.offered_packets = 0
        self.granted_packets = 0
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
        plan, _, src_t = self._plan(dst, src)
        self._cache_store(dst, src, plan, src_t)
        return plan

    def dispatch(self, x: torch.Tensor, dst, src
                 ) -> Tuple[torch.Tensor, DispatchPlan]:
        """Plan + scatter packets ``x`` [T, D] into destination receive
        slabs [n_ports, C, D]; dropped packets land nowhere."""
        entry = self._cache_lookup(dst, src)
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

    def combine(self, y: torch.Tensor, plan: DispatchPlan,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Gather result slabs back to packet order ([T, D]), scaled by
        ``weights``; dropped packets get zeros."""
        if weights is None:
            weights = torch.ones(plan.keep.shape, dtype=y.dtype,
                                 device=y.device)
        entry = None
        if self.plan_cache is not None:
            entry = self.plan_cache.entry_for_plan(self.epoch, plan)
        if (entry is not None and self._shared_scatter
                and tuple(y.shape[:2]) == (plan.counts.shape[0],
                                           self.capacity)):
            self._cache_addrs(entry)
            return arbiter.combine_at(y, entry.caddr, entry.cmask, weights)
        return self.backend.combine(y, plan, weights)

    def transfer(self, x: torch.Tensor, dst, src,
                 apply_fn: Optional[ApplyFn] = None,
                 weights: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, DispatchPlan]:
        """Round-trip: plan -> dispatch -> ``apply_fn`` on the slabs ->
        combine."""
        slabs, plan = self.dispatch(x, dst, src)
        y = slabs if apply_fn is None else apply_fn(slabs)
        return self.combine(y, plan, weights), plan


def fabric_for_shell(shell, *, backend="reference", capacity=None,
                     **backend_kw) -> Fabric:
    """A fabric tracking ``shell.registers`` across epochs (the
    implementation behind ``Shell.fabric``)."""
    if capacity is None:
        capacity = getattr(shell, "capacity", None)
    return Fabric(shell, backend=backend, capacity=capacity, **backend_kw)
