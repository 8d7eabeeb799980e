"""Wrappers of the crossbar-dispatch CUDA kernels (``csrc/crossbar_dispatch.cu``).

Each wrapper takes the plain version in ``ref.py`` for CPU tensors (or
under ``KernelMode.TORCH``) and launches its kernel for CUDA tensors; under
``KernelMode.CUDA`` a CPU tensor raises.  There is no fallback from the
kernel to the plain version: a kernel that does not build or launch
raises.  The library is built on first launch (``kernels/build.py``), never
at import.

Each wrapper carries ``launches``, a plain int that counts kernel launches
(plain-version calls do not count); :func:`reset_launch_counts` zeroes them.

The plans (``plan_multi``, ``plan``, and ``plan_fabric``, the fabric's
whole ``DispatchPlan`` from its register file) are one launch and no
memset up to ``PLAN_BLOCK_T`` packets, with every output part of one
``torch.empty`` buffer that the kernel writes whole and every register
read in place; above, the kernel spreads over several blocks (and
``plan_fabric`` takes a second launch), with a scratch kept per stream
that each launch leaves zeroed.

``scatter`` allocates its slabs with ``torch.empty``: the kernel writes
every byte of them, a granted packet's row or zeros, so a call is one
launch and no memset (two launches from ``OWNER_PASS_T`` packets on, see
the source note).  ``combine`` with ``weights=None`` is the unit-weight
form: the kernel copies the rows, bit-equal to weights of 1.0, and the
backwards of ``ops.py`` use it instead of a tensor of ones.

At the served decode shape a call is host time, so the CUDA path does no
work it can skip: index tensors that are int32 and contiguous already
(``ops.py`` hands them over so) are passed as they are, the stream is
PyTorch's raw current stream, and the checks read shapes and types only,
never values on the card.

TPU kernels replaced (``repro/kernels/crossbar_dispatch/kernel.py``):
``plan_multi`` and ``plan_fabric`` <- ``plan_multi_call`` (with
``PallasBackend.plan``'s epilogue), ``plan`` <- ``plan_call``,
``scatter`` <- ``scatter_call``, ``combine`` <- ``combine_call``.  What
bounds each one on the card and how the design answers it is in the
source note of the ``.cu`` file.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Optional, Tuple

import torch

from repro_torch.core.arbiter import DispatchPlan
from repro_torch.fabric.interface import KernelMode, use_kernel
from repro_torch.kernels import build
from repro_torch.kernels.crossbar_dispatch import ref

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "crossbar_dispatch.cu",)
LIB_NAME = "crossbar_dispatch"
PLAN_BLOCK_T = 8192              # packets one plan block takes at most
MAX_PORTS = 64                   # plan_multi, plan_fabric: S * S streams
PLAN_MAX_PORTS = MAX_PORTS ** 2  # plan: S streams
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MASK_BYTES = {torch.int32: 4, torch.bool: 1}
VEC_BYTES = 16                   # scatter/combine move rows as uint4
OWNER_PASS_T = 4096              # packets from which scatter maps owners first

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


_LIB = None
# Per (device, stream): the int32 flags (zeroed once; every launch leaves
# them zeroed) and data of plans over several blocks (see the source note).
_SCRATCH = {}


def library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = build.load_library(LIB_NAME, SOURCES)
        scratch = [_P, _L, _P, _L, _I, _I, _I, _P]   # + T, S, block_t, stream
        lib.crossbar_plan_multi.argtypes = [_P, _P, _P, _I, _P, _I, _I,
                                            _P] + scratch
        lib.crossbar_plan.argtypes = [_P, _P, _I, _P, _P, _P] + scratch
        lib.crossbar_plan_fabric.argtypes = [_P] * 7 + scratch
        lib.crossbar_scatter.argtypes = [_P] * 6 + [_I] * 4 + [_P]
        lib.crossbar_combine.argtypes = [_P] * 6 + [_I] * 5 + [_P]
        for fn in (lib.crossbar_plan_multi, lib.crossbar_plan,
                   lib.crossbar_plan_fabric, lib.crossbar_scatter,
                   lib.crossbar_combine):
            fn.restype = _I
        _LIB = lib
    return _LIB


def _i32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous int32 tensor; ``t`` itself when it is one."""
    if t.dtype is torch.int32 and t.is_contiguous():
        return t
    return t.to(torch.int32).contiguous()


def _rows(t: torch.Tensor, what: str) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, with 16-byte rows, in a type
    the row kernels take: they move whole rows as uint4 vectors."""
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} kernel takes float32/bfloat16, got {t.dtype}")
    if (t.shape[-1] * t.element_size()) % VEC_BYTES:
        raise ValueError(f"{what} kernel needs rows of a multiple of "
                         f"{VEC_BYTES} bytes, got {t.shape[-1]} x "
                         f"{t.element_size()} bytes")
    if not t.is_contiguous():
        t = t.contiguous()
    if t.data_ptr() % VEC_BYTES:
        t = t.clone()            # a view at an odd offset: fresh storage
    return t


def _mask(t: torch.Tensor) -> torch.Tensor:
    """An isolation mask as the plan kernels read it: int32 or bool as it
    is, contiguous; any other type as int32."""
    if t.dtype not in _MASK_BYTES:
        t = t.to(torch.int32)
    return t if t.is_contiguous() else t.contiguous()


def _launch_plan(entry, name: str, dev: torch.device, T: int, S: int,
                 n_keys: int, *args) -> None:
    """Call a plan entry with the plan scratch of PyTorch's stream on
    ``dev``.  A plan over B blocks that finds too little returns -B; then
    make 2 + B flag ints (zeroed) and (1 + B) * n_keys data ints, or keep
    what is larger, and call again."""
    stream = build.stream(dev)
    key = (dev.index, stream)
    flags, data = _SCRATCH.get(key, (None, None))
    scratch = (None, 0, None, 0) if flags is None else (
        flags.data_ptr(), flags.numel(), data.data_ptr(), data.numel())
    code = entry(*args, *scratch, T, S, PLAN_BLOCK_T, stream)
    if code < 0:
        n_flags, n_data = 2 - code, (1 - code) * n_keys
        if flags is not None:
            n_flags = max(n_flags, flags.numel())
            n_data = max(n_data, data.numel())
        flags = torch.zeros((n_flags,), dtype=torch.int32, device=dev)
        data = torch.empty((n_data,), dtype=torch.int32, device=dev)
        _SCRATCH[key] = flags, data
        code = entry(*args, flags.data_ptr(), n_flags, data.data_ptr(),
                     n_data, T, S, PLAN_BLOCK_T, stream)
    build.check(code, name)


def plan_multi(dst: torch.Tensor, src: torch.Tensor, allowed_sd: torch.Tensor,
               quota_sd: torch.Tensor, *, mode=KernelMode.AUTO
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Fused multi-source grant sweep; see ``ref.plan_multi_ref``.

    ``allowed_sd`` (int32 or bool) and ``quota_sd`` (int32) are indexed
    [src, dst].  The register file stores quota [dst, src], so callers pass
    ``regs.quota.T``: the kernel reads it through its strides, no copy."""
    if not use_kernel(mode, dst, src, allowed_sd, quota_sd):
        return ref.plan_multi_ref(dst, src, allowed_sd, quota_sd)
    S = allowed_sd.shape[0]
    T = dst.shape[0]
    if allowed_sd.shape != (S, S) or quota_sd.shape != (S, S):
        raise ValueError("allowed_sd and quota_sd must be [S, S]")
    if not 0 < S <= MAX_PORTS:
        raise ValueError(f"plan_multi kernel takes 1..{MAX_PORTS} ports, got {S}")
    if src.shape != (T,):
        raise ValueError(f"src must be [{T}], got {tuple(src.shape)}")
    dev = dst.device
    dst, src, allowed = _i32(dst), _i32(src), _mask(allowed_sd)
    quota = quota_sd if quota_sd.dtype is torch.int32 else quota_sd.to(
        torch.int32)
    out = torch.empty((3 * T + S * S,), dtype=torch.int32, device=dev)
    _launch_plan(library().crossbar_plan_multi, "crossbar_plan_multi", dev,
                 T, S, S * S, dst.data_ptr(), src.data_ptr(),
                 allowed.data_ptr(), _MASK_BYTES[allowed.dtype],
                 quota.data_ptr(), quota.stride(0), quota.stride(1),
                 out.data_ptr())
    plan_multi.launches += 1
    keep, rank, err, granted = out.split_with_sizes((T, T, T, S * S))
    return keep, rank, err, granted.view(S, S)


def plan_fabric(dst: torch.Tensor, src: torch.Tensor, allowed: torch.Tensor,
                reset: torch.Tensor, quota: torch.Tensor,
                capacity: torch.Tensor, *, mode=KernelMode.AUTO
                ) -> DispatchPlan:
    """The fabric's whole plan from its register file as stored: what
    ``CudaBackend.plan`` returns; see ``ref.plan_fabric_ref``.

    ``allowed`` [src, dst] and ``reset`` [S] bool, ``quota`` [dst, src] and
    ``capacity`` [S] (clamped to the slab depth) int32.  Registers are read
    at call time, so a register rewrite needs no rebuild.  Its launches
    count under ``plan_multi``, the TPU kernel whose place it takes on the
    fabric's path."""
    if not use_kernel(mode, dst, src, allowed, reset, quota, capacity):
        return ref.plan_fabric_ref(dst, src, allowed, reset, quota, capacity)
    S = allowed.shape[0]
    T = dst.shape[0]
    if not (allowed.dtype is reset.dtype is torch.bool
            and quota.dtype is capacity.dtype is torch.int32):
        raise TypeError("plan_fabric takes bool allowed and reset, int32 "
                        "quota and capacity")
    if not (allowed.shape == quota.shape == (S, S)
            and reset.shape == capacity.shape == (S,)):
        raise ValueError("allowed and quota must be [S, S], reset and "
                         "capacity [S]")
    if not 0 < S <= MAX_PORTS:
        raise ValueError(f"plan_fabric kernel takes 1..{MAX_PORTS} ports, "
                         f"got {S}")
    if src.shape != (T,):
        raise ValueError(f"src must be [{T}], got {tuple(src.shape)}")
    dev = dst.device
    dst, src = _i32(dst), _i32(src)
    regs = [r if r.is_contiguous() else r.contiguous()
            for r in (allowed, reset, quota, capacity)]
    # int32 slot, error [T], counts [S], drops [4], then keep as T bytes
    out = torch.empty((2 * T + S + 4 + (T + 3) // 4,), dtype=torch.int32,
                      device=dev)
    _launch_plan(library().crossbar_plan_fabric, "crossbar_plan_fabric", dev,
                 T, S, S * S, dst.data_ptr(), src.data_ptr(),
                 *[r.data_ptr() for r in regs], out.data_ptr())
    plan_multi.launches += 1
    slot, error, counts, drops, keep = out.split_with_sizes(
        (T, T, S, 4, (T + 3) // 4))
    keep = keep.view(torch.bool)
    if T % 4:
        keep = keep[:T]
    return DispatchPlan(keep=keep, slot=slot, dst=dst, error=error,
                        counts=counts, drops=drops)


def plan(dst: torch.Tensor, allowed_row: torch.Tensor,
         quota_row: torch.Tensor, capacity: torch.Tensor, *,
         mode=KernelMode.AUTO
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One source region's plan with capacity; see ``ref.plan_ref``."""
    if not use_kernel(mode, dst, allowed_row, quota_row, capacity):
        return ref.plan_ref(dst, allowed_row, quota_row, capacity)
    S = allowed_row.shape[0]
    T = dst.shape[0]
    if dst.dim() != 1 or not (allowed_row.shape == quota_row.shape
                              == capacity.shape == (S,)):
        raise ValueError("dst must be [T] and the register rows [S]")
    if not 0 < S <= PLAN_MAX_PORTS:
        raise ValueError(f"plan kernel takes 1..{PLAN_MAX_PORTS} ports, "
                         f"got {S}")
    dev = dst.device
    dst, allowed = _i32(dst), _mask(allowed_row)
    quota, cap = _i32(quota_row), _i32(capacity)
    out = torch.empty((3 * T + S,), dtype=torch.int32, device=dev)
    _launch_plan(library().crossbar_plan, "crossbar_plan", dev, T, S, S,
                 dst.data_ptr(), allowed.data_ptr(),
                 _MASK_BYTES[allowed.dtype], quota.data_ptr(), cap.data_ptr(),
                 out.data_ptr())
    plan.launches += 1
    return out.split_with_sizes((T, T, T, S))


def scatter(x: torch.Tensor, dst: torch.Tensor, keep: torch.Tensor,
            slot: torch.Tensor, *, n_ports: int, capacity: int,
            mode=KernelMode.AUTO) -> torch.Tensor:
    """Granted packets [T, D] into zeroed slabs [S, C, D]; see
    ``ref.scatter_ref``."""
    if not use_kernel(mode, x, dst, keep, slot):
        return ref.scatter_ref(x, dst, keep, slot, n_ports, capacity)
    T, D = x.shape
    if not dst.shape == keep.shape == slot.shape == (T,):
        raise ValueError("dst, keep and slot must be [T]")
    x = _rows(x, "scatter")
    dev = x.device
    slabs = torch.empty(n_ports, capacity, D, dtype=x.dtype, device=dev)
    if n_ports * capacity * D == 0:
        return slabs
    dst, keep, slot = _i32(dst), _i32(keep), _i32(slot)
    owner = None                 # held until the launch is enqueued
    if T >= OWNER_PASS_T:
        owner = torch.empty((n_ports * capacity,), dtype=torch.int32,
                            device=dev)
    code = library().crossbar_scatter(
        x.data_ptr(), dst.data_ptr(), keep.data_ptr(), slot.data_ptr(),
        None if owner is None else owner.data_ptr(), slabs.data_ptr(), T,
        n_ports, capacity, D * x.element_size() // VEC_BYTES,
        build.stream(dev))
    build.check(code, "crossbar_scatter")
    scatter.launches += 1
    return slabs


def combine(y: torch.Tensor, dst: torch.Tensor, keep: torch.Tensor,
            slot: torch.Tensor, weights: Optional[torch.Tensor], *,
            mode=KernelMode.AUTO) -> torch.Tensor:
    """Slabs [S, C, D] back to packets [T, D], weighted in float32 and
    rounded once to ``y.dtype``, or copied where ``weights`` is None; see
    ``ref.combine_ref``."""
    ts = (y, dst, keep, slot) if weights is None else (y, dst, keep, slot,
                                                       weights)
    if not use_kernel(mode, *ts):
        return ref.combine_ref(y, dst, keep, slot, weights)
    S, C, D = y.shape
    T = dst.shape[0]
    if not keep.shape == slot.shape == (T,) or (
            weights is not None and weights.shape != (T,)):
        raise ValueError("dst, keep, slot and weights must be [T]")
    y = _rows(y, "combine")
    dev = y.device
    out = torch.empty(T, D, dtype=y.dtype, device=dev)
    if T * D == 0:
        return out
    dst, keep, slot = _i32(dst), _i32(keep), _i32(slot)
    w = None
    if weights is not None:
        if weights.dtype is not torch.float32 or not weights.is_contiguous():
            weights = weights.to(torch.float32).contiguous()
        w = weights.data_ptr()
    code = library().crossbar_combine(
        y.data_ptr(), dst.data_ptr(), keep.data_ptr(), slot.data_ptr(), w,
        out.data_ptr(), T, S, C, D * y.element_size() // VEC_BYTES,
        _DTYPE_CODE[y.dtype], build.stream(dev))
    build.check(code, "crossbar_combine")
    combine.launches += 1
    return out


KERNELS = (plan_multi, plan, scatter, combine)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
