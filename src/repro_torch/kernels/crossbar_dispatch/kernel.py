"""Wrappers of the crossbar-dispatch CUDA kernels (``csrc/crossbar_dispatch.cu``).

Each wrapper takes the plain version in ``ref.py`` for CPU tensors (or
under ``KernelMode.TORCH``) and launches its kernel for CUDA tensors; under
``KernelMode.CUDA`` a CPU tensor raises.  There is no fallback from the
kernel to the plain version: a kernel that does not build or launch
raises.  The library is built on first launch (``kernels/build.py``), never
at import.

Each wrapper carries ``launches``, a plain int that counts kernel launches
(plain-version calls do not count); :func:`reset_launch_counts` zeroes them.

TPU kernels replaced (``repro/kernels/crossbar_dispatch/kernel.py``):
``plan_multi`` <- ``plan_multi_call``, ``plan`` <- ``plan_call``,
``scatter`` <- ``scatter_call``, ``combine`` <- ``combine_call``.  What
bounds each one on the card and how the design answers it is in the
source note of the ``.cu`` file.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Tuple

import torch

from repro_torch.fabric.interface import KernelMode, use_kernel
from repro_torch.kernels import build
from repro_torch.kernels.crossbar_dispatch import ref

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "crossbar_dispatch.cu",)
LIB_NAME = "crossbar_dispatch"
PLAN_BLOCK = 256                 # tokens per block of the plan kernels
MAX_PORTS = 64                   # plan_rank_kernel keeps 9 * S^2 ints in smem
PLAN_MAX_PORTS = MAX_PORTS ** 2  # ... and 9 * S ints for one source's plan
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
VEC_BYTES = 16                   # scatter/combine move rows as uint4

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    fresh = LIB_NAME not in build.load_count
    lib = build.load_library(LIB_NAME, SOURCES)
    if fresh:
        lib.crossbar_plan_multi.argtypes = [_P] * 9 + [_I, _I, _P]
        lib.crossbar_plan.argtypes = [_P] * 9 + [_I, _I, _P]
        lib.crossbar_scatter.argtypes = [_P] * 5 + [_I, _I, _I,
                                                    ctypes.c_longlong, _P]
        lib.crossbar_combine.argtypes = [_P] * 6 + [_I] * 5 + [_P]
        for fn in (lib.crossbar_plan_multi, lib.crossbar_plan,
                   lib.crossbar_scatter, lib.crossbar_combine):
            fn.restype = _I
    return lib


def _i32(t: torch.Tensor) -> torch.Tensor:
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
    t = t.contiguous()
    if t.data_ptr() % VEC_BYTES:
        t = t.clone()            # a view at an odd offset: fresh storage
    return t


def plan_multi(dst: torch.Tensor, src: torch.Tensor, allowed_sd: torch.Tensor,
               quota_sd: torch.Tensor, *, mode=KernelMode.AUTO
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Fused multi-source grant sweep; see ``ref.plan_multi_ref``.

    ``quota_sd`` is indexed [src, dst]: the register file stores quota
    [dst, src], so callers pass ``regs.quota.T`` and the wrapper makes it
    contiguous before its pointer is taken."""
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
    dst, src = _i32(dst), _i32(src)
    allowed, quota = _i32(allowed_sd), _i32(quota_sd)
    keep = torch.empty((T,), dtype=torch.int32, device=dev)
    rank = torch.empty_like(keep)
    err = torch.empty_like(keep)
    granted = torch.zeros((S, S), dtype=torch.int32, device=dev)
    n_blocks = -(-T // PLAN_BLOCK)
    hist = torch.empty((S * S, n_blocks), dtype=torch.int32, device=dev)
    code = library().crossbar_plan_multi(
        dst.data_ptr(), src.data_ptr(), allowed.data_ptr(), quota.data_ptr(),
        keep.data_ptr(), rank.data_ptr(), err.data_ptr(), granted.data_ptr(),
        hist.data_ptr(), T, S, build.stream(dev))
    build.check(code, "crossbar_plan_multi")
    plan_multi.launches += 1
    return keep, rank, err, granted


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
    keep = torch.empty((T,), dtype=torch.int32, device=dev)
    slot = torch.empty_like(keep)
    err = torch.empty_like(keep)
    counts = torch.zeros((S,), dtype=torch.int32, device=dev)
    dst = _i32(dst)
    allowed, quota, cap = _i32(allowed_row), _i32(quota_row), _i32(capacity)
    hist = torch.empty((S, -(-T // PLAN_BLOCK)), dtype=torch.int32,
                       device=dev)
    code = library().crossbar_plan(
        dst.data_ptr(), allowed.data_ptr(), quota.data_ptr(), cap.data_ptr(),
        keep.data_ptr(), slot.data_ptr(), err.data_ptr(), counts.data_ptr(),
        hist.data_ptr(), T, S, build.stream(dev))
    build.check(code, "crossbar_plan")
    plan.launches += 1
    return keep, slot, err, counts


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
    slabs = torch.zeros((n_ports, capacity, D), dtype=x.dtype, device=x.device)
    dst, keep, slot = _i32(dst), _i32(keep), _i32(slot)
    code = library().crossbar_scatter(
        x.data_ptr(), dst.data_ptr(), keep.data_ptr(), slot.data_ptr(),
        slabs.data_ptr(), T, n_ports, capacity,
        D * x.element_size() // VEC_BYTES, build.stream(x.device))
    build.check(code, "crossbar_scatter")
    scatter.launches += 1
    return slabs


def combine(y: torch.Tensor, dst: torch.Tensor, keep: torch.Tensor,
            slot: torch.Tensor, weights: torch.Tensor, *,
            mode=KernelMode.AUTO) -> torch.Tensor:
    """Slabs [S, C, D] back to packets [T, D], weighted in float32 and
    rounded once to ``y.dtype``; see ``ref.combine_ref``."""
    if not use_kernel(mode, y, dst, keep, slot, weights):
        return ref.combine_ref(y, dst, keep, slot, weights)
    S, C, D = y.shape
    T = dst.shape[0]
    if not keep.shape == slot.shape == weights.shape == (T,):
        raise ValueError("dst, keep, slot and weights must be [T]")
    y = _rows(y, "combine")
    out = torch.empty((T, D), dtype=y.dtype, device=y.device)
    dst, keep, slot = _i32(dst), _i32(keep), _i32(slot)
    w = weights.to(torch.float32).contiguous()
    code = library().crossbar_combine(
        y.data_ptr(), dst.data_ptr(), keep.data_ptr(), slot.data_ptr(),
        w.data_ptr(), out.data_ptr(), T, S, C, D, _DTYPE_CODE[y.dtype],
        build.stream(y.device))
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
