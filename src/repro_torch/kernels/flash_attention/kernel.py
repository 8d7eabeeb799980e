"""Wrappers of the flash-attention CUDA kernels (``csrc/flash_attention.cu``).

``flash_fwd`` and ``flash_bwd`` take the plain versions in ``ref.py`` for
CPU tensors (or under ``KernelMode.TORCH``) and launch their kernels for
CUDA tensors; under ``KernelMode.CUDA`` a CPU tensor raises.  :func:`route`
picks the kernel by type and head dim:

- bfloat16 at head dims 64, 128 and 256: the tensor-core kernels
  (``"tc"``);
- float32 at head dims 64, 128 and 256, and both types at the smoke
  configs' head dims 8, 12 and 16: the float32 FMA kernels (``"fma"``;
  the narrow dims on a tile 16 wide, zero-padded; the backward at 256 on
  64-column chunks of the head dim);
- anything else raises.

There is no fallback from one kernel to another or to the plain version: a
kernel that does not build, does not take the inputs or does not launch
raises.  The library is built on first launch (``kernels/build.py``),
never at import.

Each wrapper carries ``launches``, a plain int that counts calls that
launched its kernels (``flash_bwd`` launches three: the row sums of
``dO * O``, dK/dV, dQ), and ``by_route``, the same split by route; head
dim 256 counts apart, in ``launches_d256`` and its split
``by_route_d256`` of each wrapper.
Plain-version calls do not count.

TPU kernel replaced: ``flash_attention_hm`` (``_attn_kernel``) of
``repro/kernels/flash_attention/kernel.py``.  The source note of the
``.cu`` file says what bounds it on the card and how the design answers
it.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Optional, Tuple

import torch

from repro_torch.fabric.interface import KernelMode, use_kernel
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "flash_attention.cu",)
LIB_NAME = "flash_attention"
SMALL_HEAD_DIMS = (8, 12, 16)    # the smoke configs'; FMA, on a tile 16 wide
HEAD_DIMS = SMALL_HEAD_DIMS + (64, 128, 256)    # forward
BWD_HEAD_DIMS = HEAD_DIMS                       # backward
TC_HEAD_DIMS = (64, 128, 256)    # bfloat16 forward on the tensor-core kernels
TC_BWD_HEAD_DIMS = TC_HEAD_DIMS  # bfloat16 backward on the tensor-core kernels
ROUTES = ("tc", "fma")
# (query, key) tile of each route's forward (tc at head dim 256: 64 x 32, see
# :func:`fwd_tile`); the backward's tiles are in the source (tc: dK/dV 64
# queries x 128 keys, dQ 128 x 64; at head dim 256 32 x 64 and 128 x 32)
TILES = {"tc": (128, 64), "fma": (64, 64)}
VEC_BYTES = 16                   # tiles are loaded as 16-byte vectors
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    fresh = LIB_NAME not in build.load_count
    lib = build.load_library(LIB_NAME, SOURCES)
    if fresh:
        for suffix in ("", "_tc"):
            fwd = getattr(lib, "flash_attention_fwd" + suffix)
            bwd = getattr(lib, "flash_attention_bwd" + suffix)
            fwd.argtypes = [_P] * 5 + [_I] * 11 + [_P]
            bwd.argtypes = [_P] * 10 + [_I] * 11 + [_P]
            fwd.restype = bwd.restype = _I
    return lib


def route(dtype: torch.dtype, D: int, backward: bool = False) -> str:
    """The kernel that takes (dtype, head dim D) in the given direction:
    ``"tc"`` or ``"fma"``; raises on what no kernel takes."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernel takes float32/bfloat16, got {dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dims {HEAD_DIMS}, got {D}")
    if backward and D not in BWD_HEAD_DIMS:
        raise ValueError(f"flash backward takes head dims {BWD_HEAD_DIMS}, "
                         f"got {D}")
    tc = TC_BWD_HEAD_DIMS if backward else TC_HEAD_DIMS
    return "tc" if dtype == torch.bfloat16 and D in tc else "fma"


def fwd_tile(dtype: torch.dtype, D: int) -> Tuple[int, int]:
    """(query, key) tile of the forward kernel that takes (dtype, D)."""
    kernel = route(dtype, D)
    return (64, 32) if kernel == "tc" and D == 256 else TILES[kernel]


def _inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *more,
            backward: bool = False):
    """Shapes, type and head dim checked (:func:`route`); every tensor
    contiguous and 16-byte aligned (a view at an odd address is copied)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B,Sq,H,D] and k, v [B,Sk,Kv,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, D = q.shape
    Kv = k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % Kv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"form grouped-query attention")
    route(q.dtype, D, backward)
    out = []
    for t in (q, k, v, *more):
        if t.dtype != q.dtype:
            raise TypeError(f"mixed dtypes {q.dtype} and {t.dtype}")
        t = t.contiguous()
        if t.data_ptr() % VEC_BYTES:
            t = t.clone()
        out.append(t)
    return out


def _ints(q, k, *, causal: bool, window: Optional[int], q_offset: int):
    """The launchers' integer arguments; the kernels mask keys at or beyond
    their ``true_k`` argument, which is ``Sk`` since nothing is padded."""
    B, Sq, H, D = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    return (B, H, Kv, Sq, Sk, D, _DTYPE_CODE[q.dtype], int(causal),
            0 if window is None else int(window), int(q_offset), Sk)


def _entry(direction: str, kernel: str, q: torch.Tensor):
    """The library's C function for ``direction`` ("fwd" or "bwd") on
    route ``kernel``, for CUDA tensors only."""
    if kernel not in ROUTES:
        raise ValueError(f"flash kernel route must be one of {ROUTES}, "
                         f"got {kernel!r}")
    if not q.is_cuda:
        raise ValueError("the flash kernels launch on CUDA tensors")
    name = f"flash_attention_{direction}" + ("_tc" if kernel == "tc" else "")
    return name, getattr(library(), name)


def launch_fwd(q, k, v, *, kernel: str, causal: bool = True,
               window: Optional[int] = None, q_offset: int = 0):
    """Launch forward ``kernel`` (a route) on CUDA tensors, counting
    nothing: :func:`flash_fwd` counts, and ``chip_smoke.py`` times the FMA
    kernel on bfloat16 through this beside the tensor-core one."""
    q, k, v = _inputs(q, k, v)
    name, fn = _entry("fwd", kernel, q)
    ints = _ints(q, k, causal=causal, window=window, q_offset=q_offset)
    B, Sq, H, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              lse.data_ptr(), *ints, build.stream(q.device))
    build.check(code, name)
    return o, lse


def launch_bwd(q, k, v, o, lse, do, *, kernel: str, causal: bool = True,
               window: Optional[int] = None, q_offset: int = 0):
    """Launch backward ``kernel`` (a route) on CUDA tensors, counting
    nothing (see :func:`launch_fwd`)."""
    q, k, v, o, do = _inputs(q, k, v, o, do, backward=True)
    name, fn = _entry("bwd", kernel, q)
    ints = _ints(q, k, causal=causal, window=window, q_offset=q_offset)
    if lse.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"lse must be [B,H,Sq], got {tuple(lse.shape)}")
    lse = lse.float().contiguous()
    delta = torch.empty_like(lse)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *ints, build.stream(q.device))
    build.check(code, name)
    return dq, dk, dv


def _count(fn, kernel: str, D: int) -> None:
    """One launch of wrapper ``fn`` on route ``kernel``; head dim 256
    apart."""
    if D == 256:
        fn.launches_d256 += 1
        fn.by_route_d256[kernel] += 1
    else:
        fn.launches += 1
        fn.by_route[kernel] += 1


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0,
              mode=KernelMode.AUTO) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B,Sq,H,D], k/v [B,Sk,Kv,D] -> (o [B,Sq,H,D] in q.dtype, row
    log-sum-exp [B,H,Sq] float32); see ``ref.attention_fwd_ref``."""
    if not use_kernel(mode, q, k, v):
        return ref.attention_fwd_ref(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    kernel = route(q.dtype, q.shape[-1])
    out = launch_fwd(q, k, v, kernel=kernel, causal=causal, window=window,
                     q_offset=q_offset)
    _count(flash_fwd, kernel, q.shape[3])
    return out


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, mode=KernelMode.AUTO
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) for the output cotangent ``do``, recomputing the
    probabilities from ``lse``; see ``ref.attention_bwd_ref``."""
    if not use_kernel(mode, q, k, v, o, lse, do):
        return ref.attention_bwd_ref(q, k, v, do, causal=causal,
                                     window=window, q_offset=q_offset)
    kernel = route(q.dtype, q.shape[-1], backward=True)
    out = launch_bwd(q, k, v, o, lse, do, kernel=kernel, causal=causal,
                     window=window, q_offset=q_offset)
    _count(flash_bwd, kernel, q.shape[3])
    return out


KERNELS = (flash_fwd, flash_bwd)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = fn.launches_d256 = 0
        fn.by_route = dict.fromkeys(ROUTES, 0)
        fn.by_route_d256 = dict.fromkeys(ROUTES, 0)


def launch_counts() -> dict:
    """Totals per wrapper without head dim 256 (``flash_fwd``,
    ``flash_bwd``), their split by route (``flash_fwd_tc``,
    ``flash_fwd_fma``, ...), and the same at head dim 256
    (``flash_fwd_d256``, ``flash_bwd_d256``, ``flash_bwd_d256_tc``, ...)."""
    out = {}
    for fn in KERNELS:
        name = fn.__name__
        out[name] = fn.launches
        out.update({f"{name}_{r}": n for r, n in fn.by_route.items()})
        out[f"{name}_d256"] = fn.launches_d256
        out.update({f"{name}_d256_{r}": n
                    for r, n in fn.by_route_d256.items()})
    return out


reset_launch_counts()
