"""Wrappers of the flash-attention CUDA kernels (``csrc/flash_attention.cu``).

``flash_fwd`` and ``flash_bwd`` take the plain versions in ``ref.py`` for
CPU tensors (or under ``KernelMode.TORCH``) and launch their kernels for
CUDA tensors; under ``KernelMode.CUDA`` a CPU tensor raises.  :func:`route`
picks the kernel by type and head dim:

- bfloat16 at head dims 64, 128 and 256: the tensor-core kernels
  (``"tc"``).  At 64 and 128 every product runs on ``wgmma`` in blocks of
  a producer warpgroup, which brings the tiles in by TMA through a ring of
  three stages under ``mbarrier``s, and two consumer warpgroups of 64 rows:
  the forward ``fwd_ws_kernel`` (128 queries x 128-key stages; at 256,
  128 queries x 64-key stages in a ring of two), and the backward's
  ``delta_kernel``, ``dkdv_ws_kernel`` (128 keys x 64-query stages) and
  ``dq_ws_kernel`` (128 queries x 64-key stages).  At 256 the backward is
  four launches on ``wgmma`` (below);
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
``dO * O``, dK/dV, dQ; four in bf16 at head dim 256: the row sums, dK/dV
partial sums per group of query heads on ``wgmma``, their sum, dQ on
``wgmma``), and ``by_route``, the same split by route; head dim 256 counts
apart, in ``launches_d256`` and its split ``by_route_d256`` of each
wrapper.

The bf16 backward at head dim 256 splits each kv head's G query heads into
``min(D256_HEAD_GROUPS, G)`` groups, so that a train step's one kv head
fills the card: one dK/dV block per (key tile of 64, group), ordered
heaviest first by :func:`dkdv_schedule` (kept on the device per shape),
each writing float32 partial sums that a second pass adds in the groups'
order.
Plain-version calls do not count.

TPU kernel replaced: ``flash_attention_hm`` (``_attn_kernel``) of
``repro/kernels/flash_attention/kernel.py``.  The source note of the
``.cu`` file says what bounds it on the card and how the design answers
it.
"""
from __future__ import annotations

import ctypes
import functools
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
# (query, key) tile of each route's forward (tc at head dim 256: 128 x 64,
# see :func:`fwd_tile`); the backward's tiles are in the source (tc: dK/dV
# 64 queries x 128 keys, dQ 128 x 64; at head dim 256 64 x 64 and 128 x 32)
TILES = {"tc": (128, 128), "fma": (64, 64)}
D256_KEY_TILE = D256_QUERY_TILE = 64   # the bf16 dK/dV blocks at head dim 256
# query-head groups of the bf16 backward at head dim 256 (of 1, 2, 4, 8 and
# 16 in trial builds, 8 was the fastest on the card: PERF.md, section 6)
D256_HEAD_GROUPS = 8
_SCHEDULES: dict = {}                  # dK/dV schedules on the device
_SCHEDULES_KEPT = 64
VEC_BYTES = 16                   # tiles are loaded as 16-byte vectors
# the TMA copies of the warp-specialised tc kernels (the forward at every
# tc head dim, the backward at 64 and 128): a box of (columns, heads, rows,
# batches), 64 x 64 bf16 values of one head
WS_HEAD_DIMS = (64, 128, 256)
WS_BWD_HEAD_DIMS = (64, 128)
TMA_BOX = (64, 1, 64, 1)
TMA_MAX_STRIDE = 1 << 40         # bytes; strides are multiples of 16 below it
TMA_MAX_DIM = 1 << 32
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
        lib.flash_attention_bwd_d256.argtypes = [_P] * 12 + [_I] * 11 + [_P]
        lib.flash_attention_bwd_d256.restype = _I
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
    return (128, 64) if kernel == "tc" and D == 256 else TILES[kernel]


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


@functools.lru_cache(maxsize=256)
def tma_geometry(shape: Tuple[int, int, int, int], itemsize: int = 2
                 ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The tensor map that the tc kernels at head dims 64 and 128 build
    over a contiguous [B, S, heads, D] tensor of ``shape`` whose elements
    take ``itemsize`` bytes (``head_map`` in the source): its dims
    innermost first, (D, heads, S, B), and the byte strides of dims 1 to 3.
    Raises ``ValueError`` where TMA cannot take them: a stride that is not
    a multiple of 16 bytes or is 2^40 or more, a dim of 2^32 or more, or a
    head dim narrower than the box.  Kept per shape, since every launch
    asks."""
    B, S, heads, D = shape
    dims = (D, heads, S, B)
    strides = (D * itemsize, heads * D * itemsize, S * heads * D * itemsize)
    if D < TMA_BOX[0] or any(d >= TMA_MAX_DIM for d in dims) or any(
            st % 16 or st >= TMA_MAX_STRIDE for st in strides):
        raise ValueError(f"TMA cannot take a {tuple(shape)} tensor of "
                         f"{itemsize}-byte elements: dims {dims}, strides "
                         f"{strides}")
    return dims, strides


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
    if kernel == "tc" and q.shape[3] in WS_HEAD_DIMS:
        for t in (q, k, v):
            tma_geometry(tuple(t.shape), t.element_size())
    ints = _ints(q, k, causal=causal, window=window, q_offset=q_offset)
    B, Sq, H, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              lse.data_ptr(), *ints, build.stream(q.device))
    build.check(code, name)
    return o, lse


def query_tile_range(Sq: int, k0: int, *, tq: int, tk: int, true_k: int,
                     causal: bool, window: Optional[int], q_offset: int
                     ) -> Tuple[int, int]:
    """Query tiles [lo, hi) of ``tq`` rows that see the key tile of ``tk``
    rows from ``k0``: the kernels' ``query_tiles``."""
    nq = -(-Sq // tq)
    k_last = min(k0 + tk, true_k) - 1
    lo, hi = 0, nq
    if causal and k0 - q_offset > 0:
        lo = (k0 - q_offset) // tq
    if window is not None:
        last_q = k_last + window - 1 - q_offset
        hi = 0 if last_q < 0 else min(nq, last_q // tq + 1)
    return lo, hi


def head_groups(G: int, n_groups: int = D256_HEAD_GROUPS) -> list:
    """The query heads [lo, hi) of each of ``min(n_groups, G)`` groups of a
    kv head's ``G`` heads, as the kernel splits them."""
    n = min(n_groups, G)
    if n < 1:
        raise ValueError(f"head groups must be positive, got {n_groups}")
    return [(i * G // n, (i + 1) * G // n) for i in range(n)]


def dkdv_schedule(Sq: int, Sk: int, G: int, n_groups: int, *,
                  causal: bool, window: Optional[int], q_offset: int) -> list:
    """The dK/dV blocks of the bf16 backward at head dim 256, in launch
    order: every (key tile of 64, head group) once, as ``kt * n_groups +
    group``, the blocks with the most (head, query tile) pairs first, ties
    by key tile and group.  ``n_groups`` is the number of groups (at most
    G); key tiles that no query sees are kept (they write zeros)."""
    groups = head_groups(G, n_groups)
    work = []
    for kt in range(-(-Sk // D256_KEY_TILE)):
        k0 = kt * D256_KEY_TILE
        lo, hi = query_tile_range(Sq, k0, tq=D256_QUERY_TILE,
                                  tk=D256_KEY_TILE, true_k=Sk, causal=causal,
                                  window=window, q_offset=q_offset)
        tiles = max(hi - lo, 0)
        for i, (h_lo, h_hi) in enumerate(groups):
            work.append((-(h_hi - h_lo) * tiles, kt, i))
    work.sort()
    return [kt * len(groups) + i for _, kt, i in work]


def _schedule(device: torch.device, *key) -> torch.Tensor:
    """:func:`dkdv_schedule` of ``key`` as an int32 tensor on ``device``,
    made once per shape and kept (at most ``_SCHEDULES_KEPT``)."""
    full = (device.index,) + key
    sched = _SCHEDULES.get(full)
    if sched is None:
        Sq, Sk, G, n_groups, causal, window, q_offset = key
        if len(_SCHEDULES) >= _SCHEDULES_KEPT:
            _SCHEDULES.clear()
        sched = torch.tensor(
            dkdv_schedule(Sq, Sk, G, n_groups, causal=causal, window=window,
                          q_offset=q_offset), dtype=torch.int32,
            device=device)
        _SCHEDULES[full] = sched
    return sched


def launch_bwd(q, k, v, o, lse, do, *, kernel: str, causal: bool = True,
               window: Optional[int] = None, q_offset: int = 0):
    """Launch backward ``kernel`` (a route) on CUDA tensors, counting
    nothing (see :func:`launch_fwd`)."""
    q, k, v, o, do = _inputs(q, k, v, o, do, backward=True)
    name, fn = _entry("bwd", kernel, q)
    if kernel == "tc" and q.shape[3] in WS_BWD_HEAD_DIMS:
        for t in (q, k, v, do):
            tma_geometry(tuple(t.shape), t.element_size())
    ints = _ints(q, k, causal=causal, window=window, q_offset=q_offset)
    if lse.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"lse must be [B,H,Sq], got {tuple(lse.shape)}")
    lse = lse.float().contiguous()
    delta = torch.empty_like(lse)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr())
    if kernel == "tc" and q.shape[3] == 256:
        name = "flash_attention_bwd_d256"
        B, Sq, H, _ = q.shape
        Sk, Kv = k.shape[1], k.shape[2]
        G = H // Kv
        n = len(head_groups(G))
        sched = _schedule(q.device, Sq, Sk, G, n, bool(causal), window,
                          int(q_offset))
        part = torch.empty((2 * n,) + tuple(k.shape), dtype=torch.float32,
                           device=q.device)
        code = library().flash_attention_bwd_d256(
            *ptrs, part.data_ptr(), sched.data_ptr(), sched.numel(), n,
            *ints[:5], *ints[7:], build.stream(q.device))
    else:
        code = fn(*ptrs, *ints, build.stream(q.device))
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
