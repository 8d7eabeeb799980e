"""Wrappers of the RG-LRU recurrence CUDA kernel (``csrc/rglru.cu``).

Three wrappers: two over the forward kernel template, one over the
backward kernel:

- ``rglru_call`` is the TPU kernel's float32 contract: a, b float32 in,
  h and h_last float32 out, from a zero state.
- ``rglru_scan`` is the model's entry: a float32, the gated input u in
  its own type (bfloat16 or float32), an optional initial state h0 folded
  into the first step inside the kernel, h written in u's type and h_last
  in float32.  It equals ``rglru_call`` on the folded float32 input
  followed by ``h.to(u.dtype)``, bit for bit, in one launch.  With
  ``save_carries`` it also returns each tile's incoming float32 carry
  ([B, ceil(S / 16), L], a sixteenth of h), which the backward needs.
- ``rglru_scan_bwd`` is its gradient (``rglru_bwd_kernel``): du in u's
  type, da and dh0 in float32, from the saved carries and the cotangents
  of h and h_last.  The sequence is cut into chunks of
  ``BWD_CHUNK_TILES`` tiles (:func:`bwd_chunks`), one block each per group
  of 32 channels; a chunk hands its carry to the one before it through a
  64-bit word tagged with the call's epoch, in a buffer kept per stream
  and zeroed once, when it is made.  The epoch is the host's, passed with
  each launch, so the backward refuses to be captured in a CUDA graph:
  every replay would reuse one epoch.

Each takes the plain version in ``ref.py`` for CPU tensors (or under
``KernelMode.TORCH``) and launches the kernel for CUDA tensors; under
``KernelMode.CUDA`` a CPU tensor raises.  There is no fallback from the
kernel to the plain version: a kernel that does not build, does not take
the inputs or does not launch raises.  The library is built on first
launch (``kernels/build.py``), never at import.

Each wrapper's ``launches`` counts the calls that launched the kernel
(plain-version calls do not count); ``launch_counts()["rglru"]`` is the
forward's launches (``rglru_call`` and ``rglru_scan``),
``launch_counts()["rglru_bwd"]`` the backward's.

TPU kernel replaced: ``rglru_call`` (``_rglru_kernel``) of
``repro/kernels/rglru/kernel.py``; its ``chunk`` and ``block_l`` tiled the
TPU's VMEM and have no counterpart here.  The source note of the ``.cu``
file says what bounds it on the card and how the design answers it.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Optional, Tuple

import torch

from repro_torch.fabric.interface import KernelMode, use_kernel
from repro_torch.kernels import build
from repro_torch.kernels.rglru import ref

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "rglru.cu",)
LIB_NAME = "rglru"
TILE_STEPS = 16          # kSteps of csrc/rglru.cu
BWD_CHUNK_TILES = 16     # kBwdChunkTiles: 8 warps a block, 2 tiles a warp
_SLOTS: dict = {}        # (device, stream) -> [slots, calls]

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    fresh = LIB_NAME not in build.load_count
    lib = build.load_library(LIB_NAME, SOURCES)
    if fresh:
        lib.rglru_fwd.argtypes = [_P] * 4 + [_I] * 3 + [_P]
        lib.rglru_scan.argtypes = [_P] * 6 + [_I] * 4 + [_P]
        lib.rglru_scan_bwd.argtypes = ([_P] * 10 + [ctypes.c_uint]
                                       + [_I] * 4 + [_P])
        lib.rglru_tile_steps.argtypes = []
        lib.rglru_bwd_chunk_tiles.argtypes = []
        for fn in (lib.rglru_fwd, lib.rglru_scan, lib.rglru_scan_bwd,
                   lib.rglru_tile_steps, lib.rglru_bwd_chunk_tiles):
            fn.restype = _I
    return lib


def tile_steps() -> int:
    """Steps a tile of the kernel (``kSteps`` of ``csrc/rglru.cu``)."""
    return library().rglru_tile_steps()


def bwd_chunks(S: int) -> list:
    """The backward's chunks as step ranges [lo, hi), from the last one,
    the order in which the carry passes: each starts at a tile edge and
    holds ``BWD_CHUNK_TILES`` tiles of ``TILE_STEPS`` steps (the one at the
    end of the sequence, listed first, may hold fewer steps)."""
    n_tiles = -(-S // TILE_STEPS)
    step = BWD_CHUNK_TILES * TILE_STEPS
    return [(lo, min(lo + step, S))
            for lo in reversed(range(0, n_tiles * TILE_STEPS, step))]


def _slots(dev: torch.device, n: int):
    """The carry words of PyTorch's stream on ``dev`` (at least ``n``,
    zeroed when made) and this call's epoch, never 0."""
    key = (dev.index, build.stream(dev))
    got = _SLOTS.get(key)
    if got is None or got[0].numel() < n:
        got = [torch.zeros((max(n, 1),), dtype=torch.int64, device=dev),
               0 if got is None else got[1]]
        _SLOTS[key] = got
    got[1] += 1
    return got[0], (got[1] - 1) % 0xFFFFFFFF + 1


def rglru_call(a: torch.Tensor, b: torch.Tensor, *,
               mode=KernelMode.AUTO) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: [B, S, L] float32.  Returns (h [B, S, L], h_last [B, L]),
    float32, with ``h_t = a_t * h_{t-1} + b_t`` from a zero state; see
    ``ref.rglru_call_ref``."""
    if not use_kernel(mode, a, b):
        return ref.rglru_call_ref(a, b)
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"a and b must both be [B,S,L]; got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"RG-LRU kernel takes float32, got {a.dtype} and "
                        f"{b.dtype}")
    Bsz, S, L = a.shape
    a, b = a.contiguous(), b.contiguous()
    h = torch.empty_like(a)
    h_last = torch.empty((Bsz, L), dtype=torch.float32, device=a.device)
    code = library().rglru_fwd(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                               h_last.data_ptr(), Bsz, S, L,
                               build.stream(a.device))
    build.check(code, "rglru_fwd")
    rglru_call.launches += 1
    return h, h_last


def _check_scan(u, a, h0):
    if a.dim() != 3 or a.shape != u.shape:
        raise ValueError(f"u and a must both be [B,S,L]; got "
                         f"{tuple(u.shape)} and {tuple(a.shape)}")
    if a.dtype != torch.float32 or u.dtype not in (torch.float32,
                                                   torch.bfloat16):
        raise TypeError(f"RG-LRU kernel takes float32 a and bfloat16 or "
                        f"float32 u, got {a.dtype} and {u.dtype}")
    Bsz, _, L = u.shape
    if h0 is not None and tuple(h0.shape) != (Bsz, L):
        raise ValueError(f"h0 must be [B, L] = {(Bsz, L)}; got "
                         f"{tuple(h0.shape)}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def rglru_scan(u: torch.Tensor, a: torch.Tensor,
               h0: Optional[torch.Tensor] = None, *, mode=KernelMode.AUTO,
               save_carries: bool = False):
    """u: [B, S, L] bfloat16 or float32 gated inputs; a: [B, S, L] float32
    decays; ``h0`` [B, L] or None.  Returns (h [B, S, L] in u.dtype,
    h_last [B, L] float32), with ``h0`` folded in as ``b_0 = a_0 * h0 +
    u_0``; see ``ref.rglru_call_ref``.  With ``save_carries`` a third
    value: the kernel's float32 carry into each tile of ``tile_steps()``
    steps, [B, ceil(S / tile_steps()), L] (None on the plain version)."""
    if not use_kernel(mode, *((u, a) if h0 is None else (u, a, h0))):
        h, h_last = ref.rglru_call_ref(a.float(), u.float(), h0)
        out = (h.to(u.dtype), h_last)
        return out + (None,) if save_carries else out
    _check_scan(u, a, h0)
    Bsz, S, L = u.shape
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    u, a = u.contiguous(), a.contiguous()
    h = torch.empty_like(u)
    h_last = torch.empty((Bsz, L), dtype=torch.float32, device=u.device)
    lib = library()
    carries = None
    if save_carries:
        n_tiles = -(-S // lib.rglru_tile_steps())
        carries = torch.empty((Bsz, n_tiles, L), dtype=torch.float32,
                              device=u.device)
    code = lib.rglru_scan(a.data_ptr(), u.data_ptr(), _ptr(h0),
                          h.data_ptr(), h_last.data_ptr(), _ptr(carries),
                          Bsz, S, L, int(u.dtype == torch.bfloat16),
                          build.stream(u.device))
    build.check(code, "rglru_scan")
    rglru_scan.launches += 1
    return (h, h_last, carries) if save_carries else (h, h_last)


def rglru_scan_bwd(u: torch.Tensor, a: torch.Tensor,
                   h0: Optional[torch.Tensor], dh: torch.Tensor,
                   dh_last: Optional[torch.Tensor] = None,
                   carries: Optional[torch.Tensor] = None, *,
                   mode=KernelMode.AUTO
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor]]:
    """The gradient of :func:`rglru_scan` for the cotangents ``dh`` (in
    u's type) and ``dh_last`` (float32, or None): (du in u's type, da
    float32, dh0 float32 or None without ``h0``); see
    ``ref.rglru_bwd_ref``.  The kernel recomputes h within each tile from
    ``carries``, the forward's (``rglru_scan(..., save_carries=True)``),
    so its h is the forward's float32 h.  Not to be captured in a CUDA
    graph (see above): it raises while the current stream captures."""
    tensors = (u, a, dh) + tuple(t for t in (h0, dh_last) if t is not None)
    if not use_kernel(mode, *tensors):
        return ref.rglru_bwd_ref(u, a, h0, dh, dh_last)
    _check_scan(u, a, h0)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("rglru_scan_bwd takes a new epoch from the host "
                           "each call, so it cannot be captured in a CUDA "
                           "graph")
    Bsz, S, L = u.shape
    lib = library()
    n_tiles = -(-S // lib.rglru_tile_steps())
    if carries is None or tuple(carries.shape) != (Bsz, n_tiles, L) \
            or carries.dtype != torch.float32:
        raise ValueError(f"the RG-LRU backward needs the forward's float32 "
                         f"carries [B, {n_tiles}, L]")
    if dh.shape != u.shape or dh.dtype != u.dtype:
        raise TypeError(f"dh must be u's shape and type {u.dtype}, got "
                        f"{tuple(dh.shape)} {dh.dtype}")
    if dh_last is not None and (tuple(dh_last.shape) != (Bsz, L)
                                or dh_last.dtype != torch.float32):
        raise TypeError("dh_last must be float32 [B, L]")
    u, a, dh, carries = (t.contiguous() for t in (u, a, dh, carries))
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    if dh_last is not None:
        dh_last = dh_last.contiguous()
    du = torch.empty_like(u)
    da = torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    n_chunks = -(-n_tiles // lib.rglru_bwd_chunk_tiles())
    slots, epoch = _slots(u.device, n_chunks * Bsz * -(-L // 32) * 32)
    code = lib.rglru_scan_bwd(
        a.data_ptr(), u.data_ptr(), _ptr(h0), dh.data_ptr(), _ptr(dh_last),
        carries.data_ptr(), du.data_ptr(), da.data_ptr(), _ptr(dh0),
        slots.data_ptr(), epoch, Bsz, S, L, int(u.dtype == torch.bfloat16),
        build.stream(u.device))
    build.check(code, "rglru_scan_bwd")
    rglru_scan_bwd.launches += 1
    return du, da, dh0


KERNELS = (rglru_call, rglru_scan, rglru_scan_bwd)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {"rglru": rglru_call.launches + rglru_scan.launches,
            "rglru_bwd": rglru_scan_bwd.launches}


reset_launch_counts()
