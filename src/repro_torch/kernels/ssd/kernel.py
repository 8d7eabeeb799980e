"""Wrapper of the SSD chunk-scan CUDA kernel (``csrc/ssd.cu``).

``ssd_call`` takes the plain version in ``ref.py`` for CPU tensors (or
under ``KernelMode.TORCH``) and launches the kernel for CUDA tensors;
under ``KernelMode.CUDA`` a CPU tensor raises.  There is no fallback from
the kernel to the plain version: a kernel that does not build, does not
take the inputs (widths other than those instantiated, types other than
float32 and bfloat16, a chunk that does not divide the sequence) or does
not launch raises.  The library is built on first launch
(``kernels/build.py``), never at import.

``ssd_call.launches`` counts calls that launched the kernels (one a call,
though a call launches the four passes of ``csrc/ssd.cu``); plain-version
calls do not count.  The wrapper allocates the passes' scratch: C.B^T per
chunk, each chunk's own state and its incoming state.

``ssd_call_bwd`` is the gradient of ``ssd_call`` (``ref.ssd_bwd_ref`` on
the CPU): one call launches the backward's passes of ``csrc/ssd.cu`` and
counts once in ``ssd_call_bwd.launches``; it allocates their float32
scratch (the recomputed chunk states, the gradients reaching each chunk's
end, the partial dB and dC before their sum over heads in a fixed order).
``bwd_route`` says which passes take a call: bf16 at Mamba-2 780M's widths
runs the tensor-core passes, which sum dB and dC over ``HEAD_GROUP`` heads
in registers and leave ``ceil(H / HEAD_GROUP)`` partials; float32, and
bf16 at the smoke widths, the float32 FMA passes, which leave one partial
a head (``bwd_partials``).

TPU kernel replaced: ``ssd_call`` (``_ssd_kernel``) of
``repro/kernels/ssd/kernel.py``.  The source note of the ``.cu`` file
says what bounds it on the card and how the design answers it.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Optional, Tuple

import torch

from repro_torch.fabric.interface import KernelMode, use_kernel
from repro_torch.kernels import build
from repro_torch.kernels.ssd import ref

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "ssd.cu",)
LIB_NAME = "ssd"
# (P, N) instantiated: Mamba-2 780M's widths and its smoke config's
WIDTHS = ((64, 128), (16, 16))
MAX_CHUNK = 1024                              # the chunk's cum/dt in smem
TILE = 64                                     # rows of a chunk tile
HEAD_GROUP = 4          # heads a backward row-tile block sums dB, dC over
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    fresh = LIB_NAME not in build.load_count
    lib = build.load_library(LIB_NAME, SOURCES)
    if fresh:
        lib.ssd_fwd.argtypes = [_P] * 12 + [_I] * 7 + [_P]
        lib.ssd_bwd.argtypes = [_P] * 25 + [_I] * 7 + [_P]
        lib.ssd_fwd.restype = lib.ssd_bwd.restype = _I
    return lib


def _check(x, dA, dt, Bm, Cm, chunk, h0):
    if x.dim() != 4 or dA.dim() != 3 or Bm.dim() != 3:
        raise ValueError(f"x must be [B,H,S,P], dA and dt [B,H,S], B and C "
                         f"[B,S,N]; got {tuple(x.shape)}, {tuple(dA.shape)}, "
                         f"{tuple(Bm.shape)}")
    Bsz, H, S, P = x.shape
    N = Bm.shape[-1]
    if (dA.shape != (Bsz, H, S) or dt.shape != dA.shape
            or Bm.shape != (Bsz, S, N) or Cm.shape != Bm.shape):
        raise ValueError("x, dA, dt, B and C do not agree in shape")
    if (P, N) not in WIDTHS:
        raise ValueError(f"SSD kernel takes (head dim, state) in {WIDTHS}, "
                         f"got {(P, N)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"SSD kernel takes float32/bfloat16 x, got {x.dtype}")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"B and C must have x's dtype {x.dtype}, got "
                        f"{Bm.dtype} and {Cm.dtype}")
    if dA.dtype != torch.float32 or dt.dtype != torch.float32:
        raise TypeError("dA and dt must be float32")
    if not 0 < chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"sequence {S} must divide the SSD chunk {chunk} "
                         f"(at most {MAX_CHUNK})")
    if h0 is not None and (h0.shape != (Bsz, H, P, N)
                           or h0.dtype != torch.float32):
        raise ValueError(f"h0 must be float32 [B,H,P,N], got "
                         f"{tuple(h0.shape)} {h0.dtype}")


def bwd_route(dtype: torch.dtype, P: int, N: int) -> str:
    """The backward's passes for x of ``dtype`` at widths (P, N): "tc"
    (bf16 on the tensor cores, at Mamba-2 780M's widths) or "fma" (float32
    FMA on the CUDA cores: float32 inputs, and bf16 at the smoke widths)."""
    return "tc" if dtype == torch.bfloat16 and (P, N) == (64, 128) else "fma"


def bwd_partials(H: int, dtype: torch.dtype, P: int, N: int) -> int:
    """The planes of the backward's partial dB and dC: one for each group
    of ``HEAD_GROUP`` heads on the tensor-core route, one a head on the
    FMA route."""
    return -(-H // HEAD_GROUP) if bwd_route(dtype, P, N) == "tc" else H


def ssd_call(x: torch.Tensor, dA: torch.Tensor, dt: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256,
             h0: Optional[torch.Tensor] = None,
             mode=KernelMode.AUTO) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head-major SSD scan: x [B, H, S, P]; dA, dt [B, H, S] float32; Bm,
    Cm [B, S, N] in x's dtype (shared across heads); ``h0`` [B, H, P, N]
    float32 or None.  S must be a multiple of ``chunk``.  Returns (y [B, H,
    S, P] in x.dtype, h_last [B, H, P, N] float32); see
    ``ref.ssd_call_ref``."""
    tensors = (x, dA, dt, Bm, Cm) + (() if h0 is None else (h0,))
    if not use_kernel(mode, *tensors):
        return ref.ssd_call_ref(x, dA, dt, Bm, Cm, chunk, h0)
    _check(x, dA, dt, Bm, Cm, chunk, h0)
    Bsz, H, S, P = x.shape
    N = Bm.shape[-1]
    x, dA, dt, Bm, Cm = (t.contiguous() for t in (x, dA, dt, Bm, Cm))
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    h_last = torch.empty((Bsz, H, P, N), **f32)
    nc, QP = S // chunk, -(-chunk // TILE) * TILE
    cb = torch.empty((Bsz, nc, QP, QP), **f32)       # C.B^T of each chunk
    states = torch.empty((Bsz, H, nc, P, N), **f32)  # each chunk's own state
    # each chunk's incoming state: float32, or bf16 hi and lo planes
    planes = 2 if x.dtype == torch.bfloat16 else 1
    hin = torch.empty((planes, Bsz, H, nc, P, N), dtype=x.dtype,
                      device=x.device)
    dAc = torch.empty((Bsz, H, nc), **f32)           # each chunk's cum_Q
    code = library().ssd_fwd(
        x.data_ptr(), dA.data_ptr(), dt.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), cb.data_ptr(), states.data_ptr(), hin.data_ptr(),
        dAc.data_ptr(), Bsz, H, S, P, N, chunk, _DTYPE_CODE[x.dtype],
        build.stream(x.device))
    build.check(code, "ssd_fwd")
    ssd_call.launches += 1
    return y, h_last


def ssd_call_bwd(x: torch.Tensor, dA: torch.Tensor, dt: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor, *,
                 chunk: int = 256, h0: Optional[torch.Tensor] = None,
                 dh_last: Optional[torch.Tensor] = None,
                 mode=KernelMode.AUTO):
    """The gradient of :func:`ssd_call` for the cotangents ``dy`` [B, H, S,
    P] (x's type) of y and ``dh_last`` [B, H, P, N] float32 (or None) of
    h_last: (dx in x's type, ddA and ddt float32, dB and dC in B's type,
    dh0 float32, or None without ``h0``); see ``ref.ssd_bwd_ref``."""
    tensors = (x, dA, dt, Bm, Cm, dy) + tuple(
        t for t in (h0, dh_last) if t is not None)
    if not use_kernel(mode, *tensors):
        out = ref.ssd_bwd_ref(x, dA, dt, Bm, Cm, dy, chunk, h0, dh_last)
        return out[:5] + (None if h0 is None else out[5],)
    _check(x, dA, dt, Bm, Cm, chunk, h0)
    Bsz, H, S, P = x.shape
    N = Bm.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise TypeError(f"dy must be x's shape and type, got "
                        f"{tuple(dy.shape)} {dy.dtype}")
    if dh_last is not None and (dh_last.shape != (Bsz, H, P, N)
                                or dh_last.dtype != torch.float32):
        raise TypeError("dh_last must be float32 [B, H, P, N]")
    x, dA, dt, Bm, Cm, dy = (t.contiguous()
                             for t in (x, dA, dt, Bm, Cm, dy))
    h0, dh_last = (None if t is None else t.contiguous()
                   for t in (h0, dh_last))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ddA = torch.empty((Bsz, H, S), **f32)
    ddt = torch.empty((Bsz, H, S), **f32)
    dB = torch.empty_like(Bm)
    dC = torch.empty_like(Cm)
    dh0 = torch.empty((Bsz, H, P, N), **f32)
    nc, QP = S // chunk, -(-chunk // TILE) * TILE
    # hin and gend: float32, or (route "tc") two bf16 planes, hi and lo
    state = lambda: torch.empty((Bsz, H, nc, P, N), **f32)  # noqa: E731
    cb = torch.empty((Bsz, nc, QP, QP), **f32)
    states, hin, gend = state(), state(), state()
    dAc = torch.empty((Bsz, H, nc), **f32)
    h_last = torch.empty((Bsz, H, P, N), **f32)
    planes = bwd_partials(H, x.dtype, P, N)      # summed over heads after
    dBp = torch.empty((Bsz, planes, S, N), **f32)
    dCp = torch.empty((Bsz, planes, S, N), **f32)
    rows = torch.empty((3, Bsz, H, S), **f32)    # colsum, rowsum + m1, m2
    code = library().ssd_bwd(
        x.data_ptr(), dA.data_ptr(), dt.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), None if h0 is None else h0.data_ptr(), dy.data_ptr(),
        None if dh_last is None else dh_last.data_ptr(), dx.data_ptr(),
        ddA.data_ptr(), ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        dh0.data_ptr(), cb.data_ptr(), states.data_ptr(), hin.data_ptr(),
        gend.data_ptr(), dAc.data_ptr(), h_last.data_ptr(), dBp.data_ptr(),
        dCp.data_ptr(), rows[0].data_ptr(), rows[1].data_ptr(),
        rows[2].data_ptr(), Bsz, H, S, P, N, chunk, _DTYPE_CODE[x.dtype],
        build.stream(x.device))
    build.check(code, "ssd_bwd")
    ssd_call_bwd.launches += 1
    return dx, ddA, ddt, dB, dC, None if h0 is None else dh0


KERNELS = (ssd_call, ssd_call_bwd)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {"ssd": ssd_call.launches, "ssd_bwd": ssd_call_bwd.launches}


reset_launch_counts()
