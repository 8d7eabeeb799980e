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
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    fresh = LIB_NAME not in build.load_count
    lib = build.load_library(LIB_NAME, SOURCES)
    if fresh:
        lib.ssd_fwd.argtypes = [_P] * 12 + [_I] * 7 + [_P]
        lib.ssd_fwd.restype = _I
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


KERNELS = (ssd_call,)


def reset_launch_counts() -> None:
    ssd_call.launches = 0


def launch_counts() -> dict:
    return {"ssd": ssd_call.launches}


reset_launch_counts()
