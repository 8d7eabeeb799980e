"""Wrapper of the RG-LRU recurrence CUDA kernel (``csrc/rglru.cu``).

``rglru_call`` takes the plain version in ``ref.py`` for CPU tensors (or
under ``KernelMode.TORCH``) and launches the kernel for CUDA tensors;
under ``KernelMode.CUDA`` a CPU tensor raises.  There is no fallback from
the kernel to the plain version: a kernel that does not build, does not
take the inputs (types other than float32) or does not launch raises.
The library is built on first launch (``kernels/build.py``), never at
import.

``rglru_call.launches`` counts calls that launched the kernel;
plain-version calls do not count.

TPU kernel replaced: ``rglru_call`` (``_rglru_kernel``) of
``repro/kernels/rglru/kernel.py``; its ``chunk`` and ``block_l`` tiled the
TPU's VMEM and have no counterpart here.  The source note of the ``.cu``
file says what bounds it on the card and how the design answers it.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Tuple

import torch

from repro_torch.fabric.interface import KernelMode, use_kernel
from repro_torch.kernels import build
from repro_torch.kernels.rglru import ref

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "rglru.cu",)
LIB_NAME = "rglru"

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    fresh = LIB_NAME not in build.load_count
    lib = build.load_library(LIB_NAME, SOURCES)
    if fresh:
        lib.rglru_fwd.argtypes = [_P] * 4 + [_I] * 3 + [_P]
        lib.rglru_fwd.restype = _I
    return lib


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


KERNELS = (rglru_call,)


def reset_launch_counts() -> None:
    rglru_call.launches = 0


def launch_counts() -> dict:
    return {"rglru": rglru_call.launches}


reset_launch_counts()
