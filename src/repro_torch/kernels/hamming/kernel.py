"""Wrappers of the Hamming and multiplier CUDA kernels (``csrc/hamming.cu``).

Each wrapper takes a 1-D int32 word stream (32-bit patterns).  It takes the
plain version in ``ref.py`` for CPU tensors (or under ``KernelMode.TORCH``)
and launches its kernel for CUDA tensors; under ``KernelMode.CUDA`` a CPU
tensor raises.  There is no fallback from the kernel to the plain version:
a kernel that does not build or launch raises.  The library is built on
first launch (``kernels/build.py``), never at import.

Each wrapper carries ``launches``, a plain int that counts kernel launches
(plain-version calls and empty streams, which launch nothing, do not
count); :func:`reset_launch_counts` zeroes them.

TPU kernels replaced (``repro/kernels/hamming/kernel.py``):
``hamming_encode`` <- ``encode_call``, ``hamming_decode`` <-
``decode_call``, ``mul_const`` <- ``mul_call``; their (8, 1024) tiling of
VMEM has no counterpart here.  The source note of the ``.cu`` file says
what bounds them on the card and how the design answers it.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Tuple

import torch

from repro_torch.fabric.interface import KernelMode, use_kernel
from repro_torch.kernels import build
from repro_torch.kernels.hamming import ref

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "hamming.cu",)
LIB_NAME = "hamming"
VEC_BYTES = 16                   # the kernels move 4 words as one uint4

_P = ctypes.c_void_p
_L = ctypes.c_longlong


def library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    fresh = LIB_NAME not in build.load_count
    lib = build.load_library(LIB_NAME, SOURCES)
    if fresh:
        lib.hamming_encode.argtypes = [_P, _P, _L, _P]
        lib.hamming_decode.argtypes = [_P, _P, _P, _L, _P]
        lib.hamming_mul.argtypes = [_P, _P, _L, ctypes.c_uint, _P]
        for fn in (lib.hamming_encode, lib.hamming_decode, lib.hamming_mul):
            fn.restype = ctypes.c_int
    return lib


def _words(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernels take it: 1-D int32, contiguous, 16-byte
    aligned."""
    if x.dim() != 1 or x.dtype != torch.int32:
        raise TypeError(f"Hamming kernels take a 1-D int32 word stream, got "
                        f"{x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    if x.data_ptr() % VEC_BYTES:
        x = x.clone()            # a view at an odd offset: fresh storage
    return x


def hamming_encode(x: torch.Tensor, *, mode=KernelMode.AUTO) -> torch.Tensor:
    """Hamming(31,26) codewords of the low 26 bits of each word; see
    ``ref.encode_ref``."""
    if not use_kernel(mode, x):
        return ref.encode_ref(x)
    x = _words(x)
    out = torch.empty_like(x)
    if x.numel():
        build.check(library().hamming_encode(
            x.data_ptr(), out.data_ptr(), x.numel(), build.stream(x.device)),
            "hamming_encode")
        hamming_encode.launches += 1
    return out


def hamming_decode(x: torch.Tensor, *, mode=KernelMode.AUTO
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(26 data bits, corrected flag) of each codeword; see
    ``ref.decode_ref``."""
    if not use_kernel(mode, x):
        return ref.decode_ref(x)
    x = _words(x)
    data, corrected = torch.empty_like(x), torch.empty_like(x)
    if x.numel():
        build.check(library().hamming_decode(
            x.data_ptr(), data.data_ptr(), corrected.data_ptr(), x.numel(),
            build.stream(x.device)), "hamming_decode")
        hamming_decode.launches += 1
    return data, corrected


def mul_const(x: torch.Tensor, constant: int, *,
              mode=KernelMode.AUTO) -> torch.Tensor:
    """``x * constant`` with 32-bit wrap, the constant taken mod 2^32; see
    ``ref.multiply_ref``."""
    if not use_kernel(mode, x):
        return ref.multiply_ref(x, constant)
    x = _words(x)
    out = torch.empty_like(x)
    if x.numel():
        build.check(library().hamming_mul(
            x.data_ptr(), out.data_ptr(), x.numel(), constant & 0xFFFFFFFF,
            build.stream(x.device)), "hamming_mul")
        mul_const.launches += 1
    return out


KERNELS = (hamming_encode, hamming_decode, mul_const)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
