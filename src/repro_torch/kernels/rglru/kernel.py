"""Wrappers of the RG-LRU recurrence CUDA kernel (``csrc/rglru.cu``).

Two wrappers over one kernel template:

- ``rglru_call`` is the TPU kernel's float32 contract: a, b float32 in,
  h and h_last float32 out, from a zero state.
- ``rglru_scan`` is the model's entry: a float32, the gated input u in
  its own type (bfloat16 or float32), an optional initial state h0 folded
  into the first step inside the kernel, h written in u's type and h_last
  in float32.  It equals ``rglru_call`` on the folded float32 input
  followed by ``h.to(u.dtype)``, bit for bit, in one launch.

Each takes the plain version in ``ref.py`` for CPU tensors (or under
``KernelMode.TORCH``) and launches the kernel for CUDA tensors; under
``KernelMode.CUDA`` a CPU tensor raises.  There is no fallback from the
kernel to the plain version: a kernel that does not build, does not take
the inputs or does not launch raises.  The library is built on first
launch (``kernels/build.py``), never at import.

Each wrapper's ``launches`` counts the calls that launched the kernel
(plain-version calls do not count); ``launch_counts()["rglru"]`` is their
sum, the kernel's launches.

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

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    fresh = LIB_NAME not in build.load_count
    lib = build.load_library(LIB_NAME, SOURCES)
    if fresh:
        lib.rglru_fwd.argtypes = [_P] * 4 + [_I] * 3 + [_P]
        lib.rglru_scan.argtypes = [_P] * 5 + [_I] * 4 + [_P]
        lib.rglru_tile_steps.argtypes = []
        for fn in (lib.rglru_fwd, lib.rglru_scan, lib.rglru_tile_steps):
            fn.restype = _I
    return lib


def tile_steps() -> int:
    """Steps a tile of the kernel (``kSteps`` of ``csrc/rglru.cu``)."""
    return library().rglru_tile_steps()


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


def rglru_scan(u: torch.Tensor, a: torch.Tensor,
               h0: Optional[torch.Tensor] = None, *, mode=KernelMode.AUTO
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: [B, S, L] bfloat16 or float32 gated inputs; a: [B, S, L] float32
    decays; ``h0`` [B, L] or None.  Returns (h [B, S, L] in u.dtype,
    h_last [B, L] float32), with ``h0`` folded in as ``b_0 = a_0 * h0 +
    u_0``; see ``ref.rglru_call_ref``."""
    if not use_kernel(mode, *((u, a) if h0 is None else (u, a, h0))):
        h, h_last = ref.rglru_call_ref(a.float(), u.float(), h0)
        return h.to(u.dtype), h_last
    if a.dim() != 3 or a.shape != u.shape:
        raise ValueError(f"u and a must both be [B,S,L]; got "
                         f"{tuple(u.shape)} and {tuple(a.shape)}")
    if a.dtype != torch.float32 or u.dtype not in (torch.float32,
                                                   torch.bfloat16):
        raise TypeError(f"RG-LRU kernel takes float32 a and bfloat16 or "
                        f"float32 u, got {a.dtype} and {u.dtype}")
    Bsz, S, L = u.shape
    if h0 is not None:
        if tuple(h0.shape) != (Bsz, L):
            raise ValueError(f"h0 must be [B, L] = {(Bsz, L)}; got "
                             f"{tuple(h0.shape)}")
        h0 = h0.to(torch.float32).contiguous()
    u, a = u.contiguous(), a.contiguous()
    h = torch.empty_like(u)
    h_last = torch.empty((Bsz, L), dtype=torch.float32, device=u.device)
    code = library().rglru_scan(a.data_ptr(), u.data_ptr(),
                                None if h0 is None else h0.data_ptr(),
                                h.data_ptr(), h_last.data_ptr(), Bsz, S, L,
                                int(u.dtype == torch.bfloat16),
                                build.stream(u.device))
    build.check(code, "rglru_scan")
    rglru_scan.launches += 1
    return h, h_last


KERNELS = (rglru_call, rglru_scan)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {"rglru": sum(fn.launches for fn in KERNELS)}


reset_launch_counts()
