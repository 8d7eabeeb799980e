"""Kernel-mode seam: one explicit enum resolved at :class:`Fabric` construction.

Two axes of configuration stay apart: the **backend** names the crossbar
semantics (``reference`` / ``cuda`` / ``cuda_kernel``) and the **kernel
mode** names how the kernel backend's work is carried out:

==========  ==============================================================
mode        meaning
==========  ==============================================================
``AUTO``    resolve from the fabric's device: ``CUDA`` on a CUDA device,
            ``TORCH`` on the CPU.  It never probes which hardware happens
            to be present.
``TORCH``   the plain PyTorch versions of the kernels (``ref.py``), on any
            device.
``CUDA``    the hand-written kernels; raises for CPU tensors.
==========  ==============================================================

The JAX package's spellings still resolve, so configs carry across:
``"xla"``, ``"reference"``, ``"ref"``, ``"pallas_interpret"`` and
``"interpret"`` give ``TORCH``; ``"pallas"`` and ``"mosaic"`` give ``CUDA``,
and so does ``"cuda_kernel"``, the kernel backend's name (what
``launch.roofline.kernel_mode_for_target("cuda")`` returns).

>>> resolve_kernel_mode("pallas", "cpu")
Traceback (most recent call last):
    ...
ValueError: kernel mode CUDA needs a CUDA device, got cpu
>>> resolve_kernel_mode(None, "cpu") is KernelMode.TORCH
True
"""
from __future__ import annotations

import enum
from typing import Optional, Union

import torch


class KernelMode(enum.Enum):
    """How the kernel backend's plan and data plane are carried out."""

    AUTO = "auto"
    TORCH = "torch"
    CUDA = "cuda"


_ALIASES = {
    "auto": KernelMode.AUTO,
    "torch": KernelMode.TORCH,
    "cuda": KernelMode.CUDA,
    "xla": KernelMode.TORCH,
    "reference": KernelMode.TORCH,
    "ref": KernelMode.TORCH,
    "pallas": KernelMode.CUDA,
    "mosaic": KernelMode.CUDA,
    "cuda_kernel": KernelMode.CUDA,
    "pallas_interpret": KernelMode.TORCH,
    "interpret": KernelMode.TORCH,
}


def parse_kernel_mode(mode: Optional[Union[str, KernelMode]]) -> KernelMode:
    """A mode spec (enum, alias string or None) as a :class:`KernelMode`,
    ``AUTO`` left unresolved."""
    if mode is None:
        return KernelMode.AUTO
    if isinstance(mode, str):
        try:
            return _ALIASES[mode.lower()]
        except KeyError:
            raise ValueError(
                f"unknown kernel mode {mode!r}; expected one of "
                f"{sorted(_ALIASES)} or a KernelMode") from None
    if not isinstance(mode, KernelMode):
        raise TypeError(f"expected str or KernelMode, got {type(mode)!r}")
    return mode


def resolve_kernel_mode(mode: Optional[Union[str, KernelMode]],
                        device) -> KernelMode:
    """Resolve a mode spec against the device the work runs on."""
    mode = parse_kernel_mode(mode)
    dev = torch.device(device)
    if mode is KernelMode.AUTO:
        return KernelMode.CUDA if dev.type == "cuda" else KernelMode.TORCH
    if mode is KernelMode.CUDA and dev.type != "cuda":
        raise ValueError(f"kernel mode CUDA needs a CUDA device, got {dev}")
    return mode


def use_kernel(mode: Optional[Union[str, KernelMode]],
               *tensors: torch.Tensor) -> bool:
    """Kernel or plain version for one kernel call, decided by the mode and
    the tensors' device: CUDA tensors launch the kernel unless ``TORCH``
    is asked for; CPU tensors take the plain version, and raise under
    ``CUDA``."""
    if mode.__class__ is not KernelMode:
        mode = parse_kernel_mode(mode)
    device = tensors[0].device
    for t in tensors[1:]:
        if t.device != device:
            devices = sorted({str(t.device) for t in tensors})
            raise ValueError(f"tensors on several devices: {devices}")
    on_cuda = device.type == "cuda"
    if mode is KernelMode.TORCH:
        return False
    if mode is KernelMode.CUDA and not on_cuda:
        raise ValueError("KernelMode.CUDA needs CUDA tensors; got CPU tensors")
    return on_cuda
