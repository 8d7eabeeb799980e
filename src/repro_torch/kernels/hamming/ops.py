"""Public entry points of the Hamming and multiplier kernels.

Words are uint32 on the wire (the Wishbone bus width), as in the JAX
package's ``repro/kernels/hamming/ops.py``.  PyTorch has few uint32
operations, so a stream is carried inside as int32 bit patterns (a uint32
stream is viewed, any other integer type converted) and the results are
viewed back as uint32.  A stream is 1-D of any length, 0 included; the
kernels mask their ragged tail themselves, so nothing is padded.

Each entry point chooses the kernel or the plain version from the
stream's device and the kernel mode alone, in ``kernel.py``: a CUDA tensor
takes the kernel, a CPU tensor the plain version (``ref.py``).
:func:`paper_chain` composes the three into the paper's use case.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.module import ModuleChain, module_from_layer
from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels.hamming import kernel as _k


def _as_int32(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    if x.dim() != 1:
        raise ValueError(f"a word stream is 1-D, got shape {tuple(x.shape)}")
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    return x.to(torch.int32)


def hamming_encode(data, *, mode=KernelMode.AUTO) -> torch.Tensor:
    """Encode the low 26 bits of each uint32 word into a 31-bit codeword."""
    return _k.hamming_encode(_as_int32(data), mode=mode).view(torch.uint32)


def hamming_decode(code, *, mode=KernelMode.AUTO
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode codewords; returns (data26, corrected_flag), both uint32."""
    data, corrected = _k.hamming_decode(_as_int32(code), mode=mode)
    return data.view(torch.uint32), corrected.view(torch.uint32)


def multiply_const(data, constant: int = 3, *,
                   mode=KernelMode.AUTO) -> torch.Tensor:
    """32-bit wraparound constant multiply (the paper's multiplier module);
    ``constant`` is any Python int, taken mod 2^32."""
    out = _k.mul_const(_as_int32(data), constant, mode=mode)
    return out.view(torch.uint32)


def paper_chain(constant: int = 3) -> ModuleChain:
    """The paper's use case (§V-C) as a module chain: multiplier ->
    Hamming(31,26) encoder -> decoder (which passes its data words on),
    each module one of the entry points above, without parameters; a
    word is 4 bytes of activation per token."""
    def module(name, fn):
        return module_from_layer(name, lambda gen: None,
                                 lambda params, x: fn(x), d_model=1,
                                 param_count=0, flops_per_token=1.0,
                                 dtype_bytes=4)
    return ModuleChain([
        module("multiplier", lambda x: multiply_const(x, constant)),
        module("hamming_encoder", hamming_encode),
        module("hamming_decoder", lambda x: hamming_decode(x)[0]),
    ])
