"""Plain PyTorch versions of the Hamming and multiplier kernels, and the
numpy oracles.

``encode_ref``, ``decode_ref`` and ``multiply_ref`` take and return int32
tensors holding 32-bit word patterns: the CPU path of every wrapper in
``kernel.py``, and the reference the kernels are held against on the card
(bit-equal).  They build each codeword bit by bit, as the TPU kernel did,
and fold parity by xor-halving (PyTorch has no popcount).  ``>>`` on int32
is arithmetic, so a word is masked to 26 (encode) or 31 (decode) bits
before its first shift, where the reference masks it too.

``encode_np``, ``decode_np`` and ``multiply_np`` are the bit-exact numpy
oracles of the cycle-level hardware model (``core/hw/modules.py``), on
uint32 arrays.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.hw.modules import (DATA_POS, PARITY_POS,
                                         constant_multiply,
                                         hamming3126_decode,
                                         hamming3126_encode)

COVER_MASKS = tuple(
    sum(1 << (p - 1) for p in range(1, 32) if (p >> i) & 1) for i in range(5))
DATA_MASK26 = (1 << 26) - 1
CODE_MASK31 = (1 << 31) - 1


def _parity(x: torch.Tensor) -> torch.Tensor:
    """Even-parity bit of each nonnegative int32 word (xor-halving)."""
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def encode_ref(data: torch.Tensor) -> torch.Tensor:
    """Encode the low 26 bits of each word into a 31-bit codeword."""
    data = data & DATA_MASK26
    code = torch.zeros_like(data)
    for k, pos in enumerate(DATA_POS):
        code = code | (((data >> k) & 1) << (pos - 1))
    for i, ppos in enumerate(PARITY_POS):
        code = code | (_parity(code & COVER_MASKS[i]) << (ppos - 1))
    return code


def decode_ref(code: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode 31-bit codewords: (26 data bits, 1 where a bit was
    corrected).  A double-bit error is miscorrected as the reference
    miscorrects it."""
    code = code & CODE_MASK31
    syndrome = torch.zeros_like(code)
    for i in range(5):
        syndrome = syndrome | (_parity(code & COVER_MASKS[i]) << i)
    flip = torch.where(syndrome != 0,
                       torch.ones_like(code) << (syndrome.clamp(min=1) - 1),
                       0)
    fixed = code ^ flip
    data = torch.zeros_like(code)
    for k, pos in enumerate(DATA_POS):
        data = data | (((fixed >> (pos - 1)) & 1) << k)
    return data, (syndrome != 0).to(torch.int32)


def multiply_ref(data: torch.Tensor, constant: int = 3) -> torch.Tensor:
    """``data * constant`` with 32-bit wrap, the constant taken mod 2^32;
    the product is formed in int64, so nothing overflows."""
    prod = (data.to(torch.int64) * (constant & 0xFFFFFFFF)) & 0xFFFFFFFF
    return torch.where(prod >= 1 << 31, prod - (1 << 32), prod).to(torch.int32)


def encode_np(data: np.ndarray) -> np.ndarray:
    return hamming3126_encode(np.asarray(data, dtype=np.uint32))


def decode_np(code: np.ndarray):
    return hamming3126_decode(np.asarray(code, dtype=np.uint32))


def multiply_np(data: np.ndarray, constant: int = 3) -> np.ndarray:
    return constant_multiply(np.asarray(data, dtype=np.uint32), constant)
