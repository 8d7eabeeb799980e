"""The paper's three computation modules (§V-B), bit-exact.

"Three different statically implemented computation modules; the multiplier,
the hamming encoder, and the hamming decoder together with WISHBONE master and
slave interfaces."

Hamming(31,26): 26 data bits -> 31-bit codeword, parity bits at positions
1, 2, 4, 8, 16 (1-indexed), single-error-correcting. Implemented vectorised
over uint32 word arrays so the 16 KB use case (§V-C) processes 4096 words in
one shot; the CUDA-kernel version lives in ``repro_torch.kernels.hamming``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Tuple

import numpy as np

PARITY_POS: Tuple[int, ...] = (1, 2, 4, 8, 16)
DATA_POS: Tuple[int, ...] = tuple(p for p in range(1, 32) if p not in PARITY_POS)
assert len(DATA_POS) == 26

# Precomputed coverage masks over the 31-bit codeword (bit b <-> position b+1).
_COVER_MASKS = np.array(
    [sum(1 << (p - 1) for p in range(1, 32) if (p >> i) & 1) for i in range(5)],
    dtype=np.uint32)
_DATA_MASK26 = np.uint32((1 << 26) - 1)


def _popcount(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x).astype(np.uint32)


def hamming3126_encode(data: np.ndarray) -> np.ndarray:
    """Encode the low 26 bits of each uint32 word into a 31-bit codeword."""
    data = np.asarray(data, dtype=np.uint32) & _DATA_MASK26
    code = np.zeros_like(data)
    for k, pos in enumerate(DATA_POS):
        bit = (data >> np.uint32(k)) & np.uint32(1)
        code |= bit << np.uint32(pos - 1)
    # Even parity: parity bit at 2^i makes XOR over its coverage zero.
    for i, ppos in enumerate(PARITY_POS):
        par = _popcount(code & _COVER_MASKS[i]) & np.uint32(1)
        code |= par << np.uint32(ppos - 1)
    return code


def hamming3126_decode(code: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Decode 31-bit codewords; returns (data26, corrected_flag).

    Single-bit errors are corrected via the syndrome; ``corrected_flag`` is 1
    where a correction was applied (the module's error-status register input).
    """
    code = np.asarray(code, dtype=np.uint32) & np.uint32((1 << 31) - 1)
    syndrome = np.zeros_like(code)
    for i in range(5):
        s = _popcount(code & _COVER_MASKS[i]) & np.uint32(1)
        syndrome |= s << np.uint32(i)
    corrected = (syndrome != 0).astype(np.uint32)
    # Flip the erroneous bit (syndrome value = 1-indexed position).
    flip = np.where(syndrome != 0,
                    np.uint32(1) << (syndrome - np.uint32(1)),
                    np.uint32(0))
    fixed = code ^ flip
    data = np.zeros_like(code)
    for k, pos in enumerate(DATA_POS):
        bit = (fixed >> np.uint32(pos - 1)) & np.uint32(1)
        data |= bit << np.uint32(k)
    return data, corrected


def constant_multiply(data: np.ndarray, constant: int = 3) -> np.ndarray:
    """The constant-multiplier module (32-bit wraparound arithmetic)."""
    return (np.asarray(data, dtype=np.uint64) * np.uint64(constant)
            ).astype(np.uint32)


# ----------------------------------------------------------------------
# §IV-H computation-module template: input regs -> compute -> output regs,
# error status forwarded to the register file.
# ----------------------------------------------------------------------
@dataclass
class ComputationModuleSim:
    """Standard module template: registers + compute + control (§IV-H).

    ``compute_latency_cc(n_words)`` models the pipeline depth of the parallel
    computation units; all three paper modules are combinational-per-word and
    fully pipelined, so latency is ``pipeline_depth + n_words - 1`` cycles.
    """

    name: str
    fn: Callable[[np.ndarray], np.ndarray]
    pipeline_depth: int = 1
    buffer_words: int = 8            # slave-interface register depth
    error_status: int = 0
    input_regs: List[np.ndarray] = field(default_factory=list)
    output_regs: List[np.ndarray] = field(default_factory=list)

    def process(self, words: np.ndarray) -> Tuple[np.ndarray, int]:
        """Run the module on a burst; returns (output_words, compute_cycles)."""
        words = np.asarray(words, dtype=np.uint32)
        self.input_regs = [words]
        out = self.fn(words)
        self.output_regs = [out]
        cycles = self.pipeline_depth + len(words) - 1
        return out, cycles


def MultiplierModule(constant: int = 3) -> ComputationModuleSim:
    return ComputationModuleSim(
        name="multiplier", fn=lambda w: constant_multiply(w, constant),
        pipeline_depth=1)


def HammingEncoderModule() -> ComputationModuleSim:
    return ComputationModuleSim(
        name="hamming_encoder", fn=hamming3126_encode, pipeline_depth=2)


def HammingDecoderModule() -> ComputationModuleSim:
    def _decode(w: np.ndarray) -> np.ndarray:
        data, _ = hamming3126_decode(w)
        return data
    return ComputationModuleSim(
        name="hamming_decoder", fn=_decode, pipeline_depth=3)
