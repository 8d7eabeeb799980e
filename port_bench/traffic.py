"""Seeded traffic, read from a cell's ``traffic`` parameters.

Each generator gives every seed the same set of sizes, in another order,
so that two seeds differ in the tokens and the order, not in the work:

- ``train_tokens``: a copy of the token stream of the port's
  ``repro_torch.data.pipeline.synthetic_batch`` (an order-3 LCG-mixed
  stream, skewed unigram marginal, 1 in 8 tokens repeating the one
  before), from which the benchmark hands the reference the batches that
  the program's ``DataPipeline`` feeds;
- ``length_blocks``: request lengths in blocks that each hold
  ``counts[i]`` requests of ``lengths[i]``, each block shuffled;
- ``prompt``: the tokens of request ``i``, a function of (seed, i).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np


def _mix(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def train_tokens(seed: int, step: int, batch: int, seq: int,
                 vocab: int) -> Dict[str, np.ndarray]:
    """Step ``step``'s batch of the seeded train stream: ``tokens`` and
    the next-token ``labels``, [batch, seq] int32."""
    r = np.arange(batch, dtype=np.uint64)[:, None]
    t = np.arange(seq + 1, dtype=np.uint64)[None, :]
    with np.errstate(over="ignore"):
        base = _mix(np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
                    + np.uint64(step) * np.uint64(0xD1B54A32D192ED03))
        raw = _mix(base + r * np.uint64(0x2545F4914F6CDD1D) + t)
    u = (raw >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    ids = (u * u * vocab).astype(np.int64)
    copy = (raw & np.uint64(7)) == 0
    ids[:, 1:] = np.where(copy[:, 1:], ids[:, :-1], ids[:, 1:])
    ids = ids.astype(np.int32)
    return {"tokens": ids[:, :seq], "labels": ids[:, 1:seq + 1]}


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), stream])


def length_blocks(seed: int, lengths: Sequence[int],
                  counts: Sequence[int]) -> Iterator[List[int]]:
    """Blocks of request lengths, ``counts[i]`` of ``lengths[i]`` in each,
    shuffled by the seed; endless."""
    block = np.repeat(np.asarray(lengths), np.asarray(counts))
    rng = _rng(seed, 1)
    while True:
        yield [int(n) for n in rng.permutation(block)]


def prompt(seed: int, index: int, length: int, vocab: int) -> np.ndarray:
    """Request ``index``'s prompt: ``length`` token ids in [0, vocab),
    int32, drawn from (seed, index) alone."""
    return _rng(seed, 1000 + index).integers(
        0, vocab, length, dtype=np.int64).astype(np.int32)

