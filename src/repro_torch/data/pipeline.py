"""Deterministic synthetic token batches (the numpy-only part of the JAX
package's ``data/pipeline.py``, copied so that the port imports nothing of
that package): every batch is a pure function of (seed, step, shard), so
the port and the JAX package train on the same tokens.  The prefetching
``DataPipeline`` is not ported.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _mix(x: np.ndarray) -> np.ndarray:
    """64-bit splitmix-style mixer (deterministic across hosts/platforms).
    Multiplication wraps mod 2^64 by design."""
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def synthetic_batch(seed: int, step: int, shard: int, n_shards: int,
                    global_batch: int, seq_len: int, vocab: int,
                    kind: str = "train") -> Dict[str, np.ndarray]:
    """One shard of one step's global batch, deterministically.

    Rows [shard * B/n .. (shard+1) * B/n) of the global batch. Labels are the
    next-token shift of the token stream (LM objective).
    """
    assert global_batch % n_shards == 0
    rows = global_batch // n_shards
    row0 = shard * rows

    # Per-(step, row) stream seeds; per-position mixing.
    r = np.arange(rows, dtype=np.uint64)[:, None] + np.uint64(row0)
    t = np.arange(seq_len + 1, dtype=np.uint64)[None, :]
    with np.errstate(over="ignore"):
        base = _mix(np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
                    + np.uint64(step) * np.uint64(0xD1B54A32D192ED03))
        raw = _mix(base + r * np.uint64(0x2545F4914F6CDD1D) + t)

    # Skewed marginal: square a uniform in [0,1) -> low ids more frequent,
    # plus a copy-previous dependency so context carries signal.
    u = (raw >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    ids = (u * u * vocab).astype(np.int64)
    copy_mask = (raw & np.uint64(7)) == 0          # 1/8 tokens repeat prior
    ids[:, 1:] = np.where(copy_mask[:, 1:], ids[:, :-1], ids[:, 1:])
    ids = ids.astype(np.int32)

    out = {"tokens": ids[:, :seq_len]}
    if kind == "train":
        out["labels"] = ids[:, 1:seq_len + 1]
    return out
