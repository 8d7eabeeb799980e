"""Deterministic synthetic token pipeline with a prefetching host feed (the
JAX package's ``data/pipeline.py``, copied so that the port imports nothing
of that package).

Every batch is a pure function of (seed, step, shard), so

- any host can regenerate any shard of any step: restart and elastic
  resize need no data checkpointing beyond the step counter, and the port
  and the JAX package train on the same tokens;
- shard re-balancing after a topology change is a pure re-indexing;
- a background prefetch thread keeps ``depth`` batches ahead of the step
  loop, so host-side generation overlaps device compute.  The thread makes
  numpy arrays only; the train loop moves each batch to the device.

The token stream is an order-3 LCG-mixed stream with a skewed unigram
marginal, giving the LM a learnable (non-uniform) distribution.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineState:
    """Checkpointable pipeline position."""
    seed: int
    step: int


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


class DataPipeline:
    """Host-sharded, prefetching iterator over synthetic batches."""

    def __init__(self, *, seed: int, global_batch: int, seq_len: int,
                 vocab: int, shard: int = 0, n_shards: int = 1,
                 kind: str = "train", prefetch_depth: int = 2,
                 start_step: int = 0):
        self.seed = seed
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.vocab = vocab
        self.shard = shard
        self.n_shards = n_shards
        self.kind = kind
        self.depth = prefetch_depth
        self._step = start_step
        self._q: "queue.Queue[Tuple[int, Dict[str, np.ndarray]]]" = \
            queue.Queue(maxsize=max(1, prefetch_depth))
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------------
    def state(self) -> PipelineState:
        return PipelineState(seed=self.seed, step=self._step)

    def restore(self, st: PipelineState) -> None:
        self.stop()
        self.seed, self._step = st.seed, st.step

    def rebalance(self, shard: int, n_shards: int) -> None:
        """Elastic resize / straggler reassignment: new shard coordinates,
        same deterministic stream (no data loss/duplication within a step)."""
        assert self.global_batch % n_shards == 0
        self.stop()
        self.shard, self.n_shards = shard, n_shards

    # ------------------------------------------------------------------
    def _make(self, step: int) -> Dict[str, np.ndarray]:
        return synthetic_batch(self.seed, step, self.shard, self.n_shards,
                               self.global_batch, self.seq_len, self.vocab,
                               self.kind)

    def _worker(self, from_step: int) -> None:
        step = from_step
        while not self._stop.is_set():
            batch = self._make(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._worker, args=(self._step,), daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        # Join before draining: a worker blocked in ``put`` may still land
        # one batch after a drain, which the next ``start`` would read as
        # its first (the JAX package drains first).
        self._thread.join(timeout=5)
        while not self._q.empty():
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread = None

    # ------------------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._thread is None:
            batch = self._make(self._step)     # synchronous fallback
            self._step += 1
            return batch
        step, batch = self._q.get()
        assert step == self._step, f"pipeline desync: {step} != {self._step}"
        self._step += 1
        return batch
