"""``repro_torch.stats`` — the one percentile implementation.

``serve/harness.py`` (tick/admission p50/p99) and
``manager/telemetry.py`` (per-app admission percentiles the SLO policies
gate on) both call here: SLO math and reports must agree bit-for-bit — a
budget checked against one interpolation and reported under another would
make violations unreproducible.  Numpy only, like the JAX package's
``repro.stats``, whose numbers it gives.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np

__all__ = ["percentile", "percentiles"]


def percentile(xs: Iterable[float], q: float) -> float:
    """Linear-interpolated percentile (``numpy`` convention), 0.0 when
    ``xs`` is empty.  ``q`` is in [0, 100]."""
    arr = np.asarray(list(xs) if not isinstance(xs, np.ndarray) else xs,
                     dtype=np.float64)
    if arr.size == 0:
        return 0.0
    return float(np.percentile(arr, q))


def percentiles(xs: Iterable[float],
                qs: Sequence[float]) -> Tuple[float, ...]:
    """Several quantiles over one pass; 0.0s when ``xs`` is empty."""
    arr = np.asarray(list(xs) if not isinstance(xs, np.ndarray) else xs,
                     dtype=np.float64)
    if arr.size == 0:
        return tuple(0.0 for _ in qs)
    return tuple(float(v) for v in np.percentile(arr, list(qs)))
