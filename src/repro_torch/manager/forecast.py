"""Demand history + forecasting — the predictive half of the control loop.

Reactive policies (``Hysteresis``) act on the *current* :class:`Signals`
snapshot, so every reconfiguration lags demand by at least the grow streak.
This module gives the manager memory and a crystal ball:

- :class:`SignalsHistory` — a typed, fixed-capacity ring of per-tenant
  demand series, appended by ``Manager.tick()`` (idempotent per tick, so a
  policy holding the same history can push defensively without
  double-counting).  Tenants that depart are dropped from the ring.
- :class:`Forecaster` — the prediction seam: ``forecast(series, horizon)``
  returns a :class:`Forecast` (per-step predictions + a confidence in
  [0, 1]).  Implementations register by name, mirroring the elasticity
  policy registry, and share one signature so they stay interchangeable:

  - ``ewma``     — Holt's linear exponential smoothing (level + trend);
    the default.  Confidence decays with recent one-step error.
  - ``periodic`` — seasonal-naive: repeat the value one period ago.  Made
    for diurnal load; falls back to ``ewma`` until a full period of
    history exists.

``PredictiveSLO`` (``repro_torch.manager.slo``) consumes both: it
forecasts each tenant's demand ``horizon`` ticks out and grows *before*
predicted demand crosses the tenant's SLO-feasible capacity.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import (Any, Callable, Deque, Dict, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np

from repro_torch.manager.telemetry import Signals, TenantSignals

__all__ = [
    "Forecast", "SignalsHistory", "Forecaster", "EWMA", "Periodic",
    "get_forecaster", "register_forecaster", "forecaster_names",
    "HISTORY_FIELDS",
]

# Per-tenant series the ring records each tick.  "demand" is the one
# forecasters usually read: requests in flight or waiting (queue + slots),
# the load the tenant would put on regions if it had them.
HISTORY_FIELDS: Tuple[str, ...] = (
    "demand", "queue_depth", "active", "granted", "requested",
    "queue_wait", "admission_p99",
)


def _tenant_fields(t: TenantSignals) -> Dict[str, float]:
    return {
        "demand": float(t.queue_depth + t.active),
        "queue_depth": float(t.queue_depth),
        "active": float(t.active),
        "granted": float(t.granted),
        "requested": float(t.requested),
        "queue_wait": float(t.queue_wait),
        "admission_p99": float(t.admission_p99),
    }


class SignalsHistory:
    """Fixed-capacity ring of per-tenant demand series.

    One ``push(signals)`` per manager tick appends every admitted tenant's
    :data:`HISTORY_FIELDS` row (and forgets departed tenants).  Pushing the
    same tick twice is a no-op — the manager owns the ring but hands it to
    policies, which may push defensively when running managerless.

    >>> h = SignalsHistory(capacity=4)
    >>> h.capacity, len(h)
    (4, 0)
    """

    def __init__(self, capacity: int = 256):
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.capacity = int(capacity)
        self._ticks: Deque[int] = collections.deque(maxlen=self.capacity)
        self._series: Dict[str, Dict[str, Deque[float]]] = {}
        self._first_seen: Dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._ticks)

    @property
    def ticks(self) -> Tuple[int, ...]:
        return tuple(self._ticks)

    def tenants(self) -> List[str]:
        return sorted(self._series)

    def push(self, signals: Signals) -> bool:
        """Record one snapshot; returns False when the tick was already
        recorded (idempotent — safe to call from both manager and policy)."""
        if self._ticks and signals.tick <= self._ticks[-1]:
            return False
        self._ticks.append(int(signals.tick))
        live = {t.name for t in signals.tenants}
        for name in [n for n in self._series if n not in live]:
            del self._series[name]
            self._first_seen.pop(name, None)
        for t in signals.tenants:
            per = self._series.get(t.name)
            if per is None:
                per = {f: collections.deque(maxlen=self.capacity)
                       for f in HISTORY_FIELDS}
                self._series[t.name] = per
                self._first_seen[t.name] = int(signals.tick)
            for field, value in _tenant_fields(t).items():
                per[field].append(value)
        return True

    def length(self, tenant: str) -> int:
        """Recorded samples for one tenant (0 when unseen/departed)."""
        per = self._series.get(tenant)
        return len(per["demand"]) if per else 0

    def first_seen(self, tenant: str) -> Optional[int]:
        return self._first_seen.get(tenant)

    def series(self, tenant: str, field: str = "demand") -> np.ndarray:
        """One tenant's trajectory, oldest first (float64; empty if unseen).

        Raises ``KeyError`` for a field outside :data:`HISTORY_FIELDS`.
        """
        if field not in HISTORY_FIELDS:
            raise KeyError(
                f"unknown history field {field!r}; known: {HISTORY_FIELDS}")
        per = self._series.get(tenant)
        if per is None:
            return np.zeros((0,), dtype=np.float64)
        return np.asarray(per[field], dtype=np.float64)


# ----------------------------------------------------------------------
# forecasts + the forecaster seam
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Forecast:
    """Predicted per-step values for the next ``horizon`` ticks.

    ``values[k]`` predicts ``k + 1`` ticks ahead; ``confidence`` in [0, 1]
    weights how much a policy should trust the prediction (new tenants and
    noisy series forecast with low confidence).
    """

    values: Tuple[float, ...]
    horizon: int
    confidence: float

    def __post_init__(self):
        object.__setattr__(self, "values",
                           tuple(float(v) for v in self.values))

    @property
    def peak(self) -> float:
        """The worst predicted demand inside the horizon."""
        return max(self.values) if self.values else 0.0


class Forecaster:
    """Protocol (structural): ``name`` + ``forecast(series, horizon)``.

    ``series`` is oldest-first float64 demand; implementations must accept
    empty/short series and answer with low confidence rather than raise.
    """

    name: str = "forecaster"

    def forecast(self, series: np.ndarray, horizon: int) -> Forecast:
        raise NotImplementedError


_FORECASTERS: Dict[str, Callable[..., Forecaster]] = {}


def register_forecaster(name: str) -> Callable[[type], type]:
    """Class decorator: make a forecaster constructible by name."""
    def deco(cls: type) -> type:
        _FORECASTERS[name] = cls
        return cls
    return deco


def get_forecaster(spec: Any, **kw: Any) -> Forecaster:
    """Resolve a forecaster: instances pass through, names construct.

    >>> get_forecaster("ewma").name
    'ewma'
    >>> get_forecaster("periodic", period=12).period
    12
    """
    if isinstance(spec, str):
        try:
            return _FORECASTERS[spec](**kw)
        except KeyError:
            raise KeyError(
                f"unknown forecaster {spec!r}; known: {sorted(_FORECASTERS)}"
            ) from None
    if callable(getattr(spec, "forecast", None)):
        return spec
    raise TypeError(f"not a forecaster: {spec!r}")


def forecaster_names() -> List[str]:
    return sorted(_FORECASTERS)


@register_forecaster("ewma")
class EWMA(Forecaster):
    """Holt's linear exponential smoothing: level + trend.

    The classic double-EWMA: ``level`` tracks where demand is, ``trend``
    tracks where it is going, and the k-step prediction extrapolates
    ``level + k * trend`` (floored at 0 — demand can't go negative).
    Confidence is ``1 / (1 + normalized one-step error)``: a series the
    smoother has been predicting well forecasts near 1.0, a noisy or
    brand-new series near the floor.

    >>> import numpy as np
    >>> ramp = np.array([0., 2., 4., 6., 8.])
    >>> fc = EWMA(alpha=1.0, beta=1.0).forecast(ramp, horizon=2)
    >>> fc.values                       # pure extrapolation of the ramp
    (10.0, 12.0)
    >>> EWMA().forecast(ramp, horizon=2).confidence > 0.5
    True
    """

    name = "ewma"

    def __init__(self, alpha: float = 0.5, beta: float = 0.3):
        if not (0.0 < alpha <= 1.0 and 0.0 <= beta <= 1.0):
            raise ValueError(f"bad smoothing params alpha={alpha} beta={beta}")
        self.alpha = float(alpha)
        self.beta = float(beta)

    def forecast(self, series: np.ndarray, horizon: int) -> Forecast:
        horizon = max(1, int(horizon))
        xs = np.asarray(series, dtype=np.float64).ravel()
        if xs.size == 0:
            return Forecast(values=(0.0,) * horizon, horizon=horizon,
                            confidence=0.0)
        level = float(xs[0])
        trend = 0.0
        abs_err = 0.0          # EWMA of one-step absolute prediction error
        for x in xs[1:]:
            pred = level + trend
            abs_err = 0.5 * abs_err + 0.5 * abs(float(x) - pred)
            new_level = self.alpha * float(x) + (1 - self.alpha) * pred
            trend = (self.beta * (new_level - level)
                     + (1 - self.beta) * trend)
            level = new_level
        scale = max(1.0, float(np.mean(np.abs(xs))))
        confidence = 1.0 / (1.0 + abs_err / scale)
        if xs.size < 3:       # not enough samples to have earned trust
            confidence = min(confidence, 0.5)
        values = tuple(max(0.0, level + (k + 1) * trend)
                       for k in range(horizon))
        return Forecast(values=values, horizon=horizon,
                        confidence=float(confidence))


@register_forecaster("periodic")
class Periodic(Forecaster):
    """Seasonal-naive: predict the value one period ago.

    The right tool for diurnal load — tomorrow morning's peak looks like
    this morning's.  Needs ``period + 1`` samples to see a full season;
    until then it delegates to an inner :class:`EWMA`.  Confidence compares
    the last two seasons: a series that repeats itself forecasts near 1.0.

    >>> import numpy as np
    >>> wave = np.array([1., 5., 1., 5., 1., 5., 1.])
    >>> fc = Periodic(period=2).forecast(wave, horizon=2)
    >>> [round(v, 1) for v in fc.values]
    [5.0, 1.0]
    """

    name = "periodic"

    def __init__(self, period: int = 24, alpha: float = 0.5,
                 beta: float = 0.3):
        if period < 2:
            raise ValueError(f"period must be >= 2, got {period}")
        self.period = int(period)
        self._fallback = EWMA(alpha=alpha, beta=beta)

    def forecast(self, series: np.ndarray, horizon: int) -> Forecast:
        horizon = max(1, int(horizon))
        xs = np.asarray(series, dtype=np.float64).ravel()
        p = self.period
        if xs.size < p + 1:
            inner = self._fallback.forecast(xs, horizon)
            # Cap: a seasonal model running blind deserves less trust.
            return Forecast(values=inner.values, horizon=horizon,
                            confidence=min(inner.confidence, 0.5))
        season = xs[-p:]
        values = tuple(float(season[k % p]) for k in range(horizon))
        if xs.size >= 2 * p:
            prev_season = xs[-2 * p:-p]
            err = float(np.mean(np.abs(season - prev_season)))
            scale = max(1.0, float(np.mean(np.abs(season))))
            confidence = 1.0 / (1.0 + err / scale)
        else:
            confidence = 0.6   # one full season seen, none to check against
        return Forecast(values=values, horizon=horizon,
                        confidence=float(confidence))
