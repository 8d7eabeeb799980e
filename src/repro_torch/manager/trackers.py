"""Pluggable metric trackers — the manager's observability sink seam.

Every control-loop component that produces per-tick metrics (``Manager``,
``ServeHarness``, the scenario harness) streams them through the same tiny
protocol::

    class Tracker(Protocol):
        def log(self, metrics: Mapping[str, float], step: int) -> None: ...

Metrics are flat ``{name: scalar}`` dicts; ``step`` is the producer's tick.
Implementations are registered by name (mirroring the elasticity-policy and
forecaster registries) so scenarios and benches can select sinks from
strings, and they compose: ``MultiTracker`` fans one stream out to several
sinks.

Built-ins:

- ``noop``      — discard everything (the default; zero overhead)
- ``in_memory`` — append ``(step, metrics)`` rows to a list (tests, benches)
- ``jsonl``     — one JSON object per line to a file (offline analysis)

Every registered tracker's ``log`` signature starts ``(metrics, step)``
so sinks stay interchangeable.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Dict, IO, List, Mapping, Optional, Tuple

__all__ = ["Tracker", "NoopTracker", "InMemoryTracker", "JsonlTracker",
           "MultiTracker", "get_tracker", "register_tracker"]


class Tracker:
    """Protocol (structural): ``log(metrics, step)``.

    Subclassing is optional — anything with a conforming ``log`` works;
    this base just documents the seam and provides a no-op ``close``.
    """

    def log(self, metrics: Mapping[str, float], step: int) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Flush/release resources; harnesses call this when a run ends."""


_TRACKERS: Dict[str, Callable[..., Tracker]] = {}


def register_tracker(name: str) -> Callable[[type], type]:
    """Class decorator: make a tracker constructible by name."""
    def deco(cls: type) -> type:
        _TRACKERS[name] = cls
        return cls
    return deco


def get_tracker(spec: Any, **kw: Any) -> Tracker:
    """Resolve a tracker: pass instances through, build registered names.

    >>> get_tracker("in_memory").__class__.__name__
    'InMemoryTracker'
    >>> t = InMemoryTracker(); get_tracker(t) is t
    True
    """
    if isinstance(spec, str):
        try:
            return _TRACKERS[spec](**kw)
        except KeyError:
            raise KeyError(
                f"unknown tracker {spec!r}; known: {sorted(_TRACKERS)}"
            ) from None
    if callable(getattr(spec, "log", None)):
        return spec
    raise TypeError(f"not a tracker: {spec!r}")


def tracker_names() -> List[str]:
    return sorted(_TRACKERS)


@register_tracker("noop")
class NoopTracker(Tracker):
    """Discard every metric (the default sink)."""

    def log(self, metrics: Mapping[str, float], step: int) -> None:
        pass


@register_tracker("in_memory")
class InMemoryTracker(Tracker):
    """Keep ``(step, metrics)`` rows in memory — tests and benches read
    ``rows`` directly, ``series(name)`` pulls one metric's trajectory."""

    def __init__(self) -> None:
        self.rows: List[Tuple[int, Dict[str, float]]] = []

    def log(self, metrics: Mapping[str, float], step: int) -> None:
        self.rows.append((int(step), dict(metrics)))

    def series(self, name: str) -> List[float]:
        return [m[name] for _, m in self.rows if name in m]


@register_tracker("jsonl")
class JsonlTracker(Tracker):
    """One ``{"step": ..., **metrics}`` JSON object per line.

    Accepts a path (opened lazily, closed by ``close``) or an open
    file-like object (borrowed — not closed)."""

    def __init__(self, path: Any = None, *, fileobj: Optional[IO[str]] = None):
        if (path is None) == (fileobj is None):
            raise ValueError("pass exactly one of path= or fileobj=")
        self._path = path
        self._f: Optional[IO[str]] = fileobj
        self._owns = fileobj is None

    def log(self, metrics: Mapping[str, float], step: int) -> None:
        if self._f is None:
            self._f = open(self._path, "w")
        row = {"step": int(step)}
        row.update({k: metrics[k] for k in sorted(metrics)})
        self._f.write(json.dumps(row) + "\n")

    def close(self) -> None:
        if self._f is not None and self._owns:
            self._f.close()
            self._f = None


class MultiTracker(Tracker):
    """Fan one metric stream out to several sinks (composition)."""

    def __init__(self, *trackers: Tracker):
        self.trackers: Tuple[Tracker, ...] = tuple(
            get_tracker(t) for t in trackers)

    def log(self, metrics: Mapping[str, float], step: int) -> None:
        for t in self.trackers:
            t.log(metrics, step)

    def close(self) -> None:
        for t in self.trackers:
            t.close()
