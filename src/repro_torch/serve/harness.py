"""``repro_torch.serve.harness`` — seeded high-QPS serving runs over
``ElasticServer``.

The shell/fabric stack serves overlapping streams and reconfigures
without rebuilding a kernel; this is the *load generator* that exercises the
steady-state decode fast path the way a production frontend would: thousands
of concurrent seeded streams, heavy-tailed arrivals, and mid-run
control-plane events (``Grow`` / ``Shrink`` / ``FailRegion``) landing while
decode is in flight.  It is the port of the JAX package's
``serve.harness`` and gives its tokens, digests and counts on the same
schedule, on any fabric backend and device:

- :class:`SeededEngine` — a pure host-integer LCG decode engine.  Every
  token is a deterministic function of (seed, prompt), so two runs with the
  same arrival schedule produce byte-identical completions no matter what
  the fabric/cache configuration is — the bit-identity oracle for the
  cached-vs-uncached comparison.
- :func:`front_loaded_arrivals` / :func:`heavy_tailed_arrivals` — seeded
  stream schedules.  Front-loaded fills every slot at tick 0 and measures
  pure decode ticks; heavy-tailed draws Pareto inter-arrival gaps (a few
  giant bursts, many quiet stretches — the shape real request logs have).
- :class:`ReconfigEvent` — a control-plane action pinned to a tick; the
  harness applies it between admission and decode, exactly where a live
  manager would post it.
- :class:`ServeHarness` — the loop: submit due arrivals, apply due
  reconfigurations, time ``server.step()``, classify each tick as steady
  (pure decode: nothing admitted, nothing reconfigured) or not, and fold
  everything into a :class:`ServeReport`.

Every number in the report is either a pure function of the seed (tokens,
digests, counts) or an explicitly-labelled wall-time measurement (tick
percentiles, tokens/s); ``chip_smoke.py``'s ``serve_harness`` phase holds
the former equal across cache settings, backends and devices and prints
the latter.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.stats import percentile as _pct

__all__ = [
    "SeededEngine", "StreamSpec", "ReconfigEvent", "ServeHarness",
    "ServeReport", "front_loaded_arrivals", "heavy_tailed_arrivals",
    "dump_arrivals", "load_arrivals",
]

_LCG_A = 1103515245
_LCG_C = 12345
_MASK = 0x7FFFFFFF


class SeededEngine:
    """Deterministic decode engine: host integers only, no device work.

    ``prefill`` hashes the prompt into a starting token; ``decode`` advances
    an LCG.  The produced stream is a pure function of (seed, prompt), so
    completions are byte-comparable across server/fabric configurations —
    and the per-token cost is small enough that the serving tick's *system*
    overhead (admission, routing, fabric planning) dominates, which is the
    thing the serve bench is measuring.

    Implements the full fused-engine surface (``prefill_batch``,
    ``decode_batch``) so a thousand slots advance in one vectorized call;
    ``decode_batch`` returns ``None`` states (the engine is stateless).
    """

    def __init__(self, vocab: int = 32768, seed: int = 0):
        self.vocab = int(vocab)
        self.seed = int(seed)

    def _start(self, prompt) -> int:
        p = np.asarray(prompt, np.int64)
        h = (self.seed * 2654435761 + int(p.sum()) * 31 + p.size) & _MASK
        return int(h % self.vocab)

    def prefill(self, prompt) -> Tuple[int, Any]:
        return self._start(prompt), None

    def prefill_batch(self, prompts) -> List[Tuple[int, Any]]:
        return [(self._start(p), None) for p in prompts]

    def decode(self, tok: int, state: Any) -> Tuple[int, Any]:
        return int(((tok * _LCG_A + _LCG_C) & _MASK) % self.vocab), state

    def decode_batch(self, toks, states):
        nxt = ((np.asarray(toks, np.int64) * _LCG_A + _LCG_C) & _MASK) \
            % self.vocab
        return nxt.tolist(), None               # stateless: skip writeback


@dataclasses.dataclass
class StreamSpec:
    """One scheduled stream: arrives at ``tick``, decodes ``max_new``."""

    tick: int
    app_id: int
    prompt: np.ndarray
    max_new: int


def front_loaded_arrivals(n_streams: int, *, seed: int = 0,
                          apps: Sequence[int] = (0,),
                          prompt_len: int = 8,
                          max_new: int = 32) -> List[StreamSpec]:
    """All streams arrive at tick 0 — one admission burst, then every slot
    decodes in lockstep: the schedule that maximizes pure steady-state
    decode ticks (what the cached-vs-uncached comparison times)."""
    rng = np.random.default_rng(seed)
    return [StreamSpec(tick=0, app_id=int(apps[i % len(apps)]),
                       prompt=rng.integers(0, 1 << 15, prompt_len,
                                           dtype=np.int32),
                       max_new=max_new)
            for i in range(n_streams)]


def heavy_tailed_arrivals(n_streams: int, *, seed: int = 0,
                          apps: Sequence[int] = (0,),
                          mean_gap_ticks: float = 0.25,
                          alpha: float = 1.2,
                          prompt_len: Tuple[int, int] = (4, 16),
                          max_new: Tuple[int, int] = (8, 48)
                          ) -> List[StreamSpec]:
    """Pareto inter-arrival gaps (index ``alpha``; the smaller, the heavier
    the tail): long quiet stretches punctuated by bursts that overrun the
    slot pool and back up the admission queue — the schedule that makes
    admission-latency percentiles mean something."""
    rng = np.random.default_rng(seed)
    raw = rng.pareto(alpha, n_streams)
    gaps = raw * (mean_gap_ticks / max(float(raw.mean()), 1e-9))
    ticks = np.floor(np.cumsum(gaps)).astype(np.int64)
    lens = rng.integers(prompt_len[0], prompt_len[1] + 1, n_streams)
    news = rng.integers(max_new[0], max_new[1] + 1, n_streams)
    return [StreamSpec(tick=int(ticks[i]), app_id=int(apps[i % len(apps)]),
                       prompt=rng.integers(0, 1 << 15, int(lens[i]),
                                           dtype=np.int32),
                       max_new=int(news[i]))
            for i in range(n_streams)]


@dataclasses.dataclass
class ReconfigEvent:
    """A control-plane action applied at ``tick``, before that tick's
    decode — e.g. ``ReconfigEvent(40, lambda sh: sh.fail_region(2),
    "fail R2")``.  The action receives the shell; anything it posts bumps
    the register epoch and (by design) invalidates the fabric plan cache.
    """

    tick: int
    action: Callable[[Any], Any]
    label: str = ""


@dataclasses.dataclass(frozen=True)
class ServeReport:
    """One harness run, folded to the numbers the serve bench gates on."""

    n_streams: int
    n_slots: int
    ticks: int                      # server ticks executed
    steady_ticks: int               # pure-decode ticks (no admit/reconfig)
    completions: int
    tokens: int
    reconfigs: int
    wall_s: float
    tokens_per_s: float
    tick_p50_us: float              # over every tick
    tick_p99_us: float
    steady_tick_p50_us: float       # over pure-decode ticks only
    steady_tick_p99_us: float
    admission_p50_ticks: float      # submit -> admit, over completions
    admission_p99_ticks: float
    fabric_retraces: int
    plan_cache_hits: int
    plan_cache_misses: int
    plan_cache_invalidations: int
    plan_cache_hit_rate: float
    token_digest: str               # sha256 over (rid, app, tokens) rows

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in d.items()}


def _digest(completions) -> str:
    h = hashlib.sha256()
    for c in sorted(completions, key=lambda c: c.rid):
        h.update(f"{c.rid}:{c.app_id}:{c.tokens}\n".encode())
    return h.hexdigest()


def dump_arrivals(arrivals: Sequence[StreamSpec], path) -> None:
    """Write an arrival schedule as JSONL (one stream per line) — the
    interchange format scenario traces and CI artifacts use.  Round-trips
    bit-exactly through :func:`load_arrivals`."""
    import json
    with open(path, "w") as f:
        for s in arrivals:
            f.write(json.dumps({
                "tick": int(s.tick), "app_id": int(s.app_id),
                "prompt": [int(t) for t in np.asarray(s.prompt).ravel()],
                "max_new": int(s.max_new)}) + "\n")


def load_arrivals(path) -> List[StreamSpec]:
    """Read a JSONL arrival schedule written by :func:`dump_arrivals`."""
    import json
    out: List[StreamSpec] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            out.append(StreamSpec(
                tick=int(d["tick"]), app_id=int(d["app_id"]),
                prompt=np.asarray(d["prompt"], np.int32),
                max_new=int(d["max_new"])))
    return out


class ServeHarness:
    """Drive one ``ElasticServer`` through a seeded arrival schedule with
    optional mid-run reconfigurations, timing every tick.

    The server arrives with engines registered; the harness owns the
    request schedule and the clock.  ``run()`` loops: submit every stream
    whose arrival tick has come, apply every reconfiguration pinned to
    this tick, then ``server.step()`` under a ``perf_counter`` bracket.
    A tick is *steady* when nothing was submitted, nothing was
    reconfigured, and the admission queue was empty going in — i.e. the
    tick was pure decode, the path the fabric plan cache accelerates.

    ``trackers`` (``repro_torch.manager.trackers`` sinks, instances or
    registered names) receive one flat metrics dict per executed tick via
    ``log(metrics, step)`` — the same sink protocol the manager streams to.
    """

    def __init__(self, server, arrivals: Sequence[StreamSpec], *,
                 reconfigs: Sequence[ReconfigEvent] = (),
                 max_ticks: int = 1_000_000, trackers: Sequence = ()):
        from repro_torch.manager.trackers import get_tracker
        self.server = server
        self.arrivals = sorted(arrivals, key=lambda s: s.tick)
        self.reconfigs = sorted(reconfigs, key=lambda r: r.tick)
        self.max_ticks = max_ticks
        self.trackers = [get_tracker(t) for t in trackers]

    def run(self) -> ServeReport:
        from repro_torch.shell.server import StreamRequest

        srv = self.server
        pending = list(self.arrivals)
        events = list(self.reconfigs)
        tick_us: List[float] = []
        steady_us: List[float] = []
        applied = 0
        start_completions = len(srv.completions)
        t_run = time.perf_counter()
        for _ in range(self.max_ticks):
            now = srv.tick
            submitted = 0
            while pending and pending[0].tick <= now:
                spec = pending.pop(0)
                srv.submit(StreamRequest(app_id=spec.app_id,
                                         prompt=spec.prompt,
                                         max_new=spec.max_new))
                submitted += 1
            reconfigured = 0
            while events and events[0].tick <= now:
                events.pop(0).action(srv.shell)
                reconfigured += 1
            applied += reconfigured
            if srv.idle and not pending:
                break
            steady = (submitted == 0 and reconfigured == 0
                      and srv.queued_count == 0)
            t0 = time.perf_counter()
            srv.step()
            dt = (time.perf_counter() - t0) * 1e6
            tick_us.append(dt)
            if steady:
                steady_us.append(dt)
            for tracker in self.trackers:
                tracker.log({
                    "tick_us": dt,
                    "submitted": float(submitted),
                    "reconfigured": float(reconfigured),
                    "queued": float(srv.queued_count),
                    "active": float(srv.active_count),
                    "steady": 1.0 if steady else 0.0,
                }, int(now))
            if srv._stalled and not pending and not events:
                break               # every queued app awaits a Submit event
        wall = time.perf_counter() - t_run

        comps = srv.completions[start_completions:]
        waits = [c.admitted_tick - c.submitted_tick for c in comps
                 if c.submitted_tick >= 0]
        tokens = sum(len(c.tokens) for c in comps)
        cache = getattr(srv.fabric, "plan_cache", None)
        stats = cache.stats() if cache is not None else {
            "plan_cache_hits": 0, "plan_cache_misses": 0,
            "plan_cache_invalidations": 0}
        looked = stats["plan_cache_hits"] + stats["plan_cache_misses"]
        return ServeReport(
            n_streams=len(self.arrivals), n_slots=srv.n_slots,
            ticks=len(tick_us), steady_ticks=len(steady_us),
            completions=len(comps), tokens=tokens, reconfigs=applied,
            wall_s=wall,
            tokens_per_s=tokens / wall if wall > 0 else 0.0,
            tick_p50_us=_pct(tick_us, 50), tick_p99_us=_pct(tick_us, 99),
            steady_tick_p50_us=_pct(steady_us, 50),
            steady_tick_p99_us=_pct(steady_us, 99),
            admission_p50_ticks=_pct(waits, 50),
            admission_p99_ticks=_pct(waits, 99),
            fabric_retraces=int(srv.fabric.trace_count),
            plan_cache_hits=int(stats["plan_cache_hits"]),
            plan_cache_misses=int(stats["plan_cache_misses"]),
            plan_cache_invalidations=int(
                stats["plan_cache_invalidations"]),
            plan_cache_hit_rate=(stats["plan_cache_hits"] / looked
                                 if looked else 0.0),
            token_digest=_digest(comps))
