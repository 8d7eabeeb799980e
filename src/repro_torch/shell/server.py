"""``ElasticServer`` — continuous-batching, shell-routed elastic serving.

The seed ``ServeLoop.serve`` was wave-based: it padded a fixed batch, decoded
every request to the longest ``max_new``, and only then accepted more work.
This server replaces the wave with an **admission queue + slot rotation**:

- requests enter via ``submit`` and wait in an admission queue;
- the server keeps ``n_slots`` concurrent decode slots, each with its own
  B=1 decode state (``DecodeState.pos`` is a scalar, so slots at different
  sequence positions cannot share one batched cache);
- every ``step()`` first admits queued requests into free slots (prefill),
  then advances each active slot by one token — so new requests start
  decoding *while* earlier ones are mid-stream, and a finished slot is
  reused on the very next tick (continuous batching);
- admission is **routed through the shell**: a request's ``app_id`` must map
  to an admitted tenant, and the completion records the ingress port the
  live register file assigned (a region port, or the host port when the
  tenant's chain starts on-server).  Unknown apps stay queued until a
  ``Submit`` event lands — the control plane gates the data plane;
- admission prefills are **fused**: each ``step()`` issues one batched
  prefill call per (engine, prompt-length) group instead of replaying each
  admitted prompt token by token, then splits the batched decode state into
  per-slot B=1 states — identical per-slot decode semantics, one dispatch;
- every tick's decode traffic flows through a **shell-bound fabric**
  (``shell.fabric()``): one packet per active slot to its entry port, so
  ``port_traffic`` reads back the per-port grant counts under the *live*
  register file — reconfigurations re-route the very next tick with zero
  recompiles (inactive slots ride the ``dst = -1`` padding path).

Engines are pluggable: ``register_model`` builds a real model engine;
tests inject lightweight fakes via ``register_engine`` (anything with
``prefill(prompt) -> (tok, state)`` and ``decode(tok, state) ->
(next_tok, state)``; an optional ``prefill_batch(prompts) -> [(tok,
state), ...]`` opts into fused admission, and an optional
``decode_batch(toks, states) -> (toks, states)`` opts into fused
per-tick decode across slots — elementwise-identical to the loop).

``ServerPool`` runs several servers over one shell on one clock, and
``probe()``/``probes()`` feed ``repro_torch.manager``'s control loop.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.shell.shell import Shell


@dataclasses.dataclass
class StreamRequest:
    """One generation request in a tenant's stream."""

    app_id: int
    prompt: np.ndarray                  # [S] int32
    max_new: int = 16
    rid: int = -1                       # assigned by the server at submit
    submitted_tick: int = -1            # stamped by the server at submit


@dataclasses.dataclass
class StreamCompletion:
    rid: int
    app_id: int
    tokens: List[int]
    entry_port: int                     # shell route at admission time
    admitted_tick: int
    finished_tick: int
    submitted_tick: int = -1            # admission latency = admitted - this


class ModelEngine:
    """B=1 greedy-decode engine over a ported model.

    Prefill is one batched call per group of same-length prompts: all
    prompts admitted on a tick replay through ``decode_step`` together
    (B = number of admissions), and the batched decode state is split into
    per-slot B=1 states afterwards.  Runs on ``device`` (the card unless
    ``"cpu"`` is asked for).  ``params`` come from
    ``repro_torch.ckpt.convert.params_from_numpy``, or else are drawn from
    a ``torch.Generator`` seeded with ``seed``.
    """

    def __init__(self, cfg, *, max_len: int = 128, seed: int = 0,
                 params=None, device=None):
        from repro_torch.core.device import resolve_device
        from repro_torch.models.lm import build_model
        from repro_torch.runtime.serve import extra_decode_inputs

        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_len = max_len
        self.model = build_model(cfg, device=self.device)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = self.model.init(gen)
        self.params = params
        self._extras = extra_decode_inputs(cfg, 1, self.model.dtype,
                                           self.device)

    def _greedy(self, logits) -> List[int]:
        from repro_torch.runtime.serve import greedy_tokens
        return greedy_tokens(logits, self.cfg.vocab).tolist()

    @torch.inference_mode()
    def prefill_batch(self, prompts) -> List[Tuple[int, Any]]:
        """Batched admission prefill for same-length prompts (one call)."""
        B = len(prompts)
        S = len(prompts[0])
        assert all(len(p) == S for p in prompts), \
            "prefill_batch groups same-length prompts"
        tokens = torch.as_tensor(np.stack([np.asarray(p, np.int32)
                                           for p in prompts]),
                                 device=self.device)
        state = self.model.init_decode_state(B, self.max_len)
        for s in range(S):
            logits, state = self.model.decode_step(
                self.params, state, {"tokens": tokens[:, s:s + 1]})
        return list(zip(self._greedy(logits), state.split()))

    def prefill(self, prompt: np.ndarray) -> Tuple[int, Any]:
        """Single-prompt prefill (the B=1 case of ``prefill_batch``)."""
        return self.prefill_batch([prompt])[0]

    @torch.inference_mode()
    def decode(self, tok: int, state: Any) -> Tuple[int, Any]:
        batch = {"tokens": torch.tensor([[tok]], dtype=torch.int32,
                                        device=self.device),
                 **self._extras}
        logits, state = self.model.decode_step(self.params, state, batch)
        return self._greedy(logits)[0], state


@dataclasses.dataclass(slots=True)
class _Slot:
    # ``slots=True``: the steady-state decode loop touches every field of
    # every active slot every tick — dict-less attribute access is a
    # measurable share of the tick at thousands of slots.
    request: StreamRequest
    entry_port: int
    admitted_tick: int
    state: Any
    next_tok: int
    produced: List[int] = dataclasses.field(default_factory=list)


class ElasticServer:
    """Admission queue + ``n_slots`` rotating decode slots over a ``Shell``.

    The data plane is a shell-bound :class:`repro_torch.fabric.Fabric`
    (``fabric_backend`` selects its dispatch implementation): each tick the
    active slots' tokens are planned as packets host-port -> entry-port
    under the live register file, and the granted counts accumulate in
    ``port_traffic`` — so a ``shell.post`` that resets or re-routes a port
    is visible in the served traffic on the very next tick, without any
    kernel rebuilt (``repro_torch.kernels.build.load_count`` stays at 1,
    and ``fabric.trace_count`` stays flat).

    ``slots_per_region`` (off by default) couples admission to the control
    plane's grants: a tenant may hold at most ``max(1, placed_regions *
    slots_per_region)`` concurrent decode slots, so ``Grow``/``Shrink``
    decisions change its *service rate*, not just its routing — the
    capacity model the SLO-driven scenarios exercise.  Unset, admission is
    first-come-first-served over the free slots.
    """

    def __init__(self, shell: Shell, *, n_slots: int = 4,
                 fabric_backend: str = "reference",
                 plan_cache: bool = True,
                 slots_per_region: Optional[int] = None, device=None):
        self.shell = shell
        self.n_slots = n_slots
        self.slots_per_region = slots_per_region
        # Decode ticks between reconfigurations offer byte-identical packet
        # vectors under an unchanged register epoch, so the fabric's
        # epoch-keyed plan cache (repro_torch.fabric.cache) is on by default —
        # the steady-state fast path.  ``Shell.post`` bumps the epoch and
        # invalidates it; pass ``plan_cache=False`` to always replan.
        self.fabric = shell.fabric(backend=fabric_backend,
                                   plan_cache=plan_cache, device=device)
        self.device = self.fabric.device
        self.queue: Deque[StreamRequest] = collections.deque()
        self.slots: List[Optional[_Slot]] = [None] * n_slots
        self.completions: List[StreamCompletion] = []
        self.tick = 0
        self._engines: Dict[int, Any] = {}
        self._rid_counter = itertools.count()
        self._stalled = False
        # Steady-state route memo: the slot->port packet vector only changes
        # when slot occupancy does (admission / completion), so between those
        # events each tick reuses the same host arrays — which also keeps
        # the plan-cache key bytes identical without rebuilding them.
        self._routes_dirty = True
        self._dst = np.full(n_slots, -1, np.int32)
        self._src = np.full(n_slots, -1, np.int32)
        self._active = 0

    # ---- traffic counters (cumulative; reconfigurations re-route, they
    # never reset these — the fabric owns the tally, shared with account())
    @property
    def port_traffic(self) -> np.ndarray:
        """Per-port grant counts accumulated over every served tick."""
        return self.fabric.port_traffic

    @property
    def offered_packets(self) -> int:
        """Packets offered to the fabric (drop rate = 1 - granted/offered)."""
        return self.fabric.offered_packets

    @property
    def granted_packets(self) -> int:
        return self.fabric.granted_packets

    @property
    def masked_by_src(self) -> np.ndarray:
        """INVALID_DEST packets per originating source port (isolation
        attribution — hostile sprays debit the offender's port only)."""
        return self.fabric.masked_by_src

    @property
    def dropped_by_src(self) -> np.ndarray:
        """All non-granted offers per originating source port."""
        return self.fabric.dropped_by_src

    # ---- engines ------------------------------------------------------
    def register_model(self, app_id: int, cfg, *, max_len: int = 128,
                       seed: int = 0, params=None) -> None:
        """Build and attach a :class:`ModelEngine` for ``app_id`` from a
        model config, on the server's device::

            server.register_model(0, get_config("tinyllama_1_1b",
                                                smoke=True))"""
        self._engines[app_id] = ModelEngine(cfg, max_len=max_len, seed=seed,
                                            params=params,
                                            device=self.device)

    def register_engine(self, app_id: int, engine: Any) -> None:
        """Duck-typed engine injection: anything with ``prefill(prompt) ->
        (tok, state)`` and ``decode(tok, state) -> (tok, state)`` (an
        optional ``prefill_batch`` opts into fused admission; an optional
        ``decode_batch(toks, states)`` fuses each tick's decode pass).

        >>> import numpy as np
        >>> from repro_torch.core.elastic import Region
        >>> from repro_torch.core.module import ModuleFootprint
        >>> from repro_torch.shell import Shell
        >>> from repro_torch.shell.server import ElasticServer, StreamRequest
        >>> GB = 1 << 30
        >>> shell = Shell([Region(rid=0, n_chips=8, hbm_bytes=8 * GB)])
        >>> _ = shell.submit("chat", [ModuleFootprint(GB, 1e9, 4096)],
        ...                  app_id=0)
        >>> class CountEngine:
        ...     def prefill(self, prompt): return 100, None
        ...     def decode(self, tok, state): return tok + 1, state
        >>> server = ElasticServer(shell, n_slots=2, device="cpu")
        >>> server.register_engine(0, CountEngine())
        >>> _ = server.submit(StreamRequest(app_id=0,
        ...                                 prompt=np.zeros(4, np.int32),
        ...                                 max_new=3))
        >>> [c.tokens for c in server.run()]
        [[100, 101, 102]]
        """
        self._engines[app_id] = engine

    # ---- request path -------------------------------------------------
    def submit(self, request: StreamRequest) -> int:
        """Enqueue a request; returns its server-assigned request id."""
        if request.app_id not in self._engines:
            raise KeyError(f"no engine registered for app {request.app_id}")
        request.rid = next(self._rid_counter)
        request.submitted_tick = self.tick
        self.queue.append(request)
        return request.rid

    @property
    def active_count(self) -> int:
        # Maintained counter, not a slot scan: ``step`` reads this every
        # tick and a scan over thousands of slots would dominate the
        # steady-state tick (admit +N, completion -1, reset 0).
        return self._active

    @property
    def queued_count(self) -> int:
        return len(self.queue)

    @property
    def idle(self) -> bool:
        return self.active_count == 0 and not self.queue

    def drop_queued(self, app_id: int) -> None:
        """Remove an app's queued requests (a departed tenant takes its
        pending work with it); active slots finish their streams."""
        self.queue = collections.deque(
            r for r in self.queue if r.app_id != app_id)

    def reset(self, *, cold_cache: bool = False) -> None:
        """Return the server to an empty, tick-zero state for the next
        scenario: queue, slots, completions and the stall latch clear, and
        the shell-bound fabric's cumulative accounting resets with it —
        previously a reused server leaked the old run's ``port_traffic``
        into the next scenario's first ``Signals`` window (the fabric owns
        those counters, so clearing server state alone was not enough).
        Engines stay registered; the shell is untouched.

        ``cold_cache=True`` also drops the plan cache's memoized entries
        (not just its counters) — required for record→replay teardown,
        where the replay's ``plan_cache_hit_rate`` must be bit-identical
        to the recording: warm entries would turn the replay's first
        offers into hits the recorded run counted as misses.  The default
        stays warm so steady-state scenario *sequences* keep their decode
        fast path."""
        self.queue.clear()
        self.slots = [None] * self.n_slots
        self.completions = []
        self.tick = 0
        self._stalled = False
        self._rid_counter = itertools.count()
        self._routes_dirty = True
        self._active = 0
        self.fabric.reset_accounting(cold_cache=cold_cache)

    # ---- telemetry ----------------------------------------------------
    def probe(self):
        """A ``repro_torch.manager`` telemetry probe over this server:
        per-app queue depth / wait / active slots, the per-port grant
        counters, and the offered-vs-granted drop tally."""
        from repro_torch.manager.telemetry import ServerProbe
        return ServerProbe(self)

    # ---- the server tick ----------------------------------------------
    def _admit(self) -> int:
        """Fill free slots from the queue; shell-gated. Returns admissions.

        Prefills are fused: one ``prefill_batch`` per (engine,
        prompt-length) group of this tick's admissions, instead of one
        replay per request (engines without ``prefill_batch`` fall back to
        per-request ``prefill``)."""
        if not self.queue:
            return 0                # steady state: skip the free-slot scan
        free = [i for i, slot in enumerate(self.slots) if slot is None]
        picked: List[Tuple[int, StreamRequest, int]] = []
        blocked: List[StreamRequest] = []
        holding: Dict[int, int] = {}
        if self.slots_per_region is not None:
            for slot in self.slots:
                if slot is not None:
                    app = slot.request.app_id
                    holding[app] = holding.get(app, 0) + 1
        while free and self.queue:
            cand = self.queue.popleft()
            port = self.shell.route(cand.app_id)
            if port is None:
                # Tenant not admitted to the shell (yet): park it and try
                # the next request — the control plane gates entry.
                blocked.append(cand)
                continue
            if self.slots_per_region is not None:
                # Grant-coupled capacity: regions buy concurrency (every
                # tenant keeps one on-server slot so nobody starves).
                t = self.shell.state.tenant_by_app(cand.app_id)
                placed = t.placed_count if t is not None else 0
                limit = max(1, placed * self.slots_per_region)
                if holding.get(cand.app_id, 0) >= limit:
                    blocked.append(cand)
                    continue
                holding[cand.app_id] = holding.get(cand.app_id, 0) + 1
            picked.append((free.pop(0), cand, port))
        self.queue.extendleft(reversed(blocked))

        groups: Dict[Tuple[int, int], List[Tuple[int, StreamRequest, int]]]
        groups = {}
        for item in picked:
            _, req, _ = item
            groups.setdefault((req.app_id, len(req.prompt)),
                              []).append(item)
        for (app_id, _), items in groups.items():
            engine = self._engines[app_id]
            batch_fn = getattr(engine, "prefill_batch", None)
            if batch_fn is not None:
                results = batch_fn([req.prompt for _, req, _ in items])
            else:
                results = [engine.prefill(req.prompt)
                           for _, req, _ in items]
            for (i, req, port), (tok, state) in zip(items, results):
                self.slots[i] = _Slot(request=req, entry_port=port,
                                      admitted_tick=self.tick, state=state,
                                      next_tok=tok)
        if picked:
            self._routes_dirty = True
            self._active += len(picked)
        return len(picked)

    def _account_traffic(self) -> None:
        """Plan this tick's slot->port packets through the live fabric.

        One packet per slot; empty slots carry ``dst = -1`` (the padding
        path) so the packet array shape is static across ticks — the plan
        never changes, only register *values* steer the grants.  The
        packet vectors go in as host numpy arrays and are memoized between
        occupancy changes: the fabric's plan cache keys on their bytes
        directly, so a steady-state tick (same slots, same epoch) is a
        pure host-side lookup with no device round-trip."""
        if self._routes_dirty:
            dst = np.full(self.n_slots, -1, np.int32)
            for i, slot in enumerate(self.slots):
                if slot is not None:
                    dst[i] = slot.entry_port
            self._dst = dst
            self._src = np.full(self.n_slots, self.shell.state.host_port,
                                np.int32)
            self._routes_dirty = False
        plan = self.fabric.plan(self._dst, self._src)
        # Padding slots (dst = -1) are dropped by design; only real slots
        # count as offered load, so offered - granted is the true drop
        # tally.  The fabric owns the cumulative counters; passing the
        # source vector keys drops/masks to their originating port
        # (server traffic originates at the host bridge).
        self.fabric.account(plan, self._src)

    def step(self) -> List[StreamCompletion]:
        """One server tick: admit, then one decode token per active slot."""
        admitted = self._admit()
        # A stall means this tick had nothing to do AND nothing could enter:
        # every queued request is waiting on a control-plane event.  Slots
        # that free at the end of this tick don't count — the next tick's
        # admission pass gets first claim on them.
        self._stalled = (bool(self.queue) and admitted == 0
                         and self.active_count == 0)
        if self.active_count:
            self._account_traffic()
        finished: List[StreamCompletion] = []
        # Survivor grouping: per-app slot lists feed the fused decode pass.
        # With a single registered engine (the high-QPS serving shape) the
        # grouping collapses to one list append per slot — no dict hop.
        one_app = len(self._engines) == 1
        survivors: List[_Slot] = []
        live: Dict[int, List[_Slot]] = {}
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            slot.produced.append(slot.next_tok)
            if len(slot.produced) >= slot.request.max_new:
                comp = StreamCompletion(
                    rid=slot.request.rid, app_id=slot.request.app_id,
                    tokens=list(slot.produced), entry_port=slot.entry_port,
                    admitted_tick=slot.admitted_tick,
                    finished_tick=self.tick,
                    submitted_tick=slot.request.submitted_tick)
                self.completions.append(comp)
                finished.append(comp)
                self.slots[i] = None            # rotate: free on completion
                self._routes_dirty = True
                self._active -= 1
                continue
            if one_app:
                survivors.append(slot)
            else:
                live.setdefault(slot.request.app_id, []).append(slot)
        if one_app and survivors:
            live[survivors[0].request.app_id] = survivors
        # Decode pass: one fused ``decode_batch`` call per engine that
        # offers it (1k slots advance in one call instead of 1k), per-slot
        # ``decode`` otherwise.  ``decode_batch`` may return ``None`` for
        # the states to mean "unchanged / managed in place".
        for app_id, slots in live.items():
            engine = self._engines[app_id]
            batch_fn = getattr(engine, "decode_batch", None)
            if batch_fn is not None and len(slots) > 1:
                toks, states = batch_fn([s.next_tok for s in slots],
                                        [s.state for s in slots])
                if states is None:
                    for slot, tok in zip(slots, toks):
                        slot.next_tok = tok
                else:
                    for slot, tok, state in zip(slots, toks, states):
                        slot.next_tok, slot.state = tok, state
            else:
                for slot in slots:
                    slot.next_tok, slot.state = engine.decode(slot.next_tok,
                                                              slot.state)
        self.tick += 1
        return finished

    def run(self, *, max_ticks: int = 10_000) -> List[StreamCompletion]:
        """Step until queue and slots drain, or until admission stalls
        (every queued app unrouted — those requests wait for a control-plane
        ``Submit`` and a later ``run()``)."""
        start = len(self.completions)
        for _ in range(max_ticks):
            if self.idle:
                break
            self.step()
            if self._stalled:
                break
        return self.completions[start:]


class ServerPool:
    """Several ``ElasticServer`` frontends over one shell — the multi-server
    pool shape production scenarios run.

    One control plane, N serving processes: every server shares the pool's
    register file (so a single ``Shell.post`` re-routes all of them), but
    each owns its admission queue, decode slots, and shell-bound fabric on
    ``device`` (the card unless ``"cpu"`` is asked for).  Apps are pinned to
    a *home* server at engine registration (``app_id % n_servers`` unless
    overridden), requests route there at ``submit``, and ``step()``
    advances every server on one clock.

    Telemetry composes by construction: ``probes()`` returns one
    ``ServerProbe`` per server, and ``assemble_signals`` merges them into
    one ``Signals`` (dict channels merge per app, counters sum).  The
    signature pin is per fabric — ``fabric_traces`` reports the *max*
    over servers, which stays 1 when every fabric ran one plan signature.
    """

    def __init__(self, shell: Shell, n_servers: int, *, n_slots: int = 4,
                 fabric_backend: str = "reference", plan_cache: bool = True,
                 slots_per_region: Optional[int] = None, device=None):
        if n_servers < 1:
            raise ValueError(f"n_servers must be >= 1, got {n_servers}")
        self.shell = shell
        self.servers: List[ElasticServer] = [
            ElasticServer(shell, n_slots=n_slots,
                          fabric_backend=fabric_backend,
                          plan_cache=plan_cache,
                          slots_per_region=slots_per_region, device=device)
            for _ in range(n_servers)]
        self.device = self.servers[0].device
        self._home: Dict[int, ElasticServer] = {}

    def __len__(self) -> int:
        return len(self.servers)

    # ---- engines / routing --------------------------------------------
    def server_for(self, app_id: int) -> ElasticServer:
        """The app's home server (defaults to ``app_id % n_servers``)."""
        return self._home.get(app_id,
                              self.servers[app_id % len(self.servers)])

    def register_engine(self, app_id: int, engine: Any,
                        *, server: Optional[int] = None) -> None:
        home = self.servers[server if server is not None
                            else app_id % len(self.servers)]
        home.register_engine(app_id, engine)
        self._home[app_id] = home

    def submit(self, request: StreamRequest) -> int:
        return self.server_for(request.app_id).submit(request)

    def drop_queued(self, app_id: int) -> None:
        """Remove an app's queued requests (a departed tenant takes its
        pending work with it)."""
        self.server_for(app_id).drop_queued(app_id)

    # ---- one pool clock -----------------------------------------------
    def step(self) -> List[StreamCompletion]:
        finished: List[StreamCompletion] = []
        for srv in self.servers:
            finished.extend(srv.step())
        return finished

    def reset(self, *, cold_cache: bool = False) -> None:
        for srv in self.servers:
            srv.reset(cold_cache=cold_cache)

    # ---- aggregate views ----------------------------------------------
    @property
    def queued_count(self) -> int:
        return sum(s.queued_count for s in self.servers)

    @property
    def active_count(self) -> int:
        return sum(s.active_count for s in self.servers)

    @property
    def idle(self) -> bool:
        return all(s.idle for s in self.servers)

    @property
    def completions(self) -> List[StreamCompletion]:
        out: List[StreamCompletion] = []
        for srv in self.servers:
            out.extend(srv.completions)
        return out

    def _summed(self, name: str) -> np.ndarray:
        total = getattr(self.servers[0], name).copy()
        for srv in self.servers[1:]:
            total = total + getattr(srv, name)
        return total

    @property
    def port_traffic(self) -> np.ndarray:
        return self._summed("port_traffic")

    @property
    def offered_packets(self) -> int:
        return sum(int(s.offered_packets) for s in self.servers)

    @property
    def granted_packets(self) -> int:
        return sum(int(s.granted_packets) for s in self.servers)

    @property
    def masked_by_src(self) -> np.ndarray:
        return self._summed("masked_by_src")

    @property
    def dropped_by_src(self) -> np.ndarray:
        return self._summed("dropped_by_src")

    @property
    def fabric_traces(self) -> int:
        """Worst per-fabric signature count (the pin: == 1)."""
        return max(int(s.fabric.trace_count) for s in self.servers)

    def probes(self):
        """One ``ServerProbe`` per member server; feed the whole list to
        ``Manager(probes=...)`` and the channels merge into one
        ``Signals``."""
        return [s.probe() for s in self.servers]
