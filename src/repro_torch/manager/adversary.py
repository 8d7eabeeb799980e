"""``repro_torch.manager.adversary`` — the hostile-tenant behavior seam.

The paper's security story is enforced *mechanically* at the crossbar: the
masking registers drop requests to destinations outside a tenant's
isolation domain at the master port, and the WRR arbiter caps every PR
region at its allocated bandwidth share.  This module supplies the other
half of the experiment — tenants that actively try to break those
guarantees — so the scenario harness can run attackers and honest tenants
against one clock, one ``ServerPool`` and one ``Signals`` stream, and
check that the isolation claims hold under hostile load (the
cross-tenant interference and
bandwidth-abuse risks catalogued by arXiv:2209.11158 and
arXiv:2009.13914).

An attacker is a registered strategy (same decorator-registry shape as
``PlacementPolicy`` / ``ElasticityPolicy`` / ``Forecaster``): it sees a
frozen per-tick :class:`AttackView` of what a *real* hostile tenant could
observe — its own placement, public pool
facts, and its own accounted fabric feedback — and returns actions the
harness applies through the ordinary tenant entry points.  Attackers get
no privileged handles: no shell, no register file, no other tenant's
state.  Anything they break, a real tenant could have broken.

Built-in attackers::

    noisy_neighbor   saturates its own WRR allocation every tick (floods
                     requests + offers a full-capacity burst at its port)
    dest_sprayer     sprays invalid / foreign destination addresses — the
                     paper's masked-request path
    drop_retrier     re-offers everything the arbiter dropped, trying to
                     steal bandwidth through persistence
    cascade_failer   triggers region failures whenever the pool runs hot,
                     forcing reconfiguration churn under load

``get_attacker`` resolves a name (or passes an instance through), so
scenario specs can carry attacker mixes as plain strings in record/replay
traces.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Type, Union

__all__ = [
    "AttackView", "SprayAction", "RequestAction", "FailAction", "Attacker",
    "NoisyNeighbor", "DestSprayer", "DropRetrier", "CascadeFailer",
    "register_attacker", "get_attacker", "attacker_names", "ATTACKER_KINDS",
]


# ----------------------------------------------------------------------
# what an attacker can see
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AttackView:
    """One tick's tenant-eye view of the system.

    Deliberately restricted to what a co-located hostile tenant could
    legitimately observe: its own placement and accounted fabric feedback,
    plus coarse public pool facts (port count, capacity, utilization).
    Nothing here reveals another tenant's slots or traffic.
    """

    tick: int
    app_id: int
    name: str
    host_port: int                    # the AXI bridge port (port 0)
    my_ports: Tuple[int, ...]         # crossbar ports of my placed modules
    n_ports: int                      # total fabric ports (host + regions)
    capacity: int                     # per-destination slot capacity
    healthy_rids: Tuple[int, ...]     # regions currently marked healthy
    utilization: float                # pool-wide placed/healthy fraction
    my_masked: int = 0                # cumulative masked packets from my ports
    my_dropped: int = 0               # cumulative non-granted offers, my ports

    @property
    def placed(self) -> bool:
        return bool(self.my_ports)


# ----------------------------------------------------------------------
# what an attacker can do
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SprayAction:
    """Offer raw packets to the fabric from the tenant's own port.

    ``dsts`` are destination *ports*; out-of-range or foreign values are
    exactly what the masking registers exist to stop.  Negative values are
    padding to the fabric and are never emitted by built-in attackers."""

    dsts: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class RequestAction:
    """Submit an ordinary serving request (admission-queue pressure)."""

    prompt: int = 8
    max_new: int = 8


@dataclasses.dataclass(frozen=True)
class FailAction:
    """Induce a region fault (a tenant crashing / wedging its own PR
    bitstream takes the region down until the harness heals it)."""

    rid: int


Action = Union[SprayAction, RequestAction, FailAction]


# ----------------------------------------------------------------------
# the seam
# ----------------------------------------------------------------------
class Attacker:
    """Base class: one hostile tenant's per-tick behavior."""

    name = "attacker"

    def step(self, view: AttackView, rng) -> List[Action]:
        """Actions to apply this tick (may be empty)."""
        raise NotImplementedError


_ATTACKERS: Dict[str, Type[Attacker]] = {}


def register_attacker(cls: Type[Attacker]) -> Type[Attacker]:
    """Class decorator adding an ``Attacker`` to the registry by its
    ``name`` — the seam's registration point (linted by FAB004).

    >>> @register_attacker
    ... class Lurker(Attacker):
    ...     name = "lurker"
    ...     def step(self, view, rng):
    ...         return []
    >>> get_attacker("lurker").name
    'lurker'
    """
    _ATTACKERS[cls.name] = cls
    return cls


def get_attacker(spec: Union[str, Attacker]) -> Attacker:
    """Resolve a registry name to a fresh instance (instances pass
    through, so specs can carry pre-configured attackers)."""
    if isinstance(spec, Attacker):
        return spec
    if spec not in _ATTACKERS:
        raise KeyError(
            f"unknown attacker {spec!r}; known: {sorted(_ATTACKERS)}")
    return _ATTACKERS[spec]()


def attacker_names() -> List[str]:
    return sorted(_ATTACKERS)


# ----------------------------------------------------------------------
# built-in hostile tenants
# ----------------------------------------------------------------------
@register_attacker
class NoisyNeighbor(Attacker):
    """Saturates its own WRR allocation every tick.

    Floods the admission queue with requests and offers a full
    ``capacity``-sized burst at its own port — entirely *legal* traffic
    that maximally exercises the arbiter.  The isolation property under
    test: however loud this tenant gets, honest tenants' granted
    bandwidth never dips below their WRR share (the arbiter's per-source
    round-robin ranks are computed independently per destination)."""

    name = "noisy_neighbor"

    def __init__(self, requests_per_tick: int = 4):
        self.requests_per_tick = int(requests_per_tick)

    def step(self, view: AttackView, rng) -> List[Action]:
        actions: List[Action] = [
            RequestAction(prompt=16, max_new=16)
            for _ in range(self.requests_per_tick)
        ]
        if view.placed:
            # a full-capacity legal burst at my own port, every tick
            actions.append(
                SprayAction(dsts=(view.my_ports[0],) * view.capacity))
        return actions


@register_attacker
class DestSprayer(Attacker):
    """Sprays invalid and foreign destination addresses — the paper's
    masked-request path.

    Half the burst targets ports past the end of the fabric (classic
    wild-pointer Wishbone writes), half targets other regions' ports,
    which the masking registers deny unless the destination belongs to
    the same tenant.  Never targets the host bridge (universally allowed
    — that would be legal traffic, not an isolation probe) and never
    emits negative values (padding to the fabric, silently not offered)."""

    name = "dest_sprayer"

    def __init__(self, burst: int = 8):
        self.burst = int(burst)

    def step(self, view: AttackView, rng) -> List[Action]:
        if not view.placed:
            return []
        mine = set(view.my_ports)
        foreign = [p for p in range(1, view.n_ports)
                   if p not in mine and p != view.host_port]
        dsts: List[int] = []
        for i in range(self.burst):
            if i % 2 == 0 or not foreign:
                dsts.append(view.n_ports + int(rng.integers(0, 4)))
            else:
                dsts.append(foreign[int(rng.integers(0, len(foreign)))])
        return [SprayAction(dsts=tuple(dsts))]


@register_attacker
class DropRetrier(Attacker):
    """Bandwidth stealing by persistence: re-offers everything the
    arbiter dropped last window on top of a fresh over-capacity burst.

    Reads its *own* accounted drop feedback (``view.my_dropped``) — the
    exact signal a real firmware retry loop would key on — and escalates
    until capped.  The arbiter's quota/capacity cut is stateless per
    cycle, so retries only ever re-lose the same arbitration: the
    property suite asserts honest grants are untouched."""

    name = "drop_retrier"

    def __init__(self, base_burst: int = 4, cap: int = 32):
        self.base_burst = int(base_burst)
        self.cap = int(cap)
        self._last_dropped = 0

    def step(self, view: AttackView, rng) -> List[Action]:
        if not view.placed:
            return []
        fresh_drops = max(0, view.my_dropped - self._last_dropped)
        self._last_dropped = view.my_dropped
        n = min(self.cap, self.base_burst + fresh_drops)
        return [SprayAction(dsts=(view.my_ports[0],) * n)]


@register_attacker
class CascadeFailer(Attacker):
    """Triggers region failures under load.

    Whenever pool utilization crosses ``threshold`` (the moment a fault
    hurts most) it takes down a random healthy region, then sits out a
    cooldown so the harness's heal path gets exercised too.  The property
    under test: the shell masks the dead region, traffic re-routes, and
    ``fabric_retraces`` stays at 1 through the reconfiguration storm (and,
    on the card, no kernel library is loaded twice)."""

    name = "cascade_failer"

    def __init__(self, threshold: float = 0.5, cooldown: int = 4):
        self.threshold = float(threshold)
        self.cooldown = int(cooldown)
        self._last_fail: Optional[int] = None

    def step(self, view: AttackView, rng) -> List[Action]:
        if not view.healthy_rids or view.utilization < self.threshold:
            return []
        if (self._last_fail is not None
                and view.tick - self._last_fail < self.cooldown):
            return []
        self._last_fail = view.tick
        rid = view.healthy_rids[int(rng.integers(0, len(view.healthy_rids)))]
        return [FailAction(rid=rid)]


ATTACKER_KINDS: Tuple[str, ...] = tuple(attacker_names())
