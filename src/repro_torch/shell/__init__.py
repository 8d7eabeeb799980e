"""``repro_torch.shell`` — the unified, event-driven shell API.

The paper's shell (resource manager + register file + interconnect reacting
to reconfiguration events) as one coherent package:

- ``repro_torch.shell.state``   — immutable ``PoolState`` the planner folds over
- ``repro_torch.shell.events``  — the event taxonomy (tenant lifecycle + FT)
- ``repro_torch.shell.planner`` — pure ``plan(state, event) -> (state, Plan)``
- ``repro_torch.shell.policy``  — pluggable placement policies
  (``first_fit`` / ``best_fit`` / ``defrag``)
- ``repro_torch.shell.regfile`` — full + delta register synthesis
- ``repro_torch.shell.shell``   — the stateful ``Shell`` facade (``post`` seam)
- ``repro_torch.shell.server``  — ``ElasticServer``, continuous-batching
  serving, and ``ServerPool`` (several servers over one shell)

Ported from the JAX package's ``repro.shell``.
"""
from repro_torch.shell.events import (Event, FailRegion, Grow, HealRegion,
                                HeartbeatLost, Migrate, Release, Shrink,
                                Submit, WatchdogTimeout)
from repro_torch.shell.planner import Action, Plan, plan, reconfig_cost_s, replay
from repro_torch.shell.policy import (BestFit, Defrag, FirstFit, PlacementPolicy,
                                get_policy, register_policy)
from repro_torch.shell.regfile import (RegisterDelta, apply_delta, compute_delta,
                                 full_registers, registers_content_equal)
from repro_torch.shell.shell import LogEntry, Shell
from repro_torch.shell.state import (ON_SERVER, PoolState, RegionState, SLOTarget,
                               TenantEntry, check_invariants)

__all__ = [
    "Shell", "LogEntry",
    "Event", "Submit", "Release", "Shrink", "Grow", "Migrate",
    "FailRegion", "HealRegion", "HeartbeatLost", "WatchdogTimeout",
    "plan", "replay", "Plan", "Action", "reconfig_cost_s",
    "PlacementPolicy", "FirstFit", "BestFit", "Defrag",
    "get_policy", "register_policy",
    "RegisterDelta", "full_registers", "compute_delta", "apply_delta",
    "registers_content_equal",
    "PoolState", "RegionState", "TenantEntry", "SLOTarget", "ON_SERVER",
    "check_invariants",
    # lazily resolved (pulls model machinery): ElasticServer & friends
    "ElasticServer", "ModelEngine", "StreamRequest", "StreamCompletion",
    "ServerPool",
]

_SERVER_NAMES = {"ElasticServer", "ModelEngine", "StreamRequest",
                 "StreamCompletion", "ServerPool"}


def __getattr__(name):
    # PEP 562: keep `import repro.shell` light — the serving data plane
    # (models, kernels) loads only when actually used.
    if name in _SERVER_NAMES:
        from repro_torch.shell import server
        return getattr(server, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
