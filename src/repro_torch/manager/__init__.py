"""``repro_torch.manager`` — the closed-loop elastic resource manager.

The paper's envisioned manager "can increase or decrease the number of PR
regions allocated to an application based on its acceleration requirements
and PR regions' availability".  ``repro_torch.shell`` (event-driven
reconfiguration) and ``repro_torch.fabric`` (the register-gated crossbar)
are the mechanisms; this package is the policy loop that drives them
autonomously.  It is the port of the JAX package's ``manager`` and gives
its decisions and traces on the same inputs:

- ``repro_torch.manager.telemetry`` — ``Signals``: one typed snapshot per
  tick, assembled from pluggable ``Probe`` sources (``server.probe()``,
  ``stats.probe()``, ``fabric.probe()``) — replaces ad-hoc attribute reads.
- ``repro_torch.manager.policies``  — ``ElasticityPolicy`` seam + built-ins:
  ``Hysteresis`` (pressure/idleness with cooldowns),
  ``TrafficAwareDefrag`` (port-traffic-ranked migration and shrink
  victims), ``FairShare`` (weighted max-min region allocation),
  ``PolicyChain`` (composition).
- ``repro_torch.manager.manager``   — the tick-driven ``Manager`` loop
  (sample -> decide -> ``shell.post`` -> record), with a demand
  ``SignalsHistory`` ring and pluggable ``Tracker`` metric sinks.
- ``repro_torch.manager.forecast``  — the ``Forecaster`` seam (``EWMA`` Holt
  smoothing, ``Periodic`` seasonal-naive) over per-tenant demand series.
- ``repro_torch.manager.slo``       — ``SLOTarget`` budgets, violation
  accounting, and the registered ``PredictiveSLO`` policy that grows
  *before* forecast demand crosses SLO-feasible capacity.
- ``repro_torch.manager.trackers``  — metric sinks (``noop`` /
  ``in_memory`` / ``jsonl``, composable) streaming per-tick control-loop
  metrics.
- ``repro_torch.manager.scenarios`` — seeded, deterministic workload
  scenarios (bursty / diurnal / churn / failure_storm / production /
  adversarial) stepping workload + server(s) + manager together, with
  JSONL record/replay of the applied workload.
- ``repro_torch.manager.adversary`` — the hostile-tenant seam
  (``@register_attacker``): noisy_neighbor / dest_sprayer / drop_retrier /
  cascade_failer behaviors the adversarial scenario steps against honest
  tenants.
"""
from repro_torch.manager.adversary import (ATTACKER_KINDS, Attacker,
                                           AttackView, CascadeFailer,
                                           DestSprayer, DropRetrier,
                                           FailAction, NoisyNeighbor,
                                           RequestAction, SprayAction,
                                           attacker_names, get_attacker,
                                           register_attacker)
from repro_torch.manager.forecast import (EWMA, Forecast, Forecaster, Periodic,
                                          SignalsHistory, forecaster_names,
                                          get_forecaster, register_forecaster)
from repro_torch.manager.manager import Decision, Manager
from repro_torch.manager.policies import (ElasticityPolicy, FairShare,
                                          Hysteresis, PolicyChain,
                                          TrafficAwareDefrag, abuse_scores,
                                          get_elasticity_policy,
                                          register_elasticity_policy)
from repro_torch.manager.slo import (PredictiveSLO, SLOTarget,
                                     forecastable_violations, slo_violations)
from repro_torch.manager.telemetry import (FabricProbe, Probe, ServerProbe,
                                           Signals, StragglerProbe,
                                           TenantSignals, assemble_signals,
                                           fragmentation)
from repro_torch.manager.trackers import (InMemoryTracker, JsonlTracker,
                                          MultiTracker, NoopTracker, Tracker,
                                          get_tracker, register_tracker)

__all__ = [
    "Manager", "Decision",
    "ElasticityPolicy", "Hysteresis", "TrafficAwareDefrag", "FairShare",
    "PolicyChain", "abuse_scores", "get_elasticity_policy",
    "register_elasticity_policy",
    "Attacker", "AttackView", "SprayAction", "RequestAction", "FailAction",
    "NoisyNeighbor", "DestSprayer", "DropRetrier", "CascadeFailer",
    "register_attacker", "get_attacker", "attacker_names", "ATTACKER_KINDS",
    "Signals", "TenantSignals", "Probe", "ServerProbe", "StragglerProbe",
    "FabricProbe", "assemble_signals", "fragmentation",
    "SignalsHistory", "Forecast", "Forecaster", "EWMA", "Periodic",
    "get_forecaster", "register_forecaster", "forecaster_names",
    "SLOTarget", "PredictiveSLO", "slo_violations",
    "forecastable_violations",
    "Tracker", "NoopTracker", "InMemoryTracker", "JsonlTracker",
    "MultiTracker", "get_tracker", "register_tracker",
    # lazily resolved (pulls in the serving stack): scenario harness
    "run_scenario", "ScenarioResult", "ScenarioSpec", "TenantSpec",
    "SyntheticEngine", "SCENARIO_KINDS", "build_spec", "default_policy",
    "predictive_policy", "adversarial_policy", "RecordedWorkload",
    "DEFAULT_SLO",
]

_SCENARIO_NAMES = {"run_scenario", "ScenarioResult", "ScenarioSpec",
                   "TenantSpec", "SyntheticEngine", "SCENARIO_KINDS",
                   "build_spec", "default_policy", "predictive_policy",
                   "adversarial_policy", "RecordedWorkload", "DEFAULT_SLO"}


def __getattr__(name):
    # PEP 562: the scenario harness imports the serving stack; keep
    # `import repro_torch.manager` light for policy/telemetry-only users.
    if name in _SCENARIO_NAMES:
        from repro_torch.manager import scenarios
        return getattr(scenarios, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
