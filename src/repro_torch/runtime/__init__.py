"""The training runtime (``TrainLoop``), its fault tolerance (watchdog,
heartbeats, straggler statistics), the serving helpers and the deprecated
fixed-wave ``ServeLoop``."""
from repro_torch.runtime.ft import (HeartbeatMonitor, StepWatchdog,  # noqa: F401
                                    StragglerStats, WatchdogEvent)
from repro_torch.runtime.serve import ServeLoop  # noqa: F401
from repro_torch.runtime.train import TrainLoop, TrainLoopConfig  # noqa: F401
