"""The training runtime (``TrainLoop``), its fault tolerance (watchdog,
heartbeats, straggler statistics) and the serving helpers."""
from repro_torch.runtime.ft import (HeartbeatMonitor, StepWatchdog,  # noqa: F401
                                    StragglerStats, WatchdogEvent)
from repro_torch.runtime.train import TrainLoop, TrainLoopConfig  # noqa: F401
