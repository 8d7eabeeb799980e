"""``repro_torch.telemetry`` — alias for
:mod:`repro_torch.manager.telemetry`.

The telemetry API ships inside the manager package (signals exist to feed
the control loop), but it is useful standalone — dashboards, tests, and
custom controllers import the snapshot machinery from here without
touching policies or the loop.  The export list is the source module's
``__all__``, so the two surfaces cannot drift.
"""
from repro_torch.manager.telemetry import *        # noqa: F401,F403
from repro_torch.manager.telemetry import __all__  # noqa: F401
