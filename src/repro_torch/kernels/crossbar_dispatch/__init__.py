"""Crossbar-dispatch kernels: plan_multi (and the fabric's whole plan,
plan_fabric), plan, scatter, combine."""
from repro_torch.kernels.crossbar_dispatch.ops import (  # noqa: F401
    crossbar_combine, crossbar_dispatch, crossbar_plan)
