"""``repro_torch.fabric``: one data-plane API over the crossbar.

A :class:`Fabric` binds a register file (or a live ``Shell``) to a
plan-equivalent dispatch backend on a device

    reference    plain PyTorch plan + shared scatter/gather
    cuda         the fabric's plan kernel + shared scatter/gather
                 (alias ``pallas``)
    cuda_kernel  the plan, scatter and combine kernels
    sharded      ``all_to_all`` over the ranks of a ``torch.distributed``
                 process group (``group=``), packets moved by the scatter
                 and combine kernels

and exposes ``plan`` / ``dispatch`` / ``combine`` / ``transfer``, with the
sanitizer (``debug=``, ``REPRO_FABRIC_DEBUG``) raising ``FabricCheckError``.
"""
from repro_torch.core.arbiter import DispatchPlan                  # noqa: F401
from repro_torch.fabric.backends import (CombineRoute,             # noqa: F401
                                         CudaBackend,
                                         ReferenceBackend,
                                         ShardedBackend,
                                         backend_names,
                                         get_backend,
                                         register_fabric_backend)
from repro_torch.fabric.cache import PlanCache, plan_key           # noqa: F401
from repro_torch.fabric.fabric import (DEBUG_ENV_VAR, Fabric,      # noqa: F401
                                       fabric_for_shell)
from repro_torch.fabric.interface import (KernelMode,              # noqa: F401
                                          resolve_kernel_mode)
from repro_torch.fabric.sanitize import FabricCheckError           # noqa: F401

__all__ = [
    "Fabric", "fabric_for_shell", "DispatchPlan", "PlanCache", "plan_key",
    "KernelMode", "resolve_kernel_mode", "ReferenceBackend", "CudaBackend",
    "ShardedBackend", "CombineRoute", "get_backend",
    "register_fabric_backend", "backend_names", "DEBUG_ENV_VAR",
    "FabricCheckError",
]
