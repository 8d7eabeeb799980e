"""Computation-module template (§IV-H) — the unit of elasticity.

"We provide a standard template for the computation modules to have the same
interfaces." A module is a self-contained compute stage with a uniform
contract so the Elastic Resource Manager can place it on any region (or on
the host) and the crossbar can route between modules without bespoke glue.

A module is a function of (params, x) + parameters + resource footprint.
The footprint (param bytes, FLOPs/token, activation bytes/token) is what the
shell uses to decide placement — the analogue of a partial bitstream's
resource requirement.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class ModuleFootprint:
    """Resource requirement of one module (the ERM's placement currency)."""

    param_bytes: int
    flops_per_token: float
    activation_bytes_per_token: int

    def fits(self, region_hbm_bytes: int, reserve_fraction: float = 0.2) -> bool:
        return self.param_bytes <= region_hbm_bytes * (1 - reserve_fraction)


@dataclasses.dataclass
class ComputationModule:
    """§IV-H template: input regs -> compute units -> output regs + status.

    ``apply(params, x)`` must be pure and shape-preserving on the leading
    token axis; ``init`` builds params from a ``torch.Generator``.
    """

    name: str
    init: Callable[[torch.Generator], Any]
    apply: Callable[[Any, torch.Tensor], torch.Tensor]
    footprint: ModuleFootprint

    def __call__(self, params: Any, x: torch.Tensor) -> torch.Tensor:
        return self.apply(params, x)


def _to(tree: Any, device: torch.device) -> Any:
    """Every tensor of a nested dict/list/tuple of parameters on
    ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


@dataclasses.dataclass
class ModuleChain:
    """An application's acceleration requirement, expressed as small modules
    (Fig 2). The chain is the decomposition the paper assumes as input —
    "techniques to decompose ... are outside the scope of this paper"; here a
    chain is just an ordered module list with crossbar hops between stages.
    """

    modules: List[ComputationModule]

    def init(self, gen: torch.Generator) -> List[Any]:
        """Each module's parameters, drawn in turn from ``gen``."""
        return [m.init(gen) for m in self.modules]

    def apply(self, params: Sequence[Any], x: torch.Tensor,
              placement: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Run the chain. ``placement[i] == -1`` (``ON_SERVER``) means the
        module runs on the server: on ``torch.device("cpu")``, with its
        input and parameters copied there and its output copied back to
        ``x``'s device — the paper's explicit placement when no PR region
        is free.  Every other module runs where ``x`` lies."""
        cpu = torch.device("cpu")
        for i, (m, p) in enumerate(zip(self.modules, params)):
            if placement is not None and placement[i] < 0:
                x = m.apply(_to(p, cpu), x.to(cpu)).to(x.device)
            else:
                x = m.apply(p, x)
        return x

    @property
    def footprints(self) -> List[ModuleFootprint]:
        """Per-module placement currency — what ``Shell.submit`` consumes
        when a chain (rather than a bare footprint list) is admitted."""
        return [m.footprint for m in self.modules]

    @property
    def total_footprint(self) -> ModuleFootprint:
        return ModuleFootprint(
            param_bytes=sum(m.footprint.param_bytes for m in self.modules),
            flops_per_token=sum(m.footprint.flops_per_token for m in self.modules),
            activation_bytes_per_token=max(
                (m.footprint.activation_bytes_per_token for m in self.modules),
                default=0))


def module_from_layer(name: str, init_fn, apply_fn, *, d_model: int,
                      param_count: int, flops_per_token: float,
                      dtype_bytes: int = 2) -> ComputationModule:
    """Wrap a model layer as a crossbar-routable computation module."""
    return ComputationModule(
        name=name, init=init_fn, apply=apply_fn,
        footprint=ModuleFootprint(
            param_bytes=param_count * dtype_bytes,
            flops_per_token=flops_per_token,
            activation_bytes_per_token=d_model * dtype_bytes))
