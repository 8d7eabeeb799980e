"""Computation-module footprint (paper §IV-H): the shell's placement
currency.  Only :class:`ModuleFootprint` is ported; the shell needs
nothing else from the module template."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModuleFootprint:
    """Resource requirement of one module (the ERM's placement currency)."""

    param_bytes: int
    flops_per_token: float
    activation_bytes_per_token: int

    def fits(self, region_hbm_bytes: int, reserve_fraction: float = 0.2) -> bool:
        return self.param_bytes <= region_hbm_bytes * (1 - reserve_fraction)
