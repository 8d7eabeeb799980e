"""PR-region description (paper §IV-A).  Only :class:`Region` is ported:
the shell builds its immutable pool from these."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Region:
    """A fixed-size slice of the device pool — the PR-region analogue."""

    rid: int
    n_chips: int
    hbm_bytes: int
    healthy: bool = True
    tenant: Optional[str] = None
    module_idx: Optional[int] = None     # which of the tenant's modules

    @property
    def free(self) -> bool:
        return self.healthy and self.tenant is None
