"""The port's kernels by name, as the profiler shows them (each kept in an
anonymous namespace, the flash ones in ``tc::``), and the device seconds
of a traced window's ops by kernel family."""
from __future__ import annotations

import re
from typing import Iterable, Optional

CROSSBAR = ("plan_kernel", "finish_kernel", "scan_scatter_kernel",
            "owner_kernel", "gather_kernel")
FLASH = ("fwd_ws_kernel", "dkdv_ws_kernel", "dq_ws_kernel", "delta_kernel",
         "fwd_kernel", "dkdv_kernel", "dq_kernel", "dkdv_wg_kernel",
         "dkdv_sum_kernel", "dq_wg_kernel", "dkdv_wide_kernel",
         "dq_wide_kernel")


def base(name: str) -> Optional[str]:
    """A port kernel's name without namespace and arguments; None for
    anything else (PyTorch's and the libraries' kernels)."""
    if "(anonymous namespace)::" not in name or "at::native" in name:
        return None
    head = name.split("(anonymous namespace)::", 1)[-1].removeprefix("tc::")
    return re.split(r"[<(]", head)[0]


def seconds(ops: Iterable[tuple], family) -> Optional[float]:
    """Device seconds of the ops of a kernel family; None where none ran."""
    got = [d for n, _, d in ops if base(n) in family]
    return sum(got) if got else None
