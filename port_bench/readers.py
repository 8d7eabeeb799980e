"""What the per-layer metrics' readers (``metrics/<metric>.py``) share:
each returns None where its cell's run left nothing to read."""
from __future__ import annotations

from typing import Optional

from port_bench import kernels, roofline


def mfu(b) -> Optional[float]:
    """Model FLOPs of the window over its seconds, as % of the bf16
    peak."""
    f = b.work.get("window_flops")
    if not f or not b.window_s:
        return None
    return 100.0 * f / b.window_s / roofline.PEAK_BF16_FLOPS


def crossbar_roofline(b) -> Optional[float]:
    """The crossbar calls' least time over their kernels' device time in
    the traced window, %."""
    t = kernels.seconds(b.device_ops, kernels.CROSSBAR)
    n = b.work.get("traced_crossbar_bytes")
    if not t or not n:
        return None
    return 100.0 * roofline.least_s(n) / t


def flash_roofline(b) -> Optional[float]:
    """The flash calls' least time over their kernels' device time in the
    traced window, %."""
    t = kernels.seconds(b.device_ops, kernels.FLASH)
    least = b.work.get("traced_flash_least_s")
    if not t or not least:
        return None
    return 100.0 * least / t


def device_idle(b) -> Optional[float]:
    """The share of the traced window in which no device op ran, %."""
    busy = b.busy_s()
    if busy is None or not b.trace_window_s:
        return None
    return 100.0 * max(0.0, 1.0 - busy / b.trace_window_s)


def peak_mem_gb(b) -> Optional[float]:
    """``torch.cuda.max_memory_allocated()`` over the window, GB."""
    return b.window_peak_bytes / 1e9 if b.window_peak_bytes else None


def span_mean_ms(b, name: str) -> Optional[float]:
    """The mean host milliseconds of a benchmark span in the window."""
    xs = b.spans.get(name)
    return 1e3 * sum(xs) / len(xs) if xs else None
