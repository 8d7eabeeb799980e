"""``device_idle.prefill``: ``readers.device_idle`` of the prefill cell's run."""
from port_bench import readers


def read(b):
    return readers.device_idle(b)
