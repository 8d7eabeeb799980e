"""``device_idle.train``: ``readers.device_idle`` of the train cell's run."""
from port_bench import readers


def read(b):
    return readers.device_idle(b)
