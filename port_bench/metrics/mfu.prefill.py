"""``mfu.prefill``: ``readers.mfu`` of the prefill cell's run."""
from port_bench import readers


def read(b):
    return readers.mfu(b)
