"""``crossbar_roofline.prefill``: ``readers.crossbar_roofline`` of the prefill cell's run."""
from port_bench import readers


def read(b):
    return readers.crossbar_roofline(b)
