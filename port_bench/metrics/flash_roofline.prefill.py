"""``flash_roofline.prefill``: ``readers.flash_roofline`` of the prefill cell's run."""
from port_bench import readers


def read(b):
    return readers.flash_roofline(b)
