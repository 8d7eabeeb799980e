"""``flash_roofline.train``: ``readers.flash_roofline`` of the train cell's run."""
from port_bench import readers


def read(b):
    return readers.flash_roofline(b)
