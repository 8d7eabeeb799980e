"""``crossbar_roofline.train``: ``readers.crossbar_roofline`` of the train cell's run."""
from port_bench import readers


def read(b):
    return readers.crossbar_roofline(b)
