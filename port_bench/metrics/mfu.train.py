"""``mfu.train``: ``readers.mfu`` of the train cell's run."""
from port_bench import readers


def read(b):
    return readers.mfu(b)
