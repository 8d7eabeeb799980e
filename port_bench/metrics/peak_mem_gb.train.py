"""``peak_mem_gb.train``: ``readers.peak_mem_gb`` of the train cell's run."""
from port_bench import readers


def read(b):
    return readers.peak_mem_gb(b)
