"""``peak_mem_gb.prefill``: ``readers.peak_mem_gb`` of the prefill cell's run."""
from port_bench import readers


def read(b):
    return readers.peak_mem_gb(b)
