"""``pipeline.wait_ms.train``: the mean host milliseconds a train step
waits for its batch (``next`` on the port's ``DataPipeline`` and the copy
to the card), over the window."""
from port_bench import readers


def read(b):
    return readers.span_mean_ms(b, "pipeline.next")
