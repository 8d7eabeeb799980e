"""RG-LRU linear recurrence: a hand-written CUDA kernel (forward only) for
the hybrid family's prefill and loss forward."""
