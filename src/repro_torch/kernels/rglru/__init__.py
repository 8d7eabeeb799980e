"""RG-LRU linear recurrence: hand-written CUDA kernels, forward and
backward, for the hybrid family's prefill and training."""
