"""Flash attention: a hand-written CUDA kernel (forward and backward) for
the LM's prefill and training attention."""
