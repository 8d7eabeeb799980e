"""Mamba-2 SSD chunk scan: a hand-written CUDA kernel (forward only) for the
SSM family's prefill and loss forward."""
