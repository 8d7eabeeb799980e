"""Mamba-2 SSD chunk scan: hand-written CUDA kernels, forward and backward,
for the SSM family's prefill and training."""
