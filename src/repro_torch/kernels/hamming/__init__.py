"""The paper's Hamming(31,26) encoder and decoder and constant multiplier:
hand-written CUDA kernels for the use-case modules."""
from repro_torch.kernels.hamming.ops import (  # noqa: F401
    hamming_decode, hamming_encode, multiply_const)
