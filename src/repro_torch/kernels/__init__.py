"""Hand-written CUDA kernels of the port and their plain versions.

Re-exported here, as the JAX package's ``repro.kernels`` does: the
deprecated single-source crossbar shims and the Hamming/multiplier entry
points."""
from repro_torch.kernels.crossbar_dispatch import (  # noqa: F401
    crossbar_combine, crossbar_dispatch, crossbar_plan)
from repro_torch.kernels.hamming import (  # noqa: F401
    hamming_decode, hamming_encode, multiply_const)
