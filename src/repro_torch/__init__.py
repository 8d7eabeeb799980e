"""PyTorch/CUDA port of the FPGA-elasticity system (JAX package: ``repro``).

The serving path — ``ElasticServer`` -> ``ModelEngine`` ->
``DenseLM.decode_step`` -> ``moe_apply_fabric`` -> ``Fabric`` — runs on an
NVIDIA H100 through three hand-written CUDA kernels
(``kernels/crossbar_dispatch``).  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
