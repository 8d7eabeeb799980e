"""Cycle-level, paper-faithful simulator of the FPGA system of
"Towards Hardware Support for FPGA Resource Elasticity" (Awan & Aliyeva, 2021).

This subpackage reproduces the paper's *published hardware*, in simulation:

- ``registers``  — the Table III register file (20 registers, exact addresses).
- ``arbiter``    — the LZC-based Weighted-Round-Robin arbiter of §IV-E.1.
- ``wishbone``   — WB master/slave interface state machines (§IV-F).
- ``crossbar``   — the 4x4 (generalised NxN) crossbar cycle simulator (§IV-E).
- ``modules``    — the three computation modules of §V-B: constant multiplier,
                   Hamming(31,26) encoder and decoder (bit-exact).
- ``area``       — analytical area/power model calibrated to Tables I & II.
- ``system``     — the full-system use-case model for §V-C/§V-D (Fig 5).

The tensor re-expression of the same mechanisms lives in ``repro_torch.core``
(registers, arbiter) and ``repro_torch.kernels`` (the CUDA kernels).
"""
from repro_torch.core.hw.registers import RegisterFile, RegAddr
from repro_torch.core.hw.arbiter import WRRArbiter, lzc32, rotl, first_requester
from repro_torch.core.hw.crossbar import CrossbarSim, MasterRequest, TransferResult, ErrorCode
from repro_torch.core.hw.modules import (
    hamming3126_encode, hamming3126_decode, constant_multiply,
    ComputationModuleSim, MultiplierModule, HammingEncoderModule, HammingDecoderModule,
)
from repro_torch.core.hw.area import AreaModel
from repro_torch.core.hw.system import ElasticUseCase, UseCaseResult

__all__ = [
    "RegisterFile", "RegAddr",
    "WRRArbiter", "lzc32", "rotl", "first_requester",
    "CrossbarSim", "MasterRequest", "TransferResult", "ErrorCode",
    "hamming3126_encode", "hamming3126_decode", "constant_multiply",
    "ComputationModuleSim", "MultiplierModule", "HammingEncoderModule",
    "HammingDecoderModule",
    "AreaModel", "ElasticUseCase", "UseCaseResult",
]
