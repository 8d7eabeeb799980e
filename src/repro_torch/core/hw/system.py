"""Full-system model of the paper's §V-C/§V-D use case.

16 KB of user data flows through constant-multiplier -> Hamming(31,26)
encoder -> decoder. Three elasticity cases:

  case 1: multiplier on FPGA, encoder+decoder on the server CPU,
  case 2: multiplier+encoder on FPGA, decoder on the CPU,
  case 3: everything on FPGA.

The FPGA side is timed by the cycle model of :mod:`repro_torch.core.hw.crossbar`
(250 MHz system clock, WRR quota `q` packages per grant session). The host
side needs three constants the paper does not publish (PCIe/driver base cost,
per-module CPU cost, and a host-visible per-grant-session synchronisation
cost); :func:`ElasticUseCase.calibrate` fits them to the paper's four
observations (16.9 ms, 10.87 ms, 5.24 %, 6 %) by least squares and reports the
residuals, so the reproduction is explicit about what is measured (cycle
counts) vs modelled (milliseconds).

Data correctness is *not* modelled: the three modules actually run
(:mod:`repro_torch.core.hw.modules`) and the output is checked bit-exactly.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.hw.crossbar import STATUS_CC, TIME_TO_GRANT_CC
from repro_torch.core.hw.modules import (
    ComputationModuleSim, HammingDecoderModule, HammingEncoderModule,
    MultiplierModule, hamming3126_decode,
)

FPGA_CLOCK_HZ = 250e6          # §II-B: system runs at 250 MHz (ICAP at 125 MHz)
USE_CASE_BYTES = 16 * 1024     # §V-C
WORD_BYTES = 4                 # 32-bit WB data width
USE_CASE_WORDS = USE_CASE_BYTES // WORD_BYTES   # 4096

# Paper-reported observations used for calibration.
PAPER_CASE1_MS = 16.9
PAPER_CASE3_MS = 10.87
PAPER_BW_IMPROVEMENT_1ACC = 0.0524
PAPER_BW_IMPROVEMENT_3ACC = 0.06
PAPER_QUOTA_LO, PAPER_QUOTA_HI = 16, 128       # §V-D packet counts


def hop_stream_cc(n_words: int, quota: int) -> int:
    """Cycles to stream ``n_words`` through one crossbar hop with WRR quota.

    Each grant session moves up to ``quota`` words and costs the 4-cc
    time-to-grant plus the 1-cc status turnaround (§V-E).
    """
    sessions = math.ceil(n_words / quota)
    return n_words + sessions * (TIME_TO_GRANT_CC + STATUS_CC)


def chain_cc(n_words: int, quota: int, modules: List[ComputationModuleSim]) -> int:
    """Pipelined module chain: hops = host->m1, m1->m2, ..., mk->host.

    Sessions flow through the chain in a software pipeline; total time is one
    hop's full streaming time plus a per-stage fill of (quota + grant overhead
    + module pipeline depth) cycles.
    """
    stream = hop_stream_cc(n_words, quota)
    fill = sum(quota + TIME_TO_GRANT_CC + STATUS_CC + m.pipeline_depth
               for m in modules)
    return stream + fill


def grant_sessions(n_words: int, quota: int, n_hops: int) -> int:
    return n_hops * math.ceil(n_words / quota)


def host_sync_sessions(n_words: int, quota: int) -> int:
    """Grant sessions visible to the *host*: the AXI-WB ingress and WB-AXI
    egress hops (§IV-G). Internal module-to-module re-grants are pure FPGA
    cycles already counted by :func:`chain_cc`."""
    return 2 * math.ceil(n_words / quota)


@dataclass
class HostConstants:
    """Calibrated host-side costs (see module docstring)."""

    pcie_base_ms: float        # driver + DMA setup + bulk transfer
    cpu_module_ms: float       # per software module pass over 16 KB
    sync_us_per_session: float # host-visible cost per WRR grant session


@dataclass
class UseCaseResult:
    case: int                  # number of modules on the FPGA (1..3)
    quota: int
    total_ms: float
    fpga_ms: float
    cpu_ms: float
    sync_ms: float
    fpga_cycles: int
    sessions: int
    output: np.ndarray
    data_ok: bool


@dataclass
class ElasticUseCase:
    """§V-C elasticity + §V-D bandwidth-allocation experiments."""

    constant: int = 3
    n_words: int = USE_CASE_WORDS
    host: Optional[HostConstants] = None
    calibration_residuals: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.modules = [MultiplierModule(self.constant),
                        HammingEncoderModule(),
                        HammingDecoderModule()]
        if self.host is None:
            self.calibrate()

    # ------------------------------------------------------------------
    def calibrate(self) -> HostConstants:
        """Least-squares fit of host constants to the paper's observations."""
        q = PAPER_QUOTA_LO
        # 1) sync cost from the two §V-D improvements (FPGA-cycle deltas are
        #    microseconds and folded in exactly).
        rows = []
        for n_fpga, improv, total in (
                (1, PAPER_BW_IMPROVEMENT_1ACC, PAPER_CASE1_MS),
                (3, PAPER_BW_IMPROVEMENT_3ACC, PAPER_CASE3_MS)):
            d_sessions = (host_sync_sessions(self.n_words, PAPER_QUOTA_LO)
                          - host_sync_sessions(self.n_words, PAPER_QUOTA_HI))
            d_fpga_ms = 1e3 * (
                chain_cc(self.n_words, PAPER_QUOTA_LO, self.modules[:n_fpga])
                - chain_cc(self.n_words, PAPER_QUOTA_HI, self.modules[:n_fpga])
            ) / FPGA_CLOCK_HZ
            rows.append((d_sessions, improv * total - d_fpga_ms))
        num = sum(ds * target * 1e3 for ds, target in rows)        # us
        den = sum(ds * ds for ds, _ in rows)
        sync_us = num / den

        # 2) base + cpu cost from the two Fig 5 endpoints at quota 16.
        fpga3_ms = 1e3 * chain_cc(self.n_words, q, self.modules) / FPGA_CLOCK_HZ
        sync3_ms = host_sync_sessions(self.n_words, q) * sync_us * 1e-3
        base_ms = PAPER_CASE3_MS - fpga3_ms - sync3_ms
        fpga1_ms = 1e3 * chain_cc(self.n_words, q, self.modules[:1]) / FPGA_CLOCK_HZ
        sync1_ms = host_sync_sessions(self.n_words, q) * sync_us * 1e-3
        cpu_ms = (PAPER_CASE1_MS - base_ms - fpga1_ms - sync1_ms) / 2

        self.host = HostConstants(pcie_base_ms=base_ms, cpu_module_ms=cpu_ms,
                                  sync_us_per_session=sync_us)
        # Residuals of the overdetermined §V-D fit.
        for n_fpga, improv, total, tag in (
                (1, PAPER_BW_IMPROVEMENT_1ACC, PAPER_CASE1_MS, "bw_1acc"),
                (3, PAPER_BW_IMPROVEMENT_3ACC, PAPER_CASE3_MS, "bw_3acc")):
            model = self._bandwidth_improvement(n_fpga)
            self.calibration_residuals[tag] = model - improv
        return self.host

    # ------------------------------------------------------------------
    def run_case(self, n_fpga_modules: int, quota: int = PAPER_QUOTA_LO,
                 seed: int = 0) -> UseCaseResult:
        """Execute one elasticity case end-to-end (bit-exact data + time model)."""
        if not 1 <= n_fpga_modules <= 3:
            raise ValueError("cases are 1..3 modules on the FPGA")
        assert self.host is not None
        rng = np.random.default_rng(seed)
        data = rng.integers(0, 1 << 26, size=self.n_words, dtype=np.uint32)

        # --- bit-exact data path (FPGA or CPU — same functions, by design).
        x = data
        for mod in self.modules:
            x, _ = mod.process(x)
        expected = (data.astype(np.uint64) * np.uint64(self.constant)
                    ).astype(np.uint32) & np.uint32((1 << 26) - 1)
        data_ok = bool(np.array_equal(x & np.uint32((1 << 26) - 1), expected))

        # --- timing model.
        on_fpga = self.modules[:n_fpga_modules]
        n_cpu = 3 - n_fpga_modules
        cycles = chain_cc(self.n_words, quota, on_fpga)
        sessions = host_sync_sessions(self.n_words, quota)
        fpga_ms = 1e3 * cycles / FPGA_CLOCK_HZ
        sync_ms = sessions * self.host.sync_us_per_session * 1e-3
        cpu_ms = n_cpu * self.host.cpu_module_ms
        total = self.host.pcie_base_ms + fpga_ms + sync_ms + cpu_ms
        return UseCaseResult(case=n_fpga_modules, quota=quota, total_ms=total,
                             fpga_ms=fpga_ms, cpu_ms=cpu_ms, sync_ms=sync_ms,
                             fpga_cycles=cycles, sessions=sessions,
                             output=x, data_ok=data_ok)

    def _bandwidth_improvement(self, n_fpga_modules: int) -> float:
        lo = self.run_case(n_fpga_modules, PAPER_QUOTA_LO).total_ms
        hi = self.run_case(n_fpga_modules, PAPER_QUOTA_HI).total_ms
        return (lo - hi) / lo

    def figure5(self, quota: int = PAPER_QUOTA_LO) -> Dict[int, float]:
        """Execution time (ms) for cases 1..3 — the paper's Fig 5."""
        return {k: self.run_case(k, quota).total_ms for k in (1, 2, 3)}

    def bandwidth_table(self) -> Dict[int, float]:
        """§V-D: relative improvement from quota 16 -> 128, per case."""
        return {k: self._bandwidth_improvement(k) for k in (1, 2, 3)}
