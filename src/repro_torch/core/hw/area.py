"""Analytical area/power model calibrated to Tables I & II of the paper.

FPGA area (LUT/FF/BRAM) has no TPU analogue, so this model intentionally stays
in FPGA units; it exists to reproduce the paper's §V-F/§V-G comparisons:

- 4x4 WB crossbar: 475 LUT / 60 FF / 0 BRAM / 1 mW,
- 61% fewer LUTs and 95% fewer FFs than the 2x2 NoC of Mbongue et al. [16]
  (1220 LUT / 1240 FF / 80 mW), and 80x less power,
- 48.6% more LUTs / 46.4% fewer FFs than 4x the E-WB shared bus of [21],
- request completion 13 cc vs 22 cc traversing only src+dst NoC routers
  (the headline "69% less" corresponds to a ~4-router path; both reported),
- LZC-arbiter area grows quadratically in port count; worst-case latency
  grows linearly in the number of contending masters (Fig 6).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.hw.crossbar import request_completion_cc, worst_case_completion_cc

# Table I (KCU1500 / XCKU115): component -> (LUT, FF, BRAM)
TABLE_I: Dict[str, tuple] = {
    "xdma_ip_core":        (33441, 30843, 62.0),
    "wb_crossbar":         (475,   60,    0.0),
    "wb_hamming_decoder":  (432,   646,   0.0),
    "wb_master_interface": (213,   27,    0.0),
    "wb_slave_interface":  (115,   220,   0.0),
    "hamming_decoder":     (104,   399,   0.0),
    "wb_hamming_encoder":  (233,   99,    0.0),
    "wb_multiplier":       (138,   624,   0.0),
    "axi_wb_fifo_system":  (975,   1842,  13.5),
    "wb_axi_fifo_system":  (389,   2274,  13.5),
    "register_file":       (265,   560,   0.0),
    "total":               (36348, 36948, 89.0),
}

# Table II comparison points.
NOC_2X2_LUT, NOC_2X2_FF, NOC_POWER_MW = 1220, 1240, 80.0
CROSSBAR_SYSTEM_LUT, CROSSBAR_SYSTEM_FF = 1599, 796
EWB_4X_LUT, EWB_4X_FF = 1076, 1484
CROSSBAR_POWER_MW = 1.0

# Derived per-port interface cost (Table II system minus bare crossbar, /4).
_PORT_IF_LUT = (CROSSBAR_SYSTEM_LUT - 475) // 4    # 281 = 196 (master) + 85 (slave)
_PORT_IF_FF = (CROSSBAR_SYSTEM_FF - 60) // 4       # 184

# NoC per-router flit model (§V-G): head flit 2 cc, each remaining flit 1 cc;
# 8 data words => 10 flits (head + tail + 8 body) => 11 cc per router.
_NOC_CC_PER_ROUTER = 2 + 9


@dataclass
class AreaModel:
    """Scalable area model anchored at the measured 4-port design."""

    base_ports: int = 4
    base_crossbar_lut: int = 475
    base_crossbar_ff: int = 60

    def crossbar_lut(self, n_ports: int) -> float:
        """LUTs ~ quadratic in ports: the muxes + LZC arbiter dominate (§V-G)."""
        return self.base_crossbar_lut * (n_ports / self.base_ports) ** 2

    def crossbar_ff(self, n_ports: int) -> float:
        """FFs ~ linear: grant/package-counter state per port."""
        return self.base_crossbar_ff * (n_ports / self.base_ports)

    def system_lut(self, n_ports: int) -> float:
        return self.crossbar_lut(n_ports) + n_ports * _PORT_IF_LUT

    def system_ff(self, n_ports: int) -> float:
        return self.crossbar_ff(n_ports) + n_ports * _PORT_IF_FF

    # --- paper's comparative claims ------------------------------------
    def lut_saving_vs_noc(self) -> float:
        return 1.0 - 475 / NOC_2X2_LUT            # 61.1%

    def ff_saving_vs_noc(self) -> float:
        return 1.0 - 60 / NOC_2X2_FF              # 95.2%

    def power_ratio_vs_noc(self) -> float:
        return NOC_POWER_MW / CROSSBAR_POWER_MW   # 80x

    def lut_overhead_vs_ewb(self) -> float:
        return CROSSBAR_SYSTEM_LUT / EWB_4X_LUT - 1.0   # +48.6%

    def ff_saving_vs_ewb(self) -> float:
        return 1.0 - CROSSBAR_SYSTEM_FF / EWB_4X_FF     # 46.4%

    @staticmethod
    def noc_completion_cc(n_routers: int = 2) -> int:
        return _NOC_CC_PER_ROUTER * n_routers

    def latency_saving_vs_noc(self, n_routers: int = 2) -> float:
        """13 cc vs 11·R cc. R=2 (paper's explicit arithmetic) gives 40.9%;
        the headline 69% matches a ~4-router path (70.5%)."""
        return 1.0 - request_completion_cc(8) / self.noc_completion_cc(n_routers)

    @staticmethod
    def worst_case_latency_curve(max_masters: int = 8, n_words: int = 8):
        """Fig 6: worst-case completion latency vs number of PR regions."""
        return {n: worst_case_completion_cc(n, n_words)
                for n in range(1, max_masters + 1)}

    @staticmethod
    def register_count(n_regions: int = 3) -> int:
        """§V-G: each extra PR region adds 3 registers (allowed addresses,
        package quota, destination address) on top of the base file."""
        base = 20 - 3 * 3   # the prototype's 20 registers serve 3 PR regions
        return base + 3 * n_regions
