"""Register file of the proposed system — exact Table III layout.

The register file is the *reconfiguration surface* of the paper's design: the
FPGA Elastic Resource Manager achieves elasticity by rewriting only these
registers (destination addresses, allowed-address isolation masks, and the
per-(slave, master) package quotas that implement dynamic bandwidth
allocation), never by touching the tenant modules themselves (§IV-D, §IV-E).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List


class RegAddr(enum.IntEnum):
    """Table III register addresses (byte addresses, 32-bit registers)."""

    DEVICE_ID = 0x00
    PR1_DEST = 0x04
    PR2_DEST = 0x08
    PR3_DEST = 0x0C
    RESET = 0x10                 # Reset PR regions and ports [3:0]
    ALLOWED_PORT0 = 0x14         # Allowed Addresses of Port 0 Master (one-hot mask)
    ALLOWED_PORT1 = 0x18
    ALLOWED_PORT2 = 0x1C
    ALLOWED_PORT3 = 0x20
    PKGS_PORT0 = 0x24            # Package numbers allowed in port 0 for ports [3:0]
    PKGS_PORT1 = 0x28
    PKGS_PORT2 = 0x2C
    PKGS_PORT3 = 0x30
    APP0_DEST = 0x34
    APP1_DEST = 0x38
    APP2_DEST = 0x3C
    APP3_DEST = 0x40
    PR_ERROR_STATUS = 0x44       # PR region [3:1] last transaction error status
    APP_ERROR_STATUS = 0x48      # App. ID [3:0] last transaction error status
    ICAP_STATUS = 0x4C

    @classmethod
    def allowed(cls, port: int) -> "RegAddr":
        return cls(cls.ALLOWED_PORT0 + 4 * port)

    @classmethod
    def pkgs(cls, port: int) -> "RegAddr":
        return cls(cls.PKGS_PORT0 + 4 * port)

    @classmethod
    def pr_dest(cls, region: int) -> "RegAddr":
        if not 1 <= region <= 3:
            raise ValueError("paper exposes destination registers for PR regions 1..3")
        return cls(cls.PR1_DEST + 4 * (region - 1))

    @classmethod
    def app_dest(cls, app_id: int) -> "RegAddr":
        return cls(cls.APP0_DEST + 4 * app_id)


N_REGISTERS = 20  # "Our current implementation uses 20 registers" (§V-F)


@dataclass
class RegisterFile:
    """A 20-register, 32-bit register file with the paper's field packing.

    Package-quota registers pack one 8-bit quota per master port:
    ``PKGS_PORTj[8*i+7 : 8*i]`` = packages master ``i`` may send to slave ``j``
    per grant session ("allowed number of packages", §IV-E.1). Allowed-address
    registers hold a one-hot mask over slave ports (§IV-E.2): bit ``j`` set ⇔
    this master may target slave ``j``. Error-status registers pack one 4-bit
    code per region / application ID.
    """

    n_ports: int = 4
    regs: Dict[int, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        for addr in RegAddr:
            self.regs.setdefault(int(addr), 0)
        if not self.regs[int(RegAddr.DEVICE_ID)]:
            self.regs[int(RegAddr.DEVICE_ID)] = 0x4B435531  # "KCU1" device id tag

    # --- raw access -------------------------------------------------------
    def read(self, addr: int) -> int:
        if int(addr) not in self.regs:
            raise KeyError(f"invalid register address {hex(addr)}")
        return self.regs[int(addr)]

    def write(self, addr: int, value: int) -> None:
        if int(addr) not in self.regs:
            raise KeyError(f"invalid register address {hex(addr)}")
        self.regs[int(addr)] = value & 0xFFFFFFFF

    # --- typed fields -----------------------------------------------------
    def set_allowed_mask(self, master_port: int, mask: int) -> None:
        self.write(RegAddr.allowed(master_port), mask)

    def allowed_mask(self, master_port: int) -> int:
        return self.read(RegAddr.allowed(master_port))

    def set_quota(self, slave_port: int, master_port: int, packages: int) -> None:
        """Set packages master ``master_port`` may send to slave ``slave_port``."""
        if not 0 <= packages <= 0xFF:
            raise ValueError("8-bit package quota")
        reg = self.read(RegAddr.pkgs(slave_port))
        shift = 8 * master_port
        reg = (reg & ~(0xFF << shift)) | (packages << shift)
        self.write(RegAddr.pkgs(slave_port), reg)

    def quota(self, slave_port: int, master_port: int) -> int:
        return (self.read(RegAddr.pkgs(slave_port)) >> (8 * master_port)) & 0xFF

    def quota_row(self, slave_port: int) -> List[int]:
        return [self.quota(slave_port, m) for m in range(self.n_ports)]

    def set_pr_dest(self, region: int, dest_onehot: int) -> None:
        self.write(RegAddr.pr_dest(region), dest_onehot)

    def pr_dest(self, region: int) -> int:
        return self.read(RegAddr.pr_dest(region))

    def set_app_dest(self, app_id: int, dest_onehot: int) -> None:
        self.write(RegAddr.app_dest(app_id), dest_onehot)

    def app_dest(self, app_id: int) -> int:
        return self.read(RegAddr.app_dest(app_id))

    def set_reset(self, port: int, asserted: bool) -> None:
        reg = self.read(RegAddr.RESET)
        reg = (reg | (1 << port)) if asserted else (reg & ~(1 << port))
        self.write(RegAddr.RESET, reg)

    def in_reset(self, port: int) -> bool:
        return bool(self.read(RegAddr.RESET) >> port & 1)

    def set_pr_error(self, region: int, code: int) -> None:
        """PR region [3:1] last transaction error status, 4 bits per region."""
        reg = self.read(RegAddr.PR_ERROR_STATUS)
        shift = 4 * (region - 1)
        reg = (reg & ~(0xF << shift)) | ((code & 0xF) << shift)
        self.write(RegAddr.PR_ERROR_STATUS, reg)

    def pr_error(self, region: int) -> int:
        return (self.read(RegAddr.PR_ERROR_STATUS) >> (4 * (region - 1))) & 0xF

    def set_app_error(self, app_id: int, code: int) -> None:
        reg = self.read(RegAddr.APP_ERROR_STATUS)
        shift = 4 * app_id
        reg = (reg & ~(0xF << shift)) | ((code & 0xF) << shift)
        self.write(RegAddr.APP_ERROR_STATUS, reg)

    def app_error(self, app_id: int) -> int:
        return (self.read(RegAddr.APP_ERROR_STATUS) >> (4 * app_id)) & 0xF

    def set_icap_status(self, status: int) -> None:
        self.write(RegAddr.ICAP_STATUS, status)

    def icap_status(self) -> int:
        return self.read(RegAddr.ICAP_STATUS)
