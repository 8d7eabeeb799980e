"""Registers, arbitration and the module/region records of the port."""
from repro_torch.core.registers import validate_registers  # noqa: F401
