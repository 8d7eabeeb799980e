"""Registers, arbitration and the module/region records of the port."""
