"""Crossbar-dispatch kernels: plan_multi, scatter, combine."""
