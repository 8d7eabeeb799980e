"""The fabric's whole plan on the CPU: the port's ``ref.plan_fabric_ref``
(the plain version of the fabric's plan kernel, ``kernel.plan_fabric``, and
the path ``CudaBackend.plan`` takes on the CPU) against the JAX package's
``PallasBackend.plan`` and the port's ``ReferenceBackend.plan``.

Registers are drawn with numpy: isolation holes, a port held in reset,
quotas, capacities that drop packets; packets carry ``dst = -1`` padding
and ``dst`` and ``src`` outside ``[0, S)``.  The JAX backend runs as its own
tests run it on the CPU: its Pallas kernel in interpret mode up to 255
packets, its compiled ``lax.scan`` reference above.  Every field is held
exactly (``np.array_equal``).  The kernel itself is held against these on
the card in ``test_torch_kernels_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (jax_registers, np_packets, np_registers, to_np,
                         torch_registers)
from repro.fabric.backends import PallasBackend
from repro_torch.fabric.backends import CudaBackend, ReferenceBackend
from repro_torch.kernels.crossbar_dispatch import kernel as K
from repro_torch.kernels.crossbar_dispatch import ref

FIELDS = ("keep", "slot", "dst", "error", "counts", "drops")
INTERPRET_T = 255            # the Pallas kernel in interpret mode up to here


def _inputs(T, S, seed):
    rng = np.random.default_rng(seed)
    regs = np_registers(rng, S, capacity=max(1, T // (2 * S)))
    dst, src = np_packets(rng, T, S)
    bad = rng.random(T) < 0.03                  # sources outside [0, S)
    src[bad] = rng.choice(np.array([-2, S, S + 5], np.int32), bad.sum())
    return regs, dst, src


@pytest.mark.parametrize("S", [1, 2, 8, 16, 64])
@pytest.mark.parametrize("T", [1, 2, 255, 2048, 3000])
def test_plan_fabric_ref_matches_jax_and_reference(T, S):
    regs, dst, src = _inputs(T, S, seed=T * 100 + S)
    jp = PallasBackend(interpret=True if T <= INTERPRET_T else None).plan(
        jnp.asarray(dst), jnp.asarray(src), jax_registers(regs))
    tregs = torch_registers(regs)
    td, ts = torch.from_numpy(dst), torch.from_numpy(src)
    fp = ref.plan_fabric_ref(td, ts, tregs.allowed, tregs.reset, tregs.quota,
                             tregs.capacity)
    plans = {"plan_fabric_ref": fp,
             "ReferenceBackend": ReferenceBackend().plan(td, ts, tregs),
             "CudaBackend": CudaBackend().plan(td, ts, tregs),
             "kernel.plan_fabric": K.plan_fabric(
                 td, ts, tregs.allowed, tregs.reset, tregs.quota,
                 tregs.capacity)}
    for name, plan in plans.items():
        for f in FIELDS:
            assert getattr(plan, f).dtype == getattr(fp, f).dtype, (name, f)
            assert np.array_equal(to_np(getattr(jp, f)),
                                  to_np(getattr(plan, f))), (name, f)
    if T >= 2048 and S >= 8:                    # every verdict occurs
        assert all(int(n) > 0 for n in fp.drops), fp.drops


def test_plan_fabric_refuses_cpu_tensors_under_cuda_mode():
    regs, dst, src = _inputs(16, 4, seed=0)
    tregs = torch_registers(regs)
    before = K.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        K.plan_fabric(torch.from_numpy(dst), torch.from_numpy(src),
                      tregs.allowed, tregs.reset, tregs.quota,
                      tregs.capacity, mode="cuda")
    assert K.launch_counts() == before
