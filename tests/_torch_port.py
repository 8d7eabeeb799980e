"""Shared helpers of the ``test_torch_*`` files: seeded numpy inputs handed
to both the JAX package and the PyTorch port, and conversions between
them.  JAX stays on the CPU; data crosses as numpy arrays."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from repro.core.registers import CrossbarRegisters as JaxRegisters
from repro_torch.core.registers import CrossbarRegisters as TorchRegisters

REG_FIELDS = ("dest", "allowed", "quota", "capacity", "reset", "error",
              "version")
PLAN_FIELDS = ("keep", "slot", "dst", "error", "counts", "drops")


def np_registers(rng: np.random.Generator, n: int, *, capacity: int = 8,
                 holes: bool = True):
    """Seeded random register contents: isolation holes, quotas (0 ==
    unlimited), per-port capacities and a reset port."""
    allowed = np.ones((n, n), bool)
    quota = np.zeros((n, n), np.int32)
    cap = np.full((n,), capacity, np.int32)
    reset = np.zeros((n,), bool)
    if holes:
        allowed = rng.random((n, n)) > 0.2
        quota = np.where(rng.random((n, n)) > 0.5,
                         rng.integers(1, 6, (n, n)), 0).astype(np.int32)
        cap = rng.integers(1, capacity + 1, (n,)).astype(np.int32)
        reset[rng.integers(0, n)] = n > 2
    return dict(dest=(np.arange(n) % n).astype(np.int32), allowed=allowed,
                quota=quota, capacity=cap, reset=reset,
                error=np.zeros((n,), np.int32), version=np.int32(0))


def jax_registers(d) -> JaxRegisters:
    return JaxRegisters(**{k: jnp.asarray(v) for k, v in d.items()})


def torch_registers(d, device="cpu") -> TorchRegisters:
    return TorchRegisters(**{k: torch.as_tensor(np.asarray(v), device=device)
                             for k, v in d.items()})


def np_packets(rng, T: int, n: int, *, pad: float = 0.1, n_src=None):
    """[T] dst (with ``-1`` padding rows and a few out-of-range ports) and
    [T] src."""
    dst = rng.integers(0, n, T).astype(np.int32)
    dst[rng.random(T) < pad] = -1
    dst[rng.random(T) < pad / 4] = n            # out of range: dropped
    src = rng.integers(0, n if n_src is None else n_src, T).astype(np.int32)
    return dst, src


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def assert_same_plan(jplan, tplan) -> None:
    for f in PLAN_FIELDS:
        a, b = to_np(getattr(jplan, f)), to_np(getattr(tplan, f))
        assert np.array_equal(a, b), (f, a, b)


def assert_same_registers(jregs, tregs, fields=REG_FIELDS) -> None:
    for f in fields:
        a, b = to_np(getattr(jregs, f)), to_np(getattr(tregs, f))
        assert np.array_equal(a, b), (f, a, b)


def smoke_mixtral(dispatch: str, **moe_kw):
    """The smoke Mixtral config of a package's registry, float32, with its
    MoE on ``dispatch``."""
    def _cfg(get_config):
        cfg = get_config("mixtral_8x7b", smoke=True)
        return dataclasses.replace(
            cfg, dtype="float32",
            moe=dataclasses.replace(cfg.moe, dispatch=dispatch, **moe_kw))
    return _cfg
