"""Where a train cell's dry-run peak and the card's differ.

The dry run costs the plain data plane on the ``meta`` device; the card
runs the kernels.  This prints, for the ``launch`` phase's two train
cells (the served Mixtral-8x7B cut to 2 layers, the whole Mamba-2 780M;
S=4096, B=1), the predicted peak with the plain path and with the plain
attention and SSD scan replaced by stand-ins that allocate what the
kernels' autograd Functions allocate: the flash kernel's outputs and its
saved set (q, k, v, o and the float32 log-sum-exp), the SSD kernel's
outputs and gradients and no chunk temporaries.  No card is needed:

    PYTHONPATH=src python -m repro_torch.launch.peak_gap
"""
from __future__ import annotations

import contextlib
import dataclasses
import json

import torch

from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.models import attention


class _FlashSaved(torch.autograd.Function):
    """The flash kernel's allocations: o and the log-sum-exp forward,
    saved with q, k and v; dq, dk, dv and delta backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        o = torch.empty_like(q)
        lse = q.new_empty((q.shape[0], q.shape[2], q.shape[1]),
                          dtype=torch.float32)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = torch.empty_like(lse)
        del delta
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _ssd_call(x, dA, dt, Bm, Cm, *, chunk, h0=None, mode=None):
    B, H, _, P = x.shape
    return torch.empty_like(x), x.new_empty((B, H, P, Bm.shape[-1]),
                                            dtype=torch.float32)


def _ssd_call_bwd(x, dA, dt, Bm, Cm, dy, *, chunk, h0=None, dh_last=None,
                  mode=None):
    return (torch.empty_like(x), torch.empty_like(dA), torch.empty_like(dt),
            torch.empty_like(Bm), torch.empty_like(Cm),
            None if h0 is None else torch.empty_like(h0))


@contextlib.contextmanager
def kernel_allocations():
    """The plain attention and SSD scan allocating as their kernels do."""
    saved = (attention._attention_chunked, ssd_kernel.ssd_call,
             ssd_kernel.ssd_call_bwd)
    attention._attention_chunked = lambda q, k, v, **kw: _FlashSaved.apply(
        q, k, v)
    ssd_kernel.ssd_call, ssd_kernel.ssd_call_bwd = _ssd_call, _ssd_call_bwd
    try:
        yield
    finally:
        (attention._attention_chunked, ssd_kernel.ssd_call,
         ssd_kernel.ssd_call_bwd) = saved


def main() -> None:
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _cell_costs
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.config import ShapeConfig
    mixtral = get_config("mixtral_8x7b")
    cells = {
        "mixtral_train": dataclasses.replace(
            mixtral, n_layers=2, remat="nothing",
            moe=dataclasses.replace(mixtral.moe, dispatch="cuda_kernel")),
        "mamba_train": get_config("mamba2_780m"),
    }
    shape = ShapeConfig("train_4k_b1", 4096, 1, "train")
    for name, cfg in cells.items():
        plain = _cell_costs(cfg, shape, make_smoke_mesh(), False, 1)[3]
        with kernel_allocations():
            kernel = _cell_costs(cfg, shape, make_smoke_mesh(), False, 1)[3]
        print(json.dumps({"cell": name, "peak_plain": plain,
                          "peak_kernel_allocations": kernel}), flush=True)


if __name__ == "__main__":
    main()
