"""Mixture-of-Experts layer routed through the paper's crossbar.

Sources are token groups (master ports), destinations are experts (slave
ports), the expert capacity is the receive-slab depth, and ``expert_mask``
is the tenant's isolation row.  Over-capacity and masked packets drop with
the paper's error codes, which surface as the router's drop statistics.

``moe_apply`` dispatches on ``dispatch_impl``: any name registered as a
fabric backend (``"reference"``, ``"cuda"``, ``"cuda_kernel"``) routes every
group through one ``Fabric`` round-trip (:func:`moe_apply_fabric`).  The
JAX package's ``"dense"``, ``"gather"`` and ``"sharded"`` impls are not
ported.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.registers import ErrorCode
from repro_torch.models.common import ParamDef
from repro_torch.models.config import MoEConfig
from repro_torch.models.mlp import gated_act


def moe_defs(d_model: int, d_ff: int, moe: MoEConfig,
             act: str) -> Dict[str, ParamDef]:
    f_in = 2 * d_ff if act in ("swiglu", "geglu") else d_ff
    return {
        "w_router": ParamDef((d_model, moe.n_experts)),
        "w_in": ParamDef((moe.n_experts, d_model, f_in)),
        "w_out": ParamDef((moe.n_experts, d_ff, d_model)),
    }


def expert_capacity(group_tokens: int, moe: MoEConfig,
                    multiple: int = 8) -> int:
    c = math.ceil(moe.capacity_factor * group_tokens * moe.top_k
                  / moe.n_experts)
    return max(multiple, math.ceil(c / multiple) * multiple)


def moe_apply(params, x: torch.Tensor, moe: MoEConfig, act: str, *,
              group_size: int = 1024,
              expert_mask: Optional[torch.Tensor] = None,
              dispatch_impl: str = "cuda_kernel",
              kernel_mode: Optional[str] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, S, d] -> (y [B, S, d], stats), through a fabric backend."""
    from repro_torch.fabric.backends import is_fabric_backend
    if not is_fabric_backend(dispatch_impl):
        raise NotImplementedError(
            f"MoE dispatch {dispatch_impl!r} is not ported; use a fabric "
            f"backend ('reference', 'cuda', 'cuda_kernel')")
    return moe_apply_fabric(params, x, moe, act, group_size=group_size,
                            expert_mask=expert_mask, backend=dispatch_impl,
                            kernel_mode=kernel_mode)


@functools.lru_cache(maxsize=None)
def _group_fabric(n_experts: int, capacity: int, backend: str,
                  kernel_mode: Optional[str], device: torch.device):
    """One cached fabric per MoE geometry and device.

    The fabric reads its registers through a mutable cell so a call can
    swap in the tenant's isolation mask; the canonical file (all experts
    allowed, no quota, capacity ``capacity``) lives on the device and is
    moved there once."""
    from repro_torch.core.registers import CrossbarRegisters
    from repro_torch.fabric import Fabric
    cell = {"regs": CrossbarRegisters.create(n_experts, capacity=capacity,
                                             device=device)}
    fabric = Fabric(lambda: cell["regs"], backend=backend, capacity=capacity,
                    kernel_mode=kernel_mode, device=device)
    return fabric, cell


def _mode_key(kernel_mode: Optional[str]) -> Optional[str]:
    # "auto" and None both mean "resolve from the device": one cache entry
    return None if kernel_mode == "auto" else kernel_mode


def _moe_router(params, xf: torch.Tensor, moe: MoEConfig,
                expert_mask: Optional[torch.Tensor]):
    """Flat tokens [T, d] -> (dst [T*k] int32, w [T*k], probs [T, E]):
    token-major packets, k per token, with renormalised top-k weights."""
    k = moe.top_k
    logits = (xf @ params["w_router"]).float()
    if expert_mask is not None:
        logits = torch.where(expert_mask[None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return (top_e.reshape(-1).to(torch.int32),
            top_p.reshape(-1).to(xf.dtype), probs)


def _expert_ffn(slabs: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
                act: str) -> torch.Tensor:
    """The expert MLP over receive slabs [E, C, d]."""
    h = gated_act(torch.bmm(slabs, w_in), act, slabs.dtype)
    return torch.bmm(h, w_out)


def moe_apply_fabric(params, x: torch.Tensor, moe: MoEConfig, act: str, *,
                     group_size: int = 1024,
                     expert_mask: Optional[torch.Tensor] = None,
                     backend: str = "reference",
                     kernel_mode: Optional[str] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MoE dispatch as a fabric transfer per token group.

    Each group's packets are planned, scattered into expert slabs, run
    through the expert FFN and combined back with the router weights; on
    ``cuda_kernel`` that is the fabric's plan kernel (``plan_fabric``),
    ``scatter`` and ``combine``.  The groups run in a loop (the JAX
    package vmaps them)."""
    B, S, d = x.shape
    E, k = moe.n_experts, moe.top_k
    T = B * S
    g = min(group_size, T)
    G = T // g
    assert G * g == T, f"tokens {T} not divisible by group size {g}"
    xf = x.reshape(G, g, d)
    dst, w, probs = _moe_router(params, x.reshape(T, d), moe, expert_mask)
    dst = dst.reshape(G, g * k)
    w = w.reshape(G, g * k)
    cap = expert_capacity(g, moe)

    fabric, cell = _group_fabric(E, cap, backend, _mode_key(kernel_mode),
                                 x.device)
    canonical = cell["regs"]
    if expert_mask is not None:
        cell["regs"] = dataclasses.replace(
            canonical, allowed=expert_mask[None, :].expand(E, E).clone())
    src = torch.zeros((g * k,), dtype=torch.int32, device=x.device)

    def experts_fn(slabs):                                 # [E, C, d]
        return _expert_ffn(slabs, params["w_in"], params["w_out"], act)

    ys, plans = [], []
    try:
        for i in range(G):
            xk = xf[i].repeat_interleave(k, dim=0)         # [gk, d]
            slabs, plan = fabric.dispatch(xk, dst[i], src)
            ys.append(fabric.combine(experts_fn(slabs), plan, weights=w[i]))
            plans.append(plan)
    finally:
        cell["regs"] = canonical
    y = torch.stack(ys).reshape(G, g, k, d).sum(dim=2).reshape(B, S, d)

    counts = torch.stack([p.counts for p in plans])
    frac_tokens = (counts.sum(0) / (G * g * k)).float()
    aux_loss = E * torch.sum(frac_tokens * probs.mean(0))
    stats = {
        "aux_loss": aux_loss,
        "dropped": sum((~p.keep).sum() for p in plans),
        "iso_dropped": sum(p.drops[ErrorCode.INVALID_DEST] for p in plans),
        "capacity": torch.tensor(cap),
        "plans": plans,
    }
    return y, stats
