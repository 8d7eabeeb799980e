"""Mixture-of-Experts layer routed through the paper's crossbar.

Sources are token groups (master ports), destinations are experts (slave
ports), the expert capacity is the receive-slab depth, and ``expert_mask``
is the tenant's isolation row.  Over-capacity and masked packets drop with
the paper's error codes, which surface as the router's drop statistics.

``moe_apply`` dispatches on ``dispatch_impl``, as the JAX package's does:

- ``"dense"`` (the default, as in the JAX package): the Mesh-TF one-hot
  formulation, dispatch and combine as ``torch.einsum`` over a
  [G, g*k, E, C] selection tensor;
- ``"gather"`` (:func:`moe_apply_gather`): the same grants by indexed
  scatter and gather, no selection tensor;
- any name registered as a fabric backend (``"reference"``, ``"cuda"``,
  ``"cuda_kernel"``): every group through one ``Fabric`` round-trip
  (:func:`moe_apply_fabric`); ``cuda_kernel`` runs the crossbar kernels;
- ``"sharded"`` (:func:`moe_apply_sharded`): mesh expert parallelism over
  the ranks of a ``torch.distributed`` process group (``group``, where the
  JAX package names a mesh axis): experts are slave ports partitioned
  across the ranks, tokens cross them through the sharded fabric
  backend's global-WRR ``all_to_all``, packets move through the scatter
  and combine kernels.  :func:`moe_forward_sharded` is the wrapper that
  takes global tensors on every rank.

On a tensor-parallel rank (``shard``, a ``parallel.ShardCtx``; the dense,
gather and fabric impls) the experts are replicated over the ``model``
axis and each rank holds its block of every expert's ``d_ff``: the router
runs on the rank's tokens (replicated over ``model``), the tokens entering
the experts and the combine weights take ``shard.tp_in`` (their gradients
are partial on each rank), the combined partial sums take ``shard.tp_out``
and the load-balance loss is computed from grants and router
probabilities summed over the batch axes (``shard.batch_sum``), so that it
is the global batch's.

All three give the fabric's packet semantics: a packet's slot is its rank
among its group's packets to the same expert (the WRR package counter), it
is dropped at rank >= capacity, and it is dropped when ``expert_mask``
forbids its expert.  The stats carry the JAX package's keys plus
``counts``, the grants per expert.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.registers import ErrorCode
from repro_torch.fabric import collectives as coll
from repro_torch.models.common import ParamDef
from repro_torch.models.config import MoEConfig
from repro_torch.models.mlp import gated_act


def moe_defs(d_model: int, d_ff: int, moe: MoEConfig,
             act: str) -> Dict[str, ParamDef]:
    f_in = 2 * d_ff if act in ("swiglu", "geglu") else d_ff
    return {
        "w_router": ParamDef((d_model, moe.n_experts), ("fsdp", None)),
        "w_in": ParamDef((moe.n_experts, d_model, f_in),
                         (None, "fsdp", "tp")),
        "w_out": ParamDef((moe.n_experts, d_ff, d_model),
                          (None, "tp", "fsdp")),
    }


def expert_capacity(group_tokens: int, moe: MoEConfig,
                    multiple: int = 8) -> int:
    c = math.ceil(moe.capacity_factor * group_tokens * moe.top_k
                  / moe.n_experts)
    return max(multiple, math.ceil(c / multiple) * multiple)


def moe_apply(params, x: torch.Tensor, moe: MoEConfig, act: str, *,
              group_size: int = 1024,
              expert_mask: Optional[torch.Tensor] = None,
              dispatch_impl: str = "dense",
              registers=None, group=None,
              capacity: Optional[int] = None,
              kernel_mode: Optional[str] = None, shard=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, S, d] -> (y [B, S, d], stats).

    ``expert_mask``: optional [E] bool, the tenant's allowed-destinations
    register; packets to a disallowed expert drop (``stats["iso_dropped"]``).
    ``dispatch_impl``: ``"dense"``, ``"gather"``, ``"sharded"`` or a fabric
    backend's name (see the module docstring).  ``"sharded"`` runs on every
    rank of ``group`` with this rank's tokens and expert block and routes
    through :func:`moe_apply_sharded` (``registers`` and ``capacity`` pass
    through, ``group_size`` is ignored: the rank is the group).
    ``kernel_mode`` selects the fabric's lowering; the dense and gather
    impls run no crossbar kernel and ignore it.  ``shard``: this rank's
    view of a tensor-parallel mesh (see the module doc)."""
    if dispatch_impl == "gather":
        return moe_apply_gather(params, x, moe, act, group_size=group_size,
                                expert_mask=expert_mask, shard=shard)
    if dispatch_impl == "sharded":
        if shard is not None:
            raise NotImplementedError(
                "expert parallelism inside a tensor-parallel layer")
        return moe_apply_sharded(params, x, moe, act, registers=registers,
                                 group=group, expert_mask=expert_mask,
                                 capacity=capacity, kernel_mode=kernel_mode)
    if dispatch_impl != "dense":
        return moe_apply_fabric(params, x, moe, act, group_size=group_size,
                                expert_mask=expert_mask,
                                backend=dispatch_impl,
                                kernel_mode=kernel_mode, shard=shard)
    B, S, d = x.shape
    E, k = moe.n_experts, moe.top_k
    G, g, dst, w, probs, cap, keep, rank, iso_dropped = _grouped_grants(
        params, x, moe, group_size, expert_mask)
    x, w = _tp_in(shard, x), _tp_in(shard, w)
    sel = (torch.nn.functional.one_hot(dst.long(), E).to(x.dtype)
           * keep[..., None].to(x.dtype))                  # [G, gk, E]
    slot = torch.where(keep, rank, 0)
    slot_oh = torch.nn.functional.one_hot(slot.long(), cap).to(x.dtype)
    disp = sel[..., :, None] * slot_oh[..., None, :]       # [G, gk, E, C]

    xk = x.reshape(G, g, d).repeat_interleave(k, dim=1)    # [G, gk, d]
    xe = torch.einsum("gtec,gtd->gecd", disp, xk)          # [G, E, C, d]
    ye = torch.stack([_expert_ffn(xe[i], params["w_in"], params["w_out"],
                                  act) for i in range(G)])
    comb = disp * w[..., None, None]
    y = torch.einsum("gtec,gecd->gtd", comb, ye)           # [G, gk, d]
    y = y.reshape(G, g, k, d).sum(dim=2).reshape(B, S, d)
    return _tp_out(shard, y), _stats(keep, dst, probs, E, iso_dropped, cap,
                                     shard)


def _tp_in(shard, t: torch.Tensor) -> torch.Tensor:
    return t if shard is None else shard.tp_in(t)


def _tp_out(shard, t: torch.Tensor) -> torch.Tensor:
    return t if shard is None else shard.tp_out(t)


def _aux_loss(counts, n_packets: int, probs, n_experts: int, shard):
    """The load-balance loss: granted fraction x mean router probability
    per expert, over the global batch on a tensor-parallel rank."""
    if shard is None or not shard.batch:
        frac_tokens = (counts / n_packets).float()
        return n_experts * torch.sum(frac_tokens * probs.mean(0))
    n = shard.batch_shards
    counts = shard.batch_sum(counts)
    mean_p = shard.batch_sum(probs.sum(0)) / (probs.shape[0] * n)
    frac_tokens = (counts / (n_packets * n)).float()
    return n_experts * torch.sum(frac_tokens * mean_p)


def moe_apply_gather(params, x: torch.Tensor, moe: MoEConfig, act: str, *,
                     group_size: int = 1024,
                     expert_mask: Optional[torch.Tensor] = None, shard=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Gather/scatter MoE dispatch: the dense impl's grants with no
    selection tensor.  Each packet goes to the flat slab address
    ``dst * cap + rank`` (``index_add`` onto zeros: every granted address
    is written once, dropped packets add into a trash row that is sliced
    off) and its result comes back with ``index_select``.  FLOPs: experts
    only; bytes O(T*k*d)."""
    B, S, d = x.shape
    E, k = moe.n_experts, moe.top_k
    G, g, dst, w, probs, cap, keep, rank, iso_dropped = _grouped_grants(
        params, x, moe, group_size, expert_mask)
    x, w = _tp_in(shard, x), _tp_in(shard, w)
    rows = E * cap + 1                                     # + the trash row
    slot_addr = torch.where(keep, dst * cap + torch.where(keep, rank, 0),
                            E * cap)                       # [G, gk]
    flat = (slot_addr + rows * torch.arange(
        G, dtype=slot_addr.dtype, device=x.device)[:, None]).reshape(-1)
    xk = x.reshape(G, g, d).repeat_interleave(k, dim=1)    # [G, gk, d]
    slabs = x.new_zeros((G * rows, d)).index_add(0, flat, xk.reshape(-1, d))
    xe = slabs.reshape(G, rows, d)[:, :E * cap].reshape(G, E, cap, d)
    ye = torch.stack([_expert_ffn(xe[i], params["w_in"], params["w_out"],
                                  act) for i in range(G)])
    ye_flat = torch.cat([ye.reshape(G, E * cap, d),
                         ye.new_zeros((G, 1, d))], dim=1).reshape(-1, d)
    back = ye_flat.index_select(0, flat).reshape(G, g * k, d)
    back = back * (w * keep.to(w.dtype))[..., None]
    y = back.reshape(G, g, k, d).sum(dim=2).reshape(B, S, d)
    return _tp_out(shard, y), _stats(keep, dst, probs, E, iso_dropped, cap,
                                     shard)


def _grouped_grants(params, x: torch.Tensor, moe: MoEConfig,
                    group_size: int, expert_mask: Optional[torch.Tensor]):
    """The dense and gather impls' routing and grants: the shared router,
    then each packet's rank among its group's packets to the same expert
    (``cumsum`` of one-hots), kept under the capacity and the mask.

    Returns (G, g, dst [G, gk], w [G, gk], probs [T, E], cap, keep [G, gk]
    bool, rank [G, gk] int32, iso_dropped)."""
    B, S, d = x.shape
    E, k = moe.n_experts, moe.top_k
    T = B * S
    g = min(group_size, T)
    G = T // g
    assert G * g == T, f"tokens {T} not divisible by group size {g}"
    dst, w, probs = _moe_router(params, x.reshape(T, d), moe, expert_mask)
    dst = dst.reshape(G, g * k)
    w = w.reshape(G, g * k)
    cap = expert_capacity(g, moe)
    e_oh = torch.nn.functional.one_hot(dst.long(), E).to(torch.int32)
    rank = (e_oh.cumsum(dim=1, dtype=torch.int32) - e_oh).gather(
        2, dst.long()[..., None])[..., 0]
    keep = rank < cap                                      # WRR quota
    if expert_mask is not None:
        iso_ok = expert_mask[dst.long()]
        keep &= iso_ok
        iso_dropped = (~iso_ok).sum()
    else:
        iso_dropped = torch.zeros((), dtype=torch.int64, device=x.device)
    return G, g, dst, w, probs, cap, keep, rank, iso_dropped


def _stats(keep, dst, probs, n_experts: int, iso_dropped, cap: int,
           shard=None):
    """The dense and gather impls' stats: grants per expert, the
    load-balance aux loss (granted fraction x mean router probability per
    expert, as the fabric impl computes it) and the drop read-back."""
    counts = torch.zeros((n_experts,), dtype=torch.int32, device=keep.device)
    counts.index_add_(0, dst.reshape(-1).long(),
                      keep.reshape(-1).to(torch.int32))
    return {"aux_loss": _aux_loss(counts, keep.numel(), probs, n_experts,
                                  shard),
            "dropped": (~keep).sum(), "iso_dropped": iso_dropped,
            "capacity": torch.tensor(cap), "counts": counts}


@functools.lru_cache(maxsize=None)
def _group_fabric(n_experts: int, capacity: int, backend: str,
                  kernel_mode: Optional[str], device: torch.device, group):
    """One cached fabric per MoE geometry, device and (for the sharded
    backend) process group, so that different groups never share WRR
    geometry.

    The fabric reads its registers through a mutable cell so a call can
    swap in the tenant's isolation mask; the canonical file (all experts
    allowed, no quota, capacity ``capacity``) lives on the device and is
    moved there once."""
    from repro_torch.core.registers import CrossbarRegisters
    from repro_torch.fabric import Fabric
    cell = {"regs": CrossbarRegisters.create(n_experts, capacity=capacity,
                                             device=device)}
    kw = {"group": group} if backend == "sharded" else {}
    # debug off: the JAX package's MoE calls its fabric inside a trace,
    # where an environment-sourced sanitizer does not run
    fabric = Fabric(lambda: cell["regs"], backend=backend, capacity=capacity,
                    kernel_mode=kernel_mode, device=device, debug=False, **kw)
    return fabric, cell


def moe_fabric(n_experts: int, capacity: int, backend: str,
               kernel_mode: Optional[str] = None, device=None, group=None):
    """The cached ``Fabric`` a given MoE geometry dispatches through on
    ``device`` (the card unless ``"cpu"`` is asked for) and, for
    ``"sharded"``, ``group``, so that tests and telemetry can read its
    ``trace_count`` (the pin that a reconfiguration builds nothing) or
    attach its ``probe()``."""
    from repro_torch.core.device import resolve_device
    return _group_fabric(n_experts, capacity, backend,
                         _mode_key(kernel_mode), resolve_device(device),
                         group)[0]


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
                     kernel_mode: Optional[str] = None, shard=None
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
    dst, w, probs = _moe_router(params, x.reshape(T, d), moe, expert_mask)
    xf = _tp_in(shard, x).reshape(G, g, d)
    dst = dst.reshape(G, g * k)
    w = _tp_in(shard, w).reshape(G, g * k)
    cap = expert_capacity(g, moe)

    fabric, cell = _group_fabric(E, cap, backend, _mode_key(kernel_mode),
                                 x.device, None)
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
    aux_loss = _aux_loss(counts.sum(0), G * g * k, probs, E, shard)
    stats = {
        "aux_loss": aux_loss,
        "dropped": sum((~p.keep).sum() for p in plans),
        "iso_dropped": sum(p.drops[ErrorCode.INVALID_DEST] for p in plans),
        "capacity": torch.tensor(cap),
        "counts": counts.sum(0),
        "plans": plans,
    }
    return _tp_out(shard, y), stats


def _sharded_stats(plan, dst, probs, n_experts: int, E_loc: int, cap: int,
                   offered: int, src, reduce=lambda t: t):
    """The sharded impl's stats from its plan (``src`` is each packet's
    owning shard, ``reduce`` sums a local count over the group): the JAX
    package's keys, with the grants split into packets that stayed on
    their source shard and packets that crossed to another."""
    mine = (plan.keep & (dst // E_loc == src)).to(torch.int32)
    local_counts = torch.zeros((n_experts,), dtype=torch.int32,
                               device=dst.device).index_add_(
        0, dst.long(), mine)
    local_counts = reduce(local_counts)
    local = local_counts.sum(dtype=torch.int32)
    granted = plan.counts.sum(dtype=torch.int32)
    offered_t = torch.tensor(offered, dtype=torch.int32, device=dst.device)
    frac_tokens = (plan.counts / offered).float()
    return {
        "aux_loss": n_experts * torch.sum(frac_tokens * probs),
        "dropped": offered_t - granted,
        "iso_dropped": plan.drops[ErrorCode.INVALID_DEST],
        "capacity": torch.tensor(cap),
        "counts": plan.counts,
        "offered_packets": offered_t,
        "granted_packets": granted,
        "local_packets": local,
        "remote_packets": granted - local,
        "local_counts": local_counts,
        "remote_counts": plan.counts - local_counts,
    }


def moe_apply_sharded(params, x: torch.Tensor, moe: MoEConfig, act: str, *,
                      registers=None, group=None,
                      expert_mask: Optional[torch.Tensor] = None,
                      capacity: Optional[int] = None,
                      kernel_mode: Optional[str] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mesh expert parallelism through the sharded fabric backend.

    Runs on every rank of ``group`` (``None``: the default world group;
    ``group`` stands where the JAX package's ``axis_name`` stands; use
    :func:`moe_forward_sharded` for global tensors): ``x`` is this rank's
    [B_loc, S, d] slice, ``params["w_in"]``/``["w_out"]`` are its
    [E_loc, ...] expert block, ``params["w_router"]`` is replicated.
    Tokens cross the ranks through the global-WRR ``all_to_all``
    (``ShardedBackend``); on the card the packets move through the scatter
    and combine kernels.

    ``registers`` is the E-port register file, a value: a
    ``Shell.post(Grow/Shrink/FailRegion)`` re-routes the next call with no
    new signature (``moe_fabric(E, cap, "sharded", group=group)
    .trace_count`` is the pin).  Defaults to a fully open file.
    ``capacity`` defaults to ``expert_capacity(T_loc * n_shards)``.

    Stats beyond the local impls', each summed over the group:
    ``offered_packets``/``granted_packets``, ``counts`` (the global
    per-expert grants), ``local_packets``/``remote_packets`` (grants that
    stayed on their source rank or crossed to another) and their per-port
    splits ``local_counts``/``remote_counts``; ``Fabric.account_stats``
    folds them into the manager's telemetry.
    """
    from repro_torch.core.registers import CrossbarRegisters

    E, k = moe.n_experts, moe.top_k
    B_loc, S, d = x.shape
    T_loc = B_loc * S
    E_loc = params["w_in"].shape[0]
    if E_loc == 0 or E % E_loc:
        raise ValueError(
            f"local expert block ({E_loc}) must divide n_experts ({E}); "
            f"shard w_in/w_out over the group's ranks")
    n_shards = E // E_loc
    cap = (capacity if capacity is not None
           else expert_capacity(T_loc * n_shards, moe))
    if registers is None:
        registers = CrossbarRegisters.create(E, capacity=cap,
                                             device=x.device)
    xf = x.reshape(T_loc, d)
    dst, w, probs = _moe_router(params, xf, moe, expert_mask)

    fabric, _ = _group_fabric(E, cap, "sharded", _mode_key(kernel_mode),
                              x.device, group)
    xk = xf.repeat_interleave(k, dim=0)                    # [T_loc*k, d]
    src = torch.zeros((T_loc * k,), dtype=torch.int32, device=x.device)
    # dispatch and combine apart (not ``transfer``, whose ``apply_fn`` is a
    # signature): the experts' closure is new on every call
    slabs, plan = fabric.dispatch(xk, dst, src, registers=registers)
    ys = _expert_ffn(slabs, params["w_in"], params["w_out"], act)
    y = fabric.combine(ys, plan, weights=w, registers=registers)
    y = y.reshape(T_loc, k, d).sum(dim=1).reshape(B_loc, S, d)

    me = coll.axis_index(group)
    frac_probs = (coll.psum(probs.sum(0), group) / (T_loc * n_shards))
    return y, _sharded_stats(plan, dst, frac_probs, E, E_loc, cap,
                             T_loc * k * n_shards, me,
                             lambda t: coll.psum(t, group))


def moe_apply_sharded_reference(params, x: torch.Tensor, moe: MoEConfig,
                                act: str, *, n_shards: int, registers=None,
                                expert_mask: Optional[torch.Tensor] = None,
                                capacity: Optional[int] = None
                                ) -> Tuple[torch.Tensor,
                                           Dict[str, torch.Tensor]]:
    """Single-device oracle for :func:`moe_apply_sharded`.

    Same router, register file and stats, but the whole batch on one device
    through the *reference* backend, each token's source port set to the
    shard that would own it (the batch laid out shard-major, as
    :func:`moe_forward_sharded` splits it).  The sharded path matches it
    bit for bit on plans and within float tolerance on outputs.
    """
    from repro_torch.core.registers import CrossbarRegisters

    E, k = moe.n_experts, moe.top_k
    B, S, d = x.shape
    T = B * S
    if B % n_shards or E % n_shards:
        raise ValueError(f"batch {B} and n_experts {E} must both divide "
                         f"into {n_shards} shards")
    T_loc = T // n_shards
    E_loc = E // n_shards
    cap = capacity if capacity is not None else expert_capacity(T, moe)
    if registers is None:
        registers = CrossbarRegisters.create(E, capacity=cap,
                                             device=x.device)
    xf = x.reshape(T, d)
    dst, w, probs = _moe_router(params, xf, moe, expert_mask)

    fabric, _ = _group_fabric(E, cap, "reference", None, x.device, None)
    xk = xf.repeat_interleave(k, dim=0)
    src = torch.arange(n_shards, dtype=torch.int32,
                       device=x.device).repeat_interleave(T_loc * k)
    slabs, plan = fabric.dispatch(xk, dst, src, registers=registers)
    ys = _expert_ffn(slabs, params["w_in"], params["w_out"], act)
    y = fabric.combine(ys, plan, weights=w, registers=registers)
    y = y.reshape(T, k, d).sum(dim=1).reshape(B, S, d)
    return y, _sharded_stats(plan, dst, probs.mean(0), E, E_loc, cap,
                             T * k, src)


def moe_forward_sharded(params, x: torch.Tensor, moe: MoEConfig, act: str,
                        *, group=None, registers=None,
                        expert_mask: Optional[torch.Tensor] = None,
                        capacity: Optional[int] = None,
                        kernel_mode: Optional[str] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The wrapper around :func:`moe_apply_sharded` with global tensors.

    Every rank of ``group`` passes the global ``x`` [B, S, d] and the full
    parameters; the wrapper takes this rank's batch slice and expert block
    (both dims must divide by the group's size), and returns the global
    ``y`` (gathered over the batch) and the stats, which are replicated,
    as JAX's ``shard_map`` output is global.  Gradients: every rank gets
    the whole gradient of ``x`` and of every parameter, the replicated
    router's summed over the ranks and the sharded ones gathered, equal to
    the single-device oracle's (:func:`moe_apply_sharded_reference`).
    ``registers`` (replicated, a value) and ``capacity`` (default
    ``expert_capacity(B * S)``) pass through."""
    n = coll.axis_size(group)
    B, S, _ = x.shape
    E = moe.n_experts
    if B % n or E % n:
        raise ValueError(f"batch ({B}) and n_experts ({E}) must be "
                         f"divisible by the group's size ({n})")
    cap = capacity if capacity is not None else expert_capacity(B * S, moe)
    local = {"w_router": coll.replicate(params["w_router"], group),
             "w_in": coll.shard(params["w_in"], 0, group),
             "w_out": coll.shard(params["w_out"], 0, group)}
    y, stats = moe_apply_sharded(
        local, coll.shard(x, 0, group), moe, act, registers=registers,
        group=group, expert_mask=expert_mask, capacity=cap,
        kernel_mode=kernel_mode)
    return coll.gather(y, 0, group), stats
