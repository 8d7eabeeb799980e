"""Pluggable data-plane backends for :class:`repro_torch.fabric.Fabric`.

Every backend realises the same interconnect contract (plan grant
decisions from the live register file, dispatch packets into destination
slabs, combine results back to packet order) and all of them are
plan-equivalent: identical ``keep``/``slot``/``error``/``counts`` for the
same packets and registers.

- ``reference``: the plain plan (``arbiter.wrr_dispatch_plan``) and the
  shared flat-address scatter/gather of ``repro_torch.core.arbiter``.
- ``cuda`` (alias ``pallas``): ONE launch of the fabric's plan kernel
  (``kernel.plan_fabric``) computes the whole plan from the register file:
  every (src, dst) stream's ranks and iso/quota verdicts, the global WRR
  slots of the shared closed form ``arbiter.wrr_slots``, the capacity cut,
  counts and drops (its plain version, ``ref.plan_fabric_ref``, on the CPU
  and under ``KernelMode.TORCH``).  Data moves through the shared scatter
  by default; ``data_plane="kernel"`` moves it with the scatter and
  combine kernels instead.
- ``cuda_kernel``: ``CudaBackend(data_plane="kernel")``, all three kernels.
- ``sharded``: regions are the ranks of a ``torch.distributed`` process
  group (where the JAX package has a mesh axis).  ``dispatch`` scatters
  local packets into a flat send slab and ``all_to_all``s it; ``combine``
  routes *addresses* across the group (a second ``all_to_all`` pair) so
  each rank pulls exactly its own packets' result rows: bytes between
  ranks scale with packets, not with ``n_ports * capacity`` slabs.  The
  per-source granted counts are ``all_gather``-ed so every rank computes
  the same global WRR slots the single-device plan assigns.  The register
  file's ``n_ports`` destinations partition contiguously into
  ``n_ports // group size`` slave ports per rank (MoE expert parallelism:
  experts are slave ports, each rank owns an expert block), while source
  ids stay the ranks.  Packets move through the scatter and combine
  kernels on the card (their plain versions on the CPU).

Registers are values (kernel arguments), so a register rewrite re-routes
traffic through the kernels already loaded.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import arbiter
from repro_torch.core.arbiter import DispatchPlan, wrr_slots
from repro_torch.core.registers import CrossbarRegisters, ErrorCode
from repro_torch.fabric import collectives as coll
from repro_torch.fabric.interface import KernelMode, parse_kernel_mode



class ReferenceBackend:
    """The plan-semantics ground truth, moving packets through the shared
    scatter/gather path."""

    name = "reference"
    uses_shared_scatter = True

    def plan(self, dst: torch.Tensor, src: torch.Tensor,
             regs: CrossbarRegisters) -> DispatchPlan:
        if dst.shape[0] == 0:
            return arbiter.empty_plan(dst, regs.n_ports)
        return arbiter.wrr_dispatch_plan(dst, src, regs)

    def dispatch(self, x: torch.Tensor, plan: DispatchPlan,
                 regs: CrossbarRegisters, capacity: int) -> torch.Tensor:
        return arbiter.dispatch(x, plan, regs.n_ports, capacity)

    def combine(self, y: torch.Tensor, plan: DispatchPlan,
                weights: torch.Tensor) -> torch.Tensor:
        return arbiter.combine(y, plan, weights)


class CudaBackend:
    """The fabric's plan kernel (the whole plan in one launch), and either
    the shared scatter or the scatter/combine kernels as data plane.

    ``kernel_mode`` is bound by ``Fabric`` from its device (``AUTO``:
    kernels on a CUDA device, plain versions on the CPU).  Under
    ``TORCH`` the data plane is the shared scatter, like the JAX
    backend's XLA lowering.
    """

    name = "cuda"

    def __init__(self, *, data_plane: str = "scatter",
                 kernel_mode=None):
        if data_plane not in ("scatter", "kernel"):
            raise ValueError(f"data_plane must be 'scatter' or 'kernel', "
                             f"got {data_plane!r}")
        self.data_plane = data_plane
        self.kernel_mode = parse_kernel_mode(kernel_mode)
        # bound here: an import in ``plan`` costs host time on every call
        from repro_torch.kernels.crossbar_dispatch.kernel import plan_fabric
        self._plan_fabric = plan_fabric

    def apply_kernel_mode(self, mode: KernelMode) -> None:
        """Bind a resolved :class:`KernelMode` (``Fabric.__init__``)."""
        self.kernel_mode = mode

    @property
    def uses_shared_scatter(self) -> bool:
        return (self.data_plane == "scatter"
                or self.kernel_mode is KernelMode.TORCH)

    def plan(self, dst: torch.Tensor, src: torch.Tensor,
             regs: CrossbarRegisters) -> DispatchPlan:
        if dst.shape[0] == 0:
            return arbiter.empty_plan(dst, regs.n_ports)
        return self._plan_fabric(dst, src, regs.allowed, regs.reset,
                                 regs.quota, regs.capacity,
                                 mode=self.kernel_mode)

    def dispatch(self, x: torch.Tensor, plan: DispatchPlan,
                 regs: CrossbarRegisters, capacity: int) -> torch.Tensor:
        if self.uses_shared_scatter:
            return arbiter.dispatch(x, plan, regs.n_ports, capacity)
        from repro_torch.kernels.crossbar_dispatch.ops import _dispatch
        return _dispatch(x, plan.dst, plan.keep, plan.slot,
                         n_ports=regs.n_ports, capacity=capacity,
                         mode=self.kernel_mode)

    def combine(self, y: torch.Tensor, plan: DispatchPlan,
                weights: torch.Tensor) -> torch.Tensor:
        if self.uses_shared_scatter:
            return arbiter.combine(y, plan, weights)
        from repro_torch.kernels.crossbar_dispatch.ops import _combine
        return _combine(y, plan.dst, plan.keep, plan.slot, weights,
                        mode=self.kernel_mode)


def _cuda_kernel_backend(**kw) -> CudaBackend:
    kw.setdefault("data_plane", "kernel")
    return CudaBackend(**kw)


# ----------------------------------------------------------------------
# sharded: regions as the ranks of a process group
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CombineRoute:
    """The ``all_to_all`` lane layout of one sharded combine, persisted.

    ``ShardedBackend.combine`` routes *addresses* before it routes rows:
    each source scatters the slab rows its packets occupy into
    per-destination-rank lanes and one ``all_to_all`` delivers them.  That
    address half depends only on the plan (the offered packets and the
    register epoch), so steady-state decode ticks can build it once per
    reconfiguration (``build_route``) and replay it (``combine(...,
    route=...)``).  Replaying a route built for another plan or slab shape
    is a bug of the caller.
    """

    addr_recv: torch.Tensor  # [n_src, W] int32: my slab rows to serve, per
    #                          requesting source rank (-1 = empty lane row)
    keep: torch.Tensor       # [T] bool: granted and within this slab depth
    pos: torch.Tensor        # [T] int32: packet's lane position in its group
    dshard: torch.Tensor     # [T] int32: destination rank per packet


# The sharded data plane is composed of the crossbar kernels' entry points
# (``ops._dispatch`` and ``ops._combine``, autograd Functions) and the
# self-inverse ``all_to_all``.  The backward of (scatter -> all_to_all ->
# sum over sources) is (broadcast -> the same all_to_all -> gather at the
# same flat address), the JAX package's custom VJP, without a backward
# written here; the combine's likewise replays its lane route backward.
def _sharded_dispatch_at(group, geom: Tuple[int, int, int], x: torch.Tensor,
                         dst: torch.Tensor, keep: torch.Tensor,
                         slot: torch.Tensor, mode=KernelMode.AUTO
                         ) -> torch.Tensor:
    """Scatter local packets into the send slab at ``dst*C+slot`` over all
    ``n_dst`` ports, ``all_to_all`` the per-rank blocks, and sum the
    per-source contributions into this rank's receive slabs [pps, C, D].
    ``geom = (n_src, pps, capacity)``.  Backward oracle:
    :func:`sharded_dispatch_at_bwd_ref`."""
    from repro_torch.kernels.crossbar_dispatch.ops import _dispatch
    n_src, pps, capacity = geom
    send = _dispatch(x, dst, keep, slot, n_ports=n_src * pps,
                     capacity=capacity, mode=mode)
    recv = coll.all_to_all(send.reshape(n_src, pps, capacity, x.shape[-1]),
                           group)
    # slots are globally unique per destination: at most one source wrote
    # each row, so the sum is exact
    return recv.sum(0)


def sharded_dispatch_at_bwd_ref(group, geom: Tuple[int, int, int],
                                g: torch.Tensor,
                                addr: torch.Tensor) -> torch.Tensor:
    """Dense one-hot oracle for the :func:`_sharded_dispatch_at` backward
    (an explicit [T, n_dst*C+1] routing matrix; test-only, called on every
    rank of ``group``).  ``addr`` is ``arbiter.flat_slot_addr``."""
    n_src, pps, capacity = geom
    n_dst = n_src * pps
    D = g.shape[-1]
    gb = g[None].expand(n_src, pps, capacity, D)
    back = coll.all_to_all(gb, group)
    flat = torch.cat([back.reshape(n_dst * capacity, D),
                      g.new_zeros((1, D))])
    oh = (addr.long()[:, None] == torch.arange(
        n_dst * capacity + 1, device=g.device)[None, :]).to(g.dtype)
    return torch.einsum("tr,rd->td", oh, flat)


def _sharded_combine_at(group, n_src: int, y: torch.Tensor,
                        addr_recv: torch.Tensor, idx: torch.Tensor,
                        gate: torch.Tensor, weights: torch.Tensor,
                        mode=KernelMode.AUTO) -> torch.Tensor:
    """Address-routed sharded combine over a prebuilt route: gather my slab
    rows per requesting rank (``addr_recv``; -1 = empty lane), ``all_to_all``
    them home, and read each packet's lane at ``idx = dshard * W +
    min(pos, W-1)``, gated by ``gate`` (the route's ``keep``) and weighted.
    Both gathers are the combine kernel's: the first in its unit-weight
    form at (addr // C, addr % C), the second at (idx // W, idx % W) with
    the weights.  Backward oracle: :func:`sharded_combine_at_bwd_ref`."""
    from repro_torch.kernels.crossbar_dispatch.ops import _combine
    pps, C, D = y.shape
    W = addr_recv.shape[-1]
    a = addr_recv.reshape(-1)
    live = a >= 0
    rows = _combine(y, torch.where(live, a // C, 0), live,
                    torch.where(live, a % C, 0), None, mode=mode)
    back = coll.all_to_all(rows.reshape(n_src, W, D), group)
    return _combine(back, idx // W, gate, idx % W, weights, mode=mode)


def sharded_combine_at_bwd_ref(group, n_src: int, g: torch.Tensor,
                               y: torch.Tensor, addr_recv: torch.Tensor,
                               idx: torch.Tensor, gate: torch.Tensor,
                               weights: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense one-hot oracle for the :func:`_sharded_combine_at` backward:
    (d_y, d_weights) through explicit routing matrices (test-only, called
    on every rank of ``group``)."""
    pps, C, D = y.shape
    W = addr_recv.shape[-1]
    dev = g.device
    gf = g.float()
    gw = gf * (gate.float() * weights.float())[:, None]
    oh_lane = ((idx.long()[:, None] == torch.arange(n_src * W, device=dev))
               & gate[:, None]).float()
    d_back = torch.einsum("tl,td->ld", oh_lane, gw).reshape(n_src, W, D)
    d_rows = coll.all_to_all(d_back, group)
    oh_recv = ((addr_recv.long()[..., None]
                == torch.arange(pps * C, device=dev))
               & (addr_recv >= 0)[..., None]).float()
    d_y = torch.einsum("swr,swd->rd", oh_recv, d_rows).reshape(pps, C, D)
    rows = torch.einsum("swr,rd->swd", oh_recv,
                        y.reshape(pps * C, D).float())
    back = coll.all_to_all(rows, group)
    pre = torch.einsum("tl,ld->td", oh_lane, back.reshape(n_src * W, D))
    d_w = (gf * pre).sum(-1)
    return d_y.to(y.dtype), d_w.to(weights.dtype)


class ShardedBackend:
    """Crossbar over the ranks of a ``torch.distributed`` process group.

    ``group`` stands where the JAX package's ``axis_name`` stands (``None``:
    the default world group).  Every method is called on every rank of the
    group, each with the same number of local packets, as the devices of a
    ``shard_map`` are.  Each rank is one source region (its source id is
    its rank; the ``src`` argument is ignored) and holds its local packets.
    The register file's ``n_ports`` destinations partition contiguously
    across the ranks (``ports_per_shard = n_ports // group size``); after
    ``dispatch`` each rank owns the receive slabs of its own port block.
    ``counts``/``drops`` are summed over the group, so every rank sees the
    single-device plan's global histogram.

    The plan is plain PyTorch: the fabric's plan kernel computes a whole
    single-device plan in one launch, and a sharded plan needs a
    collective (the ``all_gather`` of granted counts) between its stream
    ranks and its WRR slots.  The data plane moves packets with the
    scatter and combine kernels on the card (``kernel_mode``, bound by
    ``Fabric`` from its device; their plain versions on the CPU).
    """

    name = "sharded"
    #: slabs are partitioned across the group; the fabric's single-device
    #: address cache does not describe this data plane.
    uses_shared_scatter = False

    def __init__(self, group=None, *, kernel_mode=None):
        self.group = group
        self.kernel_mode = parse_kernel_mode(kernel_mode)

    def apply_kernel_mode(self, mode: KernelMode) -> None:
        """Bind a resolved :class:`KernelMode` (``Fabric.__init__``)."""
        self.kernel_mode = mode

    def effective_src(self, src: torch.Tensor) -> torch.Tensor:
        """The source port this backend plans with: its rank, not the
        caller's ``src`` vector (which it ignores).  The sanitizer asks for
        this so its isolation re-check matches the plan's own inputs."""
        return torch.full_like(src.to(torch.int32),
                               coll.axis_index(self.group))

    def ports_per_shard(self, regs: CrossbarRegisters) -> int:
        """Slave ports each rank owns; ``n_ports`` must divide evenly."""
        n_src = coll.axis_size(self.group)
        n_dst = regs.n_ports
        if n_dst % n_src:
            raise ValueError(
                f"sharded backend needs n_ports ({n_dst}) divisible by the "
                f"group's size ({n_src}) so the port space partitions into "
                f"equal per-rank blocks")
        return n_dst // n_src

    def plan(self, dst: torch.Tensor, src: torch.Tensor,
             regs: CrossbarRegisters) -> DispatchPlan:
        n_dst = regs.n_ports
        self.ports_per_shard(regs)                           # divisibility
        me = coll.axis_index(self.group)
        dst = dst.to(torch.int32)
        in_range = (dst >= 0) & (dst < n_dst)
        dstc = dst.clamp(0, n_dst - 1)
        dstl = dstc.long()
        iso_ok = (in_range & regs.allowed[me, dstl]
                  & ~regs.reset[me] & ~regs.reset[dstl])
        rank = arbiter._stream_ranks(dstc, iso_ok, n_dst)
        quota = regs.quota[dstl, me]
        keep_pre = iso_ok & ((quota == 0) | (rank < quota))
        # Global WRR slots from the all-gathered per-source granted counts.
        mine = arbiter.bincount_i32(dstc, keep_pre, n_dst)
        granted = coll.all_gather(mine, self.group)          # [src, dst]
        slot = wrr_slots(rank, granted, dstc, me)
        cap_ok = slot < regs.capacity[dstl]
        keep = keep_pre & cap_ok
        error = torch.where(
            ~iso_ok, ErrorCode.INVALID_DEST,
            torch.where(~keep_pre, ErrorCode.GRANT_TIMEOUT,
                        torch.where(cap_ok, ErrorCode.OK,
                                    ErrorCode.ACK_TIMEOUT))).to(torch.int32)
        counts = coll.psum(arbiter.bincount_i32(dstc, keep, n_dst),
                           self.group)
        drops = coll.psum(arbiter.bincount_i32(error, None, 4), self.group)
        return DispatchPlan(keep=keep, slot=torch.where(keep, slot, 0),
                            dst=dst, error=error, counts=counts, drops=drops)

    def dispatch(self, x: torch.Tensor, plan: DispatchPlan,
                 regs: CrossbarRegisters, capacity: int) -> torch.Tensor:
        """Local packets [T_loc, D] -> this rank's receive slabs [P, C, D]
        (``P = ports_per_shard``, the rank's contiguous slave-port block).
        The send slab is the scatter kernel's at the flat ``dst * C + slot``
        address; slots are globally unique per destination, so the
        per-source contributions out of the ``all_to_all`` just sum."""
        n_src = coll.axis_size(self.group)
        pps = self.ports_per_shard(regs)
        return _sharded_dispatch_at(self.group, (n_src, pps, capacity), x,
                                    plan.dst, plan.keep, plan.slot,
                                    self.kernel_mode)

    def build_route(self, plan: DispatchPlan,
                    capacity: int) -> CombineRoute:
        """The address half of :meth:`combine`: one ``all_to_all`` of int
        addresses that tells every rank which of its slab rows each
        source's packets occupy.  Depends only on the plan and the slab
        depth: persist it within a register epoch and replay it via
        ``combine(..., route=...)``."""
        n_src = coll.axis_size(self.group)
        n_dst = plan.counts.shape[0]
        pps = n_dst // n_src
        C = capacity
        T = plan.dst.shape[0]
        # Row budget per (source, destination-rank) lane: a source cannot
        # land more packets on one rank than it has packets, nor more than
        # the rank's port block holds.
        W = min(T, pps * C)
        dstc = plan.dst.clamp(0, n_dst - 1)
        dshard = dstc // pps
        # Over-slab slots drop, as everywhere on the scatter data plane;
        # without this guard the combine would alias them onto a live row.
        keep = plan.keep & (plan.slot < C)
        pos = arbiter._stream_ranks(dshard, keep, n_src)
        local_addr = (dstc % pps) * C + plan.slot             # row in dest's y
        # Scatter addresses into the per-destination-rank send lanes
        # (lane W is the trash slot for drops; -1 marks empty rows).
        lane = dshard * (W + 1) + torch.where(keep, pos.clamp(max=W), W)
        addr_send = torch.full((n_src * (W + 1),), -1, dtype=torch.int32,
                               device=plan.dst.device)
        addr_send[lane.long()] = torch.where(keep, local_addr, -1).to(
            torch.int32)
        addr_send = addr_send.reshape(n_src, W + 1)[:, :W]
        addr_recv = coll.all_to_all(addr_send, self.group)
        return CombineRoute(addr_recv=addr_recv, keep=keep, pos=pos,
                            dshard=dshard)

    def combine(self, y: torch.Tensor, plan: DispatchPlan,
                weights: torch.Tensor, *,
                route: Optional[CombineRoute] = None) -> torch.Tensor:
        """Local result slabs [P, C, D] -> local packets [T_loc, D],
        weighted; dropped packets get zeros.

        Address-route gather: each source rank sends, per destination rank,
        the local slab rows its packets occupy (one ``all_to_all`` of int
        addresses), the destination gathers those rows out of its own
        [P, C, D] block, and a second ``all_to_all`` carries them home.
        ``route`` replays a persisted :class:`CombineRoute` (built by
        :meth:`build_route` for this plan and slab depth) and skips the
        address ``all_to_all``; results are bit-identical with and without
        it."""
        n_src = coll.axis_size(self.group)
        pps, C, D = y.shape
        T = plan.dst.shape[0]
        if T == 0 or C == 0:        # nothing sent / nothing grantable
            return y.new_zeros((T, D))
        if route is None:
            route = self.build_route(plan, C)
        W = route.addr_recv.shape[-1]
        idx = route.dshard * W + route.pos.clamp(max=W - 1)
        return _sharded_combine_at(self.group, n_src, y, route.addr_recv,
                                   idx, route.keep, weights,
                                   self.kernel_mode)


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------
_BACKENDS: Dict[str, Callable[..., object]] = {
    "reference": ReferenceBackend,
    "cuda": CudaBackend,
    "pallas": CudaBackend,
    "cuda_kernel": _cuda_kernel_backend,
    "sharded": ShardedBackend,
}


def register_fabric_backend(name: str, factory: Callable[..., object]
                            ) -> None:
    """Register a backend factory under ``name`` (duck-typed:
    ``plan``/``dispatch``/``combine`` with the signatures above); the name
    then works in ``Fabric(regs, backend=name)``, ``shell.fabric(name)``
    and ``moe_apply(dispatch_impl=name)``."""
    _BACKENDS[name] = factory


def get_backend(spec, **kwargs):
    """Resolve a backend: an instance passes through, a name constructs."""
    if not isinstance(spec, str):
        return spec
    try:
        factory = _BACKENDS[spec]
    except KeyError:
        raise ValueError(f"unknown fabric backend {spec!r}; "
                         f"registered: {sorted(_BACKENDS)}") from None
    return factory(**kwargs)


def is_fabric_backend(name: str) -> bool:
    return name in _BACKENDS


def backend_names():
    return sorted(_BACKENDS)
