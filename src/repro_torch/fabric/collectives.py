"""Differentiable collectives over a ``torch.distributed`` process group.

The port's analogue of a JAX mesh axis is a ``ProcessGroup``: every
function here takes ``group`` where the JAX package takes ``axis_name``
(``None`` is the default world group).  The axis index is
``dist.get_rank(group)`` (:func:`axis_index`) and the axis size
``dist.get_world_size(group)`` (:func:`axis_size`).

The transport follows ``dist.get_backend(group)``, never a failure:
gloo is a host transport, so a device tensor is copied to the host, the
collective runs there, and the result is copied back; NCCL takes device
tensors as they are.  Every rank of the group must make the same calls
in the same order with tensors of the same shapes, as the devices of a
``shard_map`` do.

Gradients follow one convention: what a rank computes from the result of
a :func:`psum` or :func:`gather` is computed alike on every rank (a
replicated loss), so the cotangent that reaches such a result is already
each rank's own and their backward passes need no collective (``psum``:
the identity; ``gather``: the rank's slice).  The sum over ranks happens
once, where a replicated tensor enters the sharded computation:
:func:`replicate` (identity forward, ``all_reduce`` backward) and
:func:`shard` (the rank's block forward, ``all_gather`` backward), which
is the transpose of a replicated ``shard_map`` input in JAX.
:func:`all_to_all` permutes blocks between ranks and is its own inverse,
so its backward is the same ``all_to_all``.

``timing`` (off by default) makes every collective synchronise the device
before and after itself and add its host seconds, calls and bytes to
``stats``, so that a caller can read the collectives' share of a step;
off, a collective enqueues what it must and nothing more.

While a ``launch.steps.OpRecorder`` is active (it puts itself in
``recorders``), every collective adds a line to its text under XLA's op
name (``all-to-all``, ``all-gather``, ``all-reduce``), so that
``launch.roofline.parse_collectives`` reads the port's steps as it reads
XLA's.

A group may also be a :class:`MetaGroup`: a description of a group (its
size and this rank's index in it) with no live ranks.  On tensors on the
``meta`` device a collective over it returns a result of the right shape
and writes its line, so that ``launch.steps.lower_step`` costs one rank
of a 256- or 512-device mesh in one process; on any other tensor it
raises.

Tensor parallelism (``models/parallel.py``) adds :func:`gather_shards`,
the FSDP weight gather (``all_gather`` forward, ``reduce_scatter``
backward: the ranks that gather a weight see different tokens, so their
cotangents differ and are summed), and :func:`pmax`, a maximum with no
gradient (the vocab-parallel cross-entropy's stabiliser).
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

#: Set ``timing = True`` to time every collective (see the module doc).
timing = False
stats = {"calls": 0, "seconds": 0.0, "bytes": 0}
#: active ``OpRecorder``s (``launch/steps.py``)
recorders: list = []


class MetaGroup:
    """A process group as a description: ``size`` ranks, this one at
    ``rank``, none of them live.  Collectives over it run on ``meta``
    tensors only (see the module doc)."""

    def __init__(self, size: int, rank: int = 0):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside a group of {size}")
        self.size, self.rank = size, rank

    def __repr__(self) -> str:
        return f"MetaGroup(size={self.size}, rank={self.rank})"


def reset_stats() -> None:
    stats.update(calls=0, seconds=0.0, bytes=0)


def axis_index(group=None) -> int:
    """This rank's index along ``group`` (JAX: ``lax.axis_index``)."""
    if isinstance(group, MetaGroup):
        return group.rank
    return dist.get_rank(group)


def axis_size(group=None) -> int:
    """The number of ranks in ``group`` (JAX: ``lax.axis_size``)."""
    if isinstance(group, MetaGroup):
        return group.size
    return dist.get_world_size(group)


def transport(group=None) -> str:
    """``"host"`` for gloo, which moves host tensors, ``"meta"`` for a
    :class:`MetaGroup`, else ``"device"``."""
    if isinstance(group, MetaGroup):
        return "meta"
    return "host" if dist.get_backend(group) == "gloo" else "device"


def _staged(fn, kind: str, group, *tensors: torch.Tensor, meta=None):
    """Run the raw collective ``fn`` (XLA's op ``kind``) on ``tensors``
    where the transport takes them, and return its outputs on the
    tensors' device.  Over a :class:`MetaGroup`, ``meta(*tensors)`` gives
    the result's shape instead (``None``: the first tensor's)."""
    if isinstance(group, MetaGroup):
        if any(t.device.type != "meta" for t in tensors):
            raise RuntimeError(
                f"{kind} over {group}: a described group has no live ranks "
                f"and takes tensors on the meta device only")
        out = (meta or torch.empty_like)(*tensors)
        for rec in recorders:
            rec.collective(kind, out, tensors)
        return out
    dev = tensors[0].device
    host = transport(group) == "host" and dev.type != "cpu"
    if timing:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
    args = [(t.cpu() if host else t).contiguous() for t in tensors]
    out = fn(*args)
    if host:
        out = out.to(dev)
    if timing:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stats["calls"] += 1
        stats["seconds"] += time.perf_counter() - t0
        stats["bytes"] += sum(t.numel() * t.element_size() for t in tensors)
    for rec in recorders:
        rec.collective(kind, out, tensors)
    return out


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    n = axis_size(group)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all needs a leading axis of {n} (the "
                         f"group's size), got {tuple(x.shape)}")

    def run(t):
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out
    return _staged(run, "all-to-all", group, x)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` stacked along a new leading axis, in rank order
    (JAX: ``all_gather``).  For integers: it carries no gradient."""
    n = axis_size(group)

    def run(t):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.stack(parts)
    return _staged(run, "all-gather", group, x,
                   meta=lambda t: t.new_empty((n, *t.shape)))


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``x`` over the group, cut into the group's size along
    ``dim``: this rank's block."""
    n = axis_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is not divisible "
                         f"by the group's {n} ranks")
    shape = list(x.shape)
    shape[dim] //= n

    def run(t):
        out = t.new_empty(shape)
        dist.reduce_scatter(out, [c.contiguous() for c in t.chunk(n, dim)],
                            op=dist.ReduceOp.SUM, group=group)
        return out
    return _staged(run, "reduce-scatter", group, x,
                   meta=lambda t: t.new_empty(shape))


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    def run(t):
        out = t.clone()
        dist.all_reduce(out, op=op, group=group)
        return out
    return _staged(run, "all-reduce", group, x)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        n, r = axis_size(group), axis_index(group)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} is not "
                             f"divisible by the group's {n} ranks")
        ctx.dim, ctx.group = dim, group
        return x.chunk(n, dim)[r].clone()

    @staticmethod
    def backward(ctx, g):
        parts = all_gather(g, ctx.group)
        return torch.cat(parts.unbind(0), ctx.dim), None, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return torch.cat(all_gather(x, group).unbind(0), dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return torch.cat(all_gather(x, group).unbind(0), dim)

    @staticmethod
    def backward(ctx, g):
        n, r = axis_size(ctx.group), axis_index(ctx.group)
        return g.chunk(n, ctx.dim)[r], None, None


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Block ``i`` of ``x``'s leading axis (which has the group's size) goes
    to rank ``i``; block ``j`` of the result came from rank ``j`` (JAX:
    ``all_to_all(split_axis=0, concat_axis=0, tiled=False)``)."""
    return _AllToAll.apply(x, group)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group (``all_reduce(SUM)``, JAX:
    ``psum``); its backward is the identity (see the module doc)."""
    return _Psum.apply(x, group)


def replicate(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x``, a tensor every rank holds alike, entering the sharded
    computation: its gradient is summed over the group."""
    return _Replicate.apply(x, group)


def shard(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim`` (``x`` held
    alike on every rank); the gradient of ``x`` is every rank's block
    gradient, gathered."""
    return _Shard.apply(x, dim, group)


def gather(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order; the
    backward keeps this rank's slice of the cotangent."""
    return _Gather.apply(x, dim, group)


def gather_shards(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's block ``x`` concatenated along ``dim`` (a weight cut
    over the group, gathered before use); the backward is a reduce-scatter:
    each rank's cotangent of the whole is summed over the group and the
    rank keeps its block.  Unlike :func:`gather`, it holds where the ranks
    compute different things from the result (FSDP: each its own
    tokens)."""
    return _GatherShards.apply(x, dim, group)


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the group (``all_reduce(MAX)``),
    detached: it carries no gradient."""
    return _all_reduce(x.detach(), group, dist.ReduceOp.MAX)
