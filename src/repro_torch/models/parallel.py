"""Tensor parallelism and FSDP for every LM family over a (data, model)
mesh.

The JAX package has no counterpart: there ``jit``'s SPMD partitioner
applies ``param_specs`` and inserts the collectives.  The port shards by
hand, rank-local in the Megatron style: each rank holds the block of every
leaf that its spec gives it (``NamedSharding.shard_shape``, the shape JAX
computes), runs the model's kernels on its local shards, and combines
partial results with the differentiable collectives of
``fabric/collectives.py``.

- ``tp`` (the ``model`` axis): column-parallel products (q, k, v, the
  fused gate|up ``w_in``, the vocab head) take their replicated input
  through ``replicate`` (backward: ``all_reduce``); row-parallel ones
  (``wo``, ``w_out``) end in ``psum``.
- ``fsdp`` (the ``data`` axis): a weight cut along ``d_model`` is gathered
  with ``gather_shards`` just before use (backward: reduce-scatter, since
  data ranks see different tokens); leaves with no ``fsdp`` dim (the
  norms, biases) take ``replicate`` over the data axes (backward:
  ``all_reduce``).  A multi-pod mesh's ``pod`` axis holds replicas: every
  leaf's gradient is also summed over it.
- The batch follows the spec it is given (``lm.batch_axes``): sharded over
  ``data`` (and ``pod``) or replicated.  The loss is the mean over the
  global batch: the local token sums are ``psum``-ed over the batch axes,
  and where ranks of the data axes hold the same tokens the backward seed
  is divided by their number (:meth:`ShardCtx.loss_scale`), so that the
  gradient sums above count each token once.

Where trouble is (each covered by ``tests/test_torch_tensor_parallel.py``
and ``tests/test_torch_tensor_parallel_families.py``):

- **Concatenated projections.**  ``mlp.py`` and ``moe.py`` fuse gate and
  up into one ``w_in`` of width ``2*d_ff`` sharded over ``tp``; a
  contiguous cut would give rank 0 gate columns only and ``gated_act``
  would chunk the wrong halves.  The SSM's ``in_proj`` concatenates
  z | x | B | C | dt and its conv x | B | C.  :class:`Pieces` marks such a
  spec (two equal pieces by default) and :func:`shard_params` cuts
  each piece by itself, so rank r holds ``gate[r] | up[r]`` and
  ``z[r] | x[r] | B[r] | C[r] | dt[r]``, of the shape JAX's contiguous
  cut gives; :func:`unshard_params` is its exact inverse.
- **The SSM** (``ssm.py``): a rank runs the SSD scan on its heads; B and C
  are gathered over ``model`` after the conv (every head reads the whole
  state width; backward: reduce-scatter), the per-head ``[H]`` leaves are
  sliced after ``replicate`` (:meth:`ShardCtx.tp_slice`), and the gated
  norm over ``d_inner`` sums its mean of squares over ``model`` forward
  and backward (:meth:`ShardCtx.tp_stat`: ``psum``'s backward alone is
  the identity, right for a row-parallel output, wrong for a statistic
  every rank consumes).  The decode state is the rank's heads and conv
  channels.
- **The RG-LRU** (``rglru.py``): a rank holds a contiguous block of the
  channels in every leaf; the block-diagonal gates ``w_r``/``w_i`` are cut
  on their block axis (:data:`BLOCK_AXIS`), not on each block's last dim
  as JAX's spec is, so that a rank's gate columns are its channels (the
  same bytes, another shape; ROADMAP C).  A block is never cut: the model
  axis must divide the 16 blocks.
- **The encoder-decoder**: the encoder output is replicated over
  ``model`` (its blocks' row-parallel outputs end in ``psum``); each rank
  projects its own cross-attention K/V heads from it, and the
  cross-attention cache holds the rank's heads.
- **Heads.**  Local head counts come from :class:`HeadLayout`, never from
  ``cfg.n_heads``/``cfg.n_kv_heads``.  Where the model axis does not
  divide the q heads (8 heads over 16, LLaVA-NeXT's 56 over 16), the heads
  are split over the largest divisor of the axis and replicated over the
  rest: the ranks of one head block gather their ``wq`` columns over the
  block (``q_group``); each multiplies its own columns of the block's
  output by its ``wo`` rows.  Where the local kv columns are not the
  whole kv heads the local q heads use (Kv=2 over 4), the rank gathers
  ``wk``/``wv`` over the model axis and keeps those heads; where
  ``cfg.kv_shard == "replicate"`` they are whole already.  The gathers are
  recorded like every other collective.
- **Vocab-parallel embedding and head.**  ``embed`` (``tp``, ``fsdp``) is
  a masked lookup of the rank's vocab rows, then ``psum``; the head
  (``lm_head``, or granite's tied ``embed.T``) gives vocab-sharded logits,
  and the cross-entropy reduces its max and sum-exp over ``model``.
  ``prefill``/``decode_step`` return logits sharded on vocab (JAX's
  ``P(None, "model")``); :meth:`ShardCtx.gather_vocab` unshards them.
- **The KV cache** is head-local: each rank caches its local kv heads for
  all slots (JAX's ``decode_state_shapes`` shards slots over ``model``).
  Per device the bytes are the same where the axis divides Kv (ROADMAP C).
- **The MoE layer**: experts are replicated over ``model``, each model
  rank holding its half of every expert's ``d_ff``; routing runs on the
  rank's tokens, the experts' partial sums are ``psum``-ed after the
  combine, the combine weights enter through ``replicate``, and the
  load-balance statistics are summed over the batch axes.
- **AdamW's global-norm clip** sums squares over every rank, each
  replicated block counted once (:meth:`ShardCtx.grad_sq`).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.fabric import collectives as coll
from repro_torch.models.common import tree_leaves, tree_map

MODEL, DATA, POD = "model", "data", "pod"
GATED = ("swiglu", "geglu")

if TYPE_CHECKING:
    from repro_torch.launch.mesh import MeshSpec


class Pieces(tuple):
    """The spec of a leaf whose ``model`` dim concatenates pieces (a fused
    gate|up, the SSM's z | x | B | C | dt): each piece is cut over the axis
    by itself, so that rank r holds piece[r] of each, side by side.
    ``widths`` are the pieces' widths, or numbers in their proportion.
    Equal to the plain spec (a tuple) everywhere else."""

    def __new__(cls, spec, widths: Sequence[int] = (1, 1)):
        self = super().__new__(cls, spec)
        self.widths = tuple(widths)
        return self

    def with_entries(self, entries) -> "Pieces":
        """The same pieces under other mesh-axis entries."""
        out = tuple.__new__(type(self), entries)
        out.widths = self.widths
        return out

    def sizes(self, total: int) -> List[int]:
        """The pieces' sizes in a dim of ``total``."""
        unit, rem = divmod(total, sum(self.widths))
        if rem:
            raise ValueError(f"a dim of {total} does not split into pieces "
                             f"of widths {self.widths}")
        return [w * unit for w in self.widths]


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def layout_specs(model, multi_pod: bool = False):
    """``model.param_specs(multi_pod)`` as the ranks hold the leaves:

    - the fused gate|up ``w_in`` (the MLP's and the experts') marked
      :class:`Pieces` of two equal widths;
    - the SSM's ``in_proj`` marked :class:`Pieces` (z | x | B | C | dt) and
      its ``conv_w``/``conv_b`` (x | B | C), so that a rank holds its heads'
      z, x and dt, and its block of B and C;
    - the RG-LRU's block-diagonal ``w_r``/``w_i`` cut on the block axis
      (dim 0) where JAX's spec cuts each block's last dim: a rank holds the
      whole blocks of its own channels, as ``w_gate``, ``b_r`` and ``lam``
      are cut (the same bytes as JAX's block, another shape; ROADMAP C).
    """
    cfg = model.cfg
    specs = model.param_specs(multi_pod)
    gated = cfg.mlp_act in GATED
    ssm = {}
    if cfg.family == "ssm":
        d_inner = cfg.ssm.expand * cfg.d_model
        N, H = cfg.ssm.d_state, cfg.ssm.n_heads(cfg.d_model)
        ssm = {"in_proj": (d_inner, d_inner, N, N, H),
               "conv_w": (d_inner, N, N), "conv_b": (d_inner, N, N)}

    def walk(tree):
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            if k in ("mlp", "moe") and isinstance(v, dict) and "w_in" in v \
                    and gated:
                v = {**v, "w_in": Pieces(v["w_in"])}
            elif k == "mixer" and ssm:
                v = {**v, **{n: Pieces(v[n], w) for n, w in ssm.items()}}
            elif k == "rec" and isinstance(v, dict) and "w_r" in v:
                v = {**v, **{n: BLOCK_AXIS for n in ("w_r", "w_i")}}
            out[k] = walk(v)
        return out
    return walk(specs)


#: the RG-LRU gates' layout: whole blocks over ``model`` (``layout_specs``)
BLOCK_AXIS = (MODEL, None, None)


def without_axis(specs, axis: str):
    """``specs`` with the mesh axis ``axis`` taken out of every entry
    (:class:`Pieces` kept)."""
    def one(s):
        entries = tuple(None if e == axis else e for e in s)
        return s.with_entries(entries) if isinstance(s, Pieces) else entries
    return tree_map(one, specs)


def mesh_coords(mesh: MeshSpec, rank: int) -> Tuple[int, ...]:
    """Rank ``rank``'s coordinates (row-major over ``mesh.shape``)."""
    out = []
    for n in reversed(mesh.shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def mesh_rank(mesh: MeshSpec, coords: Sequence[int]) -> int:
    r = 0
    for n, c in zip(mesh.shape, coords):
        r = r * n + c
    return r


def _block(mesh: MeshSpec, coords, names) -> Tuple[int, int]:
    """(index, count) of the block the ranks at ``coords`` hold along a
    dim sharded over the axes ``names`` (row-major over them, as JAX)."""
    idx, n = 0, 1
    for a in names:
        i = mesh.axis_names.index(a)
        idx = idx * mesh.shape[i] + coords[i]
        n *= mesh.shape[i]
    return idx, n


def _cut(x: torch.Tensor, spec, mesh: MeshSpec, coords) -> torch.Tensor:
    for dim, entry in enumerate(spec):
        names = _axes(entry)
        if not names:
            continue
        idx, n = _block(mesh, coords, names)
        if isinstance(spec, Pieces) and MODEL in names:
            pieces = x.split(spec.sizes(x.shape[dim]), dim)
            for p in pieces:
                if p.shape[dim] % n:
                    raise ValueError(
                        f"a piece of {p.shape[dim]} of dim {dim} of "
                        f"{tuple(x.shape)} (widths {spec.widths}) is not "
                        f"divisible by {n} ({names})")
            x = torch.cat([p.chunk(n, dim)[idx] for p in pieces], dim)
        else:
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} is not "
                                 f"divisible by {n} ({names})")
            x = x.chunk(n, dim)[idx]
    return x.clone()


def shard_params(tree, specs, mesh: MeshSpec, coords):
    """The block of every leaf of the global tree ``tree`` that the rank at
    ``coords`` holds under ``specs`` (:func:`layout_specs`): each leaf's
    shape is ``NamedSharding(mesh, spec).shard_shape`` (the RG-LRU's
    block-axis gates excepted), a :class:`Pieces` leaf holds its pieces'
    blocks side by side.  Works on any device, ``meta`` included."""
    return tree_map(lambda x, s: _cut(x, s, mesh, coords), tree, specs)


def _place(shards: List[torch.Tensor], spec, mesh: MeshSpec):
    """A global leaf from every rank's block (rank order)."""
    shape = list(shards[0].shape)
    for dim, entry in enumerate(spec):
        shape[dim] *= _block(mesh, (0,) * len(mesh.shape), _axes(entry))[1]
    out = shards[0].new_empty(shape)
    for rank, x in enumerate(shards):
        coords = mesh_coords(mesh, rank)
        per_dim = []                   # (slice of x, slice of out) pairs
        for dim, entry in enumerate(spec):
            idx, n = _block(mesh, coords, _axes(entry))
            size = x.shape[dim]
            if isinstance(spec, Pieces) and MODEL in _axes(entry):
                pairs, lo, glo = [], 0, 0
                for whole in spec.sizes(shape[dim]):
                    c = whole // n
                    pairs.append((slice(lo, lo + c),
                                  slice(glo + idx * c, glo + (idx + 1) * c)))
                    lo, glo = lo + c, glo + whole
                per_dim.append(pairs)
            else:
                per_dim.append([(slice(None),
                                 slice(idx * size, (idx + 1) * size))])
        for pairs in itertools.product(*per_dim):
            out[tuple(d for _, d in pairs)] = x[tuple(s for s, _ in pairs)]
    return out


def unshard_params(shards: List[Any], specs, mesh: MeshSpec):
    """The global tree from every rank's local tree (a list in rank
    order): the inverse of :func:`shard_params`.  Replicated blocks are
    taken from the first rank that holds them."""
    return tree_map(lambda s, *xs: _place(list(xs), s, mesh), specs,
                    *shards)


# ----------------------------------------------------------------------
# the rank's view of the mesh
# ----------------------------------------------------------------------
def _lines(mesh: MeshSpec, axes: Sequence[str]) -> List[List[int]]:
    """Every group of ranks that differ only along ``axes``, in a fixed
    order (the same on every rank), each in rank order."""
    others = [i for i, a in enumerate(mesh.axis_names) if a not in axes]
    along = [i for i, a in enumerate(mesh.axis_names) if a in axes]
    out = []
    for fixed in itertools.product(*(range(mesh.shape[i]) for i in others)):
        ranks = []
        for moving in itertools.product(*(range(mesh.shape[i])
                                          for i in along)):
            c = [0] * len(mesh.shape)
            for i, v in zip(others, fixed):
                c[i] = v
            for i, v in zip(along, moving):
                c[i] = v
            ranks.append(mesh_rank(mesh, c))
        out.append(ranks)
    return out


@dataclasses.dataclass
class ShardCtx:
    """One rank's view of a mesh: its coordinates and the process groups
    of the axes it belongs to.  :meth:`launched` builds live groups inside
    launched ranks; :meth:`described` builds ``MetaGroup``s, so that one
    process can cost any rank of any mesh on the ``meta`` device.

    ``batch`` names the mesh axes the batch is sharded over (from the
    batch spec; :meth:`with_batch`)."""

    mesh: "MeshSpec"
    coords: Tuple[int, ...]
    groups: Dict[Any, Any]
    live: bool
    batch: Tuple[str, ...] = ()

    # ---- construction ----------------------------------------------------
    @classmethod
    def launched(cls, mesh: MeshSpec) -> "ShardCtx":
        """Inside launched ranks of ``mesh.size`` (an initialised
        ``torch.distributed`` world, rank = the row-major index of the
        coordinates; the groups take the world's backend): one group a
        line of each axis, and of (pod, data).  Every rank must call this
        together."""
        import torch.distributed as dist
        if not dist.is_initialized() or dist.get_world_size() != mesh.size:
            raise RuntimeError(f"ShardCtx.launched needs {mesh.size} "
                               f"launched ranks")
        rank = dist.get_rank()
        groups = {}
        for key in cls._group_keys(mesh):
            for ranks in _lines(mesh, key):
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[key] = g
        groups["world"] = None                  # the default group
        return cls(mesh, mesh_coords(mesh, rank), groups, live=True)

    @classmethod
    def described(cls, mesh: MeshSpec, coords: Optional[Sequence[int]] = None
                  ) -> "ShardCtx":
        """Rank ``coords`` (default: all zeros) of ``mesh`` with
        ``MetaGroup``s: collectives run on ``meta`` tensors only."""
        coords = tuple(coords or (0,) * len(mesh.shape))
        groups = {}
        for key in cls._group_keys(mesh):
            line = next(r for r in _lines(mesh, key)
                        if mesh_rank(mesh, coords) in r)
            groups[key] = coll.MetaGroup(len(line),
                                         line.index(mesh_rank(mesh, coords)))
        groups["world"] = coll.MetaGroup(mesh.size, mesh_rank(mesh, coords))
        return cls(mesh, coords, groups, live=False)

    @staticmethod
    def _group_keys(mesh: MeshSpec):
        keys = [(a,) for a in mesh.axis_names]
        dp = tuple(a for a in (POD, DATA) if a in mesh.axis_names)
        if len(dp) > 1:
            keys.append(dp)
        return keys

    def with_batch(self, bspec) -> "ShardCtx":
        """This view with the batch sharded over the axes of ``bspec`` (a
        batch dim's spec entry: None, an axis name or a tuple of them)."""
        return dataclasses.replace(self, batch=_axes(bspec))

    # ---- axes ------------------------------------------------------------
    def size(self, axis: str) -> int:
        return (self.mesh.axis_size(axis) if axis in self.mesh.axis_names
                else 1)

    def index(self, axis: str) -> int:
        return (self.coords[self.mesh.axis_names.index(axis)]
                if axis in self.mesh.axis_names else 0)

    def group(self, *axes: str):
        """The group of the ranks that differ from this one only along
        ``axes`` (those of the mesh); None when the mesh has none of
        them."""
        axes = tuple(a for a in (POD, DATA, MODEL)
                     if a in axes and a in self.mesh.axis_names)
        if not axes:
            return None
        return self.groups[axes]

    @property
    def world(self):
        return self.groups["world"]

    @property
    def batch_shards(self) -> int:
        return math.prod(self.size(a) for a in self.batch)

    def batch_rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch under the batch spec."""
        if global_batch % self.batch_shards:
            raise ValueError(f"batch {global_batch} does not divide over "
                             f"{self.batch}")
        n = global_batch // self.batch_shards
        i, _ = _block(self.mesh, self.coords, self.batch)
        return slice(i * n, (i + 1) * n)

    def loss_scale(self) -> float:
        """1 / the number of ranks of the data axes (pod, data) that hold
        the same tokens: the backward seed that makes the gradient sums
        over those axes count each token once."""
        dp = self.size(POD) * self.size(DATA)
        return self.batch_shards / dp

    # ---- collectives the layers call ------------------------------------
    def tp_in(self, x: torch.Tensor) -> torch.Tensor:
        """A model-replicated activation entering column-parallel work."""
        return coll.replicate(x, self.group(MODEL))

    def tp_out(self, y: torch.Tensor) -> torch.Tensor:
        """Row-parallel partial sums, summed over ``model``."""
        return coll.psum(y, self.group(MODEL))

    def tp_stat(self, x: torch.Tensor) -> torch.Tensor:
        """A statistic every model rank consumes (a norm's sum of squares
        over a dim cut over ``model``): summed over ``model`` forward, and
        its cotangent summed over ``model`` backward, since each rank
        scales its own channels by it."""
        g = self.group(MODEL)
        return coll.replicate(coll.psum(x, g), g)

    def tp_slice(self, w: torch.Tensor) -> torch.Tensor:
        """This model rank's contiguous block of a leaf replicated over
        ``model`` (the SSM's per-head ``[H]`` leaves), its gradient summed
        over ``model`` so that every rank holds the whole leaf's."""
        n = w.shape[0] // self.size(MODEL)
        return coll.replicate(w, self.group(MODEL)).narrow(
            0, self.index(MODEL) * n, n)

    def tp_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every model rank's block of an activation, concatenated along
        ``dim`` (the SSM's B and C); backward: each rank's cotangent
        summed, its block kept."""
        return coll.gather_shards(x, dim, self.group(MODEL))

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over local tokens, summed over the batch axes."""
        if not self.batch:
            return x
        return coll.psum(x, self.group(*self.batch))

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """Vocab-sharded logits [..., V/M] -> [..., V] (no gradient)."""
        parts = coll.all_gather(logits.detach(), self.group(MODEL))
        return torch.cat(parts.unbind(0), -1)

    def gather_batch(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows [B_loc, ...] -> every rank's [B, ...] (no
        gradient)."""
        if not self.batch:
            return x
        parts = coll.all_gather(x.detach(), self.group(*self.batch))
        return torch.cat(parts.unbind(0), 0)

    def weight(self, w: torch.Tensor, spec) -> torch.Tensor:
        """A local leaf made whole along its ``fsdp`` dim (gathered over
        ``data``), with its gradient summed over the data axes where ranks
        see different tokens (see the module doc)."""
        dims = [i for i, e in enumerate(spec) if DATA in _axes(e)]
        if dims:
            if self.group(POD) is not None:
                w = coll.replicate(w, self.group(POD))
            return coll.gather_shards(w, dims[0], self.group(DATA))
        dp = self.group(POD, DATA)
        return w if dp is None else coll.replicate(w, dp)

    def weights(self, tree, specs):
        """:meth:`weight` over a tree of leaves (a layer's dict)."""
        return tree_map(self.weight, tree, specs)

    @torch.no_grad()
    def whole_over_data(self, tree, specs):
        """Every local leaf gathered once along its ``fsdp`` dim: the
        rank's ``model`` shards, whole along ``d_model`` (for serving,
        which keeps no optimizer state and would otherwise gather every
        weight again for each token)."""
        def one(w, s):
            dims = [i for i, e in enumerate(s) if DATA in _axes(e)]
            return (coll.gather_shards(w, dims[0], self.group(DATA))
                    if dims else w)
        return tree_map(one, tree, specs)

    def grad_sq(self, specs):
        """The squared global norm of gradients laid out as ``specs``: each
        rank's sum over its leaves, a block held by k ranks weighted 1/k,
        summed over every rank (AdamW's ``grad_sq``)."""
        weights = [1.0 / (self.mesh.size // math.prod(
            _block(self.mesh, self.coords, _axes(e))[1] for e in s))
                   for s in tree_leaves(specs)]

        def fn(grads):
            tot = sum(g.float().square().sum() * k
                      for g, k in zip(tree_leaves(grads), weights))
            return coll.psum(tot, self.world)
        return fn

    # ---- heads ----------------------------------------------------------
    def heads(self, cfg) -> "HeadLayout":
        """This rank's :class:`HeadLayout` for ``cfg`` (creating the q head
        block's group where the layout needs one)."""
        M, m = self.size(MODEL), self.index(MODEL)
        H, Kv = cfg.n_heads, cfg.n_kv_heads
        G = H // Kv
        Mq = max(f for f in range(1, M + 1) if M % f == 0 and H % f == 0)
        r = M // Mq
        j = m // r
        Hb = H // Mq
        if Hb >= G and Hb % G == 0:
            n_kv = Hb // G
        elif Hb < G and G % Hb == 0:
            n_kv = 1
        else:
            raise NotImplementedError(
                f"{H} q heads in blocks of {Hb} straddle the GQA groups of "
                f"{G}: no head layout over a model axis of {M}")
        kv0 = (j * Hb) // G
        if cfg.kv_shard != "tp":
            kv_src = "replicated"
        elif r == 1 and Kv % M == 0:
            kv_src = "local"          # the rank's kv columns are its heads
        else:
            kv_src = "gather"
        c = H * cfg.hd // M
        off = (m - j * r) * c
        return HeadLayout(n_q=Hb, n_kv=n_kv, kv0=kv0, kv_src=kv_src,
                          q_group=self._model_block(r) if r > 1 else None,
                          o_cols=(off, off + c), hd=cfg.hd)

    def _model_block(self, r: int):
        """The group of the ``r`` consecutive model ranks of this one's
        block."""
        key = ("model_block", r)
        if key not in self.groups:
            M = self.size(MODEL)
            m = self.index(MODEL)
            if not self.live:
                self.groups[key] = coll.MetaGroup(r, m % r)
            else:
                import torch.distributed as dist
                me = dist.get_rank()
                for line in _lines(self.mesh, (MODEL,)):
                    for b in range(M // r):
                        ranks = line[b * r:(b + 1) * r]
                        g = dist.new_group(ranks)
                        if me in ranks:
                            self.groups[key] = g
        return self.groups[key]


@dataclasses.dataclass(frozen=True)
class HeadLayout:
    """The attention heads one model rank computes.

    ``n_q`` q heads (a block of the global heads; the ranks of
    ``q_group``, when not None, share the block and gather its ``wq``
    columns), ``n_kv`` kv heads from global head ``kv0``, whose weights are
    the rank's own (``"local"``), gathered over the model axis and sliced
    (``"gather"``) or replicated (``"replicated"``); ``o_cols`` are the
    columns of the block's output [.., n_q * hd] that meet the rank's
    ``wo`` rows."""

    n_q: int
    n_kv: int
    kv0: int
    kv_src: str
    q_group: Any
    o_cols: Tuple[int, int]
    hd: int

    def project(self, ctx: ShardCtx, p: Dict[str, torch.Tensor]):
        """The rank's q/k/v weights (and biases) from an attention dict
        already whole along ``d_model``: {"wq", "wk", "wv"[, "bq", ...]}."""
        out = dict(p)
        if self.q_group is not None:
            out["wq"] = coll.gather_shards(p["wq"], 1, self.q_group)
            if "bq" in p:
                out["bq"] = coll.gather_shards(p["bq"], 0, self.q_group)
        lo, hi = self.kv0 * self.hd, (self.kv0 + self.n_kv) * self.hd
        for w, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
            if w not in p or self.kv_src == "local":
                continue
            if self.kv_src == "gather":
                full = coll.gather_shards(p[w], dim, ctx.group(MODEL))
            else:
                full = coll.replicate(p[w], ctx.group(MODEL))
            out[w] = full.narrow(dim, lo, hi - lo)
        return out

    def out(self, ctx: ShardCtx, o: torch.Tensor, wo: torch.Tensor):
        """The attention output [B, S, n_q, hd] through the rank's ``wo``
        rows, summed over the model axis: [B, S, d]."""
        o = o.reshape(*o.shape[:-2], -1)
        lo, hi = self.o_cols
        if hi - lo != o.shape[-1]:
            o = o[..., lo:hi]
        return ctx.tp_out(o @ wo)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.k, None


def scale_grad(x: torch.Tensor, k: float) -> torch.Tensor:
    """``x`` whose gradient is multiplied by ``k``."""
    return x if k == 1.0 else _ScaleGrad.apply(x, k)


def xent_vocab_parallel(logits: torch.Tensor, labels: torch.Tensor,
                        true_vocab: int, ctx: ShardCtx) -> torch.Tensor:
    """Per-token cross-entropy [..] from vocab-sharded logits [.., V/M]
    (this rank's block of the padded vocab): max and sum-exp reduced over
    ``model``, padded columns masked, the gold logit taken where the label
    falls in the block.  At a model axis of 1 it computes what
    ``lm._xent_per_token`` computes, op for op."""
    group = ctx.group(MODEL)
    logits = logits.float()
    Vl = logits.shape[-1]
    off = ctx.index(MODEL) * Vl
    if ctx.size(MODEL) * Vl > true_vocab:
        col = off + torch.arange(Vl, device=logits.device)
        logits = torch.where(col < true_vocab, logits,
                             torch.finfo(torch.float32).min)
    mx = coll.pmax(logits.amax(-1), group)
    s = coll.psum(torch.exp(logits - mx[..., None]).sum(-1), group)
    logz = torch.log(s) + mx
    lab = labels.long() - off
    mine = (lab >= 0) & (lab < Vl)
    gold = logits.gather(-1, lab.clamp(0, Vl - 1)[..., None])[..., 0]
    gold = coll.psum(torch.where(mine, gold, 0.0), group)
    return logz - gold


def embed_vocab_parallel(embed: torch.Tensor, tokens: torch.Tensor,
                         ctx: ShardCtx) -> torch.Tensor:
    """Token embeddings from this rank's vocab rows [V/M, d]: a masked
    lookup, summed over ``model``."""
    Vl = embed.shape[0]
    off = ctx.index(MODEL) * Vl
    t = tokens.long() - off
    mine = (t >= 0) & (t < Vl)
    rows = embed[t.clamp(0, Vl - 1)]
    return ctx.tp_out(torch.where(mine[..., None], rows,
                                  torch.zeros((), dtype=rows.dtype,
                                              device=rows.device)))
