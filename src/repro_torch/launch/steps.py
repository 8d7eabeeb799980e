"""Step functions and sharding trees for training and serving (the JAX
package's ``launch/steps.py``).

``build_step`` returns what the dry run and a launcher need for one
(arch x shape) cell: the step callable, its arguments as tensors on the
``meta`` device and the in/out shardings derived from the model's
partition specs.  ``lower_step`` runs the step once on the ``meta``
device and returns a :class:`Lowered`, the port's counterpart of a
lowered XLA program: its FLOPs (``torch.utils.flop_counter``), bytes
accessed, memory (argument, output and temp bytes) and the text of the
ops it ran (:class:`OpRecorder`).

Over a mesh of more than one device a step is one rank's program
(``models/parallel.py``, ``DenseLM`` only): ``build_step(shard=ctx)``
with a ``ShardCtx`` of launched ranks runs on the rank's local shards;
``lower_step`` records rank (0, ..., 0) of any ``MeshSpec`` on the
``meta`` device with described groups, its collectives among its ops.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
import weakref
from typing import Any, Callable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry as _FLOPS

from repro_torch.launch.mesh import MeshSpec
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.lm import DecodeState, batch_axes, build_model
from repro_torch.optim.adamw import AdamW, OptState


def _value_and_grad(model, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(model, opt: AdamW, microbatches: int = 1):
    """One optimizer step; ``microbatches > 1`` accumulates float32
    gradients over sequential microbatches (activations shrink by that
    factor; gradients and the optimizer see the same mathematics).

    ``train_step(params, opt_state, batch) -> (params, opt_state, loss)``;
    the parameters are updated in place (``AdamW.apply_updates``)."""

    def train_step(params, opt_state: OptState, batch):
        if microbatches == 1:
            loss, grads = _value_and_grad(model, params, batch)
        else:
            def split(x, i):
                x = torch.as_tensor(x, device=model.device)
                n = x.shape[0] // microbatches
                return x[i * n:(i + 1) * n]

            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(microbatches):
                mb = {k: split(x, i) for k, x in batch.items()}
                l, g = _value_and_grad(model, params, mb)
                loss = loss + l
                grads = tree_map(lambda a, b: a.add_(b.float()), grads, g)
            inv = 1.0 / microbatches
            loss = loss * inv
            grads = tree_map(lambda g: g.mul_(inv), grads)
        updates, opt_state = opt.update(grads, opt_state, params)
        del grads
        params = AdamW.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


# ----------------------------------------------------------------------
# shardings
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A partition spec (a tuple of mesh-axis names, a tuple of names or
    None per dim) over a :class:`MeshSpec` (JAX's ``NamedSharding``)."""

    mesh: MeshSpec
    spec: Tuple = ()

    def _axes(self, ndim: int):
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"array's {ndim} dims")
        out = []
        for i in range(ndim):
            a = self.spec[i] if i < len(self.spec) else None
            out.append(() if a is None else tuple(a) if isinstance(a, tuple)
                       else (a,))
        return out

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        """One device's block of an array of ``global_shape``; raises
        ``ValueError`` where a dim does not divide, as JAX does."""
        global_shape = tuple(global_shape)
        out = []
        for i, (n, names) in enumerate(zip(global_shape,
                                           self._axes(len(global_shape)))):
            f = math.prod(self.mesh.axis_size(a) for a in names)
            if n % f:
                raise ValueError(
                    f"{self} implies that array axis {i} is partitioned {f} "
                    f"times, but the dimension size is {n} (full shape: "
                    f"{global_shape})")
            out.append(n // f)
        return tuple(out)

    def placements(self, device_mesh) -> list:
        """The spec as ``DTensor`` placements on ``device_mesh`` (the live
        mesh of ``self.mesh``): ``Shard(d)`` on each mesh dim that shards
        tensor dim ``d``, ``Replicate()`` on the others."""
        from torch.distributed.tensor import Replicate, Shard
        axes = self._axes(len(self.spec))
        out = []
        for name in device_mesh.mesh_dim_names:
            dims = [d for d, names in enumerate(axes) if name in names]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out


def _map_specs(fn, tree):
    """``fn`` over the spec tuples of a tree of dicts, lists, NamedTuples
    (``OptState``) and dataclasses (``DecodeState``)."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_specs(fn, v) for v in tree]
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_specs(fn, v) for v in tree))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_specs(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if getattr(tree, f.name) is not None})
    return fn(tree)


def named(mesh: MeshSpec, tree):
    """Every spec of ``tree`` as a :class:`NamedSharding` over ``mesh``."""
    return _map_specs(lambda s: NamedSharding(mesh, s), tree)


@dataclasses.dataclass
class StepBundle:
    """One cell: callable + argument structs + shardings, and (the port's
    additions) ``remake``: ``build_step`` with the same arguments, for
    another ``device`` and ``kernel_mode``; ``model``, the model the step
    runs."""
    step: Callable
    arg_structs: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    donate_argnums: Tuple[int, ...] = ()
    remake: Optional[Callable[..., "StepBundle"]] = None
    model: Any = None


def opt_state_structs(model, pshapes=None) -> OptState:
    """AdamW's state as meta tensors: float32 moments shaped like the
    parameters (``pshapes``, default the model's) and the int32 step (a
    host int in a live state)."""
    pshapes = model.param_shapes() if pshapes is None else pshapes
    f32 = lambda: tree_map(lambda p: torch.empty(
        p.shape, dtype=torch.float32, device="meta"), pshapes)
    return OptState(step=torch.empty((), dtype=torch.int32, device="meta"),
                    m=f32(), v=f32())


def opt_state_specs(model, multi_pod: bool) -> OptState:
    pspecs = model.param_specs(multi_pod)
    return OptState(step=(), m=pspecs, v=pspecs)


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec,
               *, multi_pod: bool, opt: Optional[AdamW] = None,
               microbatches: int = 1, constrain_activations: bool = True,
               kernel_mode: Optional[str] = None,
               device=None, shard=None) -> StepBundle:
    """Build one (arch x shape) cell with the model on ``device`` (the card
    unless ``"cpu"`` or ``"meta"`` is asked for).

    ``shard`` (a ``parallel.ShardCtx`` over ``mesh``: launched ranks, or
    described ones on ``meta``) builds one rank's program: the model runs
    on the rank's local shards (``parallel.shard_params`` of the global
    parameters) and its rows of the batch under the batch spec, the
    argument structs are those local shapes, and the train step's clip
    takes the global norm (``ShardCtx.grad_sq``); the shardings stay the
    global specs.  Only ``DenseLM`` shards; the other families raise on a
    mesh of more than one device (ROADMAP A11).

    ``kernel_mode`` overrides ``cfg.kernel_mode`` (every kernel the model
    runs: flash attention, the recurrent scans, a fabric-backed MoE's
    crossbar), the seam through which the same step is costed against the
    kernels or their plain versions.  The train step is
    ``make_train_step``; prefill and decode are ``model.prefill`` and
    ``model.decode_step``."""
    remake = functools.partial(
        build_step, cfg, shape, mesh, multi_pod=multi_pod, opt=opt,
        microbatches=microbatches,
        constrain_activations=constrain_activations, shard=shard)
    if kernel_mode is not None and kernel_mode != cfg.kernel_mode:
        cfg = dataclasses.replace(cfg, kernel_mode=kernel_mode)
    model = build_model(cfg, device=device)
    if constrain_activations:
        model.batch_axis = batch_axes(shape.global_batch, multi_pod)
    pshapes = model.param_shapes()
    pspecs = model.param_specs(multi_pod)
    bstructs, bspecs = model.input_shapes(shape, multi_pod)
    logits_sh = NamedSharding(mesh, (None, "model"))
    opt = opt or AdamW()
    if shard is not None:
        from repro_torch.models.parallel import layout_specs, shard_params
        shard = shard.with_batch(bspecs["tokens"][0])
        model.shard_over(shard)
        layout = layout_specs(model, multi_pod)
        pshapes = shard_params(pshapes, layout, mesh, shard.coords)
        rows = shard.batch_rows(shape.global_batch)
        bstructs = {k: _meta_like(v[rows]) for k, v in bstructs.items()}
        opt = dataclasses.replace(opt, grad_sq=shard.grad_sq(layout))

    if shape.kind == "train":
        step = make_train_step(model, opt, microbatches)
        ospecs = named(mesh, opt_state_specs(model, multi_pod))
        args = (pshapes, opt_state_structs(model, pshapes), bstructs)
        in_sh = (named(mesh, pspecs), ospecs, named(mesh, bspecs))
        out_sh = (named(mesh, pspecs), ospecs, NamedSharding(mesh, ()))
        return StepBundle(step, args, in_sh, out_sh, (0, 1), remake, model)

    if shape.kind == "prefill":
        def serve_step(params, batch):
            return model.prefill(params, batch)
        return StepBundle(serve_step, (pshapes, bstructs),
                          (named(mesh, pspecs), named(mesh, bspecs)),
                          logits_sh, (), remake, model)

    sstructs, sspecs = model.decode_state_shapes(shape, multi_pod)
    if shard is not None:
        # the rank's state: its rows and its local kv heads (head-local
        # caches, ``models/parallel.py``)
        on_meta = build_model(cfg, device="meta")
        on_meta.shard_over(shard)
        local = on_meta.init_decode_state(bstructs["tokens"].shape[0],
                                          shape.seq_len)
        sstructs = dataclasses.replace(local, pos=sstructs.pos)

    def decode_step(params, state, batch):
        return model.decode_step(params, state, batch)

    return StepBundle(decode_step, (pshapes, sstructs, bstructs),
                      (named(mesh, pspecs), named(mesh, sspecs),
                       named(mesh, bspecs)),
                      (logits_sh, named(mesh, sspecs)), (1,), remake, model)


def _meta_like(t: torch.Tensor) -> torch.Tensor:
    """A meta tensor of ``t``'s shape and type with storage of its own."""
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


# ----------------------------------------------------------------------
# lowering: one run on the meta device, recorded
# ----------------------------------------------------------------------
_DTYPE_NAMES = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}
# ops whose output is a view of their input: they move no bytes
_ALIASING = frozenset({torch.ops.aten._unsafe_view.default})


def _sig(dtype, shape) -> str:
    """A tensor as XLA writes a shape: ``bf16[2,64]``."""
    name = _DTYPE_NAMES.get(dtype, str(dtype).removeprefix("torch."))
    return f"{name}[{','.join(str(d) for d in shape)}]"


def _line(n: int, name: str, outs, ins) -> str:
    res = (_sig(*outs[0]) if len(outs) == 1
           else f"({', '.join(_sig(*o) for o in outs)})")
    return f"%{n} = {res} {name}({', '.join(_sig(*i) for i in ins)})"


@functools.lru_cache(maxsize=None)
def _check_storage_preservation() -> None:
    """The memory count needs a storage's Python object to live exactly as
    long as the storage (torch keeps it alive while any tensor holds the
    storage); raise if this torch does not."""
    freed = []
    t = torch.empty(4, device="meta")
    weakref.finalize(t.untyped_storage(), freed.append, 1)
    if freed:
        raise RuntimeError("this torch does not keep a storage's Python "
                           "object alive with the storage; OpRecorder "
                           "cannot count live memory")


def _tensors(values) -> list:
    """The tensors of an op's arguments or results (tensors, and lists or
    tuples of them, a level deep)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out += [t for t in v if isinstance(t, torch.Tensor)]
    return out


def _storage_leaves(tree) -> list:
    """The tensors of a tree of dicts, lists, NamedTuples and
    dataclasses."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _storage_leaves(v)]
    return []


def _unique_bytes(tensors) -> Tuple[set, int]:
    keys, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if id(st) not in keys:
            keys.add(id(st))
            total += st.nbytes()
    return keys, total


class OpRecorder(TorchDispatchMode):
    """While active, records every aten op run on any device: a text line
    per op (``%7 = bf16[2,64] aten.mm.default(bf16[2,32], bf16[32,64])``),
    its FLOPs (by ``torch.utils.flop_counter``'s table, which
    ``FlopCounterMode`` counts with: the matmuls, convolutions and
    attention products), the bytes it reads and writes (its tensor
    operands' and outputs' ``nbytes``; a view moves none), and the storage
    it allocates.  The port's collectives (``fabric/collectives.py``) add
    lines under XLA's op names (``all-to-all``, ``all-gather``,
    ``all-reduce``).

    Live memory counts each storage once (views share it) from the op
    that allocates it until torch frees it, wherever the last reference
    was held (autograd's saved tensors too); ``peak_bytes`` is its
    largest value.  ``arguments`` are the tree(s) alive before the step:
    their storage is not counted as allocated."""

    def __init__(self, arguments=()):
        super().__init__()
        _check_storage_preservation()
        self._ops: list = []
        self.flops = 0
        self.bytes_accessed = 0
        self._args, self.argument_bytes = _unique_bytes(
            _storage_leaves(arguments))
        self._live: dict = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def _free(self, key) -> None:
        self.live_bytes -= self._live.pop(key)

    def _allocated(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._args or key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        for t in outs:
            self._allocated(t)
        if not (func.is_view or func in _ALIASING):
            self.bytes_accessed += sum(
                t.numel() * t.element_size() for t in ins + outs)
        count = _FLOPS.get(func.overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        self._ops.append((func, [(t.dtype, t.shape) for t in outs],
                          [(t.dtype, t.shape) for t in ins]))
        return out

    def collective(self, kind: str, out: torch.Tensor, ins) -> None:
        """One collective of ``fabric/collectives.py``."""
        self._ops.append((kind, [(out.dtype, out.shape)],
                          [(t.dtype, t.shape) for t in ins]))

    def __enter__(self):
        from repro_torch.fabric import collectives
        collectives.recorders.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.fabric import collectives
        collectives.recorders.remove(self)
        return super().__exit__(*exc)

    def text(self) -> str:
        return "\n".join(_line(n, str(f), outs, ins)
                         for n, (f, outs, ins) in enumerate(self._ops))


@dataclasses.dataclass(frozen=True)
class MemoryAnalysis:
    """XLA's ``memory_analysis()`` fields for a recorded step: the
    arguments' bytes; the outputs' bytes; temp, the peak of live storage
    the step allocated less the outputs it allocated; alias, the outputs
    that are arguments updated in place.  Their sum less alias is the
    step's peak of live storage, arguments included."""
    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    alias_size_in_bytes: int
    generated_code_size_in_bytes: int = 0


class Lowered:
    """One step run on the ``meta`` device, recorded (``lower_step``)."""

    def __init__(self, flops: float, bytes_accessed: float,
                 memory: MemoryAnalysis, text: str, seconds: float):
        self.flops, self.bytes_accessed = flops, bytes_accessed
        self.memory, self.text, self.seconds = memory, text, seconds

    def cost_analysis(self) -> dict:
        """``{"flops", "bytes accessed"}``: FLOPs as
        ``torch.utils.flop_counter.FlopCounterMode`` counts them (the
        matmuls and attention products), bytes summed over every op's
        operands and outputs."""
        return {"flops": self.flops, "bytes accessed": self.bytes_accessed}

    def memory_analysis(self) -> MemoryAnalysis:
        return self.memory

    def as_text(self) -> str:
        return self.text


def _host_scalars(args) -> tuple:
    """The live state's host ints where the structs hold JAX's int32
    scalars: ``OptState.step`` and ``DecodeState.pos`` (0: a step's cost
    does not depend on them)."""
    out = []
    for a in args:
        if isinstance(a, OptState):
            a = a._replace(step=0)
        elif isinstance(a, DecodeState):
            a = dataclasses.replace(a, pos=0)
        out.append(a)
    return tuple(out)


def record_step(step: Callable, args) -> Lowered:
    """Run ``step(*args)`` once under an :class:`OpRecorder` (on whatever
    device ``args`` live)."""
    t0 = time.perf_counter()
    with OpRecorder(args) as rec:
        out = step(*args)
        outs = _storage_leaves(out)
        _, out_bytes = _unique_bytes(outs)
        _, alias = _unique_bytes([t for t in outs if id(
            t.untyped_storage()) in rec._args])
        memory = MemoryAnalysis(
            argument_size_in_bytes=rec.argument_bytes,
            output_size_in_bytes=out_bytes,
            temp_size_in_bytes=rec.peak_bytes - (out_bytes - alias),
            alias_size_in_bytes=alias)
    return Lowered(float(rec.flops), float(rec.bytes_accessed), memory,
                   rec.text(), time.perf_counter() - t0)


def lower_step(bundle: StepBundle, mesh: MeshSpec) -> Lowered:
    """Run the bundle's step once on its meta structs, the model on
    ``meta`` under ``kernel_mode_for_target("meta")`` (the plain data
    plane), recorded.  Over a mesh of more than one device it records rank
    (0, ..., 0) of ``mesh`` (``ShardCtx.described``: no live ranks), its
    arguments the rank's local shards and its collectives among its ops;
    only ``DenseLM`` shards (the other families raise, ROADMAP A11)."""
    from repro_torch.launch.roofline import kernel_mode_for_target
    kw = {}
    if mesh.size != 1:
        from repro_torch.models.parallel import ShardCtx
        kw["shard"] = ShardCtx.described(mesh)
    meta = bundle.remake(device="meta",
                         kernel_mode=kernel_mode_for_target("meta"), **kw)
    return record_step(meta.step, _host_scalars(meta.arg_structs))
