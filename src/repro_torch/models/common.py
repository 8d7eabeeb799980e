"""Shared model primitives: norms, rope, a ``ParamDef``-driven init and
the partition specs.

Parameters are plain nested dicts of tensors with the JAX package's names
and layouts, so converted JAX parameters drop straight in
(``repro_torch.ckpt.convert``).

A partition spec is pure data here: a tuple of mesh-axis names (or None),
one per tensor dim, equal to ``tuple()`` of the JAX package's
``PartitionSpec`` for the same parameter.  What a production mesh is in
the port (a ``DeviceMesh`` needs its ranks to exist) is left to the
launch tools: ``repro_torch.launch.mesh`` describes the production
meshes and ``repro_torch.launch.steps.NamedSharding`` maps a spec onto
one.  A shape without storage is a tensor on the ``meta`` device (JAX's
``ShapeDtypeStruct``): :func:`shape_tree`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

Params = Any  # nested dict of tensors


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ----------------------------------------------------------------------
# Initialisers: every parameter is drawn from one explicit torch.Generator
# ----------------------------------------------------------------------
def normal_init(gen: torch.Generator, shape: Sequence[int], dtype, scale: float,
                device) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) > 1 else 1
    std = scale / max(1.0, fan_in) ** 0.5
    out = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                      device=device)
    return out.mul_(std).to(dtype)


def zeros_init(gen, shape, dtype, scale=0.0, device="cpu") -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones_init(gen, shape, dtype, scale=0.0, device="cpu") -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative parameter definition: shape + logical sharding + init."""
    shape: Tuple[int, ...]
    spec: Tuple[Optional[str], ...]          # logical axes, see LOGICAL_RULES
    init: Callable = normal_init
    scale: float = 1.0


# Logical-axis -> mesh-axis rules. ``fsdp`` shards the d_model/storage dim
# over the data axis (ZeRO-3 style weight sharding); ``tp`` shards output
# features over the model axis (Megatron style). Batch goes over (pod, data).
LOGICAL_RULES: Dict[Optional[str], Optional[Any]] = {
    "fsdp": "data",
    "tp": "model",
    "layers": None,
    "experts": None,
    "batch": ("pod", "data"),
    "batch_1pod": "data",
    None: None,
}


def logical_to_spec(axes: Sequence[Optional[str]], *, multi_pod: bool,
                    rules: Optional[Dict[str, Any]] = None) -> Tuple:
    """Logical axes -> a spec: one mesh axis (or None) per dim."""
    rules = dict(LOGICAL_RULES if rules is None else rules)
    if not multi_pod:
        rules["batch"] = "data"
    return tuple(rules.get(a, None) if a is not None else None for a in axes)


def spec_tree(defs: Dict[str, Any], *, multi_pod: bool):
    """The specs of a nested dict (and lists) of ParamDefs, same tree."""
    return tree_map(lambda d: logical_to_spec(d.spec, multi_pod=multi_pod),
                    defs)


def shape_tree(defs: Dict[str, Any], dtype) -> Params:
    """The parameters a nested dict (and lists) of ParamDefs defines, as
    tensors of ``dtype`` on the ``meta`` device: shapes, no storage."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=dtype,
                                          device="meta"), defs)


def tree_nbytes(tree) -> int:
    """The bytes the tensors of a nested dict/list tree hold."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def init_params(defs: Dict[str, Any], gen: torch.Generator, dtype,
                device) -> Params:
    """Materialise a nested dict (and lists) of ParamDefs, in key order."""
    if isinstance(defs, ParamDef):
        return defs.init(gen, defs.shape, dtype, defs.scale, device)
    if isinstance(defs, list):
        return [init_params(d, gen, dtype, device) for d in defs]
    return {k: init_params(v, gen, dtype, device) for k, v in defs.items()}


def tree_leaves(tree) -> list:
    """The tensors of a nested dict/list tree, in key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def leaf_names(tree, prefix: str = "") -> list:
    """The paths of ``tree_leaves(tree)``, in its order (``layers[0].w``)."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in leaf_names(v, f"{prefix}.{k}" if prefix else k)]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}[{i}]")]
    return [prefix]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


# ----------------------------------------------------------------------
# Norms and rotary position embeddings
# ----------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5, *,
             reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
             ) -> torch.Tensor:
    """RMSNorm over the last dim.  ``reduce`` maps the mean of squares of
    ``x``'s block to the whole dim's, where the dim is cut over ranks."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    if reduce is not None:
        ms = reduce(ms)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * gamma


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)                # [hd/2]
    angles = positions[..., :, None].float() * freqs             # [..., S, hd/2]
    angles = angles[..., :, None, :]                             # [..., S, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def silu_f32(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x.float())


def gelu_f32(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return torch.nn.functional.gelu(x.float(), approximate="tanh")
