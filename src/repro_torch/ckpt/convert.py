"""Parameters and optimizer state between the JAX package's layout, as
numpy arrays, and the port's.

The JAX package stacks every per-layer leaf along a leading layer axis
(``params["layers"]`` [L, ...] in ``DenseLM`` and ``SSMLM``;
``params["groups"]``, ``["groups"]["rec"]`` and ``["trail"]`` in
``HybridLM``; ``params["enc_layers"]`` and ``["dec_layers"]`` in
``EncDecLM``, see :data:`STACKED`); the port keeps layers apart, so those
leaves are unstacked into lists of per-layer dicts (and stacked again on
the way back).  Names and per-leaf layouts are the same in both packages, so both
compute the same thing.  The AdamW moments have the parameters' layout
in float32.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.common import dtype_of
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptState


# Keys whose leaves the JAX package stacks along a leading layer axis, and
# within each such layer the keys stacked once more: DenseLM and SSMLM
# stack ``layers`` [L, ...]; HybridLM stacks ``groups`` [n_groups, ...],
# ``groups.rec`` [n_groups, pattern_rec, ...] and ``trail`` [n_trail, ...];
# EncDecLM stacks ``enc_layers`` and ``dec_layers``.
STACKED = {"layers": {}, "groups": {"rec": {}}, "trail": {},
           "enc_layers": {}, "dec_layers": {}}


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(
        device=device, dtype=dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _unstack(tree: Dict[str, Any], stacked: Dict[str, Any]):
    """Keys in ``stacked`` hold leaves stacked [n, ...]: each becomes a
    list of n per-layer trees (with their own stacked keys unstacked)."""
    out = {}
    for k, v in tree.items():
        if k not in stacked:
            out[k] = v
            continue
        n = len(np.asarray(next(iter(_leaves(v)))))
        out[k] = [_unstack(_map(v, lambda a, i=i: np.asarray(a)[i]),
                           stacked[k]) for i in range(n)]
    return out


def _stack(tree: Dict[str, Any], stacked: Dict[str, Any]):
    """The inverse of :func:`_unstack`, on numpy leaves."""
    out = {}
    for k, v in tree.items():
        if k not in stacked:
            out[k] = v
            continue
        layers = [_stack(lp, stacked[k]) for lp in v]
        out[k] = _stack_leaves(layers)
    return out


def _stack_leaves(layers):
    """Per-layer trees of one structure -> one tree of stacked leaves."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack_leaves([lp[k] for lp in layers]) for k in first}
    return np.stack(layers)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _from_numpy(tree: Dict[str, Any], dtype, device) -> Dict[str, Any]:
    return _map(_unstack(tree, STACKED), lambda a: _tensor(a, dtype, device))


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameters (or a tree of their layout, such as gradients
    or AdamW moments) as the JAX parameter tree: layers stacked, float32
    numpy leaves."""
    as_np = lambda t: t.detach().float().cpu().numpy()
    return _stack(_map(params, as_np), STACKED)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device=None) -> Dict[str, Any]:
    """``tree``: the JAX parameter tree with numpy (or array-like) leaves.
    Returns the port's parameters on ``device`` (the card unless ``"cpu"``
    is asked for) in ``cfg.dtype``."""
    return _from_numpy(tree, dtype_of(cfg.dtype), resolve_device(device))


def opt_state_from_numpy(step: int, m: Dict[str, Any], v: Dict[str, Any],
                         cfg: ModelConfig, device=None) -> OptState:
    """The JAX ``OptState``'s step and moment trees (numpy leaves) as the
    port's ``OptState`` (float32 moments on ``device``)."""
    device = resolve_device(device)
    return OptState(step=int(step),
                    m=_from_numpy(m, torch.float32, device),
                    v=_from_numpy(v, torch.float32, device))


def opt_state_to_numpy(state: OptState):
    """(step, m, v) in the JAX layout, float32 numpy leaves."""
    return state.step, params_to_numpy(state.m), params_to_numpy(state.v)
