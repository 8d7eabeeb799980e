"""Parameters and optimizer state between the JAX package's layout, as
numpy arrays, and the port's.

The JAX ``DenseLM`` stacks every per-layer leaf as ``[L, ...]`` under
``params["layers"]``; the port keeps layers apart, so those leaves are
unstacked into a list of per-layer dicts (and stacked again on the way
back).  Names and per-leaf layouts are the same in both packages, so both
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


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(
        device=device, dtype=dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _from_numpy(tree: Dict[str, Any], n_layers: int, dtype,
                device) -> Dict[str, Any]:
    out = {k: _map(v, lambda a: _tensor(a, dtype, device))
           for k, v in tree.items() if k != "layers"}
    layers = tree["layers"]
    out["layers"] = [_map(layers, lambda a, i=i: _tensor(np.asarray(a)[i],
                                                         dtype, device))
                     for i in range(n_layers)]
    return out


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameters (or a tree of their layout, such as gradients
    or AdamW moments) as the JAX parameter tree: layers stacked, float32
    numpy leaves."""
    as_np = lambda t: t.detach().float().cpu().numpy()
    out = {k: _map(v, as_np) for k, v in params.items() if k != "layers"}
    out["layers"] = _map_stack(params["layers"], as_np)
    return out


def _map_stack(layers, fn):
    """Per-layer dicts -> one dict of leaves stacked [L, ...]."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _map_stack([lp[k] for lp in layers], fn) for k in first}
    return np.stack([fn(t) for t in layers])


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device=None) -> Dict[str, Any]:
    """``tree``: the JAX parameter tree with numpy (or array-like) leaves.
    Returns the port's parameters on ``device`` (the card unless ``"cpu"``
    is asked for) in ``cfg.dtype``."""
    return _from_numpy(tree, cfg.n_layers, dtype_of(cfg.dtype),
                       resolve_device(device))


def opt_state_from_numpy(step: int, m: Dict[str, Any], v: Dict[str, Any],
                         cfg: ModelConfig, device=None) -> OptState:
    """The JAX ``OptState``'s step and moment trees (numpy leaves) as the
    port's ``OptState`` (float32 moments on ``device``)."""
    device = resolve_device(device)
    return OptState(step=int(step),
                    m=_from_numpy(m, cfg.n_layers, torch.float32, device),
                    v=_from_numpy(v, cfg.n_layers, torch.float32, device))


def opt_state_to_numpy(state: OptState):
    """(step, m, v) in the JAX layout, float32 numpy leaves."""
    return state.step, params_to_numpy(state.m), params_to_numpy(state.v)
