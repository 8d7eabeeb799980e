"""Parameters from the JAX package, as numpy arrays, into the port's layout.

The JAX ``DenseLM`` stacks every per-layer leaf as ``[L, ...]`` under
``params["layers"]``; the port keeps layers apart, so those leaves are
unstacked into a list of per-layer dicts.  Names and per-leaf layouts are
the same in both packages, so both compute the same thing.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.common import dtype_of
from repro_torch.models.config import ModelConfig


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(
        device=device, dtype=dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device=None) -> Dict[str, Any]:
    """``tree``: the JAX parameter tree with numpy (or array-like) leaves.
    Returns the port's parameters on ``device`` (the card unless ``"cpu"``
    is asked for) in ``cfg.dtype``."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    out = {k: _map(v, lambda a: _tensor(a, dtype, device))
           for k, v in tree.items() if k != "layers"}
    layers = tree["layers"]
    out["layers"] = [_map(layers, lambda a, i=i: _tensor(np.asarray(a)[i],
                                                         dtype, device))
                     for i in range(cfg.n_layers)]
    return out
