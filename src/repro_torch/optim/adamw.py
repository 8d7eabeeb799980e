"""AdamW with a global-norm clip, plus a cosine LR schedule (the JAX
package's ``optim/adamw.py``).

The moments are float32 and parameter-shaped; the update is computed in
float32 and cast to each parameter's dtype.  To hold a full-width model's
state on one card, ``update`` writes the new moments into the state's
tensors in place and ``apply_updates`` adds the updates to the parameters
in place (the JAX package returns new arrays; the values are the same).

On a tensor-parallel rank the gradients are local shards: ``grad_sq``
(``parallel.ShardCtx.grad_sq``) then gives the squared global norm over
every rank, each replicated block counted once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import tree_leaves, tree_map


class OptState(NamedTuple):
    step: int
    m: Any              # first moment  (float32, param-shaped)
    v: Any              # second moment (float32, param-shaped)


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        step = float(step)
        if step < warmup:
            return base_lr * step / max(1, warmup)
        t = min(max((step - warmup) / max(1, total - warmup), 0.0), 1.0)
        return 0.5 * base_lr * (1 + math.cos(math.pi * t))
    return lr


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Any = 1e-3                 # float or callable(step) -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # gradients -> their squared global norm (None: the sum over the leaves)
    grad_sq: Optional[Callable[[Any], torch.Tensor]] = None

    def init(self, params) -> OptState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return OptState(step=0, m=tree_map(zeros, params),
                        v=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: OptState, params) -> Tuple[Any, OptState]:
        """(updates in each parameter's dtype, the next state); the state's
        moment tensors are updated in place."""
        step = state.step + 1
        # Global-norm clip (float32).
        if self.grad_sq is not None:
            gsq = self.grad_sq(grads)
        else:
            gsq = sum(g.float().square().sum() for g in tree_leaves(grads))
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        lr = self.lr(step) if callable(self.lr) else self.lr
        # bias corrections in float32, as the JAX package computes them
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(step))

        def upd(g, m, v, p):
            g = g.float() * scale
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).add_(g.mul_(g), alpha=1 - self.b2)
            del g                        # one float32 temporary fewer
            delta = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            delta.add_(p, alpha=self.weight_decay)
            return delta.mul_(-lr).to(p.dtype)

        updates = tree_map(upd, grads, state.m, state.v, params)
        return updates, OptState(step=step, m=state.m, v=state.v)

    @staticmethod
    @torch.no_grad()
    def apply_updates(params, updates):
        """``params + updates`` in each parameter's dtype, in place."""
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.add_(u.to(p.dtype))
        return params
