"""The train step (the JAX package's ``launch/steps.py::make_train_step``)."""
from __future__ import annotations

import torch

from repro_torch.models.common import tree_leaves, tree_map
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
