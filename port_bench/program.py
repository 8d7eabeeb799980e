"""The program under test, as the drivers take it: the port's model built
from a configuration file, its optimizer from a cell's parameters.  Only
the drivers import this module (and through it ``repro_torch``, from the
checkout's ``src/``); the reference and the yardstick do not."""
from __future__ import annotations

import math


def model_config(cfg: dict, train: bool = False):
    """The port's ``ModelConfig`` of a configuration file's keys (the
    layers and window as run) and its ``port`` settings.  The port fixes
    the MoE's groups at 1024 tokens and, in its train loss, the
    load-balance weight at 0.01: a file that states others cannot run."""
    from repro_torch.models.config import ModelConfig, MoEConfig
    port = cfg["port"]
    if cfg["moe"]["group_tokens"] != 1024:
        raise ValueError("the port's MoE groups 1024 tokens")
    if train and cfg["router_aux_loss_coef"] != 0.01:
        raise ValueError("the port's train loss weighs the load-balance "
                         "loss 0.01")
    return ModelConfig(
        name=cfg["name"], family="moe",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        attn_window=cfg["sliding_window"], rope_theta=cfg["rope_theta"],
        norm_eps=cfg["rms_norm_eps"], dtype=port["dtype"],
        remat=port["remat"], kernel_mode=port.get("kernel_mode", "auto"),
        moe=MoEConfig(n_experts=cfg["num_local_experts"],
                      top_k=cfg["num_experts_per_tok"],
                      capacity_factor=cfg["moe"]["capacity_factor"],
                      dispatch=port["dispatch"]))


def model(cfg: dict, device, train: bool = False):
    from repro_torch.models.lm import build_model
    return build_model(model_config(cfg, train), device=device)


def check_layout(m, params) -> None:
    """The benchmark's weights have the shapes the program declares."""
    from repro_torch.models.common import leaf_names, tree_leaves
    want = m.param_shapes()
    got = {n: tuple(t.shape) for n, t in zip(leaf_names(params),
                                               tree_leaves(params))}
    need = {n: tuple(t.shape) for n, t in zip(leaf_names(want),
                                                tree_leaves(want))}
    if got != need:
        raise ValueError(f"weights do not fit the model: {got} != {need}")


def adamw(opt: dict):
    """The port's AdamW on its cosine schedule, from a cell's
    ``optimizer`` parameters (``grad_clip`` None: no clip)."""
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    clip = opt["grad_clip"]
    return AdamW(lr=cosine_schedule(opt["lr"], opt["warmup"], opt["total"]),
                 b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                 weight_decay=opt["weight_decay"],
                 grad_clip=math.inf if clip is None else clip)


def free(*_) -> None:
    """Drop the card's cached blocks once the caller has let go of the
    program's state."""
    import gc
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    den = float(b.norm())
    return float((a - b).norm()) / den if den else math.inf
