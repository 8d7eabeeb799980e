"""Seeded weights of a Mixtral configuration, made on the device.

Every matrix is drawn from one ``torch.Generator`` seeded with the run's
seed, in a few large calls into one flat buffer of the served type, then
scaled by ``1 / sqrt(fan_in)`` (the second-to-last dimension) in place;
the norms' gains are ones.  The tree has the names and layouts of the
port's ``DenseLM`` (its vocabulary padded to a multiple of 2048), so the
program takes it as it is and the reference reads the same tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

VOCAB_PAD = 2048
CHUNK = 1 << 28                  # elements a generator call fills


def padded_vocab(cfg: dict) -> int:
    return math.ceil(cfg["vocab_size"] / VOCAB_PAD) * VOCAB_PAD


def layout(cfg: dict) -> Tuple[List[Tuple[str, tuple]], List[Tuple[str, tuple]]]:
    """(matrices, gains): each a list of (path, shape), paths as
    ``layers.0.attn.wq``."""
    d, H, Kv = (cfg["hidden_size"], cfg["num_attention_heads"],
                cfg["num_key_value_heads"])
    hd, ff, E = d // H, cfg["intermediate_size"], cfg["num_local_experts"]
    Vp = padded_vocab(cfg)
    mats = [("embed", (Vp, d)), ("lm_head", (d, Vp))]
    gains = [("final_norm", (d,))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        gains += [(p + "norm1", (d,)), (p + "norm2", (d,))]
        mats += [(p + "attn.wq", (d, H * hd)), (p + "attn.wk", (d, Kv * hd)),
                 (p + "attn.wv", (d, Kv * hd)), (p + "attn.wo", (H * hd, d)),
                 (p + "moe.w_router", (d, E)),
                 (p + "moe.w_in", (E, d, 2 * ff)),
                 (p + "moe.w_out", (E, ff, d))]
    return mats, gains


def make(cfg: dict, seed: int, device) -> dict:
    """The seeded parameter tree (``embed``, ``final_norm``, ``lm_head``,
    ``layers``: a list of per-layer dicts) in the configuration's type."""
    dtype = getattr(torch, cfg["port"]["dtype"])
    mats, gains = layout(cfg)
    total = sum(math.prod(s) for _, s in mats)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.empty(total, dtype=dtype, device=device)
    for i in range(0, total, CHUNK):
        flat[i:i + CHUNK].normal_(generator=gen)
    tree: Dict = {"layers": [{} for _ in range(cfg["num_hidden_layers"])]}
    at = 0
    for path, shape in mats:
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        leaf.mul_(1.0 / math.sqrt(max(1, shape[-2])))
        _set(tree, path, leaf)
        at += n
    for path, shape in gains:
        _set(tree, path, torch.ones(shape, dtype=dtype, device=device))
    return tree


def _set(tree: dict, path: str, value) -> None:
    keys = path.split(".")
    if keys[0] == "layers":
        node = tree["layers"][int(keys[1])]
        keys = keys[2:]
    else:
        node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, in a fixed order."""
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += [(f"{k}.{p}" if p else k, t) for p, t in leaves(tree[k])]
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out += [(f"{i}.{p}", t) for p, t in leaves(v)]
    else:
        out.append(("", tree))
    return out
