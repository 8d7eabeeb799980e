"""The benchmark's yardstick of work: the H100's published peaks, and the
operations and bytes that a Mixtral step needs, counted from its shapes.

Kept beside the benchmark so that no change to the program can move it.
Every count is of the work the inputs need, whatever kernel does it:

- model FLOPs (``train_flops``, ``prefill_flops``): 2 per multiply-add of
  the active parameters (the router, the attention projections, the top-k
  experts and the head), times 3 for a train step (forward, and a backward
  of twice the forward), plus attention over the live (causal, windowed)
  query-key pairs; the capacity slabs' padding is not counted;
- the crossbar's bytes (``crossbar_bytes``): each input byte read once and
  each output byte written once, by call: the plan, the scatter into the
  slabs and the weighted combine out of them, and in a train step their
  backward calls (the scatter's is a unit-weight combine, the combine's a
  scatter and a unit-weight combine);
- flash attention (``flash_fwd`` and ``flash_bwd``): 4 FLOPs a head
  dimension and live pair forward, 8 backward; q, k, v (and o, dO, the
  row statistics backward) read once, the outputs written once.

The peaks are NVIDIA's data sheet for the H100 SXM at 700 W (dense bf16,
no sparsity).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

PEAK_BF16_FLOPS = 989e12        # tensor cores, dense bf16
HBM_BYTES_PER_S = 3.35e12       # HBM3
BF16, F32, I32 = 2, 4, 4


def least_s(n_bytes: float, n_flops: float = 0.0,
            flops_per_s: float = PEAK_BF16_FLOPS) -> float:
    """The least time the chip could take: the larger of the bytes over
    the HBM rate and the operations over the peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / flops_per_s)


def live_pairs(sq: int, sk: int, causal: bool, window: Optional[int],
               q_offset: int = 0) -> int:
    """The unmasked (query, key) pairs of one head of one sequence: query
    ``q_offset + i`` sees keys in ``(pos - window, pos]`` (all keys when
    not causal, none past ``sk``)."""
    q_pos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(q_pos + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(q_pos - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo, 0).sum())


def capacity(group_tokens: int, n_experts: int, top_k: int,
             capacity_factor: float, multiple: int = 8) -> int:
    """Slab depth of a token group: the configuration's capacity factor
    times the group's packets an expert, rounded up to ``multiple``."""
    c = math.ceil(capacity_factor * group_tokens * top_k / n_experts)
    return max(multiple, math.ceil(c / multiple) * multiple)


def moe_groups(tokens: int, group: int) -> tuple:
    """(groups, tokens a group) of a call on ``tokens`` tokens."""
    g = min(group, tokens)
    return tokens // g, g


# ---- one configuration's shapes ------------------------------------------
def dims(cfg: dict) -> dict:
    """The sizes the counts read from a configuration file's keys."""
    d = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    return {"d": d, "H": H, "Kv": cfg["num_key_value_heads"],
            "hd": d // H, "ff": cfg["intermediate_size"],
            "E": cfg["num_local_experts"], "k": cfg["num_experts_per_tok"],
            "V": cfg["vocab_size"], "L": cfg["num_hidden_layers"],
            "window": cfg["sliding_window"],
            "cf": cfg["moe"]["capacity_factor"],
            "group": cfg["moe"]["group_tokens"]}


def active_params_per_token(cfg: dict) -> int:
    """Parameters a token multiplies through in the layers: attention
    projections, the router and its top-k experts (the head apart)."""
    m = dims(cfg)
    d, H, Kv, hd = m["d"], m["H"], m["Kv"], m["hd"]
    attn = d * H * hd * 2 + d * Kv * hd * 2
    experts = m["k"] * 3 * d * m["ff"]
    return m["L"] * (attn + d * m["E"] + experts)


def attention_flops_fwd(cfg: dict, seq: int) -> float:
    """Forward attention FLOPs of one sequence over every layer."""
    m = dims(cfg)
    pairs = live_pairs(seq, seq, True, m["window"])
    return m["L"] * m["H"] * 4.0 * m["hd"] * pairs


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one train step on ``batch`` rows of ``seq``."""
    m = dims(cfg)
    tokens = batch * seq
    dense = 6.0 * tokens * (active_params_per_token(cfg) + m["d"] * m["V"])
    return dense + 3.0 * batch * attention_flops_fwd(cfg, seq)


def prefill_flops(cfg: dict, seq: int) -> float:
    """Model FLOPs of one prefill of ``seq`` tokens that returns the last
    token's logits."""
    m = dims(cfg)
    return (2.0 * seq * active_params_per_token(cfg) + 2.0 * m["d"] * m["V"]
            + attention_flops_fwd(cfg, seq))


def crossbar_bytes(cfg: dict, tokens: int, train: bool) -> float:
    """Bytes the crossbar calls of one pass over ``tokens`` tokens need,
    over every layer (bf16 rows, int32 routes, float32 weights)."""
    m = dims(cfg)
    G, g = moe_groups(tokens, m["group"])
    C = capacity(g, m["E"], m["k"], m["cf"])
    pk = g * m["k"]                           # packets of a group
    rows = pk * m["d"] * BF16                 # the packets' rows
    slabs = m["E"] * C * m["d"] * BF16        # one group's slabs
    route = 3 * pk * I32                      # dst, keep, slot
    plan = 2 * pk * I32 + 3 * pk * I32        # dst, src in; keep, slot, err
    scatter = rows + route + slabs
    combine = slabs + route + pk * F32 + rows
    unit_combine = slabs + route + rows
    per_group = plan + scatter + combine
    if train:
        per_group += unit_combine + scatter + unit_combine
    return float(m["L"] * G * per_group)


def flash_work(cfg: dict, batch: int, seq: int, backward: bool) -> tuple:
    """(FLOPs, bytes) of the flash calls of one pass over every layer:
    the forward, and with ``backward`` the backward too."""
    m = dims(cfg)
    H, Kv, hd = m["H"], m["Kv"], m["hd"]
    pairs = live_pairs(seq, seq, True, m["window"])
    q = batch * seq * H * hd * BF16
    kv = batch * seq * Kv * hd * BF16
    lse = batch * seq * H * F32
    flops = 4.0 * hd * pairs * H * batch
    n_bytes = q + 2 * kv + q + lse               # q, k, v in; o, lse out
    if backward:
        flops += 8.0 * hd * pairs * H * batch
        # q, k, v, o, dO, lse in; dq, dk, dv out
        n_bytes += 3 * q + 2 * kv + lse + q + 2 * kv
    return flops * m["L"], float(n_bytes * m["L"])


def flash_least_s(cfg: dict, batch: int, seq: int, backward: bool) -> float:
    """The least time of the flash calls of one pass over every layer:
    each forward call, and each backward call, bound by its own
    operations or bytes."""
    f_fwd, b_fwd = flash_work(cfg, batch, seq, False)
    t = least_s(b_fwd, f_fwd)
    if backward:
        f_all, b_all = flash_work(cfg, batch, seq, True)
        t += least_s(b_all - b_fwd, f_all - f_fwd)
    return t
