"""A plain Mixtral in PyTorch, float32: the benchmark's reference.

It imports nothing of the program.  It reads the configuration file's keys
and the benchmark's seeded weights (``port_bench.weights``, the layout of
the port's ``DenseLM``), upcast to float32 layer by layer, so that the
8-layer Mixtral-8x22B fits beside them.  Matrix products run in IEEE
float32 (``tf32_off``).  ``quant="fp8"`` is the control: the same
arithmetic with every product's operands rounded to float8 e4m3 with a
scale per tensor (per expert for the experts), the next precision below
the configuration's bfloat16.

The layer, as the configuration and the port's semantics state it:

- RMSNorm (``rms_norm_eps``), then q, k, v projections; rotary embedding
  on the two halves of each head (``rope_theta``); causal attention over
  the last ``sliding_window`` keys, kv head ``h // (H / Kv)`` for query
  head ``h``, scores scaled by ``head_dim ** -0.5``;
- RMSNorm, then the router's softmax over the experts in float32, the
  top ``num_experts_per_tok`` renormalised; the tokens cut into groups of
  ``moe.group_tokens``, each token's packets in order (token by token,
  expert choice by choice); a packet keeps its place when fewer than
  ``capacity`` earlier packets of its group went to the same expert
  (``capacity = ceil(capacity_factor * group * k / E)``, rounded up to 8),
  and is dropped otherwise; a SwiGLU expert (``w_in`` holds the gate then
  the up projection); the kept packets' outputs summed with their
  weights;
- the final RMSNorm and the head over the first ``vocab_size`` columns;
  the train loss is the mean next-token cross entropy plus
  ``router_aux_loss_coef`` times the load-balance loss (experts x the sum
  over experts of granted share x mean router probability), summed over
  the layers.

Parameters keep the configuration's bfloat16 between optimizer steps: an
AdamW step (``adamw_step``) computes in float32 and rounds each new
parameter to bfloat16, as the configuration holds its weights.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

FP8_MAX = 448.0                  # float8 e4m3, the products' operands
FP8_GRAD_MAX = 57344.0           # float8 e5m2, the gradients entering them


@contextlib.contextmanager
def tf32_off():
    """IEEE float32 products on the card for the block."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with a scale per tensor, back in
    float32; the gradient passes straight through."""
    with torch.no_grad():
        s = (t.detach().abs().max() / FP8_MAX).clamp_min(1e-30)
        q = (t.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return t + (q - t).detach() if t.requires_grad else q


class _GradFP8(torch.autograd.Function):
    """Identity forward; the gradient rounded to float8 e5m2 with a scale
    per tensor, as an fp8 training recipe feeds the backward products."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        s = (g.abs().max() / FP8_GRAD_MAX).clamp_min(1e-30)
        return (g / s).to(torch.float8_e5m2).to(torch.float32) * s


class Ops:
    """The products, in float32 or in the control's float8: operands in
    e4m3 forward, and backward the gradient entering each product in e5m2
    (the saved operands are the rounded ones)."""

    def __init__(self, quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown precision {quant!r}")
        self.quant = quant

    def q(self, t):
        return _fp8(t) if self.quant else t

    def _out(self, y):
        return _GradFP8.apply(y) if self.quant and y.requires_grad else y

    def mm(self, a, b):
        return self._out(self.q(a) @ self.q(b))

    def einsum(self, eq, a, b):
        return self._out(torch.einsum(eq, self.q(a), self.q(b)))


def dims(cfg: dict) -> dict:
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"d": d, "H": H, "Kv": cfg["num_key_value_heads"], "hd": d // H,
            "E": cfg["num_local_experts"], "k": cfg["num_experts_per_tok"],
            "V": cfg["vocab_size"], "eps": cfg["rms_norm_eps"],
            "theta": cfg["rope_theta"], "window": cfg["sliding_window"],
            "cf": cfg["moe"]["capacity_factor"],
            "group": cfg["moe"]["group_tokens"],
            "aux": cfg["router_aux_loss_coef"]}


def rms_norm(x, g, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g


def rope(x, positions, theta):
    """x [B, S, h, hd], positions [S]: rotate the two halves."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = positions.float()[:, None] * inv                  # [S, hd/2]
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window, ops: Ops, block: int = 512):
    """Causal (windowed) GQA attention, q [B, S, H, hd], k/v [B, S, Kv,
    hd], computed a block of queries at a time over the keys it sees."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    out = []
    for q0 in range(0, S, block):
        q1 = min(q0 + block, S)
        k0 = 0 if window is None else max(0, q0 - window + 1)
        qp = torch.arange(q0, q1, device=q.device)[:, None]
        kp = torch.arange(k0, q1, device=q.device)[None, :]
        live = kp <= qp
        if window is not None:
            live &= kp > qp - window
        s = ops.einsum("bqhd,bkhd->bhqk", q[:, q0:q1], k[:, k0:q1])
        s = s * hd ** -0.5
        s = s.masked_fill(~live, -math.inf)
        p_ = torch.softmax(s, dim=-1)
        out.append(ops.einsum("bhqk,bkhd->bqhd", p_, v[:, k0:q1]))
    return torch.cat(out, dim=1)


def capacity(g: int, m: dict) -> int:
    c = math.ceil(m["cf"] * g * m["k"] / m["E"])
    return max(8, math.ceil(c / 8) * 8)


def moe(lp, x, m: dict, ops: Ops, probe: Optional[list] = None):
    """x [T, d] -> (y [T, d], load-balance loss, dropped packets).
    ``probe`` gets, for the last token, how far its packets' ranks lie
    under the capacity (negative: dropped) and the router's margin
    between its k-th and (k+1)-th choice."""
    T, d = x.shape
    E, k = m["E"], m["k"]
    logits = ops.mm(x, lp["w_router"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    g = min(m["group"], T)
    G = T // g
    assert G * g == T, f"{T} tokens do not divide into groups of {g}"
    cap = capacity(g, m)
    dst = top_e.reshape(G, g * k)                           # packet order
    onehot = F.one_hot(dst, E)
    rank = ((onehot.cumsum(1) - onehot) * onehot).sum(-1)
    keep = (rank < cap).reshape(T, k)
    y = torch.zeros_like(x)
    # one view an expert: the backward stacks their gradients once
    w_in, w_out = lp["w_in"].unbind(0), lp["w_out"].unbind(0)
    for e in range(E):
        tok, slot = torch.nonzero((top_e == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        h = ops.mm(x[tok], w_in[e])
        gate, up = h.chunk(2, dim=-1)
        out = ops.mm(F.silu(gate) * up, w_out[e])
        y = y.index_add(0, tok, out * top_p[tok, slot][:, None])
    if probe is not None:
        last = rank.reshape(T, k)[-1]
        srt = logits[-1].sort(descending=True).values
        probe.append({"capacity_margin": int((cap - last).min()),
                      "router_margin": float(srt[k - 1] - srt[k])
                      if k < E else math.inf})
    counts = torch.zeros(E, device=x.device).index_add_(
        0, top_e.reshape(-1), keep.reshape(-1).float())
    aux = E * torch.sum(counts / (T * k) * probs.mean(0))
    return y, aux, int((~keep).sum())


def layer(lp, x, positions, m: dict, ops: Ops, probe=None):
    """One block on x [B, S, d]: (x out, load-balance loss, drops)."""
    B, S, d = x.shape
    H, Kv, hd = m["H"], m["Kv"], m["hd"]
    h = rms_norm(x, lp["norm1"], m["eps"])
    a = lp["attn"]
    q = rope(ops.mm(h, a["wq"]).reshape(B, S, H, hd), positions, m["theta"])
    kk = rope(ops.mm(h, a["wk"]).reshape(B, S, Kv, hd), positions,
              m["theta"])
    v = ops.mm(h, a["wv"]).reshape(B, S, Kv, hd)
    o = attention(q, kk, v, m["window"], ops)
    x = x + ops.mm(o.reshape(B, S, H * hd), a["wo"])
    h2 = rms_norm(x, lp["norm2"], m["eps"])
    y, aux, drops = moe(lp["moe"], h2.reshape(B * S, d), m, ops, probe)
    return x + y.reshape(B, S, d), aux, drops


def f32(tree):
    """A tree of tensors upcast to float32."""
    if isinstance(tree, dict):
        return {k: f32(v) for k, v in tree.items()}
    return tree.float()


@torch.no_grad()
def logits_at(params, tokens: torch.Tensor, cfg: dict,
              quant: Optional[str] = None,
              probe: Optional[list] = None) -> torch.Tensor:
    """The logits over the vocabulary at the last token of one sequence
    ``tokens`` [S], computed layer by layer (each layer's weights upcast
    to float32 when it runs); ``probe`` gets each layer's view of the
    last token (see ``moe``).  Returns [1, V] float32."""
    m = dims(cfg)
    ops = Ops(quant)
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    x = params["embed"][tokens.long()].float()[None]
    for lp in params["layers"]:
        x, _, _ = layer(f32(lp), x, pos, m, ops, probe)
    h = rms_norm(x[0, S - 1:], params["final_norm"].float(), m["eps"])
    return ops.mm(h, params["lm_head"][:, :m["V"]].float())


def loss(p32, batch: Dict[str, torch.Tensor], cfg: dict, ops: Ops):
    """The train loss of float32 parameters on a batch [B, S]."""
    m = dims(cfg)
    tokens, labels = batch["tokens"], batch["labels"]
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    x = p32["embed"][tokens.long()]
    aux = 0.0
    for lp in p32["layers"]:
        # each layer's activations recomputed in the backward
        x, a = torch.utils.checkpoint.checkpoint(
            lambda lp_, x_: layer(lp_, x_, pos, m, ops)[:2], lp, x,
            use_reentrant=False)
        aux = aux + a
    h = rms_norm(x, p32["final_norm"], m["eps"])
    total = 0.0
    head = p32["lm_head"][:, :m["V"]]
    for c0 in range(0, S, 1024):
        logits = ops.mm(h[:, c0:c0 + 1024], head)
        total = total + F.cross_entropy(
            logits.reshape(-1, m["V"]),
            labels[:, c0:c0 + 1024].reshape(-1).long(), reduction="sum")
    return total / (B * S) + m["aux"] * aux


def leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def tree_like(tree, values):
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)
    return build(tree)


def adamw_steps(params, batches, cfg: dict, opt: dict,
                sample: Dict[str, torch.Tensor],
                quant: Optional[str] = None):
    """``len(batches)`` AdamW steps from the bfloat16 ``params`` (a tree
    the caller hands over and holds no more: its tensors are replaced).
    Returns (losses, the clipped first gradient's norm by leaf name, the
    norm of every leaf's change after the steps, the first gradient's
    norm before the clip by leaf name, the clipped first gradient's
    elements at ``sample[name]`` (flat indices) by leaf name).  The
    moments are float32; each leaf is updated in turn and its gradient
    freed, so that the 8x7B cut's state fits one card beside its float32
    copy."""
    ops = Ops(quant)
    names = [n for n, _ in leaves(params)]
    p16 = [t.detach() for _, t in leaves(params)]
    skeleton = tree_like(params, [None] * len(p16))
    del params                    # the caller hands its tree over
    p0 = [t.to("cpu") for t in p16]
    m_ = [torch.zeros_like(t, dtype=torch.float32) for t in p16]
    v_ = [torch.zeros_like(t, dtype=torch.float32) for t in p16]
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses, first, first_raw, first_at = [], None, None, None
    for step, batch in enumerate(batches, start=1):
        p32 = [t.float().requires_grad_() for t in p16]
        with tf32_off():
            ls = loss(tree_like(skeleton, p32), batch, cfg, ops)
            grads = list(torch.autograd.grad(ls, p32))
        losses.append(float(ls.detach()))
        del p32, ls
        with torch.no_grad():
            gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
            clip = opt["grad_clip"]
            scale = (torch.ones_like(gnorm) if clip is None else
                     torch.clamp(clip / gnorm.clamp_min(1e-12), max=1.0))
            if step == 1:
                first_raw = {n: g.norm().item() for n, g in zip(names, grads)}
                first = {n: (g * scale).norm().item()
                         for n, g in zip(names, grads)}
                first_at = {n: g.reshape(-1)[sample[n]] * scale
                            for n, g in zip(names, grads)}
            lr = lr_at(opt, step)
            bc1 = 1 - b1 ** step
            bc2 = 1 - b2 ** step
            for i in range(len(grads)):
                g = grads[i].mul_(scale)
                grads[i] = None
                m_[i].mul_(b1).add_(g, alpha=1 - b1)
                v_[i].mul_(b2).addcmul_(g, g, value=1 - b2)
                del g
                delta = torch.div(v_[i], bc2).sqrt_().add_(eps)
                delta = torch.div(m_[i], bc1).div_(delta)
                p = p16[i].float()
                delta.add_(p, alpha=wd).mul_(-lr).add_(p)
                del p
                p16[i] = delta.to(p16[i].dtype)
                del delta
    change = {n: (a.float() - b.to(a.device).float()).norm().item()
              for n, a, b in zip(names, p16, p0)}
    return losses, first, change, first_raw, first_at


def lr_at(opt: dict, step: int) -> float:
    """The cosine schedule of the cell: a linear warm-up to ``lr`` over
    ``warmup`` steps, then half a cosine to 0 at ``total``."""
    base, warm, total = opt["lr"], opt["warmup"], opt["total"]
    if step < warm:
        return base * step / max(1, warm)
    t = min(max((step - warm) / max(1, total - warm), 0.0), 1.0)
    return 0.5 * base * (1 + math.cos(math.pi * t))
