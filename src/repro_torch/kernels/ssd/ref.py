"""Plain PyTorch versions of the SSD chunk-scan kernel.

- :func:`ssd_ref` is the oracle: the direct sequential recurrence, a
  Python loop over the sequence, independent of the chunked algebra of
  both the kernel and ``repro_torch.models.ssm.ssd_chunked``.
- :func:`ssd_call_ref` is the kernel's own function in plain PyTorch: the
  chunked state-space-duality algebra of the TPU kernel, every chunk's
  quadratic term at once and the state carried across chunks in a loop
  over the chunks.  It is the CPU path of ``kernel.ssd_call`` and the body
  of the model's ``ssd_chunked``.
- :func:`ssd_bwd_ref` is the gradient of :func:`ssd_call_ref` in explicit
  chunked formulas (no autograd): the CPU path of ``kernel.ssd_call_bwd``
  and the yardstick of its CUDA kernel, which computes the same terms.

    h_t = exp(dA_t) * h_{t-1} + dt_t * x_t B_t^T
    y_t = C_t . h_t        (per head, per channel)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_ref(x: torch.Tensor, dA: torch.Tensor, dt: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, H, S, P]; dA, dt: [B, H, S]; Bm, Cm: [B, S, N].  Returns
    (y [B, H, S, P] in x.dtype, h_last [B, H, P, N] float32)."""
    Bsz, H, S, P = x.shape
    N = Bm.shape[-1]
    xf, dAf, dtf = x.float(), dA.float(), dt.float()
    Bf, Cf = Bm.float(), Cm.float()
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dec = torch.exp(dAf[:, :, t])                          # [B, H]
        upd = torch.einsum("bh,bhp,bn->bhpn", dtf[:, :, t], xf[:, :, t],
                           Bf[:, t])
        h = h * dec[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    return torch.stack(ys, dim=2).to(x.dtype), h


def ssd_call_ref(x: torch.Tensor, dA: torch.Tensor, dt: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function: x [B, H, S, P]; dA, dt [B, H, S]; Bm, Cm
    [B, S, N] (one group, shared by the heads); ``h0`` [B, H, P, N] or
    None (zeros).  S must be a multiple of ``chunk``.  Returns (y [B, H, S,
    P] in x.dtype, h_last [B, H, P, N] float32).  Sums in float32."""
    Bsz, H, S, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    if S % Q:
        raise ValueError(f"sequence {S} must divide the SSD chunk {Q}")
    nc = S // Q
    xf = x.float().reshape(Bsz, H, nc, Q, P)
    dtf = dt.float().reshape(Bsz, H, nc, Q)
    Cf = Cm.float().reshape(Bsz, nc, Q, N)
    cum, decay, CB, h_starts, h = _chunk_forward(
        xf, dA.float().reshape(Bsz, H, nc, Q), dtf,
        Bm.float().reshape(Bsz, nc, Q, N), Cf, h0)
    # within-chunk term: G[i, j] = (C_i . B_j) exp(cum_i - cum_j) dt_j, i >= j
    G = CB[:, None] * decay * dtf[..., None, :]
    del decay
    y = torch.einsum("bhcij,bhcjp->bhcip", G, xf)
    del G
    # contribution of the carried state: exp(cum_i) * C_i . h_start
    y = y + torch.einsum("bcin,bhcpn->bhcip", Cf, h_starts) \
        * torch.exp(cum)[..., None]
    return y.reshape(Bsz, H, S, P).to(x.dtype), h


def _chunk_forward(xf, dAf, dtf, Bf, Cf, h0):
    """The chunked forward's pieces, float32 and chunk-major: cum (the
    within-chunk cumsum of dA), the decays exp(cum_i - cum_j) on i >= j
    (masked to 0 before exp above the diagonal, where cum_i - cum_j > 0 may
    overflow), C.B^T of each chunk, each chunk's incoming state and
    h_last."""
    Bsz, H, nc, Q, P = xf.shape
    N = Bf.shape[-1]
    cum = torch.cumsum(dAf, dim=-1)                  # inclusive, <= 0 steps
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xf.device).tril()
    li = cum[..., :, None] - cum[..., None, :]       # [B, H, nc, Q, Q]
    decay = torch.where(causal, torch.exp(torch.where(causal, li, 0.0)), 0.0)
    del li
    CB = torch.einsum("bcin,bcjn->bcij", Cf, Bf)     # [B, nc, Q, Q]
    # chunk-end states and the carry across chunks
    w = torch.exp(cum[..., -1:] - cum) * dtf         # [B, H, nc, Q]
    states = torch.einsum("bhcjp,bcjn->bhcpn", xf * w[..., None], Bf)
    chunk_decay = torch.exp(cum[..., -1])            # [B, H, nc]
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xf.device)
         if h0 is None else h0.float())
    starts = []
    for c in range(nc):
        starts.append(h)
        h = h * chunk_decay[:, :, c, None, None] + states[:, :, c]
    return cum, decay, CB, torch.stack(starts, dim=2), h


def ssd_bwd_ref(x: torch.Tensor, dA: torch.Tensor, dt: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                chunk: int, h0: Optional[torch.Tensor] = None,
                dh_last: Optional[torch.Tensor] = None):
    """The gradient of :func:`ssd_call_ref` for the cotangents ``dy`` [B, H,
    S, P] of y and ``dh_last`` [B, H, P, N] (or None) of h_last.  Returns
    (dx [B, H, S, P] in x.dtype, ddA and ddt [B, H, S] float32, dB and dC
    [B, S, N] in B's dtype, summed over the heads, dh0 [B, H, P, N]
    float32).  Sums in float32.

    With cum the within-chunk cumsum of dA, g_c the gradient reaching the
    end of chunk c from later chunks (``dh_last`` for the last; g_{c-1} =
    exp(cum_Q,c) g_c + sum_i exp(cum_i) dy_i^T C_i) and, in a chunk, D[i, j]
    = (dy_i . x_j) exp(cum_i - cum_j) dt_j on i >= j and M = D * C.B^T:

        z_j   = sum_i (C_i . B_j) exp(cum_i - cum_j) dy_i + exp(cum_Q - cum_j) g B_j
        dx_j  = dt_j z_j;   ddt_j = x_j . z_j
        dB_j  = sum_h [sum_i D[i, j] C_i + dt_j exp(cum_Q - cum_j) x_j^T g]
        dC_i  = sum_h [sum_j D[i, j] B_j + exp(cum_i) dy_i^T h_in]
        ddA_u = sum_{t >= u} (rowsum M + m1 - colsum M)_t + sum_{r < u} m2_r + m3
        dh0   = g_{-1}

    with m1_i = exp(cum_i) dy_i . (h_in C_i), m2_j = dt_j x_j . (exp(cum_Q -
    cum_j) g B_j) and m3 = exp(cum_Q) <g, h_in> per chunk: ddA_u sums the
    pairs (t, r) that straddle u (r < u <= t), so no term cancels another
    across the chunk."""
    Bsz, H, S, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    if S % Q:
        raise ValueError(f"sequence {S} must divide the SSD chunk {Q}")
    nc = S // Q
    xf = x.float().reshape(Bsz, H, nc, Q, P)
    dyf = dy.float().reshape(Bsz, H, nc, Q, P)
    dAf = dA.float().reshape(Bsz, H, nc, Q)
    dtf = dt.float().reshape(Bsz, H, nc, Q)
    Bf = Bm.float().reshape(Bsz, nc, Q, N)
    Cf = Cm.float().reshape(Bsz, nc, Q, N)
    cum, decay, CB, h_in, _ = _chunk_forward(xf, dAf, dtf, Bf, Cf, h0)
    e_cum = torch.exp(cum)
    e_end = torch.exp(cum[..., -1:] - cum)          # exp(cum_Q - cum_j)

    # the gradient reaching each chunk's end, carried back across chunks
    sdy = torch.einsum("bhcip,bcin->bhcpn", dyf * e_cum[..., None], Cf)
    g = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if dh_last is None else dh_last.float())
    g_end = [None] * nc
    for c in reversed(range(nc)):
        g_end[c] = g
        g = g * e_cum[:, :, c, -1, None, None] + sdy[:, :, c]
    dh0 = g
    g_end = torch.stack(g_end, dim=2)                # [B, H, nc, P, N]

    G = CB[:, None] * decay                          # [B, H, nc, i, j]
    gB = torch.einsum("bhcpn,bcjn->bhcjp", g_end, Bf) * e_end[..., None]
    z = torch.einsum("bhcij,bhcip->bhcjp", G, dyf) + gB
    dx = dtf[..., None] * z
    ddt = (xf * z).sum(-1)

    D = torch.einsum("bhcip,bhcjp->bhcij", dyf, xf) * decay * dtf[..., None, :]
    dB = (torch.einsum("bhcij,bcin->bcjn", D, Cf)
          + torch.einsum("bhcj,bhcjp,bhcpn->bcjn", dtf * e_end, xf, g_end))
    dyh = torch.einsum("bhcip,bhcpn->bhcin", dyf, h_in) * e_cum[..., None]
    dC = torch.einsum("bhcij,bcjn->bcin", D, Bf) + dyh.sum(1)

    M = D * CB[:, None]
    m1 = (dyh * Cf[:, None]).sum(-1)
    m2 = dtf * (xf * gB).sum(-1)
    m3 = e_cum[..., -1] * (g_end * h_in).sum((-1, -2))
    del D, G
    inner = M.sum(-1) + m1 - M.sum(-2)
    suffix = torch.flip(torch.cumsum(torch.flip(inner, (-1,)), -1), (-1,))
    before = torch.cumsum(m2, -1)
    before = torch.cat([torch.zeros_like(before[..., :1]), before[..., :-1]],
                       -1)
    ddA = suffix + before + m3[..., None]
    return (dx.reshape(Bsz, H, S, P).to(x.dtype), ddA.reshape(Bsz, H, S),
            ddt.reshape(Bsz, H, S), dB.reshape(Bsz, S, N).to(Bm.dtype),
            dC.reshape(Bsz, S, N).to(Cm.dtype), dh0)
