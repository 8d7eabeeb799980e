"""Plain PyTorch versions of the SSD chunk-scan kernel.

- :func:`ssd_ref` is the oracle: the direct sequential recurrence, a
  Python loop over the sequence, independent of the chunked algebra of
  both the kernel and ``repro_torch.models.ssm.ssd_chunked``.
- :func:`ssd_call_ref` is the kernel's own function in plain PyTorch: the
  chunked state-space-duality algebra of the TPU kernel, every chunk's
  quadratic term at once and the state carried across chunks in a loop
  over the chunks.  It is the CPU path of ``kernel.ssd_call`` and the body
  of the model's ``ssd_chunked``.

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
    dAf = dA.float().reshape(Bsz, H, nc, Q)
    dtf = dt.float().reshape(Bsz, H, nc, Q)
    Bf = Bm.float().reshape(Bsz, nc, Q, N)
    Cf = Cm.float().reshape(Bsz, nc, Q, N)

    cum = torch.cumsum(dAf, dim=-1)                  # inclusive, <= 0 steps
    # within-chunk term: G[i, j] = (C_i . B_j) exp(cum_i - cum_j) dt_j, i >= j
    CB = torch.einsum("bcin,bcjn->bcij", Cf, Bf)     # [B, nc, Q, Q]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    li = cum[..., :, None] - cum[..., None, :]       # [B, H, nc, Q, Q]
    # masked to 0 before exp: above the diagonal li > 0 and may overflow
    decay = torch.where(causal, torch.exp(torch.where(causal, li, 0.0)), 0.0)
    G = CB[:, None] * decay * dtf[..., None, :]
    del li, decay
    y = torch.einsum("bhcij,bhcjp->bhcip", G, xf)
    del G

    # chunk-end states and the carry across chunks
    w = torch.exp(cum[..., -1:] - cum) * dtf         # [B, H, nc, Q]
    states = torch.einsum("bhcjp,bcjn->bhcpn", xf * w[..., None], Bf)
    chunk_decay = torch.exp(cum[..., -1])            # [B, H, nc]
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    starts = []
    for c in range(nc):
        starts.append(h)
        h = h * chunk_decay[:, :, c, None, None] + states[:, :, c]
    h_starts = torch.stack(starts, dim=2)            # [B, H, nc, P, N]

    # contribution of the carried state: exp(cum_i) * C_i . h_start
    y = y + torch.einsum("bcin,bhcpn->bhcip", Cf, h_starts) \
        * torch.exp(cum)[..., None]
    return y.reshape(Bsz, H, S, P).to(x.dtype), h
