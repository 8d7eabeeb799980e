"""Plain PyTorch versions of the RG-LRU recurrence kernel,
``h_t = a_t * h_{t-1} + b_t`` over [B, S, L] float32.

- :func:`rglru_ref` is the oracle: the direct sequential recurrence, a
  Python loop over the sequence.
- :func:`rglru_call_ref` is the kernel's function in plain PyTorch as the
  JAX model computes it: a Hillis-Steele doubling scan within chunks of
  ``chunk`` steps and the state carried across chunks.  It is the CPU path
  of ``kernel.rglru_call`` and the body of the model's ``rglru_scan``.
- :func:`rglru_tiled_ref` computes the scan in the CUDA kernel's order
  (tiles of ``steps`` steps, each reduced to an affine map, the maps
  composed tile by tile); the tests use it to check the algebra that the
  kernel relies on.
- :func:`rglru_bwd_ref` is the gradient of the model's entry (``h0``
  folded into the first step) in explicit formulas: the CPU path of
  ``kernel.rglru_scan_bwd`` and the yardstick of its CUDA kernel.
- :func:`rglru_bwd_tiled_ref` computes the backward's gradient scan in the
  CUDA kernel's order, tile by tile or cut into chunks as the kernel's
  blocks take it; the tests use it to check that the chunks change no
  bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rglru_ref(a: torch.Tensor, b: torch.Tensor,
              h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: [B, S, L]; ``h0`` [B, L] or None.  Returns (h [B, S, L],
    h_last [B, L]), float32."""
    Bsz, S, L = a.shape
    af, bf = a.float(), b.float()
    h = (torch.zeros((Bsz, L), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    hs = []
    for t in range(S):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rglru_call_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, chunk: int = 2048
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: [B, S, L]; ``h0`` [B, L] or None (zeros).  S must be a
    multiple of ``min(chunk, S)``.  Returns (h [B, S, L], h_last [B, L]),
    float32."""
    Bsz, S, L = a.shape
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence {S} must divide the scan chunk {Q}")
    carry = (torch.zeros((Bsz, L), dtype=torch.float32, device=a.device)
             if h0 is None else h0.float())
    out = []
    for c0 in range(0, S, Q):
        ac = a[:, c0:c0 + Q].float()
        bc = b[:, c0:c0 + Q].float()
        # after the rounds, bc = scan within the chunk from a zero state and
        # ac = the running product of the decays
        s = 1
        while s < Q:
            bc = torch.cat([bc[:, :s], bc[:, s:] + ac[:, s:] * bc[:, :-s]], 1)
            ac = torch.cat([ac[:, :s], ac[:, s:] * ac[:, :-s]], 1)
            s *= 2
        hc = bc + ac * carry[:, None]                  # fold the carry in
        carry = hc[:, -1]
        out.append(hc)
    return torch.cat(out, dim=1), carry


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x * y + z rounded once to float32 (the float64 product is exact),
    as the kernel's FMA rounds it but for rare double roundings."""
    return (x.double() * y.double() + z.double()).float()


def rglru_tiled_ref(a: torch.Tensor, b: torch.Tensor,
                    h0: Optional[torch.Tensor] = None, *, steps: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence in the order of ``csrc/rglru.cu``, for tiles of
    ``steps`` steps (the kernel's are ``kernel.tile_steps()``): ``h0`` folded into
    the first step as ``b_0 = a_0 * h0 + b_0`` (two roundings); each tile
    of ``steps`` steps reduced to ``h -> A h + B`` (A the product of its
    decays, B its scan from a zero state); the carry into tile k composed
    as ``c_k = A_k c_{k-1} + B_k`` from ``c_{-1} = 0``; and h sequential
    within the tile from its carry.  a, b: [B, S, L]; ``h0`` [B, L] or
    None.  Returns (h [B, S, L], h_last [B, L]), float32."""
    Bsz, S, L = a.shape
    af, bf = a.float(), b.float().clone()
    if h0 is not None and S:
        bf[:, 0] = af[:, 0] * h0.float() + bf[:, 0]
    carry = torch.zeros((Bsz, L), dtype=torch.float32, device=a.device)
    hs = []
    for t0 in range(0, S, steps):
        ac, bc = af[:, t0:t0 + steps], bf[:, t0:t0 + steps]
        A = torch.ones_like(carry)
        B = torch.zeros_like(carry)
        h = carry
        for t in range(ac.shape[1]):
            A = A * ac[:, t]
            B = _fma(ac[:, t], B, bc[:, t])
            h = _fma(ac[:, t], h, bc[:, t])
            hs.append(h)
        carry = _fma(A, carry, B)
    if not hs:
        return (torch.empty((Bsz, 0, L), dtype=torch.float32, device=a.device),
                carry if h0 is None else h0.float())
    return torch.stack(hs, dim=1), hs[-1]


def rglru_bwd_ref(u: torch.Tensor, a: torch.Tensor,
                  h0: Optional[torch.Tensor], dh: torch.Tensor,
                  dh_last: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             Optional[torch.Tensor]]:
    """The gradient of ``h_t = a_t h_{t-1} + u_t`` (h_{-1} = ``h0``, or 0)
    for the cotangents ``dh`` [B, S, L] of h and ``dh_last`` [B, L] (or
    None) of h_last:

        g_t   = dh_t + a_{t+1} g_{t+1}   (g_{S-1} = dh_{S-1} + dh_last)
        du_t  = g_t                       (in u's type)
        da_t  = g_t h_{t-1}               (float32, with the float32 h)
        dh0   = a_0 g_0                   (None without ``h0``)

    The float32 h is recomputed by :func:`rglru_call_ref`, and g is the
    same doubling scan run backward in time.  Returns (du, da, dh0)."""
    Bsz, S, L = a.shape
    af = a.float()
    h, _ = rglru_call_ref(af, u.float(), h0)
    h_prev = torch.cat([(torch.zeros_like(h[:, :1]) if h0 is None
                         else h0.float()[:, None]), h[:, :-1]], dim=1)
    # backward in time: G_s = g_{S-1-s} = dh_{S-1-s} + a_{S-s} G_{s-1}
    a_rev = torch.cat([torch.ones_like(af[:, :1]),
                       torch.flip(af, (1,))[:, :-1]], dim=1)
    carry = None if dh_last is None else dh_last.float()
    g_rev, _ = rglru_call_ref(a_rev, torch.flip(dh.float(), (1,)), carry)
    g = torch.flip(g_rev, (1,))
    dh0 = None if h0 is None else af[:, 0] * g[:, 0]
    return g.to(u.dtype), g * h_prev, dh0


def _bwd_map(ac: torch.Tensor, gc: torch.Tensor):
    """A tile's map x -> A x + B of the gradient x arriving from its right
    (B = a_{t0} g_{t0} from x = 0), as the kernel reduces it: ac, gc [B, n,
    L] float32."""
    n = ac.shape[1]
    A, G = ac[:, n - 1].clone(), gc[:, n - 1]
    for t in range(n - 2, -1, -1):
        A = A * ac[:, t]
        G = _fma(ac[:, t + 1], G, gc[:, t])
    return A, ac[:, 0] * G


def _bwd_tile_g(ac: torch.Tensor, gc: torch.Tensor, x: torch.Tensor):
    """g over a tile from the gradient x arriving from its right."""
    n = ac.shape[1]
    g = gc[:, n - 1] + x
    out = [g]
    for t in range(n - 2, -1, -1):
        g = _fma(ac[:, t + 1], g, gc[:, t])
        out.append(g)
    return torch.stack(out[::-1], dim=1)


def rglru_bwd_tiled_ref(a: torch.Tensor, dh: torch.Tensor,
                        dh_last: Optional[torch.Tensor] = None, *, steps: int,
                        chunk_tiles: Optional[int] = None) -> torch.Tensor:
    """g_t = dh_t + a_{t+1} g_{t+1} (g_{S-1} = dh_{S-1} + dh_last) in the
    order of ``csrc/rglru.cu``'s backward, for tiles of ``steps`` steps:
    each tile reduced to its map x -> A x + B, the gradient x into tile k
    composed as x_k = A_{k+1} x_{k+1} + B_{k+1} from the last tile's
    ``dh_last``, and g sequential within the tile from its x.  Without
    ``chunk_tiles`` the tiles are walked one at a time from the end; with
    it, as the kernel's blocks take them: every tile's map first, then each
    chunk of ``chunk_tiles`` tiles, from the last, runs the carry of the
    chunk to its right through its maps, then every tile's g.  The two
    orders perform the same roundings, so they agree bit for bit.  a, dh:
    [B, S, L]; returns g [B, S, L] float32."""
    Bsz, S, L = a.shape
    af, gf = a.float(), dh.float()
    edges = list(range(0, S, steps))
    tiles = [(t0, min(t0 + steps, S)) for t0 in edges]
    x = (torch.zeros((Bsz, L), dtype=torch.float32, device=a.device)
         if dh_last is None else dh_last.float())
    g = torch.empty((Bsz, S, L), dtype=torch.float32, device=a.device)
    if chunk_tiles is None:
        for t0, t1 in reversed(tiles):
            g[:, t0:t1] = _bwd_tile_g(af[:, t0:t1], gf[:, t0:t1], x)
            A, B = _bwd_map(af[:, t0:t1], gf[:, t0:t1])
            x = _fma(A, x, B)
        return g
    maps = [_bwd_map(af[:, t0:t1], gf[:, t0:t1]) for t0, t1 in tiles]
    x_in = [None] * len(tiles)
    for c0 in reversed(range(0, len(tiles), chunk_tiles)):
        for k in reversed(range(c0, min(c0 + chunk_tiles, len(tiles)))):
            x_in[k] = x
            x = _fma(maps[k][0], x, maps[k][1])
    for k, (t0, t1) in enumerate(tiles):
        g[:, t0:t1] = _bwd_tile_g(af[:, t0:t1], gf[:, t0:t1], x_in[k])
    return g
