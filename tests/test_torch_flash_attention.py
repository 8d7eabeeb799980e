"""The port's attention against the JAX package's, on the CPU.

The port's ``attention_prefill`` (plain chunked path), ``attention_ref``
and ``flash_attention`` (whose CPU path is the kernels' plain versions)
against JAX's ``attention_prefill`` and JAX's Pallas ``flash_attention``
run with ``interpret=True``, as ``tests/test_kernels.py`` runs it, at that
file's six shape cases and at RecurrentGemma's head dim 256 (MQA, a window).
Inputs are seeded numpy arrays handed to both.

Tolerances are the JAX package's own for its kernel: 2e-5 in float32 and
3e-2 in bfloat16 (absolute and relative).  Gradients (float32) are held
against ``jax.grad`` of JAX's ``attention_prefill`` within 1e-5: the same
arithmetic summed in another order (measured worst 1.2e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.models.attention import attention_prefill as jax_prefill
from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.attention import attention_prefill

CASES = [
    (2, 256, 256, 4, 2, 64, True, None),      # GQA causal
    (1, 300, 300, 4, 4, 64, True, None),      # MHA, ragged
    (2, 128, 512, 8, 2, 128, True, None),     # q suffix of k (q_offset)
    (1, 256, 256, 2, 1, 64, True, 128),       # MQA + sliding window
    (1, 200, 200, 4, 2, 64, False, None),     # non-causal (encoder)
    (1, 512, 512, 2, 2, 128, True, 64),       # small window, banded skip
    (1, 256, 256, 4, 1, 256, True, 64),       # RecurrentGemma: MQA, D=256
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
GRAD_TOL = 1e-5


def _inputs(case, seed=0):
    B, Sq, Sk, H, Kv, D, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, Kv, D), (B, Sk, Kv, D),
                      (B, Sq, H, D))]


def _port_paths(q, k, v, causal, window, qo):
    kw = dict(causal=causal, window=window, q_offset=qo)
    return {
        "attention_prefill": attention_prefill(q, k, v, **kw),
        "attention_ref": ref.attention_ref(q, k, v, **kw),
        "flash_attention": flash_attention(q, k, v, **kw),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_forward_matches_jax_prefill_and_jax_flash_kernel(case, dtype):
    _, Sq, Sk, _, _, _, causal, window = case
    qo = Sk - Sq
    q, k, v, _ = _inputs(case)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    want = {
        "jax attention_prefill": jax_prefill(jq, jk, jv, causal=causal,
                                             window=window, q_offset=qo),
        "jax flash_attention": jax_flash(jq, jk, jv, causal=causal,
                                         window=window, q_offset=qo,
                                         block_q=128, block_k=128,
                                         interpret=True),
    }
    got = _port_paths(tq, tk, tv, causal, window, qo)
    tol = TOL[dtype]
    for name, out in got.items():
        assert out.dtype == tdt and out.shape == tq.shape, name
        for wname, w in want.items():
            np.testing.assert_allclose(
                out.float().numpy(), np.asarray(w, np.float32), atol=tol,
                rtol=tol, err_msg=f"{name} vs {wname}")


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_gradients_match_jax_grad(case):
    _, Sq, Sk, _, _, _, causal, window = case
    qo = Sk - Sq
    q, k, v, g = _inputs(case, seed=1)
    kw = dict(causal=causal, window=window, q_offset=qo)
    want = jax.grad(lambda a, b, c: jnp.sum(jax_prefill(a, b, c, **kw) * g),
                    argnums=(0, 1, 2))(q, k, v)
    for fn in (attention_prefill, flash_attention):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        out = fn(tq, tk, tv, **kw)
        got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
        for name, a, b in zip("qkv", got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=f"{fn.__name__} d{name}")


def test_plain_forward_gives_the_row_log_sum_exp():
    """``flash_fwd``'s CPU path returns the lse the backward kernel reads:
    log of the softmax denominator of the scaled, masked scores."""
    q, k, v, _ = _inputs(CASES[3])
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = K.flash_fwd(tq, tk, tv, causal=True, window=128)
    assert lse.shape == (1, 2, 256) and lse.dtype == torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk.repeat_interleave(2, 2)) / 8.0
    pos = torch.arange(256)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - 128)
    want = torch.logsumexp(torch.where(mask, s, -torch.inf), dim=-1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(o, ref.attention_ref(tq, tk, tv, window=128))


def test_kernel_mode_cuda_refuses_cpu_tensors():
    q, k, v, _ = _inputs(CASES[0])
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = K.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_fwd(tq, tk, tv, mode=KernelMode.CUDA)
    with pytest.raises(ValueError, match="CUDA"):
        attention_prefill(tq, tk, tv, kernel_mode="cuda")
    assert K.launch_counts() == before


@pytest.mark.parametrize("shape,dtype", [
    ((1, 8, 2, 96), torch.float32),          # head dim the kernel lacks
    ((1, 8, 2, 64), torch.float16),          # type the kernel lacks
])
def test_kernel_input_checks_refuse_what_the_kernel_does_not_take(shape,
                                                                  dtype):
    q = torch.zeros(shape, dtype=dtype)
    with pytest.raises((TypeError, ValueError)):
        K._inputs(q, q, q)


ROUTE_TABLE = [   # dtype, head dim, backward, kernel or the error raised
    *[(torch.bfloat16, D, bwd, "tc") for D in (64, 128)
      for bwd in (False, True)],
    *[(torch.float32, D, bwd, "fma") for D in (64, 128)
      for bwd in (False, True)],
    *[(torch.bfloat16, 256, bwd, "tc") for bwd in (False, True)],
    *[(torch.float32, 256, bwd, "fma") for bwd in (False, True)],
    # the smoke configs' head dims: the FMA kernels, either type, both ways
    *[(dt, D, bwd, "fma") for D in (8, 12, 16)
      for dt in (torch.bfloat16, torch.float32) for bwd in (False, True)],
    *[(dt, 96, bwd, ValueError) for dt in (torch.bfloat16, torch.float32)
      for bwd in (False, True)],
    *[(torch.float16, D, bwd, TypeError) for D in (64, 128, 256)
      for bwd in (False, True)],
]


@pytest.mark.parametrize("dtype,D,backward,want", ROUTE_TABLE,
                         ids=lambda x: str(x).replace("torch.", ""))
def test_route_picks_the_kernel_for_each_type_head_dim_and_direction(
        dtype, D, backward, want):
    """bfloat16 at head dims 64, 128 and 256 takes the tensor-core kernels,
    both ways; float32 and head dims 8, 12 and 16 the FMA ones; the rest
    raises."""
    if isinstance(want, str):
        assert K.route(dtype, D, backward) == want
        assert want in K.ROUTES and want in K.TILES
    else:
        with pytest.raises(want):
            K.route(dtype, D, backward)


@pytest.mark.parametrize("kernel", ["tc", "fma", "wgmma"])
def test_launch_refuses_cpu_tensors_and_unknown_routes(kernel):
    """The launchers never run a plain version: a CPU tensor or a route
    that no kernel has raises before any library is built."""
    q, k, v, _ = _inputs(CASES[0])
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    with pytest.raises(ValueError, match="route" if kernel == "wgmma"
                       else "CUDA"):
        K.launch_fwd(tq, tk, tv, kernel=kernel)


def test_launch_counts_split_the_totals_by_route():
    counts = K.launch_counts()
    for fn in ("flash_fwd", "flash_bwd", "flash_fwd_d256", "flash_bwd_d256"):
        assert {f"{fn}_{r}" for r in K.ROUTES} <= counts.keys()
        assert fn in counts


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 64, (128, 64)), (torch.bfloat16, 128, (128, 64)),
    (torch.bfloat16, 256, (64, 32)), (torch.float32, 256, (64, 64)),
    (torch.float32, 128, (64, 64)), (torch.bfloat16, 12, (64, 64)),
])
def test_forward_tile_follows_the_route(dtype, D, want):
    """The tensor-core forward takes 128 x 64 tiles, 64 x 32 at head dim
    256 (16 rows a warp); the FMA forward 64 x 64 at every head dim."""
    assert K.fwd_tile(dtype, D) == want


def _config_head_dims():
    from repro_torch.configs import ARCH_IDS, get_config
    out = []
    for arch in ARCH_IDS:
        for smoke in (False, True):
            cfg = get_config(arch, smoke)
            if cfg.family in ("dense", "moe", "hybrid"):
                out.append((arch, smoke, cfg.family, cfg.hd))
    return out


@pytest.mark.parametrize("arch,smoke,family,D", _config_head_dims(),
                         ids=lambda x: str(x))
def test_every_configured_head_dim_has_a_kernel(arch, smoke, family, D):
    """Every head dim a config of a ported family declares, full and smoke,
    has a forward and a backward kernel in either type: the kernels take
    what the models run and train."""
    for dtype in (torch.bfloat16, torch.float32):
        assert K.route(dtype, D) in K.ROUTES
        assert K.route(dtype, D, backward=True) in K.ROUTES


def test_init_cache_matches_jax():
    from repro.models.attention import init_cache as jax_init_cache
    from repro_torch.models.attention import init_cache
    for window in (None, 6):
        want = jax_init_cache(2, 3, 8, 2, 16, window=window,
                              dtype=jnp.bfloat16)
        got = init_cache(2, 3, 8, 2, 16, window=window, dtype=torch.bfloat16,
                         device="cpu")
        for f in ("k", "v", "positions", "length"):
            a, b = np.asarray(getattr(want, f)), getattr(got, f)
            assert a.shape == tuple(b.shape), f
            assert np.array_equal(a.astype(np.float32), b.float().numpy()), f
        assert got.k.dtype == torch.bfloat16
        assert got.positions.dtype == torch.int32


@pytest.mark.parametrize("case", [
    (1, 256, 256, 4, 1, 256, True, 64),      # RecurrentGemma: MQA, a window
    (2, 96, 320, 4, 2, 256, True, 100),      # q_offset, GQA, a ragged window
], ids=lambda c: "-".join(map(str, c)))
def test_head_dim_256_backward_plain_version_matches_jax_vjp(case):
    """``attention_bwd_ref`` (the plain version of the backward kernels,
    the CPU path of ``flash_bwd``) at head dim 256 with a window against
    ``jax.vjp`` of JAX's ``attention_ref``, within 1e-5 (GRAD_TOL)."""
    from repro.kernels.flash_attention.ref import attention_ref as jax_ref
    _, Sq, Sk, _, _, _, causal, window = case
    kw = dict(causal=causal, window=window, q_offset=Sk - Sq)
    q, k, v, g = _inputs(case, seed=2)
    _, vjp = jax.vjp(lambda a, b, c: jax_ref(a, b, c, **kw), q, k, v)
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o, lse = K.flash_fwd(tq, tk, tv, **kw)
    got = K.flash_bwd(tq, tk, tv, o, lse, tg, **kw)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"d{name}")


SCHEDULE_CASES = [   # Sq, Sk, G, groups, causal, window, q_offset
    (4096, 4096, 16, 8, True, 2048, 0),     # RecurrentGemma-9B's train shape
    (4096, 4096, 16, 2, True, 2048, 0),
    (300, 300, 2, 8, True, None, 0),        # more groups than heads
    (130, 258, 16, 3, True, 100, 128),      # uneven groups, q_offset
    (96, 64, 2, 2, True, 50, 100),          # rows with no live key
    (333, 333, 4, 4, False, 48, 0),         # a window, not causal
    (200, 200, 1, 1, False, None, 0),
]


def _live(Sq, Sk, causal, window, q_offset):
    q = q_offset + np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    live = np.ones((Sq, Sk), bool)
    if causal:
        live &= k <= q
    if window is not None:
        live &= k > q - window
    return live


@pytest.mark.parametrize("case", SCHEDULE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_d256_dkdv_schedule_covers_every_block_once_heaviest_first(case):
    """The bf16 backward at head dim 256 launches one dK/dV block per (key
    tile of 64, head group): the schedule names each exactly once, the
    groups split the G heads into contiguous runs, every query tile with a
    live pair of a key tile lies in the range the block walks, and the
    blocks come heaviest first (heads x query tiles)."""
    Sq, Sk, G, groups, causal, window, q_offset = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    heads = K.head_groups(G, groups)
    n = len(heads)
    assert n == min(groups, G)
    assert heads[0][0] == 0 and heads[-1][1] == G
    assert all(lo < hi for lo, hi in heads)
    assert all(a[1] == b[0] for a, b in zip(heads, heads[1:]))
    sched = K.dkdv_schedule(Sq, Sk, G, n, **kw)
    tk, tq = K.D256_KEY_TILE, K.D256_QUERY_TILE
    n_kt = -(-Sk // tk)
    assert sorted(sched) == list(range(n_kt * n))
    live = _live(Sq, Sk, causal, window, q_offset)
    work = []
    for entry in sched:
        kt, grp = divmod(entry, n)
        lo, hi = K.query_tile_range(Sq, kt * tk, tq=tq, tk=tk, true_k=Sk,
                                    **kw)
        seen = {i // tq for i in np.nonzero(
            live[:, kt * tk:(kt + 1) * tk].any(1))[0]}
        assert seen <= set(range(lo, hi)), (kt, seen, lo, hi)
        work.append((heads[grp][1] - heads[grp][0]) * max(hi - lo, 0))
    assert work == sorted(work, reverse=True)


def test_d256_backward_of_head_groups_adds_up_to_the_whole():
    """The dK/dV partial sums of the bf16 backward at head dim 256, one per
    head group (the group's query heads alone against the kv head), added
    in the groups' order, equal the whole backward's dK and dV within 1e-5
    (float32, the plain version)."""
    B, S, H, Kv, D = 1, 96, 6, 1, 256
    rng = np.random.default_rng(3)
    q, do = (torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Kv, D)).astype(
        np.float32)) for _ in range(2))
    kw = dict(causal=True, window=40, q_offset=0)
    _, dk, dv = ref.attention_bwd_ref(q, k, v, do, **kw)
    parts = [ref.attention_bwd_ref(q[:, :, lo:hi], k, v, do[:, :, lo:hi],
                                   **kw)[1:]
             for lo, hi in K.head_groups(H, 4)]
    sk, sv = parts[0]
    for pk, pv in parts[1:]:
        sk, sv = sk + pk, sv + pv
    torch.testing.assert_close(sk, dk, atol=GRAD_TOL, rtol=GRAD_TOL)
    torch.testing.assert_close(sv, dv, atol=GRAD_TOL, rtol=GRAD_TOL)
