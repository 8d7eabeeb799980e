// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_hm` (`_attn_kernel`) of
// src/repro/kernels/flash_attention/kernel.py:107: causal / sliding-window
// GQA attention with an online softmax in float32, `q_offset` (the absolute
// position of query row 0) and `true_k` (keys at or beyond it are masked).
// The TPU kernel has no backward (XLA differentiated the jnp path); the
// backward here recomputes the probabilities from the saved row
// log-sum-exp.  A row whose keys are all masked gets o = 0 and lse = -inf,
// as the TPU kernel gives.
//
// Layout: q, o, dq [B, Sq, H, D]; k, v, dk, dv [B, Sk, Kv, D]; lse, delta
// [B, H, Sq] float32.  The model's [B, S, heads, D] layout is read in place
// through row strides, so nothing is transposed or padded: ragged tiles are
// masked here.  Query head h reads kv head h / (H / Kv).  Every block owns
// its outputs, so no atomics: dK/dV are summed over the G query heads of a
// kv head inside one block, and the results do not depend on the order in
// which blocks run.  Only live tiles are visited (none above the causal
// diagonal, none wholly outside the window, none at or beyond `true_k`).
//
// Two designs; the wrapper (`kernel.py::route`) picks one by type and head
// dim, and neither gives way to the other.
//
// 1. bfloat16 at head dims 64, 128 and 256, namespace `tc` (the train
// step, the bf16 prefill and RecurrentGemma's local attention).  What
// bounds it: at the train shape (S = 4096, D = 128, causal) the forward
// does about 1,650 operations per byte of q, k, v and o, far above the
// card's balance point of about 295, so the bf16 tensor-core rate bounds
// it, and the backward (2.5x the products) too; at RecurrentGemma's (S =
// 32768, D = 256, a window of 2048) the forward does some 4,000 per byte,
// bound by the tensor cores as well.  Hopper's tensor cores reach that rate
// only through `wgmma`, an asynchronous warpgroup product that reads its
// operands from shared memory in the layout of a 128-byte swizzle (or A
// from registers), so the design (see "the warp-specialised kernels"
// below; the forward at every tc head dim, the backward at 64 and 128) is
// built around keeping them fed:
// - every product is a `wgmma` with float32 accumulators, in blocks of
//   three warpgroups: a producer that brings every tile in by TMA (its map
//   swizzles the tile into the panel layout `wgmma` reads, and zero-fills
//   rows past Sq or Sk) through a ring of three stages (two in the forward
//   at head dim 256) under `mbarrier`s, and
//   hands its registers to two consumer warpgroups of 64 rows each;
// - within a consumer the next product is issued before the current tile's
//   probabilities or score gradients are formed, so that arithmetic runs
//   while the tensor cores work (forward: S of key tile j + 1 and P V of
//   tile j; dQ: S and dP of tile j + 1 and dS K of tile j; dK/dV: S^T and
//   dP^T together, then dV while dS^T is formed);
// - scores, probabilities and score gradients stay in registers, are
//   rounded to bf16 there and feed the next product as its A operand (P V,
//   P^T dO, dS^T Q, dS K);
// - the online softmax runs in exp2 with the scale folded into log2(e); the
//   mask is applied only to tiles that hold a masked pair (the diagonal, the
//   window's edge, the `true_k` edge); fully live tiles skip it;
// - the query tiles with the most key tiles are scheduled first, which evens
//   out the causal imbalance across the card;
// - the backward keeps three launches: delta = rowsum(dO * O); dK/dV, one
//   block per key tile of 128, S^T = K Q^T and dP^T = V dO^T once a (head,
//   query tile of 64), so P^T and dS^T are already A operands; and dQ, one
//   block per query tile of 128, which recomputes S and dP (two products
//   more than accumulating dQ with atomics, but deterministic: two runs
//   give the same gradients).
// The forward at head dim 256 (RecurrentGemma's local attention) is the
// same warp-specialised kernel with 64-key stages in a ring of two (see
// `ws::FwdTile`): a 128-row Q tile takes 64 KB of shared memory and each
// stage of K and V 64 KB more, and a consumer's 64 x 256 float32 output
// takes 128 registers a thread, which leaves room for a 64-key score tile
// but not a 128-key one.
// The backward at head dim 256 (RecurrentGemma's train step: 16 query heads
// on one kv head, a window of 2048) runs on wgmma in four launches (see
// "the backward on wgmma" below): delta; dK/dV, one block per (key tile of
// 64, group of query heads), which computes S^T and dP^T once a (key tile,
// query tile, head) and writes its group's float32 partial sums; their sum,
// in the groups' order, scaled and rounded once; and dQ, recomputing S and
// dP.  7 products of 2 D operations a live pair, against the bound's 5
// (the mma.sync kernels they replace did 9: each dK/dV block owned half the
// columns and recomputed S^T and dP^T).  What bounds it on this card: the tensor
// cores, but 227 KB of shared memory holds only K, V and two 64-row stages
// of Q and dO (or Q, dO and two 32-key stages of K and V), so one block of
// two warpgroups fills an SM, the warpgroups move in step, and the tensor
// cores idle while they form P and dS; the m64n32 score products also read
// 3 KB of shared memory a 16-deep step.  Splitting the 16 heads into 8
// groups makes 512 dK/dV blocks where 64 key tiles give 64, heaviest first
// (1, 2, 4 and 16 groups were slower: PERF.md).  On the card
// (bwd_bench.py, H100, 700 W): 1.10-1.23 ms a call at the train shape, of
// which 1.03-1.05 on the device, against a 0.261 ms bound and 2.66-2.79 ms
// for the mma.sync kernels.
// Why `mma.sync` is gone at head dims 64 and 128: an earlier `wgmma`
// version was set aside because the train cell's loss rose at seed 0.
// Measured against float32 (PERF.md, section 6), the cell's step-1
// gradients lie as far from the exact ones on the `mma.sync` kernels as on
// the plain path (about 95% of their signs agreeing on either, 99.95% of
// the large ones), and AdamW's first step follows every sign: the loss at
// seed 0 moves by more than 1 with rounding alone, so the cell cannot tell
// two right kernels apart.  The `wgmma` kernels read the same distances
// from float32 as `mma.sync`'s at the flash level, in less time.

// 2. float32 at head dims 64, 128 and 256, and both types at the smoke
// configs' head dims 8, 12 and 16: float32 FMA on the CUDA cores, 64 x 64 tiles widened to float32 in shared memory, 256 threads each
// owning 4 x 4 of a tile.  Exact rather than fast: the float32 checks hold
// the loss and gradients within 1e-4 with TF32 off, which these kernels
// meet.  Head dims 8, 12 and 16 run on a tile 16 wide: the true head dim is
// an argument, columns past it load as zero and are not stored, and the
// scale is the true head dim's.  Their rows are loaded value by value (a
// row of 12 bf16 values is 24 bytes, so a head's offset is not 16-byte
// aligned); they need no speed.  At head dim 256 Q, K and V in float32 with
// the probability tile take 214,016 bytes of shared memory, one block per
// SM; its backward takes the head dim in chunks of 64 columns
// (`dkdv_wide_kernel`, `dq_wide_kernel`).  bf16 at 256 keeps these kernels
// only to be timed beside the tensor-core ones (`kernel.launch_fwd(kernel=
// "fma")`, `launch_bwd`).
//
// Every `flash_*` function returns the `cudaError_t` of its launches.
#include <math.h>

#include "../../hopper.cuh"   // wgmma, mbarriers, TMA; includes the CUDA headers

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads; each owns 4 rows x 4 cols of a tile
constexpr int LDP = BK + 1;   // row pitch of the probability tile in shared memory
constexpr float NEG_INF = -1e30f;

struct Params {
  int B, H, Kv, Sq, Sk;
  int D;         // head dim; the FMA kernels' tile may be wider (zero-padded)
  int causal;    // 0 or 1
  int window;    // 0: no window; else keys in (q_pos - window, q_pos]
  int q_offset;  // absolute position of query row 0
  int true_k;    // keys at or beyond are masked
  float scale;   // D ** -0.5
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16-byte vector -> floats: 4 float32 or 8 bfloat16 values.
__device__ __forceinline__ void unpack(const uint4& raw, float* out, float) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = f[e];
}
__device__ __forceinline__ void unpack(const uint4& raw, float* out, __nv_bfloat16) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(h[e]);
}

// Rows [0, 64) of a tile into shared memory as float32 [64][D + 1], times
// `mul`; rows at or beyond `n_valid` are zero.  `g` points at row 0, rows
// are `pitch` elements apart.  Tiles of 64 columns and more are loaded as
// 16-byte vectors (the row and the head offset are 16-byte aligned: the
// wrapper checks the base); the narrow tile (D = 16, head dims 8, 12 and 16)
// value by value, since a head's row of 12 bf16 values is 24 bytes, and
// columns at or beyond the true head dim `dt` read zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* s, const T* g, size_t pitch,
                                          int n_valid, float mul, int dt) {
  if constexpr (D < 64) {
    for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
      const int r = idx / D, c = idx % D;
      s[r * (D + 1) + c] = r < n_valid && c < dt ? to_f(g[r * pitch + c]) * mul : 0.f;
    }
    return;
  }
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < 64 * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * VEC;
    float vals[VEC];
    if (r < n_valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(g + r * pitch + c);
      unpack(raw, vals, T());
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) s[r * LD + c + e] = vals[e] * mul;
  }
}

__device__ __forceinline__ bool live(const Params& p, int q_pos, int k_idx) {
  if (k_idx >= p.true_k) return false;
  if (p.causal && k_idx > q_pos) return false;
  if (p.window > 0 && k_idx <= q_pos - p.window) return false;
  return true;
}

// Key tiles [lo, hi) of TK rows that a query tile of TQ rows starting at
// row q0 must visit.
template <int TQ = BQ, int TK = BK>
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int* lo, int* hi) {
  const int q_first = p.q_offset + q0;
  const int q_last = p.q_offset + min(q0 + TQ, p.Sq) - 1;
  int end = (p.true_k + TK - 1) / TK;
  if (p.causal) end = min(end, q_last / TK + 1);
  int begin = 0;
  if (p.window > 0) {
    const int first_key = q_first - p.window + 1;
    if (first_key > 0) begin = first_key / TK;
  }
  *lo = begin;
  *hi = end;
}

// Query tiles [lo, hi) of TQ rows that see a key tile of TK rows starting
// at row k0.
template <int TQ = BQ, int TK = BK>
__device__ __forceinline__ void query_tiles(const Params& p, int k0, int* lo, int* hi) {
  const int nq = (p.Sq + TQ - 1) / TQ;
  const int k_last = min(k0 + TK, p.true_k) - 1;
  int begin = 0, end = nq;
  if (p.causal) {
    const int first_q = k0 - p.q_offset;
    if (first_q > 0) begin = first_q / TQ;
  }
  if (p.window > 0) {
    const int last_q = k_last + p.window - 1 - p.q_offset;
    end = last_q < 0 ? 0 : min(nq, last_q / TQ + 1);
  }
  *lo = begin;
  *hi = end;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// acc[i][j] += sum_d a[(ty*4+i)][d] * b[(tx+16j)][d] for two pairs at once
// (the backward needs Q.K^T and dO.V^T of the same tiles).
template <int D>
__device__ __forceinline__ void tile_dot2(const float* a0, const float* b0, float (*c0)[4],
                                          const float* a1, const float* b1, float (*c1)[4],
                                          int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x0[4], y0[4], x1[4], y1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0[i] = a0[(ty * 4 + i) * LD + d];
      x1[i] = a1[(ty * 4 + i) * LD + d];
      y0[i] = b0[(tx + 16 * i) * LD + d];
      y1[i] = b1[(tx + 16 * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c0[i][j] = fmaf(x0[i], y0[j], c0[i][j]);
        c1[i][j] = fmaf(x1[i], y1[j], c1[i][j]);
      }
  }
}

// ---------------------------------------------------------------------------
// forward: one block per (query tile, batch * head)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, Params p) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.Kv);
  const size_t q_pitch = (size_t)p.H * p.D, k_pitch = (size_t)p.Kv * p.D;
  const T* qb = q + ((size_t)b * p.Sq * p.H + h) * p.D;
  const T* kb = k + ((size_t)b * p.Sk * p.Kv + kvh) * p.D;
  const T* vb = v + ((size_t)b * p.Sk * p.Kv + kvh) * p.D;

  load_tile<T, D>(sQ, qb + q0 * q_pitch, q_pitch, p.Sq - q0, p.scale, p.D);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int kt0, kt1;
  key_tiles(p, q0, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(sK, kb + k0 * k_pitch, k_pitch, p.Sk - k0, 1.f, p.D);
    load_tile<T, D>(sV, vb + k0 * k_pitch, k_pitch, p.Sk - k0, 1.f, p.D);
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = sQ[(ty * 4 + i) * LD + d];
        y[i] = sK[(tx + 16 * i) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = p.q_offset + q0 + ty * 4 + i;
      bool ok[4];
      float mc = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = live(p, q_pos, k0 + tx + 16 * j);
        if (!ok[j]) s[i][j] = NEG_INF;
        mc = fmaxf(mc, s[i][j]);
      }
      const float mn = fmaxf(m[i], half_warp_max(mc));
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = ok[j] ? expf(s[i][j] - mn) : 0.f;
        rs += pij;
        sP[(ty * 4 + i) * LDP + tx + 16 * j] = pij;
      }
      l[i] = alpha * l[i] + half_warp_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const float vv = sV[c * LD + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);  // a fully masked row writes zeros
    T* orow = o + ((size_t)b * p.Sq * p.H + (size_t)row * p.H + h) * p.D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
      if (tx + 16 * cc < p.D) orow[tx + 16 * cc] = from_f<T>(acc[i][cc] / denom);
    if (tx == 0)
      lse[((size_t)b * p.H + h) * p.Sq + row] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// backward 1: delta = rowsum(dO * O), one warp per (b, row, h)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                             float* __restrict__ delta, Params p) {
  const size_t row = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const size_t n_rows = (size_t)p.B * p.Sq * p.H;
  if (row >= n_rows) return;  // warp-uniform
  const T* orow = o + row * p.D;
  const T* grow = dout + row * p.D;
  float acc = 0.f;
  for (int d = lane; d < p.D; d += 32) acc = fmaf(to_f(orow[d]), to_f(grow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % p.H;
    const size_t i = (row / p.H) % p.Sq, b = row / ((size_t)p.H * p.Sq);
    delta[(b * p.H + h) * p.Sq + i] = acc;
  }
}

// Probabilities and score gradients of one (query tile, key tile) pair:
// s <- P = exp(S - lse) on live entries, 0 elsewhere; dp <- dS = P * (dP - delta).
__device__ __forceinline__ void probs_and_dscores(const Params& p, float (*s)[4], float (*dp)[4],
                                                  const float* lse_rows, const float* delta_rows,
                                                  int q0, int k0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = qi < p.Sq && live(p, p.q_offset + qi, k0 + tx + 16 * j);
      const float pij = ok ? expf(s[i][j] - lse_rows[i]) : 0.f;
      s[i][j] = pij;
      dp[i][j] = pij * (dp[i][j] - delta_rows[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward 2: dK, dV; one block per (key tile, batch * kv head), looping over
// the G query heads of the kv head and the query tiles that see the key tile
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, Params p) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sG = sQ + BQ * LD;   // dO
  float* sP = sG + BQ * LD;   // P, then dS, [BQ][LDP]
  float* sL = sP + BQ * LDP;  // lse of the query tile's rows
  float* sD = sL + BQ;        // delta of the query tile's rows

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / p.Kv, kvh = blockIdx.y % p.Kv;
  const int G = p.H / p.Kv;
  const size_t q_pitch = (size_t)p.H * p.D, k_pitch = (size_t)p.Kv * p.D;
  const size_t k_off = ((size_t)b * p.Sk * p.Kv + kvh) * p.D + k0 * k_pitch;

  load_tile<T, D>(sK, k + k_off, k_pitch, p.Sk - k0, 1.f, p.D);
  load_tile<T, D>(sV, v + k_off, k_pitch, p.Sk - k0, 1.f, p.D);

  float gk[4][NC], gv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) gk[i][c] = gv[i][c] = 0.f;

  int qt0 = 0, qt1 = 0;
  if (k0 < p.true_k) query_tiles(p, k0, &qt0, &qt1);
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + ((size_t)b * p.Sq * p.H + h) * p.D;
    const T* gb = dout + ((size_t)b * p.Sq * p.H + h) * p.D;
    const size_t r_off = ((size_t)b * p.H + h) * p.Sq;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      load_tile<T, D>(sQ, qb + q0 * q_pitch, q_pitch, p.Sq - q0, p.scale, p.D);
      load_tile<T, D>(sG, gb + q0 * q_pitch, q_pitch, p.Sq - q0, 1.f, p.D);
      if (threadIdx.x < BQ) {
        const int row = q0 + threadIdx.x;
        sL[threadIdx.x] = row < p.Sq ? lse[r_off + row] : 0.f;
        sD[threadIdx.x] = row < p.Sq ? delta[r_off + row] : 0.f;
      }
      __syncthreads();

      float s[4][4] = {}, dp[4][4] = {};
      tile_dot2<D>(sQ, sK, s, sG, sV, dp, ty, tx);
      float lr[4], dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lr[i] = sL[ty * 4 + i];
        dr[i] = sD[ty * 4 + i];
      }
      probs_and_dscores(p, s, dp, lr, dr, q0, k0, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sP[(ty * 4 + i) * LDP + tx + 16 * j] = s[i][j];
      __syncthreads();
      // dV[key r][c] += sum_i P[i][r] * dO[i][c]
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float pr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) pr[r] = sP[i * LDP + ty * 4 + r];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const float gg = sG[i * LD + tx + 16 * cc];
#pragma unroll
          for (int r = 0; r < 4; ++r) gv[r][cc] = fmaf(pr[r], gg, gv[r][cc]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sP[(ty * 4 + i) * LDP + tx + 16 * j] = dp[i][j];
      __syncthreads();
      // dK[key r][c] += sum_i dS[i][r] * (scale * Q)[i][c]
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float dr2[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) dr2[r] = sP[i * LDP + ty * 4 + r];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const float qq = sQ[i * LD + tx + 16 * cc];
#pragma unroll
          for (int r = 0; r < 4; ++r) gk[r][cc] = fmaf(dr2[r], qq, gk[r][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = k0 + ty * 4 + r;
    if (row >= p.Sk) continue;
    const size_t off = ((size_t)b * p.Sk * p.Kv + (size_t)row * p.Kv + kvh) * p.D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      if (tx + 16 * cc >= p.D) continue;
      dk[off + tx + 16 * cc] = from_f<T>(gk[r][cc]);
      dv[off + tx + 16 * cc] = from_f<T>(gv[r][cc]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward 3: dQ; one block per (query tile, batch * head)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, Params p) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + BQ * LD;
  float* sK = sG + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.Kv);
  const size_t q_pitch = (size_t)p.H * p.D, k_pitch = (size_t)p.Kv * p.D;
  const size_t q_off = ((size_t)b * p.Sq * p.H + h) * p.D + q0 * q_pitch;
  const T* kb = k + ((size_t)b * p.Sk * p.Kv + kvh) * p.D;
  const T* vb = v + ((size_t)b * p.Sk * p.Kv + kvh) * p.D;
  const size_t r_off = ((size_t)b * p.H + h) * p.Sq;

  load_tile<T, D>(sQ, q + q_off, q_pitch, p.Sq - q0, p.scale, p.D);
  load_tile<T, D>(sG, dout + q_off, q_pitch, p.Sq - q0, 1.f, p.D);
  float lr[4], dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lr[i] = row < p.Sq ? lse[r_off + row] : 0.f;
    dr[i] = row < p.Sq ? delta[r_off + row] : 0.f;
  }
  float gq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) gq[i][c] = 0.f;

  int kt0, kt1;
  key_tiles(p, q0, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, D>(sK, kb + k0 * k_pitch, k_pitch, p.Sk - k0, 1.f, p.D);
    load_tile<T, D>(sV, vb + k0 * k_pitch, k_pitch, p.Sk - k0, 1.f, p.D);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot2<D>(sQ, sK, s, sG, sV, dp, ty, tx);
    probs_and_dscores(p, s, dp, lr, dr, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty * 4 + i) * LDP + tx + 16 * j] = dp[i][j];
    __syncthreads();
    // dQ[i][c] += sum_j dS[i][j] * K[j][c]
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sP[(ty * 4 + i) * LDP + j];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const float kk = sK[j * LD + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) gq[i][cc] = fmaf(ds[i], kk, gq[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
    T* qrow = dq + ((size_t)b * p.Sq * p.H + (size_t)row * p.H + h) * p.D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
      if (tx + 16 * cc < p.D) qrow[tx + 16 * cc] = from_f<T>(gq[i][cc] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// backward at head dim 256 (float32, and bf16 beside the tensor-core
// kernels): the tiles of 64 x 256 float32 would take 280 KB, so the head
// dim runs in chunks of WC = 64 columns.  S and dP are summed chunk by chunk
// (Q, K, dO and V chunks into four [64][65] tiles); dV, dK and dQ then take
// the chunks of dO, Q and K in turn against P or dS in shared memory.  Each
// thread keeps its 4 rows x 16 columns of both gradients in registers.
// ---------------------------------------------------------------------------
constexpr int WC = 64;                 // head-dim columns of a chunk
constexpr int WIDE_D = 256;

// S and dP of a (query tile, key tile) pair, accumulated over the head dim
// a chunk at a time.  qb, gb: the query tile's rows of q and dO; kb, vb:
// the key tile's rows of k and v.
template <typename T>
__device__ __forceinline__ void wide_scores(const T* qb, const T* gb, const T* kb, const T* vb,
                                            size_t q_pitch, size_t k_pitch, int nq, int nk,
                                            float scale, float* sQ, float* sG, float* sK,
                                            float* sV, float (*s)[4], float (*dp)[4], int ty,
                                            int tx) {
  for (int d0 = 0; d0 < WIDE_D; d0 += WC) {
    __syncthreads();  // the previous chunk's (or tile's) readers are done
    load_tile<T, WC>(sQ, qb + d0, q_pitch, nq, scale, WC);
    load_tile<T, WC>(sG, gb + d0, q_pitch, nq, 1.f, WC);
    load_tile<T, WC>(sK, kb + d0, k_pitch, nk, 1.f, WC);
    load_tile<T, WC>(sV, vb + d0, k_pitch, nk, 1.f, WC);
    __syncthreads();
    tile_dot2<WC>(sQ, sK, s, sG, sV, dp, ty, tx);
  }
}

// acc[r][c * 4 + cc] += sum_i sP[i][ty * 4 + r] * chunk c of `g`, column
// tx + 16 cc, for each chunk c loaded into `sW` in turn (times `mul`):
// the products P^T dO and dS^T Q of the dK/dV kernel.
template <typename T>
__device__ __forceinline__ void wide_pt_times(float (*acc)[WIDE_D / 16], const float* sP,
                                              float* sW, const T* g, size_t pitch, int n_valid,
                                              float mul, int ty, int tx) {
  constexpr int LDW = WC + 1;
#pragma unroll
  for (int c = 0; c < WIDE_D / WC; ++c) {
    __syncthreads();
    load_tile<T, WC>(sW, g + c * WC, pitch, n_valid, mul, WC);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < BQ; ++i) {
      float pr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pr[r] = sP[i * LDP + ty * 4 + r];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float w = sW[i * LDW + tx + 16 * cc];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c * 4 + cc] = fmaf(pr[r], w, acc[r][c * 4 + cc]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dkdv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                 Params p) {
  constexpr int D = WIDE_D, LDW = WC + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + 64 * LDW;
  float* sK = sG + 64 * LDW;
  float* sV = sK + 64 * LDW;
  float* sP = sV + 64 * LDW;   // P, then dS, [BQ][LDP]

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / p.Kv, kvh = blockIdx.y % p.Kv;
  const int G = p.H / p.Kv;
  const size_t q_pitch = (size_t)p.H * D, k_pitch = (size_t)p.Kv * D;
  const size_t k_off = ((size_t)b * p.Sk * p.Kv + kvh) * D + k0 * k_pitch;

  float gk[4][NC], gv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) gk[i][c] = gv[i][c] = 0.f;

  int qt0 = 0, qt1 = 0;
  if (k0 < p.true_k) query_tiles(p, k0, &qt0, &qt1);
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + ((size_t)b * p.Sq * p.H + h) * D;
    const T* gb = dout + ((size_t)b * p.Sq * p.H + h) * D;
    const size_t r_off = ((size_t)b * p.H + h) * p.Sq;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * BQ;
      float s[4][4] = {}, dp[4][4] = {};
      wide_scores<T>(qb + q0 * q_pitch, gb + q0 * q_pitch, k + k_off, v + k_off, q_pitch,
                     k_pitch, p.Sq - q0, p.Sk - k0, p.scale, sQ, sG, sK, sV, s, dp, ty, tx);
      float lr[4], dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        lr[i] = row < p.Sq ? lse[r_off + row] : 0.f;
        dr[i] = row < p.Sq ? delta[r_off + row] : 0.f;
      }
      probs_and_dscores(p, s, dp, lr, dr, q0, k0, ty, tx);
      __syncthreads();  // the previous tile's readers of sP are done
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sP[(ty * 4 + i) * LDP + tx + 16 * j] = s[i][j];
      // dV[key r] += sum_i P[i][r] dO[i]
      wide_pt_times<T>(gv, sP, sG, gb + q0 * q_pitch, q_pitch, p.Sq - q0, 1.f, ty, tx);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sP[(ty * 4 + i) * LDP + tx + 16 * j] = dp[i][j];
      // dK[key r] += sum_i dS[i][r] (scale Q)[i]
      wide_pt_times<T>(gk, sP, sQ, qb + q0 * q_pitch, q_pitch, p.Sq - q0, p.scale, ty, tx);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = k0 + ty * 4 + r;
    if (row >= p.Sk) continue;
    const size_t off = ((size_t)b * p.Sk * p.Kv + (size_t)row * p.Kv + kvh) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + tx + 16 * c] = from_f<T>(gk[r][c]);
      dv[off + tx + 16 * c] = from_f<T>(gv[r][c]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dq, Params p) {
  constexpr int D = WIDE_D, LDW = WC + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + 64 * LDW;
  float* sK = sG + 64 * LDW;
  float* sV = sK + 64 * LDW;
  float* sP = sV + 64 * LDW;   // dS, [BQ][LDP]

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.Kv);
  const size_t q_pitch = (size_t)p.H * D, k_pitch = (size_t)p.Kv * D;
  const size_t q_off = ((size_t)b * p.Sq * p.H + h) * D + q0 * q_pitch;
  const T* kb = k + ((size_t)b * p.Sk * p.Kv + kvh) * D;
  const T* vb = v + ((size_t)b * p.Sk * p.Kv + kvh) * D;
  const size_t r_off = ((size_t)b * p.H + h) * p.Sq;
  float lr[4], dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lr[i] = row < p.Sq ? lse[r_off + row] : 0.f;
    dr[i] = row < p.Sq ? delta[r_off + row] : 0.f;
  }
  float gq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) gq[i][c] = 0.f;

  int kt0, kt1;
  key_tiles(p, q0, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    float s[4][4] = {}, dp[4][4] = {};
    wide_scores<T>(q + q_off, dout + q_off, kb + k0 * k_pitch, vb + k0 * k_pitch, q_pitch,
                   k_pitch, p.Sq - q0, p.Sk - k0, p.scale, sQ, sG, sK, sV, s, dp, ty, tx);
    probs_and_dscores(p, s, dp, lr, dr, q0, k0, ty, tx);
    __syncthreads();  // the previous tile's readers of sP are done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty * 4 + i) * LDP + tx + 16 * j] = dp[i][j];
    // dQ[i] += sum_j dS[i][j] K[j], a chunk of K at a time
#pragma unroll
    for (int c = 0; c < D / WC; ++c) {
      __syncthreads();
      load_tile<T, WC>(sK, kb + k0 * k_pitch + c * WC, k_pitch, p.Sk - k0, 1.f, WC);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ds[i] = sP[(ty * 4 + i) * LDP + j];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float kk = sK[j * LDW + tx + 16 * cc];
#pragma unroll
          for (int i = 0; i < 4; ++i) gq[i][c * 4 + cc] = fmaf(ds[i], kk, gq[i][c * 4 + cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
    T* qrow = dq + ((size_t)b * p.Sq * p.H + (size_t)row * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) qrow[tx + 16 * c] = from_f<T>(gq[i][c] * p.scale);
  }
}

constexpr size_t wide_smem() { return (size_t)(4 * 64 * (WC + 1) + BQ * LDP) * sizeof(float); }

template <typename T>
cudaError_t launch_bwd_wide(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const float* lse, float* delta, void* dq, void* dk,
                            void* dv, const Params& p, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const size_t n_rows = (size_t)p.B * p.Sq * p.H;
  delta_kernel<T><<<(unsigned)((n_rows * 32 + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      static_cast<const T*>(o), gt, delta, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wide_smem());
  if (err != cudaSuccess) return err;
  dkdv_wide_kernel<T><<<dim3((p.Sk + BK - 1) / BK, p.B * p.Kv), THREADS, wide_smem(), stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wide_smem());
  if (err != cudaSuccess) return err;
  dq_wide_kernel<T><<<dim3((p.Sq + BQ - 1) / BQ, p.B * p.H), THREADS, wide_smem(), stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), p);
  return cudaGetLastError();
}

template <int D>
constexpr size_t fwd_smem() { return (size_t)(3 * 64 * (D + 1) + BQ * LDP) * sizeof(float); }
template <int D>
constexpr size_t bwd_smem() {
  return (size_t)(4 * 64 * (D + 1) + BQ * LDP + 2 * BQ) * sizeof(float);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       const Params& p, cudaStream_t stream) {
  auto kern = fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)fwd_smem<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  kern<<<grid, THREADS, fwd_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, const Params& p, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const size_t n_rows = (size_t)p.B * p.Sq * p.H;
  delta_kernel<T><<<(unsigned)((n_rows * 32 + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      static_cast<const T*>(o), gt, delta, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kv_kern = dkdv_kernel<T, D>;
  err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bwd_smem<D>());
  if (err != cudaSuccess) return err;
  kv_kern<<<dim3((p.Sk + BK - 1) / BK, p.B * p.Kv), THREADS, bwd_smem<D>(), stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto q_kern = dq_kernel<T, D>;
  err = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)fwd_smem<D>() + (int)(64 * (D + 1) * sizeof(float)));
  if (err != cudaSuccess) return err;
  q_kern<<<dim3((p.Sq + BQ - 1) / BQ, p.B * p.H), THREADS,
           fwd_smem<D>() + 64 * (D + 1) * sizeof(float), stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), p);
  return cudaGetLastError();
}

// ===========================================================================
// bfloat16: the tensor-core kernels, all on wgmma.  First the helpers and
// the backward at head dim 256, then the warp-specialised kernels (the
// forward at 64, 128 and 256, the backward at 64 and 128)
// ===========================================================================
namespace tc {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Does the (query tile [q0, q0 + tq), key tile [k0, k0 + tk)) pair hold a
// masked pair?  Fully live tiles skip the mask.
__device__ __forceinline__ bool needs_mask(const Params& p, int q0, int tq, int k0, int tk) {
  const int q_first = p.q_offset + q0, q_last = q_first + tq - 1;
  if (k0 + tk > p.true_k) return true;
  if (p.causal && k0 + tk - 1 > q_first) return true;
  if (p.window > 0 && k0 <= q_last - p.window) return true;
  return false;
}


// ===========================================================================
// bfloat16 at head dim 256: the backward on wgmma (warpgroup products)
// ===========================================================================
//
// Three products a (key tile, query tile, head) pair in dK/dV (S^T and dP^T
// once, then dV and dK), three in dQ (S and dP again, then dQ): 7 units of
// 2 D operations a live pair against the bound's 5 (the mma.sync kernels
// took 9).  Tiles are bf16 in shared memory as D / 64 panels of [rows][64], each
// row 128 bytes with its 16-byte chunks at c ^ (row & 7), the panels 1024
// bytes aligned: the layout of wgmma's 128-byte swizzle (descriptor layout
// type 1).  A K-major operand (the depth along the tile's row) starts 32
// bytes further a 16-deep step, LBO 16, SBO 1024 (8 rows); an MN-major B
// (the depth down the tile's rows, the transpose bit set) starts 16 rows
// further a step, LBO = the panel's bytes (the next 64 columns), SBO 1024.
// `cp.async` fills the tiles (zero rows past Sq or Sk), and
// `fence.proxy.async` makes its writes, and the probabilities the threads
// store, visible to wgmma's reads.
//
// Two warpgroups a block (256 threads).  An m64nN accumulator is, in each
// warp of the warpgroup, the m16n8 layout of its 16 rows, which is also the
// A fragment a register-sourced wgmma takes, so dS feeds dQ += dS K from
// registers.
//
// The helpers below are shared with the warp-specialised kernels at head
// dims 64 and 128: `kmajor` and `mnmajor` take any tile of D / 64 panels
// (the panel of a K-major step kk is kk / 4; an MN-major B of N > 64
// columns spans N / 64 panels, LBO apart), and the TMA boxes land in the
// same panels.  `wg_desc`, the wgmma wrappers (m64n32, m64n64 and m64n128
// from shared memory; m64n64, m64n128 and m64n256 with A from registers),
// the `mbarrier`s and the TMA copies are ../../hopper.cuh's, shared with
// ssd.cu.


namespace w256 {
constexpr int D = 256;
constexpr int NTH = 256;       // two warpgroups
constexpr int KV_BK = 64;      // dK/dV: keys a block
constexpr int KV_BQ = 64;      // dK/dV: queries a stage
constexpr int Q_BQ = 128;      // dQ: queries a block, 64 a warpgroup
constexpr int Q_BK = 32;       // dQ: keys a stage
constexpr size_t ALIGN = 1024;
constexpr size_t DKDV_SMEM = (2 * KV_BK + 4 * KV_BQ) * D * sizeof(bf16) +   // K, V, 2 x (Q, dO)
                             2 * KV_BK * KV_BQ * sizeof(bf16) +             // P^T, dS^T
                             4 * KV_BQ * sizeof(float) + ALIGN;             // 2 x (lse, delta)
constexpr size_t DQ_SMEM = (2 * Q_BQ + 4 * Q_BK) * D * sizeof(bf16) + ALIGN;  // Q, dO, 2 x (K, V)
}  // namespace w256

// Element offset of 16-byte chunk c (of 32) of row r in a [ROWS][256] tile
// stored as 4 swizzled panels of [ROWS][64].
template <int ROWS>
__device__ __forceinline__ int pswz(int r, int c) {
  return (c >> 3) * ROWS * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

// Rows [0, ROWS) of a head-dim-256 tile into its panels; rows at or beyond
// n_valid are zero.  Asynchronous: the caller commits and waits.
template <int ROWS>
__device__ __forceinline__ void load_panels(bf16* s, const bf16* g, size_t pitch, int n_valid) {
  constexpr int CH = w256::D / 8;
  static_assert(ROWS * CH % w256::NTH == 0, "a tile is whole 16-byte chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * CH / w256::NTH; ++i) {
    const int idx = threadIdx.x + i * w256::NTH;
    const int r = idx / CH, c = idx % CH;
    const bool ok = r < n_valid;
    cp_async16(smem_u32(s + pswz<ROWS>(r, c)), ok ? g + r * pitch + c * 8 : g, ok);
  }
}

// Descriptor of a K-major operand: rows from r0 of a [ROWS][256] panel tile,
// 16-deep step kk.
template <int ROWS>
__device__ __forceinline__ uint64_t kmajor(const bf16* s, int r0, int kk) {
  return wg_desc(s + (kk >> 2) * ROWS * 64 + r0 * 64 + (kk & 3) * 16, 16, 1024);
}
// Descriptor of an MN-major B: columns from panel p0 of a [ROWS][256] panel
// tile, its rows [16 kk, 16 kk + 16) the depth.
template <int ROWS>
__device__ __forceinline__ uint64_t mnmajor(const bf16* s, int p0, int kk) {
  return wg_desc(s + p0 * ROWS * 64 + kk * 16 * 64, ROWS * 128, 1024);
}

__device__ __forceinline__ bf16* align_smem(unsigned char* raw) {
  return reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(raw) + w256::ALIGN - 1) &
                                 ~(uintptr_t)(w256::ALIGN - 1));
}

// ---------------------------------------------------------------------------
// dK/dV at head dim 256: one block per (schedule entry = key tile of 64 and
// group of query heads, batch * kv head).  For each (head, query tile of 64)
// the block computes S^T = K Q^T and dP^T = V dO^T once (warpgroup w takes
// the tile's queries [32 w, 32 w + 32)), forms P^T and dS^T in float32,
// stores them as bf16 into shared memory and, behind one barrier, each
// warpgroup accumulates its 128 columns of dV += P^T dO and dK += dS^T Q.
// Q, dO, lse and delta come through a ring of two stages.  The block writes
// float32 partial sums of its head group; `dkdv_sum_kernel` adds the groups.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(w256::NTH, 1)
dkdv_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const bf16* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ part,
               const int* __restrict__ sched, int n_groups, Params p) {
  using namespace w256;
  extern __shared__ unsigned char smem_raw[];
  bf16* sK = align_smem(smem_raw);          // [4][64][64]
  bf16* sV = sK + KV_BK * D;
  bf16* sQ = sV + KV_BK * D;                // [2][4][64][64]
  bf16* sG = sQ + 2 * KV_BQ * D;            // dO, [2][4][64][64]
  bf16* sP = sG + 2 * KV_BQ * D;            // P^T [64 keys][64 queries], one panel
  bf16* sS = sP + KV_BK * KV_BQ;            // dS^T
  float* sL = reinterpret_cast<float*>(sS + KV_BK * KV_BQ);  // lse, [2][64]
  float* sDl = sL + 2 * KV_BQ;                                // delta, [2][64]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int entry = sched[blockIdx.x];
  const int kt = entry / n_groups, grp = entry % n_groups;
  const int k0 = kt * KV_BK;
  const int b = blockIdx.y / p.Kv, kvh = blockIdx.y % p.Kv;
  const int G = p.H / p.Kv;
  const int h_lo = grp * G / n_groups, h_hi = (grp + 1) * G / n_groups;
  const size_t q_pitch = (size_t)p.H * D, k_pitch = (size_t)p.Kv * D;
  const size_t k_off = ((size_t)b * p.Sk * p.Kv + kvh) * D + (size_t)k0 * k_pitch;
  const float sl2 = p.scale * LOG2E;

  int qt0 = 0, qt1 = 0;
  if (k0 < p.true_k) query_tiles<KV_BQ, KV_BK>(p, k0, &qt0, &qt1);
  const int nqt = max(qt1 - qt0, 0);
  const int n = (h_hi - h_lo) * nqt;

  // stage `st` <- query tile `i` of the flattened (head, query tile) loop
  auto load_q = [&](int i, int st) {
    const int h = kvh * G + h_lo + i / nqt, q1 = (qt0 + i % nqt) * KV_BQ;
    const size_t off = ((size_t)b * p.Sq * p.H + h) * D + (size_t)q1 * q_pitch;
    load_panels<KV_BQ>(sQ + st * KV_BQ * D, q + off, q_pitch, p.Sq - q1);
    load_panels<KV_BQ>(sG + st * KV_BQ * D, dout + off, q_pitch, p.Sq - q1);
    const size_t r_off = ((size_t)b * p.H + h) * p.Sq + q1;
    const int i_row = threadIdx.x & (KV_BQ - 1);
    const bool ok = q1 + i_row < p.Sq;
    if (threadIdx.x < KV_BQ)
      cp_async4(smem_u32(sL + st * KV_BQ + i_row), ok ? lse + r_off + i_row : lse, ok);
    else if (threadIdx.x < 2 * KV_BQ)
      cp_async4(smem_u32(sDl + st * KV_BQ + i_row), ok ? delta + r_off + i_row : delta, ok);
  };

  load_panels<KV_BK>(sK, k + k_off, k_pitch, p.Sk - k0);
  load_panels<KV_BK>(sV, v + k_off, k_pitch, p.Sk - k0);
  if (n > 0) load_q(0, 0);
  cp_async_commit();

  float gk[64], gv[64];
  zero_regs(gk);
  zero_regs(gv);
  const int kr = 16 * wi + g;         // this thread's key rows kr and kr + 8
  const int key0 = k0 + kr;

  for (int it = 0; it < n; ++it) {
    const int st = it & 1;
    const int q1 = (qt0 + it % nqt) * KV_BQ;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();   // stage st is in; every warp is done with stage st ^ 1
    if (it + 1 < n) load_q(it + 1, st ^ 1);
    cp_async_commit();

    const bf16* cQ = sQ + st * KV_BQ * D;
    const bf16* cG = sG + st * KV_BQ * D;
    float s[16], dp[16];
    zero_regs(s);
    zero_regs(dp);
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_n32(s, kmajor<KV_BK>(sK, 0, kk), kmajor<KV_BQ>(cQ, 32 * wg, kk));
      wgmma_ss_n32(dp, kmajor<KV_BK>(sV, 0, kk), kmajor<KV_BQ>(cG, 32 * wg, kk));
    }
    wg_commit();
    wg_wait0();
    fence_regs(s);
    fence_regs(dp);

    const bool masked = needs_mask(p, q1, KV_BQ, k0, KV_BK);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 32 * wg + 8 * j + 2 * t + (e & 1);   // query row of the tile
        float pe = fast_exp2(fmaf(s[4 * j + e], sl2, -sL[st * KV_BQ + col] * LOG2E));
        if (masked && !live(p, p.q_offset + q1 + col, key0 + (e >> 1) * 8)) pe = 0.f;
        s[4 * j + e] = pe;
        dp[4 * j + e] = pe * (dp[4 * j + e] - sDl[st * KV_BQ + col]);
      }
    }
    // P^T and dS^T as bf16 [key][query] into their swizzled panels
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = kr + 8 * hi, c = 32 * wg + 8 * j + 2 * t;
        const int off = r * 64 + (((c >> 3) ^ (r & 7)) << 3) + (c & 7);
        *reinterpret_cast<uint32_t*>(sP + off) = pack_bf16(s[4 * j + 2 * hi], s[4 * j + 2 * hi + 1]);
        *reinterpret_cast<uint32_t*>(sS + off) =
            pack_bf16(dp[4 * j + 2 * hi], dp[4 * j + 2 * hi + 1]);
      }
    }
    fence_proxy_async();
    __syncthreads();

    // dV[:, 128 wg + ...] += P^T dO, dK[:, 128 wg + ...] += dS^T Q
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KV_BQ / 16; ++kk) {
      wgmma_ss_n128_tb(gv, wg_desc(sP + kk * 16, 16, 1024), mnmajor<KV_BQ>(cG, 2 * wg, kk));
      wgmma_ss_n128_tb(gk, wg_desc(sS + kk * 16, 16, 1024), mnmajor<KV_BQ>(cQ, 2 * wg, kk));
    }
    wg_commit();
    wg_wait0();
  }
  fence_regs(gk);
  fence_regs(gv);

  const size_t n_elems = (size_t)p.B * p.Sk * p.Kv * D;
  float* pk = part + (size_t)(2 * grp) * n_elems;
  float* pv = pk + n_elems;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = key0 + 8 * hi;
    if (row >= p.Sk) continue;
    const size_t off = (((size_t)b * p.Sk + row) * p.Kv + kvh) * D + 128 * wg + 2 * t;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<float2*>(pk + off + 8 * j) =
          make_float2(gk[4 * j + 2 * hi], gk[4 * j + 2 * hi + 1]);
      *reinterpret_cast<float2*>(pv + off + 8 * j) =
          make_float2(gv[4 * j + 2 * hi], gv[4 * j + 2 * hi + 1]);
    }
  }
}

// dK = scale * (sum of the groups' partials), dV = sum, in the groups'
// order 0, 1, ..., rounded once to bf16; 4 elements a thread.
__global__ void dkdv_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                                bf16* __restrict__ dv, size_t n_elems, int n_groups, float scale) {
  const size_t n4 = n_elems / 4;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 sk = reinterpret_cast<const float4*>(part)[i];
    float4 sv = reinterpret_cast<const float4*>(part + n_elems)[i];
    for (int gi = 1; gi < n_groups; ++gi) {
      const float4 a = reinterpret_cast<const float4*>(part + (size_t)(2 * gi) * n_elems)[i];
      const float4 c = reinterpret_cast<const float4*>(part + (size_t)(2 * gi + 1) * n_elems)[i];
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
    }
    uint2 ok, ov;
    ok.x = pack_bf16(sk.x * scale, sk.y * scale);
    ok.y = pack_bf16(sk.z * scale, sk.w * scale);
    ov.x = pack_bf16(sv.x, sv.y);
    ov.y = pack_bf16(sv.z, sv.w);
    reinterpret_cast<uint2*>(dk)[i] = ok;
    reinterpret_cast<uint2*>(dv)[i] = ov;
  }
}

// ---------------------------------------------------------------------------
// dQ at head dim 256: one block per (batch * head, query tile of 128), the
// query tiles with the most key tiles first; warpgroup w owns rows
// [64 w, 64 w + 64).  For each key tile of 32 (a ring of two stages) it
// recomputes S = Q K^T and dP = dO V^T (m64n32), forms dS in registers and
// accumulates dQ += dS K (m64n256, dS as the register A operand).  No
// atomics: the result does not depend on the order blocks run in.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(w256::NTH, 1)
dq_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const bf16* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, bf16* __restrict__ dq, Params p) {
  using namespace w256;
  extern __shared__ unsigned char smem_raw[];
  bf16* sQ = align_smem(smem_raw);   // [4][128][64]
  bf16* sG = sQ + Q_BQ * D;          // dO
  bf16* sK = sG + Q_BQ * D;          // [2][4][32][64]
  bf16* sV = sK + 2 * Q_BK * D;      // [2][4][32][64]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = ((p.Sq + Q_BQ - 1) / Q_BQ - 1 - (int)blockIdx.y) * Q_BQ;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.Kv);
  const size_t q_pitch = (size_t)p.H * D, k_pitch = (size_t)p.Kv * D;
  const size_t q_off = ((size_t)b * p.Sq * p.H + h) * D + (size_t)q0 * q_pitch;
  const bf16* kb = k + ((size_t)b * p.Sk * p.Kv + kvh) * D;
  const bf16* vb = v + ((size_t)b * p.Sk * p.Kv + kvh) * D;
  const float sl2 = p.scale * LOG2E;

  int kt0, kt1;
  key_tiles<Q_BQ, Q_BK>(p, q0, &kt0, &kt1);
  const int n = kt1 - kt0;
  load_panels<Q_BQ>(sQ, q + q_off, q_pitch, p.Sq - q0);
  load_panels<Q_BQ>(sG, dout + q_off, q_pitch, p.Sq - q0);
  if (n > 0) {
    load_panels<Q_BK>(sK, kb + (size_t)kt0 * Q_BK * k_pitch, k_pitch, p.Sk - kt0 * Q_BK);
    load_panels<Q_BK>(sV, vb + (size_t)kt0 * Q_BK * k_pitch, k_pitch, p.Sk - kt0 * Q_BK);
  }
  cp_async_commit();

  const int wq0 = q0 + 64 * wg;                  // this warpgroup's rows
  const int row0 = wq0 + 16 * wi + g, row1 = row0 + 8;
  const size_t r_off = ((size_t)b * p.H + h) * p.Sq;
  const float lse0 = row0 < p.Sq ? lse[r_off + row0] * LOG2E : 0.f;
  const float lse1 = row1 < p.Sq ? lse[r_off + row1] * LOG2E : 0.f;
  const float dl0 = row0 < p.Sq ? delta[r_off + row0] : 0.f;
  const float dl1 = row1 < p.Sq ? delta[r_off + row1] : 0.f;
  const int qpos0 = p.q_offset + row0;

  float gq[128];
  zero_regs(gq);
  for (int it = 0; it < n; ++it) {
    const int k0 = (kt0 + it) * Q_BK;
    const int st = it & 1;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();   // stage st is in; every warp is done with stage st ^ 1
    if (it + 1 < n) {
      const int k1 = k0 + Q_BK;
      load_panels<Q_BK>(sK + (st ^ 1) * Q_BK * D, kb + (size_t)k1 * k_pitch, k_pitch, p.Sk - k1);
      load_panels<Q_BK>(sV + (st ^ 1) * Q_BK * D, vb + (size_t)k1 * k_pitch, k_pitch, p.Sk - k1);
    }
    cp_async_commit();

    const bf16* cK = sK + st * Q_BK * D;
    const bf16* cV = sV + st * Q_BK * D;
    float s[16], dp[16];
    zero_regs(s);
    zero_regs(dp);
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_n32(s, kmajor<Q_BQ>(sQ, 64 * wg, kk), kmajor<Q_BK>(cK, 0, kk));
      wgmma_ss_n32(dp, kmajor<Q_BQ>(sG, 64 * wg, kk), kmajor<Q_BK>(cV, 0, kk));
    }
    wg_commit();
    wg_wait0();
    fence_regs(s);
    fence_regs(dp);

    const bool masked = needs_mask(p, wq0, 64, k0, Q_BK);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >> 1;
        float pe = fast_exp2(fmaf(s[4 * j + e], sl2, -(hi ? lse1 : lse0)));
        if (masked && !live(p, qpos0 + hi * 8, k0 + j * 8 + 2 * t + (e & 1))) pe = 0.f;
        dp[4 * j + e] = pe * (dp[4 * j + e] - (hi ? dl1 : dl0));
      }
    }
    uint32_t a[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      a[kk][0] = pack_bf16(dp[8 * kk + 0], dp[8 * kk + 1]);
      a[kk][1] = pack_bf16(dp[8 * kk + 2], dp[8 * kk + 3]);
      a[kk][2] = pack_bf16(dp[8 * kk + 4], dp[8 * kk + 5]);
      a[kk][3] = pack_bf16(dp[8 * kk + 6], dp[8 * kk + 7]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < Q_BK / 16; ++kk) wgmma_rs_n256_tb(gq, a[kk], mnmajor<Q_BK>(cK, 0, kk));
    wg_commit();
    wg_wait0();
  }
  fence_regs(gq);

  bf16* d0 = dq + q_off + (size_t)(64 * wg + 16 * wi + g) * q_pitch + 2 * t;
  bf16* d1 = d0 + 8 * q_pitch;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (row0 < p.Sq)
      *reinterpret_cast<uint32_t*>(d0 + j * 8) =
          pack_bf16(gq[4 * j] * p.scale, gq[4 * j + 1] * p.scale);
    if (row1 < p.Sq)
      *reinterpret_cast<uint32_t*>(d1 + j * 8) =
          pack_bf16(gq[4 * j + 2] * p.scale, gq[4 * j + 3] * p.scale);
  }
}

// delta, dK/dV partials, their sum, dQ: four launches.  `sched` holds the
// n_sched = ceil(Sk / 64) * n_groups (key tile, head group) entries
// (kt * n_groups + group), heaviest first; `part` 2 * n_groups * B * Sk *
// Kv * 256 floats.
cudaError_t launch_bwd_256(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const float* lse, float* delta, void* dq, void* dk,
                           void* dv, float* part, const int* sched, int n_sched, int n_groups,
                           const Params& p, cudaStream_t stream) {
  using namespace w256;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(dout);
  if (n_groups < 1 || n_sched != (p.Sk + KV_BK - 1) / KV_BK * n_groups)
    return cudaErrorInvalidValue;
  const size_t n_rows = (size_t)p.B * p.Sq * p.H;
  delta_kernel<bf16><<<(unsigned)((n_rows * 32 + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      static_cast<const bf16*>(o), gt, delta, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if ((err = set_smem(dkdv_wg_kernel, DKDV_SMEM)) != cudaSuccess) return err;
  if (n_sched > 0) {
    dkdv_wg_kernel<<<dim3(n_sched, p.B * p.Kv), NTH, DKDV_SMEM, stream>>>(
        qt, kt, vt, gt, lse, delta, part, sched, n_groups, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const size_t n_elems = (size_t)p.B * p.Sk * p.Kv * D;
  const size_t sum_threads = (n_elems / 4 + 255) / 256;
  const unsigned sum_blocks = (unsigned)(sum_threads < 132 * 16 ? sum_threads : 132 * 16);
  if (sum_blocks > 0) {
    dkdv_sum_kernel<<<sum_blocks, 256, 0, stream>>>(part, static_cast<bf16*>(dk),
                                                    static_cast<bf16*>(dv), n_elems, n_groups,
                                                    p.scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  if ((err = set_smem(dq_wg_kernel, DQ_SMEM)) != cudaSuccess) return err;
  dq_wg_kernel<<<dim3(p.B * p.H, (p.Sq + Q_BQ - 1) / Q_BQ), NTH, DQ_SMEM, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dq), p);
  return cudaGetLastError();
}

// ===========================================================================
// bfloat16 at head dims 64 and 128: the warp-specialised kernels, forward,
// dK/dV and dQ on wgmma, fed by a producer warp through TMA
// ===========================================================================
//
// Three warpgroups a block (384 threads).  Warpgroup 0 is the producer: it
// gives up its registers (`setmaxnreg.dec` to 24) and one thread of it
// issues every load as a TMA copy (`cp.async.bulk.tensor`) of a box of 64
// rows x 64 columns of one head, through a `CUtensorMap` over the [B, S,
// heads, D] tensor: the map's 128-byte swizzle writes the box in the panel
// layout `pswz` describes (16-byte chunk c of row r at c ^ (r & 7)), rows
// past S arrive as zeros, and the copy reports its bytes to an `mbarrier`.
// Warpgroups 1 and 2 are the consumers (`setmaxnreg.inc` to 240), 64 rows
// of the product each: they wait on a stage's "full" barrier, run their
// products on wgmma with float32 accumulators, and arrive on its "empty"
// barrier (all 256 consumer threads), which lets the producer refill it.
// The ring holds STAGES (3) tiles (the forward at head dim 256 two, see
// `FwdTile`), so the next tiles' copies run while the
// current ones are multiplied; neither side stalls the other but on an
// empty or a full ring (with two, the forward and dK/dV took 6-9% longer
// on the card).  Scores, probabilities and score gradients stay in the
// consumers' registers: an m64nN accumulator is, in each warp, the m16n8
// layout of its 16 rows, which is the register A fragment of the next
// product (P V, P^T dO, dS^T Q, dS K).  Nothing is staged through shared
// memory but the tiles the producer brings in, and no `__syncthreads`
// follows the barriers' set-up.
//
// A consumer issues its next product before it forms the current tile's
// probabilities or score gradients, and waits (`wgmma.wait_group 1`) only
// for the product whose result it reads.  ptxas serialises every wgmma of
// a kernel (warnings C7513-C7515) if a register that a running wgmma reads
// or writes is touched, so the accumulators are zeroed by the first step's
// scale-d = 0 rather than by stores, and a product's register A fragments
// alternate between two arrays instead of being copied.  In the forward
// the two consumers also take turns to issue (named barriers), so one's
// softmax runs while the other's products hold the tensor cores.

// One box of 64 rows x 64 columns: columns [c, c + 64) of head h, rows
// [s, s + 64) of batch b, into the 8 KB at `dst` (1024-byte aligned).
__device__ __forceinline__ void tma_box(bf16* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                        int h, int s, int b) {
  tma4(dst, map, bar, c, h, s, b);
}
// Rows [s0, s0 + ROWS) of head h of batch b, all D columns, into the panel
// tile `dst` ([D / 64][ROWS][64]); ROWS * D * 2 bytes onto `bar`.
template <int ROWS, int D>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar, int h,
                                         int s0, int b) {
#pragma unroll
  for (int pnl = 0; pnl < D / 64; ++pnl)
#pragma unroll
    for (int r = 0; r < ROWS; r += 64) tma_box(dst + pnl * ROWS * 64 + r * 64, map, bar, 64 * pnl, h, s0 + r, b);
}
// Named barrier `id` of `n` threads: wait for it, or arrive without waiting.
// P (or dS) of a warpgroup's m64nK accumulator as the A fragments of K / 16
// 16-deep steps, rounded to bf16.
template <int K>
__device__ __forceinline__ void acc_to_a(const float (&x)[K / 2], uint32_t (&a)[K / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

namespace ws {
constexpr int NTH = 384;          // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int STAGES = 3;
constexpr int FWD_BQ = 128;                 // forward: query tile
constexpr int KV_BK = 128, KV_BQ = 64;      // dK/dV: key tile, query tile a stage
constexpr int Q_BQ = 128, Q_BK = 64;        // dQ: query tile, key tile a stage
constexpr size_t ALIGN = 1024;
constexpr size_t BARS = 64 * sizeof(uint64_t);
// The forward's key tile a stage and its stages: 128 keys in three at head
// dims 64 and 128; 64 keys in two at 256, where Q and two stages take 192
// KB of shared memory and the output 128 registers a consumer thread.
template <int D>
struct FwdTile {
  static constexpr int BK = D == 256 ? 64 : 128;
  static constexpr int STAGES = D == 256 ? 2 : 3;
};
template <int D>
constexpr size_t fwd_smem() {
  return (size_t)(FWD_BQ + 2 * FwdTile<D>::STAGES * FwdTile<D>::BK) * D * 2 + ALIGN + BARS;
}
template <int D>
constexpr size_t dkdv_smem() {
  return (size_t)(2 * KV_BK + 2 * STAGES * KV_BQ) * D * 2 + 2 * STAGES * KV_BQ * sizeof(float) +
         ALIGN + BARS;
}
template <int D>
constexpr size_t dq_smem() { return (size_t)(2 * Q_BQ + 2 * STAGES * Q_BK) * D * 2 + ALIGN + BARS; }
}  // namespace ws

// ---------------------------------------------------------------------------
// forward: one block per (batch * head, query tile of 128), the query tiles
// with the most key tiles first.  The producer brings Q once and K, V a key
// tile of BK (128; 64 at D = 256) a stage (K and V on barriers of their
// own, so S = Q K^T starts before V has landed); consumer warpgroup w owns
// query rows [64 w, 64 w + 64): S = Q K^T (m64nBK, both K-major), the
// online softmax in exp2 on the accumulator, P rounded to bf16 in
// registers, O += P V (m64nD, V MN-major).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(ws::NTH, 1)
fwd_ws_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
              float* __restrict__ lse, Params p) {
  using namespace ws;
  constexpr int BQ = FWD_BQ, BK = FwdTile<D>::BK, STAGES = FwdTile<D>::STAGES;
  extern __shared__ unsigned char smem_raw[];
  bf16* sQ = align_smem(smem_raw);   // [D / 64][BQ][64]
  bf16* sK = sQ + BQ * D;            // [STAGES][D / 64][BK][64]
  bf16* sV = sK + STAGES * BK * D;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + STAGES * BK * D);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;

  const int wg = threadIdx.x >> 7;
  const int q0 = ((p.Sq + BQ - 1) / BQ - 1 - (int)blockIdx.y) * BQ;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.Kv);
  int kt0, kt1;
  key_tiles<BQ, BK>(p, q0, &kt0, &kt1);
  const int n = max(kt1 - kt0, 0);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_k + st, 1);
      mbar_init(full_v + st, 1);
      mbar_init(empty + st, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {   // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, BQ * D * 2);
      tma_tile<BQ, D>(sQ, &mq, bar_q, h, q0, b);
      for (int it = 0; it < n; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + st, (it / STAGES - 1) & 1);
        const int k0 = (kt0 + it) * BK;
        mbar_expect_tx(full_k + st, BK * D * 2);
        tma_tile<BK, D>(sK + st * BK * D, &mk, full_k + st, kvh, k0, b);
        mbar_expect_tx(full_v + st, BK * D * 2);
        tma_tile<BK, D>(sV + st * BK * D, &mv, full_v + st, kvh, k0, b);
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;   // this warpgroup's rows [64 cw, 64 cw + 64) of the tile
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wq0 = q0 + 64 * cw;
  const int qpos0 = p.q_offset + wq0 + 16 * warp + g;
  const float sl2 = p.scale * LOG2E;

  float acc[D / 2];
  zero_regs(acc);
  // running max (log2 units) and this thread's share of the row sum, rows g
  // and g + 8 of its warp's 16
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  // S = Q K^T of key tile `it` into s (its first step overwrites s):
  // issued and committed, not waited for.
  auto issue_scores = [&](float (&s)[BK / 2], int it) {
    const int st = it % STAGES;
    mbar_wait(full_k + st, (it / STAGES) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, kmajor<BQ>(sQ, 64 * cw, kk), kmajor<BK>(sK + st * BK * D, 0, kk), kk > 0);
    wg_commit();
  };
  // O += P V of key tile `it`, P in a: issued and committed.
  auto issue_pv = [&](const uint32_t (&a)[BK / 16][4], int it) {
    const int st = it % STAGES;
    mbar_wait(full_v + st, (it / STAGES) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs_tb(acc, a[kk], mnmajor<BK>(sV + st * BK * D, 0, kk));
    wg_commit();
  };
  // Key tile `it`'s scores in s, masked on an edge tile, into probabilities
  // against the new running max; alpha: each row's factor for the output.
  auto softmax = [&](float (&s)[BK / 2], int it, float (&alpha)[2]) {
    const int k0 = (kt0 + it) * BK;
    if (needs_mask(p, wq0, 64, k0, BK)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!live(p, qpos0 + (e >> 1) * 8, k0 + j * 8 + 2 * t + (e & 1))) s[4 * j + e] = -INFINITY;
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hi], s[4 * j + 2 * hi + 1]));
      const float mn = fmaxf(mrow[hi], quad_max(mx) * sl2);
      const float base = mn == -INFINITY ? 0.f : mn;
      alpha[hi] = fast_exp2(mrow[hi] - base);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 2 * hi; e < 2 * hi + 2; ++e) {
          s[4 * j + e] = fast_exp2(fmaf(s[4 * j + e], sl2, -base));
          rs += s[4 * j + e];
        }
      }
      lrow[hi] = alpha[hi] * lrow[hi] + rs;   // summed over the quad at the end
      mrow[hi] = mn;
    }
  };

  // Each step issues S of key tile `it` and then O += P V of tile it - 1,
  // and forms tile it's probabilities while that product runs; the last
  // P V follows the loop.
  // The two consumers take turns to issue their products (named barriers
  // 1 and 2, each waited on by its consumer and arrived at by the other),
  // so one's softmax runs while the other's products hold the tensor
  // cores; consumer 0 goes first, and each issues n + 1 times.
  const int bar_own = 1 + cw, bar_other = 2 - cw;
  auto take_turn = [&]() { named_sync(bar_own, 256); };
  auto pass_turn = [&](bool last) {
    if (!(last && cw == 1)) named_arrive(bar_other, 256);
  };
  mbar_wait(bar_q, 0);
  if (cw == 1 && n > 0) named_arrive(bar_other, 256);
  uint32_t a[BK / 16][4];   // P of the tile whose P V comes next
  float s[BK / 2], alpha[2];
  if (n > 0) {
    take_turn();
    issue_scores(s, 0);
    pass_turn(false);
    wg_wait0();
    fence_regs(s);
    softmax(s, 0, alpha);   // the output is still zero
    acc_to_a<BK>(s, a);
  }
  for (int it = 1; it < n; ++it) {
    take_turn();
    issue_scores(s, it);
    fence_regs(acc);
    issue_pv(a, it - 1);
    pass_turn(false);
    wg_wait1();   // S is in; P V may still run
    fence_regs(s);
    softmax(s, it, alpha);
    wg_wait0();
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    acc_to_a<BK>(s, a);
    mbar_arrive(empty + (it - 1) % STAGES);   // K and V of tile it - 1 are read
  }
  if (n > 0) {
    take_turn();
    fence_regs(acc);
    issue_pv(a, n - 1);
    pass_turn(true);
    wg_wait0();
    fence_regs(acc);
    mbar_arrive(empty + (n - 1) % STAGES);
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const float l = quad_sum(lrow[hi]);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int row = wq0 + 16 * warp + 8 * hi + g;
    if (row >= p.Sq) continue;
    bf16* orow = o + ((size_t)b * p.Sq * p.H + (size_t)row * p.H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16(acc[4 * j + 2 * hi] * inv, acc[4 * j + 2 * hi + 1] * inv);
    if (t == 0)
      lse[((size_t)b * p.H + h) * p.Sq + row] = l > 0.f ? (mrow[hi] + log2f(l)) * LN2 : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// dK and dV: one block per (batch * kv head, key tile of 128), looping over
// the G query heads of the kv head and the query tiles of 64 that see the
// key tile.  The producer brings K and V once and (Q, dO) a query tile a
// stage; its warp also copies the tile's lse and delta into the stage
// (zero past Sq, where Q and dO are zero too, so those rows add nothing),
// every lane arriving on the stage's "full" barrier after its stores.
// Consumer warpgroup w owns keys [64 w, 64 w + 64): S^T = K Q^T and dP^T =
// V dO^T (m64n64, both K-major) once a (head, query tile), P^T and dS^T in
// float32, then dV += P^T dO and dK += dS^T Q (m64nD, P^T and dS^T as
// register A fragments, Q and dO MN-major).  At D = 128 that is 64 + 64
// accumulators for dK and dV, 32 + 32 for S^T and dP^T and 16 + 16 for the
// fragments a thread, within the consumers' 240 registers: nothing spills
// and nothing goes through shared memory.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(ws::NTH, 1)
dkdv_ws_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, Params p) {
  using namespace ws;
  constexpr int BK = KV_BK, BQ = KV_BQ;
  extern __shared__ unsigned char smem_raw[];
  bf16* sK = align_smem(smem_raw);   // [D / 64][BK][64]
  bf16* sV = sK + BK * D;
  bf16* sQ = sV + BK * D;            // [STAGES][D / 64][BQ][64]
  bf16* sG = sQ + STAGES * BQ * D;   // dO
  float* sL = reinterpret_cast<float*>(sG + STAGES * BQ * D);   // lse, [STAGES][BQ]
  float* sDl = sL + STAGES * BQ;                                // delta
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sDl + STAGES * BQ);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x >> 7;
  const int k0 = blockIdx.y * BK;
  const int b = blockIdx.x / p.Kv, kvh = blockIdx.x % p.Kv;
  const int G = p.H / p.Kv;
  int qt0 = 0, qt1 = 0;
  if (k0 < p.true_k) query_tiles<BQ, BK>(p, k0, &qt0, &qt1);
  const int nqt = max(qt1 - qt0, 0);
  const int n = G * nqt;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + st, 32);
      mbar_init(empty + st, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {   // producer: warp 0, one thread for the copies
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * BK * D * 2);
      tma_tile<BK, D>(sK, &mk, bar_kv, kvh, k0, b);
      tma_tile<BK, D>(sV, &mv, bar_kv, kvh, k0, b);
    }
    for (int it = 0; it < n; ++it) {
      const int st = it % STAGES;
      const int h = kvh * G + it / nqt, q1 = (qt0 + it % nqt) * BQ;
      if (it >= STAGES) mbar_wait(empty + st, (it / STAGES - 1) & 1);
      const size_t r_off = ((size_t)b * p.H + h) * p.Sq;
#pragma unroll
      for (int r = lane; r < BQ; r += 32) {
        const bool ok = q1 + r < p.Sq;
        sL[st * BQ + r] = ok ? lse[r_off + q1 + r] : 0.f;
        sDl[st * BQ + r] = ok ? delta[r_off + q1 + r] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(full + st, 2 * BQ * D * 2);
        tma_tile<BQ, D>(sQ + st * BQ * D, &mq, full + st, h, q1, b);
        tma_tile<BQ, D>(sG + st * BQ * D, &mdo, full + st, h, q1, b);
      } else {
        mbar_arrive(full + st);
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;   // this warpgroup's keys [64 cw, 64 cw + 64) of the tile
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wk0 = k0 + 64 * cw;
  const int key0 = wk0 + 16 * warp + g;   // this thread's keys key0 and key0 + 8
  const float sl2 = p.scale * LOG2E;

  float gk[D / 2], gv[D / 2];
  zero_regs(gk);
  zero_regs(gv);
  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n; ++it) {
    const int st = it % STAGES, ph = (it / STAGES) & 1;
    const int q1 = (qt0 + it % nqt) * BQ;
    const bf16* cQ = sQ + st * BQ * D;
    const bf16* cG = sG + st * BQ * D;
    const float* cL = sL + st * BQ;
    const float* cDl = sDl + st * BQ;
    // S^T and dP^T issued together; P^T is formed while dP^T runs, dS^T
    // while dV += P^T dO runs
    float s[BQ / 2], dp[BQ / 2];   // the first step of each product overwrites it
    mbar_wait(full + st, ph);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, kmajor<BK>(sK, 64 * cw, kk), kmajor<BQ>(cQ, 0, kk), kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, kmajor<BK>(sV, 64 * cw, kk), kmajor<BQ>(cG, 0, kk), kk > 0);
    wg_commit();
    wg_wait1();
    fence_regs(s);

    // P^T: s[4 j + e] is key key0 + 8 (e >> 1), query q1 + 8 j + 2 t + (e & 1)
    const bool masked = needs_mask(p, q1, BQ, wk0, 64);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        float pe = fast_exp2(fmaf(s[4 * j + e], sl2, -cL[col] * LOG2E));
        if (masked && !live(p, p.q_offset + q1 + col, key0 + (e >> 1) * 8)) pe = 0.f;
        s[4 * j + e] = pe;
      }
    }
    uint32_t a[BQ / 16][4], a2[BQ / 16][4];
    acc_to_a<BQ>(s, a);
    fence_regs(gv);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs_tb(gv, a[kk], mnmajor<BQ>(cG, 0, kk));
    wg_commit();
    wg_wait1();
    fence_regs(dp);

#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - cDl[col]);
      }
    acc_to_a<BQ>(dp, a2);
    fence_regs(gk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs_tb(gk, a2[kk], mnmajor<BQ>(cQ, 0, kk));
    wg_commit();
    wg_wait0();
    fence_regs(gv);
    fence_regs(gk);
    mbar_arrive(empty + st);
  }

  const size_t k_pitch = (size_t)p.Kv * D;
  const size_t base = ((size_t)b * p.Sk * p.Kv + kvh) * D + 2 * t;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = key0 + 8 * hi;
    if (row >= p.Sk) continue;
    const size_t off = base + (size_t)row * k_pitch;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + j * 8) =
          pack_bf16(gk[4 * j + 2 * hi] * p.scale, gk[4 * j + 2 * hi + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dv + off + j * 8) = pack_bf16(gv[4 * j + 2 * hi], gv[4 * j + 2 * hi + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (batch * head, query tile of 128), the query tiles with
// the most key tiles first.  The producer brings Q and dO once and K, V a
// key tile of 64 a stage; consumer warpgroup w owns query rows [64 w, 64 w
// + 64): S = Q K^T and dP = dO V^T (m64n64) again, dS in registers, dQ +=
// dS K (m64nD, K MN-major).  No atomics: the result does not depend on the
// order blocks run in.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(ws::NTH, 1)
dq_ws_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
             const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, Params p) {
  using namespace ws;
  constexpr int BQ = Q_BQ, BK = Q_BK;
  extern __shared__ unsigned char smem_raw[];
  bf16* sQ = align_smem(smem_raw);   // [D / 64][BQ][64]
  bf16* sG = sQ + BQ * D;            // dO
  bf16* sK = sG + BQ * D;            // [STAGES][D / 64][BK][64]
  bf16* sV = sK + STAGES * BK * D;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + STAGES * BK * D);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x >> 7;
  const int q0 = ((p.Sq + BQ - 1) / BQ - 1 - (int)blockIdx.y) * BQ;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.Kv);
  int kt0, kt1;
  key_tiles<BQ, BK>(p, q0, &kt0, &kt1);
  const int n = max(kt1 - kt0, 0);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {   // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, 2 * BQ * D * 2);
      tma_tile<BQ, D>(sQ, &mq, bar_q, h, q0, b);
      tma_tile<BQ, D>(sG, &mdo, bar_q, h, q0, b);
      for (int it = 0; it < n; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + st, (it / STAGES - 1) & 1);
        const int k0 = (kt0 + it) * BK;
        mbar_expect_tx(full + st, 2 * BK * D * 2);
        tma_tile<BK, D>(sK + st * BK * D, &mk, full + st, kvh, k0, b);
        tma_tile<BK, D>(sV + st * BK * D, &mv, full + st, kvh, k0, b);
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wq0 = q0 + 64 * cw;
  const int row0 = wq0 + 16 * warp + g, row1 = row0 + 8;
  const size_t r_off = ((size_t)b * p.H + h) * p.Sq;
  const float lse0 = row0 < p.Sq ? lse[r_off + row0] * LOG2E : 0.f;
  const float lse1 = row1 < p.Sq ? lse[r_off + row1] * LOG2E : 0.f;
  const float dl0 = row0 < p.Sq ? delta[r_off + row0] : 0.f;
  const float dl1 = row1 < p.Sq ? delta[r_off + row1] : 0.f;
  const int qpos0 = p.q_offset + row0;
  const float sl2 = p.scale * LOG2E;

  float gq[D / 2];
  zero_regs(gq);
  float s[BK / 2], dp[BK / 2];
  // S = Q K^T and dP = dO V^T of key tile `it` into s and dp (their first
  // step overwrites them): issued and committed as one group, not waited
  // for.
  auto issue_scores = [&](int it) {
    const int st = it % STAGES;
    mbar_wait(full + st, (it / STAGES) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(s, kmajor<BQ>(sQ, 64 * cw, kk), kmajor<BK>(sK + st * BK * D, 0, kk), kk > 0);
      wgmma_ss(dp, kmajor<BQ>(sG, 64 * cw, kk), kmajor<BK>(sV + st * BK * D, 0, kk), kk > 0);
    }
    wg_commit();
  };
  // dQ += dS K of key tile `it`, dS in a: issued and committed.
  auto issue_dq = [&](const uint32_t (&a)[BK / 16][4], int it) {
    fence_regs(gq);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs_tb(gq, a[kk], mnmajor<BK>(sK + (it % STAGES) * BK * D, 0, kk));
    wg_commit();
  };
  // dS of key tile `it` from s and dp, rounded to bf16 as the A fragments
  // of dQ += dS K.
  auto dscores = [&](int it, uint32_t (&a)[BK / 16][4]) {
    const int k0 = (kt0 + it) * BK;
    const bool masked = needs_mask(p, wq0, 64, k0, BK);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >> 1;
        float pe = fast_exp2(fmaf(s[4 * j + e], sl2, -(hi ? lse1 : lse0)));
        if (masked && !live(p, qpos0 + hi * 8, k0 + j * 8 + 2 * t + (e & 1))) pe = 0.f;
        dp[4 * j + e] = pe * (dp[4 * j + e] - (hi ? dl1 : dl0));
      }
    }
    acc_to_a<BK>(dp, a);
  };

  // Each step issues S and dP of key tile it + 1 and then dQ += dS K of
  // tile it, and forms tile it + 1's dS while that product runs.  The dS
  // fragments alternate between a0 and a1 (the loop takes two steps a
  // turn), so no register that a running product reads is written.
  uint32_t a0[BK / 16][4], a1[BK / 16][4];
  auto step = [&](const uint32_t (&cur)[BK / 16][4], uint32_t (&nxt)[BK / 16][4], int it) {
    issue_scores(it + 1);
    issue_dq(cur, it);
    wg_wait1();   // S and dP of tile it + 1 are in; dQ may still run
    fence_regs(s);
    fence_regs(dp);
    dscores(it + 1, nxt);
    wg_wait0();
    fence_regs(gq);
    mbar_arrive(empty + it % STAGES);   // K and V of tile it are read
  };
  auto last = [&](const uint32_t (&cur)[BK / 16][4], int it) {
    issue_dq(cur, it);
    wg_wait0();
    fence_regs(gq);
    mbar_arrive(empty + it % STAGES);
  };
  mbar_wait(bar_q, 0);
  if (n > 0) {
    issue_scores(0);
    wg_wait0();
    fence_regs(s);
    fence_regs(dp);
    dscores(0, a0);
  }
  int it = 0;
  for (; it + 2 < n; it += 2) {
    step(a0, a1, it);
    step(a1, a0, it + 1);
  }
  if (it + 1 < n) {
    step(a0, a1, it);
    last(a1, it + 1);
  } else if (n > 0) {
    last(a0, it);
  }

  const size_t q_pitch = (size_t)p.H * D;
  bf16* d0 = dq + ((size_t)b * p.Sq * p.H + h) * D + (size_t)row0 * q_pitch + 2 * t;
  bf16* d1 = d0 + 8 * q_pitch;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row0 < p.Sq)
      *reinterpret_cast<uint32_t*>(d0 + j * 8) = pack_bf16(gq[4 * j] * p.scale, gq[4 * j + 1] * p.scale);
    if (row1 < p.Sq)
      *reinterpret_cast<uint32_t*>(d1 + j * 8) =
          pack_bf16(gq[4 * j + 2] * p.scale, gq[4 * j + 3] * p.scale);
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// box is 64 rows x 64 columns of one head, swizzled by 128 bytes; rows
// outside [0, S) read as zero.
cudaError_t head_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_fwd_ws(const void* q, const void* k, const void* v, void* o, float* lse,
                          const Params& p, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = head_map(&mq, q, p.B, p.Sq, p.H, D)) != cudaSuccess) return err;
  if ((err = head_map(&mk, k, p.B, p.Sk, p.Kv, D)) != cudaSuccess) return err;
  if ((err = head_map(&mv, v, p.B, p.Sk, p.Kv, D)) != cudaSuccess) return err;
  if ((err = set_smem(fwd_ws_kernel<D>, ws::fwd_smem<D>())) != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.Sq + ws::FWD_BQ - 1) / ws::FWD_BQ);
  fwd_ws_kernel<D><<<grid, ws::NTH, ws::fwd_smem<D>(), stream>>>(mq, mk, mv, static_cast<bf16*>(o),
                                                                  lse, p);
  return cudaGetLastError();
}

// delta, dK/dV, dQ: three launches.
template <int D>
cudaError_t launch_bwd_ws(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, float* delta, void* dq, void* dk,
                          void* dv, const Params& p, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err;
  if ((err = head_map(&mq, q, p.B, p.Sq, p.H, D)) != cudaSuccess) return err;
  if ((err = head_map(&mdo, dout, p.B, p.Sq, p.H, D)) != cudaSuccess) return err;
  if ((err = head_map(&mk, k, p.B, p.Sk, p.Kv, D)) != cudaSuccess) return err;
  if ((err = head_map(&mv, v, p.B, p.Sk, p.Kv, D)) != cudaSuccess) return err;
  const size_t n_rows = (size_t)p.B * p.Sq * p.H;
  delta_kernel<bf16><<<(unsigned)((n_rows * 32 + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = set_smem(dkdv_ws_kernel<D>, ws::dkdv_smem<D>())) != cudaSuccess) return err;
  dkdv_ws_kernel<D><<<dim3(p.B * p.Kv, (p.Sk + ws::KV_BK - 1) / ws::KV_BK), ws::NTH,
                      ws::dkdv_smem<D>(), stream>>>(mq, mk, mv, mdo, lse, delta,
                                                    static_cast<bf16*>(dk), static_cast<bf16*>(dv), p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = set_smem(dq_ws_kernel<D>, ws::dq_smem<D>())) != cudaSuccess) return err;
  dq_ws_kernel<D><<<dim3(p.B * p.H, (p.Sq + ws::Q_BQ - 1) / ws::Q_BQ), ws::NTH, ws::dq_smem<D>(),
                    stream>>>(mq, mk, mv, mdo, lse, delta, static_cast<bf16*>(dq), p);
  return cudaGetLastError();
}

}  // namespace tc

Params make_params(int B, int H, int Kv, int Sq, int Sk, int D, int causal, int window,
                   int q_offset, int true_k) {
  Params p;
  p.B = B; p.H = H; p.Kv = Kv; p.Sq = Sq; p.Sk = Sk; p.D = D;
  p.causal = causal; p.window = window; p.q_offset = q_offset; p.true_k = true_k;
  p.scale = 1.0f / sqrtf((float)D);
  return p;
}

}  // namespace

// The FMA kernels.  dtype: 0 float32, 1 bfloat16; D: 8, 12 or 16 (on the
// zero-padded tile of 16), 64, 128 or 256 (the backward at 256 on the
// chunked kernels; the wrapper refuses others).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int B, int H, int Kv, int Sq, int Sk, int D,
                                   int dtype, int causal, int window, int q_offset, int true_k,
                                   void* stream) {
  const Params p = make_params(B, H, Kv, Sq, Sk, D, causal, window, q_offset, true_k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D <= 16) return launch_fwd<float, 16>(q, k, v, o, lse, p, s);
  if (dtype == 1 && D <= 16) return launch_fwd<__nv_bfloat16, 16>(q, k, v, o, lse, p, s);
  if (dtype == 0 && D == 64) return launch_fwd<float, 64>(q, k, v, o, lse, p, s);
  if (dtype == 0 && D == 128) return launch_fwd<float, 128>(q, k, v, o, lse, p, s);
  if (dtype == 1 && D == 64) return launch_fwd<__nv_bfloat16, 64>(q, k, v, o, lse, p, s);
  if (dtype == 1 && D == 128) return launch_fwd<__nv_bfloat16, 128>(q, k, v, o, lse, p, s);
  if (dtype == 0 && D == 256) return launch_fwd<float, 256>(q, k, v, o, lse, p, s);
  if (dtype == 1 && D == 256) return launch_fwd<__nv_bfloat16, 256>(q, k, v, o, lse, p, s);
  return cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int B, int H, int Kv, int Sq, int Sk,
                                   int D, int dtype, int causal, int window, int q_offset,
                                   int true_k, void* stream) {
  const Params p = make_params(B, H, Kv, Sq, Sk, D, causal, window, q_offset, true_k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D <= 16)
    return launch_bwd<float, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  if (dtype == 1 && D <= 16)
    return launch_bwd<__nv_bfloat16, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  if (dtype == 0 && D == 64)
    return launch_bwd<float, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  if (dtype == 0 && D == 128)
    return launch_bwd<float, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  if (dtype == 1 && D == 64)
    return launch_bwd<__nv_bfloat16, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  if (dtype == 1 && D == 128)
    return launch_bwd<__nv_bfloat16, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  if (dtype == 0 && D == 256)
    return launch_bwd_wide<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  if (dtype == 1 && D == 256)
    return launch_bwd_wide<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  return cudaErrorInvalidValue;
}

// The tensor-core kernels: bfloat16 only (dtype 1); the forward at D 64, 128 or
// 256, the backward at 64 or 128 (256: flash_attention_bwd_d256).
extern "C" int flash_attention_fwd_tc(const void* q, const void* k, const void* v, void* o,
                                      float* lse, int B, int H, int Kv, int Sq, int Sk, int D,
                                      int dtype, int causal, int window, int q_offset,
                                      int true_k, void* stream) {
  const Params p = make_params(B, H, Kv, Sq, Sk, D, causal, window, q_offset, true_k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64) return tc::launch_fwd_ws<64>(q, k, v, o, lse, p, s);
  if (dtype == 1 && D == 128) return tc::launch_fwd_ws<128>(q, k, v, o, lse, p, s);
  if (dtype == 1 && D == 256) return tc::launch_fwd_ws<256>(q, k, v, o, lse, p, s);
  return cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_tc(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const float* lse, float* delta, void* dq,
                                      void* dk, void* dv, int B, int H, int Kv, int Sq, int Sk,
                                      int D, int dtype, int causal, int window, int q_offset,
                                      int true_k, void* stream) {
  const Params p = make_params(B, H, Kv, Sq, Sk, D, causal, window, q_offset, true_k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64)
    return tc::launch_bwd_ws<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  if (dtype == 1 && D == 128)
    return tc::launch_bwd_ws<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  return cudaErrorInvalidValue;
}

// The backward at head dim 256, bfloat16, on wgmma: `sched` (device int32,
// n_sched entries) orders the (key tile, head group) blocks of dK/dV,
// `part` takes the groups' float32 partial sums (kernel.py sizes both).
extern "C" int flash_attention_bwd_d256(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const float* lse,
                                        float* delta, void* dq, void* dk, void* dv, float* part,
                                        const int* sched, int n_sched, int n_groups, int B,
                                        int H, int Kv, int Sq, int Sk, int causal, int window,
                                        int q_offset, int true_k, void* stream) {
  const Params p = make_params(B, H, Kv, Sq, Sk, 256, causal, window, q_offset, true_k);
  return tc::launch_bwd_256(q, k, v, o, dout, lse, delta, dq, dk, dv, part, sched, n_sched,
                            n_groups, p, static_cast<cudaStream_t>(stream));
}
