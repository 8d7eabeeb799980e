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
// step, the bf16 prefill and RecurrentGemma's local attention).  What bounds it: at the train shape (S = 4096, D = 128,
// causal) the forward does about 1,650 operations per byte of q, k, v and
// o, far above the card's balance point of about 295, so the bf16
// tensor-core rate bounds it, and the backward (2.5x the products) too; at
// RecurrentGemma's (S = 32768, D = 256, a window of 2048) the forward does
// some 4,000 per byte, bound by the tensor cores as well.
// What the design does about it:
// - tiles stay bf16 in shared memory, their 16-byte chunks swizzled so the
//   tensor-core loads (`ldmatrix`) are free of bank conflicts; no float32
//   staging;
// - a ring of two stages fed by `cp.async` loads the next key tile (forward,
//   dQ) or query tile (dK/dV) while the current one is multiplied;
// - every product runs on the tensor cores (`mma.sync.m16n8k16`, float32
//   accumulators); each warp owns whole rows of the product (32 query rows
//   a warp in the forward, where each K or V fragment then serves two
//   16-row groups; 16 rows in the backward, whose two accumulators leave no
//   registers for more), so scores, probabilities and score gradients stay
//   in registers, are rounded to bf16 there and feed the next product as
//   its A operand (P V, P^T dO, dS^T Q, dS K); at head dim 256 the forward
//   gives each warp 16 rows and takes 32-key tiles (see `Fwd`), and a
//   sliding window of 2048 visits about 66 key tiles a query tile, masked
//   only at the window's two edges;
// - the online softmax runs in exp2 with the scale folded into log2(e); the
//   mask is applied only to tiles that hold a masked pair (the diagonal, the
//   window's edge, the `true_k` edge); fully live tiles skip it;
// - the query tiles with the most key tiles are scheduled first, which evens
//   out the causal imbalance across the card;
// - the backward keeps three launches: delta = rowsum(dO * O); dK/dV, one
//   block per key tile, each warp computing S^T = K Q^T and dP^T = V dO^T
//   for its 16 keys so that P^T and dS^T are already A operands; and dQ,
//   which recomputes S and dP (two products more than accumulating dQ with
//   atomics, but deterministic: two runs give the same gradients).  At head
//   dim 256 (RecurrentGemma's train step: 16 query heads on one kv head,
//   a window of 2048) each dK/dV block owns half the columns of dK and dV
//   and recomputes S^T and dP^T over the whole head dim (see `Dkdv`), and
//   dQ takes 32-key tiles (see `Dq`).
// Why `mma.sync` and not `wgmma`: `wgmma` is the only way to the full bf16
// rate, but it needs 64-row warpgroup tiles, shared-memory descriptors that
// match a TMA swizzle mode, and warp specialisation with register
// reallocation.  `mma.sync` keeps each warp's fragments fixed and simple,
// which this first tensor-core version takes; `wgmma` with a TMA-fed ring
// is the next step (ROADMAP A).
//
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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
// bfloat16 at head dims 64 and 128: tensor-core kernels (mma.sync m16n8k16)
// ===========================================================================
//
// Tiles are bf16 in shared memory, rows of D values with their 16-byte
// chunks swizzled (chunk c of row r sits at c ^ (r & 7)), so the eight rows
// an `ldmatrix` reads fall in eight distinct bank groups.  `cp.async` with a
// zero-filled tail brings them in; a ragged row past Sq or Sk reads zeros.
// Every product is `mma.sync.m16n8k16` with float32 accumulators; each warp
// owns 16 * MI rows of the product, so scores, probabilities and score
// gradients stay in its registers and are fed back as the A operand of the
// next product (the accumulator layout of m16n8 pairs is the A layout of
// m16k16).
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int NT = 256;                 // 8 warps
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
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

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a * b for one 16 x 8 x 16 product (a: 4 registers, b: 2).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Element offset of 16-byte chunk `c` of row `r` in a swizzled [rows][D] tile.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

// Rows [0, ROWS) of a tile, rows `pitch` elements apart from `g`, into the
// swizzled tile `s`; rows at or beyond `n_valid` are zero.  Asynchronous:
// the caller commits and waits.
template <int ROWS, int D, int THREADS_ = NT>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, size_t pitch, int n_valid) {
  constexpr int CH = D / 8;
  static_assert(ROWS * CH % THREADS_ == 0, "a tile is whole 16-byte chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * CH / THREADS_; ++i) {
    const int idx = threadIdx.x + i * THREADS_;
    const int r = idx / CH, c = idx % CH;
    const bool ok = r < n_valid;
    cp_async16(smem_u32(s + swz<D>(r, c)), ok ? g + r * pitch + c * 8 : g, ok);
  }
}

// Operand fragments of one 16-deep step `kk` from a swizzled tile `s`
// (`lane` is the thread's lane):
// - a_frag: A rows [r0, r0 + 16), the product's depth along the tile's row;
// - b_frag: B of two n-tiles [n0, n0 + 16), the tile's rows being n and its
//   row the depth (K for Q K^T): b[0], b[1] for n0 and b[2], b[3] for n0 + 8;
// - bt_frag: B of two n-tiles [n0, n0 + 16) of the tile's columns, its rows
//   being the depth (V for P V).
template <int D>
__device__ __forceinline__ void a_frag(const bf16* s, int r0, int kk, int lane, uint32_t (&a)[4]) {
  ldsm_x4(smem_u32(s + swz<D>(r0 + (lane & 15), 2 * kk + (lane >> 4))), a);
}
template <int D>
__device__ __forceinline__ void b_frag(const bf16* s, int n0, int kk, int lane, uint32_t (&b)[4]) {
  ldsm_x4(smem_u32(s + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1))),
          b);
}
template <int D>
__device__ __forceinline__ void bt_frag(const bf16* s, int n0, int kk, int lane,
                                        uint32_t (&b)[4]) {
  ldsm_x4_t(smem_u32(s + swz<D>(16 * kk + (lane & 15), (n0 >> 3) + (lane >> 4))), b);
}

// c[m][j] += A * B for the MI x 16 rows m of a warp and the n-tiles j: A
// from registers (m16n8 accumulators x[m][2kk], x[m][2kk + 1] rounded to
// bf16), B from a tile read with bt_frag, its columns from `col0`; c:
// [MI][N / 8][4] of the warp's (MI x 16) x N product.  Each B fragment
// serves the MI row groups.
template <int D, int MI, int KSTEPS, int NTILES>
__device__ __forceinline__ void acc_times_tile(float (&c)[MI][NTILES][4],
                                               const float (&x)[MI][2 * KSTEPS][4],
                                               const bf16* s, int lane, int col0 = 0) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t a[MI][4];
#pragma unroll
    for (int m = 0; m < MI; ++m) {
      a[m][0] = pack_bf16(x[m][2 * kk][0], x[m][2 * kk][1]);
      a[m][1] = pack_bf16(x[m][2 * kk][2], x[m][2 * kk][3]);
      a[m][2] = pack_bf16(x[m][2 * kk + 1][0], x[m][2 * kk + 1][1]);
      a[m][3] = pack_bf16(x[m][2 * kk + 1][2], x[m][2 * kk + 1][3]);
    }
#pragma unroll
    for (int n = 0; n < NTILES; n += 2) {
      uint32_t b[4];
      bt_frag<D>(s, col0 + n * 8, kk, lane, b);
#pragma unroll
      for (int m = 0; m < MI; ++m) {
        mma(c[m][n], a[m], b[0], b[1]);
        mma(c[m][n + 1], a[m], b[2], b[3]);
      }
    }
  }
}

// c[m][j] += A * B^T over the depth D: A rows [r0, r0 + 16 MI) of tile `sa`,
// B rows [0, 8 * NTILES) of tile `sb` (both [rows][D]).
template <int D, int MI, int NTILES>
__device__ __forceinline__ void tile_times_tile_t(float (&c)[MI][NTILES][4], const bf16* sa,
                                                  int r0, const bf16* sb, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[MI][4];
#pragma unroll
    for (int m = 0; m < MI; ++m) a_frag<D>(sa, r0 + 16 * m, kk, lane, a[m]);
#pragma unroll
    for (int n = 0; n < NTILES; n += 2) {
      uint32_t b[4];
      b_frag<D>(sb, n * 8, kk, lane, b);
#pragma unroll
      for (int m = 0; m < MI; ++m) {
        mma(c[m][n], a[m], b[0], b[1]);
        mma(c[m][n + 1], a[m], b[2], b[3]);
      }
    }
  }
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

template <int MI, int NTILES>
__device__ __forceinline__ void zero(float (&c)[MI][NTILES][4]) {
#pragma unroll
  for (int m = 0; m < MI; ++m)
#pragma unroll
    for (int j = 0; j < NTILES; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[m][j][e] = 0.f;
}

// Forward: 4 warps, each owning 16 MI query rows; K and V in a ring of two.
// At head dims 64 and 128, MI = 2 (query tile 128), so one K or V fragment
// serves two row groups, and the key tile is 64.  At 256, MI = 1 (query
// tile 64): 32 rows a warp would take 256 float32 output accumulators a
// thread, more than the 255 registers it may have; 16 rows take 128.  Its
// key tile is 32: Q (32 KB) and the ring (64 KB) take 96 KB of shared
// memory, so two blocks share an SM, and nothing spills; 64-key tiles took
// 160 KB, one block per SM, spilled 152 bytes and ran 1.4x as long
// (PERF.md, section 6).
template <int D>
struct Fwd {
  static constexpr int MI = D >= 256 ? 1 : 2;
  static constexpr int BK = D >= 256 ? 32 : 64;
  static constexpr int THREADS = 128;
  static constexpr int BQ = THREADS / 32 * 16 * MI;
};
// dK/dV: 16 keys a warp, a ring of two query tiles.  At head dims 64 and
// 128, 8 warps (key tile 128), query tile 64, every output column a block.
// At 256 the two float32 accumulators of 16 rows x 256 columns would take
// 256 registers a thread, more than a thread may have: a block owns DO =
// 128 of the 256 columns of dK and dV (blockIdx.z picks which) and
// recomputes S^T and dP^T over the whole head dim, 4 warps (key tile 64)
// and query tile 32, so K, V and the ring take 128 KB of shared memory.
template <int D>
struct Dkdv {
  static constexpr bool WIDE = D >= 256;
  static constexpr int THREADS = WIDE ? 128 : NT;
  static constexpr int BK = THREADS / 32 * 16;
  static constexpr int BQ = WIDE ? 32 : 64;
  static constexpr int DO = WIDE ? 128 : D;
};
// dQ: query tile 128 (16 a warp), a ring of two key tiles of 64 (32 at head
// dim 256, where the accumulator takes 128 registers a thread, as in the
// forward).
template <int D>
struct Dq {
  static constexpr int BQ = 128;
  static constexpr int BK = D >= 256 ? 32 : 64;
};

template <int D>
constexpr size_t fwd_smem() { return (size_t)(Fwd<D>::BQ + 4 * Fwd<D>::BK) * D * sizeof(bf16); }
template <int D>
constexpr size_t dkdv_smem() {
  return (size_t)(2 * Dkdv<D>::BK + 4 * Dkdv<D>::BQ) * D * sizeof(bf16) +
         4 * Dkdv<D>::BQ * sizeof(float);
}
template <int D>
constexpr size_t dq_smem() { return (size_t)(2 * Dq<D>::BQ + 4 * Dq<D>::BK) * D * sizeof(bf16); }

// ---------------------------------------------------------------------------
// forward: one block per (batch * head, query tile), the query tiles with the
// most key tiles first
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(Fwd<D>::THREADS, 1)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           bf16* __restrict__ o, float* __restrict__ lse, Params p) {
  constexpr int BQ_ = Fwd<D>::BQ, BK_ = Fwd<D>::BK, MI = Fwd<D>::MI, NTH = Fwd<D>::THREADS;
  constexpr int NS = BK_ / 8;  // score n-tiles
  constexpr int NO = D / 8;    // output n-tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BQ_ * D;       // [2][BK_][D]
  bf16* sV = sK + 2 * BK_ * D;   // [2][BK_][D]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = ((p.Sq + BQ_ - 1) / BQ_ - 1 - (int)blockIdx.y) * BQ_;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.Kv);
  const size_t q_pitch = (size_t)p.H * D, k_pitch = (size_t)p.Kv * D;
  const bf16* kb = k + ((size_t)b * p.Sk * p.Kv + kvh) * D;
  const bf16* vb = v + ((size_t)b * p.Sk * p.Kv + kvh) * D;
  const float sl2 = p.scale * LOG2E;

  int kt0, kt1;
  key_tiles<BQ_, BK_>(p, q0, &kt0, &kt1);
  const int n = kt1 - kt0;
  load_tile<BQ_, D, NTH>(sQ, q + ((size_t)b * p.Sq * p.H + h) * D + q0 * q_pitch, q_pitch,
                         p.Sq - q0);
  if (n > 0) {
    load_tile<BK_, D, NTH>(sK, kb + (size_t)kt0 * BK_ * k_pitch, k_pitch, p.Sk - kt0 * BK_);
    load_tile<BK_, D, NTH>(sV, vb + (size_t)kt0 * BK_ * k_pitch, k_pitch, p.Sk - kt0 * BK_);
  }
  cp_async_commit();

  float acc[MI][NO][4];
  zero(acc);
  // running max (log2 units) and this thread's share of the row sum, for
  // rows r0 + 16 m + g (index 2 m) and r0 + 16 m + g + 8 (2 m + 1)
  float mrow[2 * MI], lrow[2 * MI];
#pragma unroll
  for (int i = 0; i < 2 * MI; ++i) {
    mrow[i] = -INFINITY;
    lrow[i] = 0.f;
  }
  const int r0 = warp * 16 * MI;
  const int qpos0 = p.q_offset + q0 + r0 + g;

  for (int it = 0; it < n; ++it) {
    const int k0 = (kt0 + it) * BK_;
    const int st = it & 1;
    if (it + 1 < n) {
      const int k1 = k0 + BK_;
      load_tile<BK_, D, NTH>(sK + (st ^ 1) * BK_ * D, kb + (size_t)k1 * k_pitch, k_pitch,
                             p.Sk - k1);
      load_tile<BK_, D, NTH>(sV + (st ^ 1) * BK_ * D, vb + (size_t)k1 * k_pitch, k_pitch,
                             p.Sk - k1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[MI][NS][4];
    zero(s);
    tile_times_tile_t<D, MI, NS>(s, sQ, r0, sK + st * BK_ * D, lane);

    if (needs_mask(p, q0, BQ_, k0, BK_)) {
#pragma unroll
      for (int m = 0; m < MI; ++m)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!live(p, qpos0 + 16 * m + (e >> 1) * 8, k0 + j * 8 + 2 * t + (e & 1)))
              s[m][j][e] = -INFINITY;
    }
#pragma unroll
    for (int m = 0; m < MI; ++m) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int i = 2 * m + hi;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[m][j][2 * hi], s[m][j][2 * hi + 1]));
        const float mn = fmaxf(mrow[i], quad_max(mx) * sl2);
        const float base = mn == -INFINITY ? 0.f : mn;
        const float alpha = fast_exp2(mrow[i] - base);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int e = 2 * hi; e < 2 * hi + 2; ++e) {
            s[m][j][e] = fast_exp2(fmaf(s[m][j][e], sl2, -base));
            rs += s[m][j][e];
          }
        }
        lrow[i] = alpha * lrow[i] + rs;  // summed over the quad at the end
        mrow[i] = mn;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          acc[m][j][2 * hi] *= alpha;
          acc[m][j][2 * hi + 1] *= alpha;
        }
      }
    }
    acc_times_tile<D, MI, BK_ / 16, NO>(acc, s, sV + st * BK_ * D, lane);
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < MI; ++m) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int i = 2 * m + hi;
      const float l = quad_sum(lrow[i]);
      const float inv = l > 0.f ? 1.f / l : 0.f;
      const int row = q0 + r0 + 16 * m + 8 * hi + g;
      if (row >= p.Sq) continue;
      bf16* orow = o + ((size_t)b * p.Sq * p.H + (size_t)row * p.H + h) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8) =
            pack_bf16(acc[m][j][2 * hi] * inv, acc[m][j][2 * hi + 1] * inv);
      if (t == 0)
        lse[((size_t)b * p.H + h) * p.Sq + row] =
            l > 0.f ? (mrow[i] + log2f(l)) * LN2 : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dK and dV: one block per (batch * kv head, key tile of 128 rows),
// looping over the G query heads and the query tiles that see the key tile;
// each warp owns 16 keys and computes S^T = K Q^T and dP^T = V dO^T, so P^T
// and dS^T are already the A operands of dV += P^T dO and dK += dS^T Q
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(Dkdv<D>::THREADS, 1)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
            Params p) {
  constexpr int BQ_ = Dkdv<D>::BQ, BK_ = Dkdv<D>::BK, NTH = Dkdv<D>::THREADS;
  constexpr int NS = BQ_ / 8;           // score n-tiles (queries)
  constexpr int NO = Dkdv<D>::DO / 8;   // output n-tiles of this block's columns
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BK_ * D;
  bf16* sQ = sV + BK_ * D;        // [2][BQ_][D]
  bf16* sG = sQ + 2 * BQ_ * D;    // dO, [2][BQ_][D]
  float* sL = reinterpret_cast<float*>(sG + 2 * BQ_ * D);  // lse, [2][BQ_]
  float* sDl = sL + 2 * BQ_;                               // delta, [2][BQ_]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.y * BK_;
  const int b = blockIdx.x / p.Kv, kvh = blockIdx.x % p.Kv;
  const int col0 = blockIdx.z * Dkdv<D>::DO;   // this block's columns of dK and dV
  const int G = p.H / p.Kv;
  const size_t q_pitch = (size_t)p.H * D, k_pitch = (size_t)p.Kv * D;
  const size_t k_off = ((size_t)b * p.Sk * p.Kv + kvh) * D + (size_t)k0 * k_pitch;
  const float sl2 = p.scale * LOG2E;

  int qt0 = 0, qt1 = 0;
  if (k0 < p.true_k) query_tiles<BQ_, BK_>(p, k0, &qt0, &qt1);
  const int nqt = max(qt1 - qt0, 0);
  const int n = G * nqt;

  // stage `st` <- query tile `i` of the flattened (head, query tile) loop
  auto load_q = [&](int i, int st) {
    const int h = kvh * G + i / nqt, q1 = (qt0 + i % nqt) * BQ_;
    const size_t off = ((size_t)b * p.Sq * p.H + h) * D + (size_t)q1 * q_pitch;
    load_tile<BQ_, D, NTH>(sQ + st * BQ_ * D, q + off, q_pitch, p.Sq - q1);
    load_tile<BQ_, D, NTH>(sG + st * BQ_ * D, dout + off, q_pitch, p.Sq - q1);
    const size_t r_off = ((size_t)b * p.H + h) * p.Sq + q1;
    const int i_row = threadIdx.x & (BQ_ - 1);
    const bool ok = q1 + i_row < p.Sq;
    if (threadIdx.x < BQ_)
      cp_async4(smem_u32(sL + st * BQ_ + i_row), ok ? lse + r_off + i_row : lse, ok);
    else if (threadIdx.x < 2 * BQ_)
      cp_async4(smem_u32(sDl + st * BQ_ + i_row), ok ? delta + r_off + i_row : delta, ok);
  };

  load_tile<BK_, D, NTH>(sK, k + k_off, k_pitch, p.Sk - k0);
  load_tile<BK_, D, NTH>(sV, v + k_off, k_pitch, p.Sk - k0);
  if (n > 0) load_q(0, 0);
  cp_async_commit();

  float gk[1][NO][4], gv[1][NO][4];
  zero(gk);
  zero(gv);
  const int r0 = warp * 16;
  const int key0 = k0 + r0 + g;  // this thread's keys: key0 and key0 + 8

  for (int it = 0; it < n; ++it) {
    const int st = it & 1;
    const int q1 = (qt0 + it % nqt) * BQ_;
    if (it + 1 < n) load_q(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bf16* cQ = sQ + st * BQ_ * D;
    const bf16* cG = sG + st * BQ_ * D;
    float s[1][NS][4], dp[1][NS][4];
    zero(s);
    zero(dp);
    tile_times_tile_t<D, 1, NS>(s, sK, r0, cQ, lane);
    tile_times_tile_t<D, 1, NS>(dp, sV, r0, cG, lane);

    const bool masked = needs_mask(p, q1, BQ_, k0, BK_);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);  // query row of the tile
        float pe = fast_exp2(fmaf(s[0][j][e], sl2, -sL[st * BQ_ + col] * LOG2E));
        if (masked && !live(p, p.q_offset + q1 + col, key0 + (e >> 1) * 8)) pe = 0.f;
        s[0][j][e] = pe;
        dp[0][j][e] = pe * (dp[0][j][e] - sDl[st * BQ_ + col]);
      }
    }
    acc_times_tile<D, 1, BQ_ / 16, NO>(gv, s, cG, lane, col0);
    acc_times_tile<D, 1, BQ_ / 16, NO>(gk, dp, cQ, lane, col0);
    __syncthreads();
  }
  cp_async_wait<0>();

  const int row0 = key0, row1 = key0 + 8;
  const size_t base = ((size_t)b * p.Sk * p.Kv + kvh) * D + col0 + 2 * t;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (row0 < p.Sk) {
      const size_t off = base + (size_t)row0 * k_pitch + j * 8;
      *reinterpret_cast<uint32_t*>(dk + off) =
          pack_bf16(gk[0][j][0] * p.scale, gk[0][j][1] * p.scale);
      *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(gv[0][j][0], gv[0][j][1]);
    }
    if (row1 < p.Sk) {
      const size_t off = base + (size_t)row1 * k_pitch + j * 8;
      *reinterpret_cast<uint32_t*>(dk + off) =
          pack_bf16(gk[0][j][2] * p.scale, gk[0][j][3] * p.scale);
      *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(gv[0][j][2], gv[0][j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dQ: one block per (batch * head, query tile of 128 rows), the
// query tiles with the most key tiles first; recomputes S and dP, so no
// atomics and the result does not depend on the order blocks run in
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT, 1)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, bf16* __restrict__ dq, Params p) {
  constexpr int BQ_ = Dq<D>::BQ, BK_ = Dq<D>::BK;
  constexpr int NS = BK_ / 8;
  constexpr int NO = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sG = sQ + BQ_ * D;
  bf16* sK = sG + BQ_ * D;       // [2][BK_][D]
  bf16* sV = sK + 2 * BK_ * D;   // [2][BK_][D]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = ((p.Sq + BQ_ - 1) / BQ_ - 1 - (int)blockIdx.y) * BQ_;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.Kv);
  const size_t q_pitch = (size_t)p.H * D, k_pitch = (size_t)p.Kv * D;
  const size_t q_off = ((size_t)b * p.Sq * p.H + h) * D + (size_t)q0 * q_pitch;
  const bf16* kb = k + ((size_t)b * p.Sk * p.Kv + kvh) * D;
  const bf16* vb = v + ((size_t)b * p.Sk * p.Kv + kvh) * D;
  const float sl2 = p.scale * LOG2E;

  int kt0, kt1;
  key_tiles<BQ_, BK_>(p, q0, &kt0, &kt1);
  const int n = kt1 - kt0;
  load_tile<BQ_, D>(sQ, q + q_off, q_pitch, p.Sq - q0);
  load_tile<BQ_, D>(sG, dout + q_off, q_pitch, p.Sq - q0);
  if (n > 0) {
    load_tile<BK_, D>(sK, kb + (size_t)kt0 * BK_ * k_pitch, k_pitch, p.Sk - kt0 * BK_);
    load_tile<BK_, D>(sV, vb + (size_t)kt0 * BK_ * k_pitch, k_pitch, p.Sk - kt0 * BK_);
  }
  cp_async_commit();

  const int r0 = warp * 16;
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
  const size_t r_off = ((size_t)b * p.H + h) * p.Sq;
  const float lse0 = row0 < p.Sq ? lse[r_off + row0] * LOG2E : 0.f;
  const float lse1 = row1 < p.Sq ? lse[r_off + row1] * LOG2E : 0.f;
  const float dl0 = row0 < p.Sq ? delta[r_off + row0] : 0.f;
  const float dl1 = row1 < p.Sq ? delta[r_off + row1] : 0.f;
  const int qpos0 = p.q_offset + row0;

  float gq[1][NO][4];
  zero(gq);
  for (int it = 0; it < n; ++it) {
    const int k0 = (kt0 + it) * BK_;
    const int st = it & 1;
    if (it + 1 < n) {
      const int k1 = k0 + BK_;
      load_tile<BK_, D>(sK + (st ^ 1) * BK_ * D, kb + (size_t)k1 * k_pitch, k_pitch, p.Sk - k1);
      load_tile<BK_, D>(sV + (st ^ 1) * BK_ * D, vb + (size_t)k1 * k_pitch, k_pitch, p.Sk - k1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bf16* cK = sK + st * BK_ * D;
    float s[1][NS][4], dp[1][NS][4];
    zero(s);
    zero(dp);
    tile_times_tile_t<D, 1, NS>(s, sQ, r0, cK, lane);
    tile_times_tile_t<D, 1, NS>(dp, sG, r0, sV + st * BK_ * D, lane);

    const bool masked = needs_mask(p, q0, BQ_, k0, BK_);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >> 1;
        float pe = fast_exp2(fmaf(s[0][j][e], sl2, -(hi ? lse1 : lse0)));
        if (masked && !live(p, qpos0 + hi * 8, k0 + j * 8 + 2 * t + (e & 1))) pe = 0.f;
        dp[0][j][e] = pe * (dp[0][j][e] - (hi ? dl1 : dl0));
      }
    }
    acc_times_tile<D, 1, BK_ / 16, NO>(gq, dp, cK, lane);
    __syncthreads();
  }
  cp_async_wait<0>();

  bf16* d0 = dq + q_off + ((size_t)(r0 + g)) * q_pitch + 2 * t;
  bf16* d1 = d0 + 8 * q_pitch;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (row0 < p.Sq)
      *reinterpret_cast<uint32_t*>(d0 + j * 8) =
          pack_bf16(gq[0][j][0] * p.scale, gq[0][j][1] * p.scale);
    if (row1 < p.Sq)
      *reinterpret_cast<uint32_t*>(d1 + j * 8) =
          pack_bf16(gq[0][j][2] * p.scale, gq[0][j][3] * p.scale);
  }
}

template <typename K>
cudaError_t set_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       const Params& p, cudaStream_t stream) {
  cudaError_t err = set_smem(fwd_kernel<D>, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.Sq + Fwd<D>::BQ - 1) / Fwd<D>::BQ);
  fwd_kernel<D><<<grid, Fwd<D>::THREADS, fwd_smem<D>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, const Params& p, cudaStream_t stream) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(dout);
  const size_t n_rows = (size_t)p.B * p.Sq * p.H;
  delta_kernel<bf16><<<(unsigned)((n_rows * 32 + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      static_cast<const bf16*>(o), gt, delta, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  using KV = Dkdv<D>;
  err = set_smem(dkdv_kernel<D>, dkdv_smem<D>());
  if (err != cudaSuccess) return err;
  dkdv_kernel<D><<<dim3(p.B * p.Kv, (p.Sk + KV::BK - 1) / KV::BK, D / KV::DO), KV::THREADS,
                   dkdv_smem<D>(), stream>>>(qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dk),
                                             static_cast<bf16*>(dv), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = set_smem(dq_kernel<D>, dq_smem<D>());
  if (err != cudaSuccess) return err;
  dq_kernel<D><<<dim3(p.B * p.H, (p.Sq + Dq<D>::BQ - 1) / Dq<D>::BQ), NT, dq_smem<D>(), stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dq), p);
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

// The tensor-core kernels: bfloat16 only (dtype 1), D 64, 128 or 256.
extern "C" int flash_attention_fwd_tc(const void* q, const void* k, const void* v, void* o,
                                      float* lse, int B, int H, int Kv, int Sq, int Sk, int D,
                                      int dtype, int causal, int window, int q_offset,
                                      int true_k, void* stream) {
  const Params p = make_params(B, H, Kv, Sq, Sk, D, causal, window, q_offset, true_k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64) return tc::launch_fwd<64>(q, k, v, o, lse, p, s);
  if (dtype == 1 && D == 128) return tc::launch_fwd<128>(q, k, v, o, lse, p, s);
  if (dtype == 1 && D == 256) return tc::launch_fwd<256>(q, k, v, o, lse, p, s);
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
    return tc::launch_bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  if (dtype == 1 && D == 128)
    return tc::launch_bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  if (dtype == 1 && D == 256)
    return tc::launch_bwd<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  return cudaErrorInvalidValue;
}
