// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_hm` (`_attn_kernel`) of
// src/repro/kernels/flash_attention/kernel.py: causal / sliding-window GQA
// attention with an online softmax in float32, `q_offset` (the absolute
// position of query row 0) and `true_k` (keys at or beyond it are masked).
// The TPU kernel has no backward (XLA differentiated the jnp path); the
// three backward kernels here recompute the probabilities from the saved
// row log-sum-exp.
//
// Layout: q, o, dq [B, Sq, H, D]; k, v, dk, dv [B, Sk, Kv, D]; lse, delta
// [B, H, Sq] float32.  The model's [B, S, heads, D] layout is read in place
// through row strides, so nothing is transposed or padded: ragged tiles are
// masked here.  Query head h reads kv head h / (H / Kv).
//
// What bounds it: at the train shape (S = 4096, D = 128, causal) the forward
// does about 1,650 operations per byte of q, k, v and o, far above the
// card's balance point of about 295, so the tensor-core rate bounds it, not
// memory.  This first version is simple and exact instead of fast: tiles of
// 64 x 64, float32 in shared memory, float32 FMA on the CUDA cores (no
// tensor cores, no TMA), so it reaches a fraction of the float32 FMA rate.  Its design answers the two things that do not
// depend on speed: (1) only live tiles are visited (none above the causal
// diagonal, none wholly outside the window, none at or beyond `true_k`), so
// work follows the mask; (2) every block owns its outputs, so no atomics:
// dK/dV are summed over the G query heads of a kv head inside one block.
//
// Head dim 256 (RecurrentGemma's local attention) has a forward only.  Its
// tiles stay 64 x 64: Q, K and V in float32 with the probability tile take
// 214,016 bytes of shared memory, under the 227 KB a block may have, so one
// block of 256 threads runs per SM, and each thread keeps 4 x 16 output
// accumulators in registers.
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
// are `pitch` elements apart and 16-byte aligned (the wrapper checks).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* s, const T* g, size_t pitch,
                                          int n_valid, float mul) {
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

// Key tiles [lo, hi) that a query tile starting at row q0 must visit.
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int* lo, int* hi) {
  const int q_first = p.q_offset + q0;
  const int q_last = p.q_offset + min(q0 + BQ, p.Sq) - 1;
  int end = (p.true_k + BK - 1) / BK;
  if (p.causal) end = min(end, q_last / BK + 1);
  int begin = 0;
  if (p.window > 0) {
    const int first_key = q_first - p.window + 1;
    if (first_key > 0) begin = first_key / BK;
  }
  *lo = begin;
  *hi = end;
}

// Query tiles [lo, hi) that see a key tile starting at row k0.
__device__ __forceinline__ void query_tiles(const Params& p, int k0, int* lo, int* hi) {
  const int nq = (p.Sq + BQ - 1) / BQ;
  const int k_last = min(k0 + BK, p.true_k) - 1;
  int begin = 0, end = nq;
  if (p.causal) {
    const int first_q = k0 - p.q_offset;
    if (first_q > 0) begin = first_q / BQ;
  }
  if (p.window > 0) {
    const int last_q = k_last + p.window - 1 - p.q_offset;
    end = last_q < 0 ? 0 : min(nq, last_q / BQ + 1);
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
  const size_t q_pitch = (size_t)p.H * D, k_pitch = (size_t)p.Kv * D;
  const T* qb = q + ((size_t)b * p.Sq * p.H + h) * D;
  const T* kb = k + ((size_t)b * p.Sk * p.Kv + kvh) * D;
  const T* vb = v + ((size_t)b * p.Sk * p.Kv + kvh) * D;

  load_tile<T, D>(sQ, qb + q0 * q_pitch, q_pitch, p.Sq - q0, p.scale);

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
    load_tile<T, D>(sK, kb + k0 * k_pitch, k_pitch, p.Sk - k0, 1.f);
    load_tile<T, D>(sV, vb + k0 * k_pitch, k_pitch, p.Sk - k0, 1.f);
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
    T* orow = o + ((size_t)b * p.Sq * p.H + (size_t)row * p.H + h) * D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) orow[tx + 16 * cc] = from_f<T>(acc[i][cc] / denom);
    if (tx == 0)
      lse[((size_t)b * p.H + h) * p.Sq + row] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// backward 1: delta = rowsum(dO * O), one warp per (b, row, h)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                             float* __restrict__ delta, Params p) {
  const size_t row = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const size_t n_rows = (size_t)p.B * p.Sq * p.H;
  if (row >= n_rows) return;  // warp-uniform
  const T* orow = o + row * D;
  const T* grow = dout + row * D;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(orow[d]), to_f(grow[d]), acc);
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
  const size_t q_pitch = (size_t)p.H * D, k_pitch = (size_t)p.Kv * D;
  const size_t k_off = ((size_t)b * p.Sk * p.Kv + kvh) * D + k0 * k_pitch;

  load_tile<T, D>(sK, k + k_off, k_pitch, p.Sk - k0, 1.f);
  load_tile<T, D>(sV, v + k_off, k_pitch, p.Sk - k0, 1.f);

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
      __syncthreads();
      load_tile<T, D>(sQ, qb + q0 * q_pitch, q_pitch, p.Sq - q0, p.scale);
      load_tile<T, D>(sG, gb + q0 * q_pitch, q_pitch, p.Sq - q0, 1.f);
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
    const size_t off = ((size_t)b * p.Sk * p.Kv + (size_t)row * p.Kv + kvh) * D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
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
  const size_t q_pitch = (size_t)p.H * D, k_pitch = (size_t)p.Kv * D;
  const size_t q_off = ((size_t)b * p.Sq * p.H + h) * D + q0 * q_pitch;
  const T* kb = k + ((size_t)b * p.Sk * p.Kv + kvh) * D;
  const T* vb = v + ((size_t)b * p.Sk * p.Kv + kvh) * D;
  const size_t r_off = ((size_t)b * p.H + h) * p.Sq;

  load_tile<T, D>(sQ, q + q_off, q_pitch, p.Sq - q0, p.scale);
  load_tile<T, D>(sG, dout + q_off, q_pitch, p.Sq - q0, 1.f);
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
    load_tile<T, D>(sK, kb + k0 * k_pitch, k_pitch, p.Sk - k0, 1.f);
    load_tile<T, D>(sV, vb + k0 * k_pitch, k_pitch, p.Sk - k0, 1.f);
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
    T* qrow = dq + ((size_t)b * p.Sq * p.H + (size_t)row * p.H + h) * D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) qrow[tx + 16 * cc] = from_f<T>(gq[i][cc] * p.scale);
  }
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
  delta_kernel<T, D><<<(unsigned)((n_rows * 32 + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
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

Params make_params(int B, int H, int Kv, int Sq, int Sk, int D, int causal, int window,
                   int q_offset, int true_k) {
  Params p;
  p.B = B; p.H = H; p.Kv = Kv; p.Sq = Sq; p.Sk = Sk;
  p.causal = causal; p.window = window; p.q_offset = q_offset; p.true_k = true_k;
  p.scale = 1.0f / sqrtf((float)D);
  return p;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; D: 64, 128 or 256 forward, 64 or 128 backward
// (the wrapper refuses others).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int B, int H, int Kv, int Sq, int Sk, int D,
                                   int dtype, int causal, int window, int q_offset, int true_k,
                                   void* stream) {
  const Params p = make_params(B, H, Kv, Sq, Sk, D, causal, window, q_offset, true_k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
  if (dtype == 0 && D == 64)
    return launch_bwd<float, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  if (dtype == 0 && D == 128)
    return launch_bwd<float, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  if (dtype == 1 && D == 64)
    return launch_bwd<__nv_bfloat16, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  if (dtype == 1 && D == 128)
    return launch_bwd<__nv_bfloat16, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  return cudaErrorInvalidValue;
}
