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
// - the backward at head dims 64 and 128 keeps three launches: delta =
//   rowsum(dO * O); dK/dV, one block per key tile, each warp computing
//   S^T = K Q^T and dP^T = V dO^T for its 16 keys so that P^T and dS^T are
//   already A operands; and dQ, which recomputes S and dP (two products
//   more than accumulating dQ with atomics, but deterministic: two runs
//   give the same gradients).
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
// Why mma.sync at head dims 64 and 128: `wgmma` needs 64-row warpgroup
// tiles, shared-memory descriptors that match the 128-byte swizzle and
// warpgroup-wide synchronisation; a `wgmma` version at head dim 128 was
// not kept, for its seed-0 train loss (ROADMAP B12).

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
// dK/dV (head dims 64 and 128): 16 keys a warp, 8 warps (key tile 128), a
// ring of two query tiles of 64, every output column a block.
template <int D>
struct Dkdv {
  static constexpr int THREADS = NT;
  static constexpr int BK = THREADS / 32 * 16;
  static constexpr int BQ = 64;
  static constexpr int DO = D;   // output columns a block
};
// dQ (head dims 64 and 128): query tile 128 (16 a warp), a ring of two key
// tiles of 64.
template <int D>
struct Dq {
  static constexpr int BQ = 128;
  static constexpr int BK = 64;
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

__device__ __forceinline__ uint64_t wg_desc(const void* ptr, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = smem_u32(ptr);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the wgmma that owns it (the asm statements alone order only themselves).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void zero_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// d[16] += A (shared, K-major) * B (shared, K-major): m64n32k16
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// d[64] += A (shared, K-major) * B (shared, MN-major): m64n128k16
__device__ __forceinline__ void wgmma_ss_n128_tb(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d[128] += A (registers, the m16n8k16 A fragment of each warp's 16 rows) *
// B (shared, MN-major): m64n256k16
__device__ __forceinline__ void wgmma_rs_n256_tb(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

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
