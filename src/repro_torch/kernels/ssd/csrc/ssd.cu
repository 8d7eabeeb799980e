// Mamba-2 SSD chunk scan (state-space duality), forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_call` (`_ssd_kernel`) of
// src/repro/kernels/ssd/kernel.py (forward; the TPU kernel has no backward,
// XLA differentiated the jnp scan; the backward's passes are described
// where its section begins, below).  Per head, with the state h [P, N]:
//
//   cum_t  = cumsum(dA_t) within the chunk                  (log decay, <= 0)
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//            + exp(cum_i) C_i . h                           (carried state)
//   h'     = exp(cum_Q) h + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T
//
// Layout (all contiguous): x, y [B, H, S, P]; dA, dt [B, H, S] float32;
// B, C [B, S, N] (one group, shared by the heads) in x's type; h0, h_last
// [B, H, P, N] float32.  Widths (P, N) = (64, 128) (Mamba-2 780M) and
// (16, 16) (its smoke config); any chunk Q that divides S, up to 1024.
//
// What bounds it: at Mamba-2 780M's widths (H = 48, chunk Q = 256) and
// S = 32768 the function moves about 432 MB (x and y in bf16, B, C, dA, dt)
// and needs about 80 GFLOP (the causal half of the chunk term, the
// carried-state term and the state update; C.B^T once per chunk), so memory
// bounds it on this card: 0.13 ms at 3.35 TB/s.  The TPU kernel walked the
// chunks of a head in order ("arbitrary" grid axis) and carried h in VMEM;
// on Hopper that is one block per head, 48 blocks on 132 SMs.  Here the
// chunks run in parallel, in Mamba-2's own chunked decomposition:
//
// 1. cb:    C.B^T of each (batch, chunk), once for all heads, into a float32
//           scratch [B, nc, QP, QP] (QP: Q rounded up to 64); only the
//           64 x 64 tiles on or below the diagonal are formed.  (The FMA
//           route; the tensor-core route forms C.B^T in pass 4.)
// 2. state: the chunk's own state s_c = sum_j exp(cum_Q - cum_j) dt_j x_j
//           B_j^T, a [P x Q].[Q x N] product, into a float32 scratch [B, H,
//           nc, P, N], and cum_Q.
// 3. pass:  the carry across chunks, h_c = exp(cum_Q,c) h_{c-1} + s_c,
//           sequential over the chunks and parallel over B.H.P.N; it writes
//           each chunk's incoming state (float32, or hi and lo bf16 planes
//           for bf16 inputs) and h_last.  Memory bound: it reads and writes
//           the scratch once.
// 4. out:   y_I = exp(cum_I) C_I . h_in^T + sum_{J <= I} G_IJ x_J for each
//           64-row tile I, with G_IJ = CB_IJ exp(cum_i - cum_j) dt_j on
//           j <= i.
//
// bfloat16 at Mamba-2 780M's widths, (P, N) = (64, 128), runs every product
// on `wgmma` ("the forward on wgmma" below: `state_wg_kernel`,
// `pass_kernel<bf16>`, `out_wg_kernel`): a TMA producer warp feeds a
// consumer warpgroup, and each block takes a group of FWD_HEAD_GROUP heads,
// so the output pass forms C.B^T from the bf16 C and B tiles once for the
// group instead of reading a float32 scratch once a head (at S = 32768 that
// read was about 1 GB, against the function's 432 MB).  cumsum, decays and
// the carried state stay float32, and only the operands fed to the tensor
// cores are bf16.  x, B and C enter as they are; the operands formed in
// float32 (x.w with w the decay times dt, G, and the incoming state) enter
// as the sum of two bf16 values, hi + lo, in two products.  So the passes
// keep the float32 algebra's accuracy (about 2^-17 relative a term) and y
// differs from the plain version only where the two round it to bf16.
// Rounding G and the incoming state once instead moved y by 2.7e-3 relative
// L2 at S=32768 (50 times the float32 FMA kernel's 5.3e-5), and rounding x.w
// once put h_last outside its limit in a CPU emulation.  float32 inputs,
// and bf16 at the smoke widths (16, 16), run the four passes with float32
// FMA on the CUDA cores (IEEE, no TF32; bf16 values widened as they load).
// Masked before exp: above the diagonal cum_i - cum_j > 0 may overflow, and
// inf * 0 is NaN, so those entries are selected to 0.
//
// `ssd_fwd` and `ssd_bwd` return the `cudaError_t` of their launches.
#include "../../hopper.cuh"   // wgmma, mbarriers, TMA; includes the CUDA headers

namespace {

constexpr int QT = 64;          // rows of a chunk tile
constexpr int F32_THREADS = 256;  // float32 passes: 16 x 16 threads

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T to_t(float v);
template <>
__device__ __forceinline__ float to_t<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 to_t<bf16>(float v) { return __float2bfloat16(v); }

// Inclusive prefix sum of a[0, n) in place, by one warp (lane = 0..31).
__device__ __forceinline__ void warp_cumsum(float* a, int n, int lane) {
  const int per = (n + 31) / 32;
  const int lo = min(lane * per, n), hi = min(lo + per, n);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += a[i];
    a[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const float excl = incl - run;
  for (int i = lo; i < hi; ++i) a[i] += excl;
}

// The chunk's cum (inclusive cumsum of dA) and dt, [0, Q), into shared
// memory.  Every pass forms cum over the whole chunk the same way, so they
// agree on it bit for bit.  Ends with a barrier.
__device__ __forceinline__ void chunk_cum(float* sCum, float* sDt, const float* dA,
                                          const float* dt, int Q) {
  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    sCum[i] = dA[i];
    sDt[i] = dt[i];
  }
  __syncthreads();
  if (threadIdx.x < 32) warp_cumsum(sCum, Q, threadIdx.x);
  __syncthreads();
}

// ===========================================================================
// bfloat16: register helpers of the tensor-core passes
// ===========================================================================
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// (a, b) as two bf16 pairs: hi = (a, b) rounded, lo = what hi missed.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// ===========================================================================
// float32: the same passes with float32 FMA; 16 x 16 threads, each owning
// 4 rows of a 64-row tile and every 16th column
// ===========================================================================

// Rows [0, QT) of a [rows][W] row-major block into shared memory as float32
// [QT][W + 1], times `mul[r]` when given; rows at or beyond `n_valid` are zero.
template <typename T, int W>
__device__ __forceinline__ void load_rows(float* s, const T* g, int n_valid,
                                          const float* mul = nullptr) {
  for (int idx = threadIdx.x; idx < QT * W; idx += blockDim.x) {
    const int r = idx / W, c = idx % W;
    s[r * (W + 1) + c] = r < n_valid ? to_f(g[(size_t)r * W + c]) * (mul ? mul[r] : 1.f) : 0.f;
  }
}

// pass 1 (float32 FMA on inputs of type T: the FMA route's forward, and the
// backward's recompute on it); grid (nI * nc, B); block x = c * nI + I.
template <typename T, int N>
__global__ void __launch_bounds__(F32_THREADS)
cb_f32_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ cb,
              int S, int Q, int nI) {
  constexpr int LDN = N + 1;
  extern __shared__ float smem[];
  float* sC = smem;          // [QT][LDN]
  float* sB = sC + QT * LDN; // [QT][LDN]
  const int I = blockIdx.x % nI, c = blockIdx.x / nI, b = blockIdx.y;
  const int nc = S / Q, QP = nI * QT;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  const int i0 = I * QT;
  float* out = cb + ((size_t)b * nc + c) * QP * QP;

  load_rows<T, N>(sC, Cm + (t0 + i0) * N, Q - i0);
  for (int J = 0; J <= I; ++J) {
    __syncthreads();
    load_rows<T, N>(sB, Bm + (t0 + J * QT) * N, Q - J * QT);
    __syncthreads();
    float s[4][4] = {};
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        cv[i] = sC[(ty * 4 + i) * LDN + n];
        bv[i] = sB[(tx + 16 * i) * LDN + n];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[(size_t)(i0 + ty * 4 + i) * QP + J * QT + tx + 16 * j] = s[i][j];
  }
}

// pass 2 (float32 FMA on inputs of type T); grid (nc * H, B); block x =
// c * H + h.  Thread (ty, tx) owns rows ty * PR + a of P and columns
// tx + 16 m of N.  DUAL (the backward): the chunk's dual state
// sum_i exp(cum_i) dy_i^T C_i, called with dy for x and C for B; it writes
// no dAc.
template <typename T, int P, int N, bool DUAL = false>
__global__ void __launch_bounds__(F32_THREADS)
state_f32_kernel(const T* __restrict__ x, const float* __restrict__ dA,
                 const float* __restrict__ dt, const T* __restrict__ Bm,
                 float* __restrict__ states, float* __restrict__ dAc, int H, int S, int Q) {
  constexpr int LDX = P + 1, LDN = N + 1, PR = P / 16, NR = N / 16;
  extern __shared__ float smem[];
  float* sX = smem;             // [QT][LDX]: x w
  float* sB = sX + QT * LDX;    // [QT][LDN]
  float* sW = sB + QT * LDN;    // [QT]
  float* sCum = sW + QT;        // [Q]
  float* sDt = sCum + Q;        // [Q]
  const int nc = S / Q;
  const int h = blockIdx.x % H, c = blockIdx.x / H, b = blockIdx.y;
  const size_t bh = (size_t)b * H + h;
  const size_t t0 = (size_t)c * Q;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  chunk_cum(sCum, sDt, dA + bh * S + t0, dt + bh * S + t0, Q);
  const float cum_last = sCum[Q - 1];
  float acc[PR][NR];
#pragma unroll
  for (int a = 0; a < PR; ++a)
#pragma unroll
    for (int m = 0; m < NR; ++m) acc[a][m] = 0.f;
  for (int j0 = 0; j0 < Q; j0 += QT) {
    const int nj = min(QT, Q - j0);
    __syncthreads();
    for (int j = threadIdx.x; j < QT; j += blockDim.x)
      sW[j] = j >= nj ? 0.f
              : DUAL  ? expf(sCum[j0 + j])
                      : expf(cum_last - sCum[j0 + j]) * sDt[j0 + j];
    __syncthreads();
    load_rows<T, P>(sX, x + (bh * S + t0 + j0) * P, nj, sW);
    load_rows<T, N>(sB, Bm + ((size_t)b * S + t0 + j0) * N, nj);
    __syncthreads();
    for (int j = 0; j < nj; ++j) {
      float xv[PR], bv[NR];
#pragma unroll
      for (int a = 0; a < PR; ++a) xv[a] = sX[j * LDX + ty * PR + a];
#pragma unroll
      for (int m = 0; m < NR; ++m) bv[m] = sB[j * LDN + tx + 16 * m];
#pragma unroll
      for (int a = 0; a < PR; ++a)
#pragma unroll
        for (int m = 0; m < NR; ++m) acc[a][m] = fmaf(xv[a], bv[m], acc[a][m]);
    }
  }
  float* out = states + (bh * nc + c) * P * N;
#pragma unroll
  for (int a = 0; a < PR; ++a)
#pragma unroll
    for (int m = 0; m < NR; ++m) out[(ty * PR + a) * N + tx + 16 * m] = acc[a][m];
  if (!DUAL && threadIdx.x == 0) dAc[bh * nc + c] = cum_last;
}

// pass 4 (float32 FMA on inputs of type T): y of 64 rows of a chunk for
// one head, y_I = exp(cum_i) C_I . h_in^T + sum_{J <= I} G_IJ x_J with G_IJ =
// CB_IJ exp(cum_i - cum_j) dt_j on j <= i, read from pass 1.  grid (nc * H *
// nI, B); block x = (c * H + h) * nI + (nI - 1 - I): the heads of a chunk
// run together (they read the same C.B^T), longest first.  Thread (ty, tx)
// owns rows ty * 4 + i of the tile and columns tx + 16 m of P.
template <typename T, int P, int N>
__global__ void __launch_bounds__(F32_THREADS)
out_f32_kernel(const T* __restrict__ x, const float* __restrict__ dA,
               const float* __restrict__ dt, const T* __restrict__ Cm,
               const float* __restrict__ cb, const float* __restrict__ hin,
               T* __restrict__ y, int H, int S, int Q, int nI) {
  constexpr int LDN = N + 1, LDX = P + 1, LDG = QT + 1, PR = P / 16;
  extern __shared__ float smem[];
  float* sC = smem;             // [QT][LDN]
  float* sH = sC + QT * LDN;    // [P][LDN]
  float* sX = sH + P * LDN;     // [QT][LDX]
  float* sG = sX + QT * LDX;    // [QT][LDG]
  float* sCum = sG + QT * LDG;  // [Q]
  float* sDt = sCum + Q;        // [Q]
  const int nc = S / Q, QP = nI * QT;
  const int I = nI - 1 - (int)(blockIdx.x % nI);
  const int h = (blockIdx.x / nI) % H, c = blockIdx.x / (nI * H), b = blockIdx.y;
  const size_t bh = (size_t)b * H + h;
  const size_t t0 = (size_t)c * Q;
  const int i0 = I * QT;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* xb = x + (bh * S + t0) * P;
  const float* cbb = cb + ((size_t)b * nc + c) * QP * QP;

  chunk_cum(sCum, sDt, dA + bh * S + t0, dt + bh * S + t0, Q);
  load_rows<T, N>(sC, Cm + ((size_t)b * S + t0 + i0) * N, Q - i0);
  const float* hb = hin + (bh * nc + c) * P * N;
  for (int idx = threadIdx.x; idx < P * N; idx += blockDim.x)
    sH[(idx / N) * LDN + idx % N] = hb[idx];
  __syncthreads();

  // the carried state: exp(cum_i) C_i . h_in
  float acc[4][PR];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < PR; ++m) acc[i][m] = 0.f;
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float cv[4], hv[PR];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = sC[(ty * 4 + i) * LDN + n];
#pragma unroll
    for (int m = 0; m < PR; ++m) hv[m] = sH[(tx + 16 * m) * LDN + n];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < PR; ++m) acc[i][m] = fmaf(cv[i], hv[m], acc[i][m]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty * 4 + i;
    const float e = row < Q ? expf(sCum[row]) : 0.f;
#pragma unroll
    for (int m = 0; m < PR; ++m) acc[i][m] *= e;
  }

  for (int J = 0; J <= I; ++J) {
    const int j0 = J * QT;
    __syncthreads();  // readers of the previous sX / sG are done
    load_rows<T, P>(sX, xb + (size_t)j0 * P, Q - j0);
    for (int idx = threadIdx.x; idx < QT * QT; idx += blockDim.x) {
      const int r = idx / QT, jj = idx % QT;
      const int i = i0 + r, j = j0 + jj;
      const bool ok = j <= i && i < Q;
      sG[r * LDG + jj] = ok ? cbb[(size_t)i * QP + j] * expf(sCum[i] - sCum[j]) * sDt[j] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < QT; ++jj) {
      float gv[4], xv[PR];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = sG[(ty * 4 + i) * LDG + jj];
#pragma unroll
      for (int m = 0; m < PR; ++m) xv[m] = sX[jj * LDX + tx + 16 * m];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int m = 0; m < PR; ++m) acc[i][m] = fmaf(gv[i], xv[m], acc[i][m]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty * 4 + i;
    if (row >= Q) continue;
    T* yrow = y + (bh * S + t0 + row) * P;
#pragma unroll
    for (int m = 0; m < PR; ++m) yrow[tx + 16 * m] = to_t<T>(acc[i][m]);
  }
}

// ---------------------------------------------------------------------------
// pass 3 (both types): the carry across chunks, 4 state elements a thread.
// hin[c] = h before chunk c (float32, or bf16 hi and lo planes), then
// h = exp(cum_Q,c) h + s_c.
// ---------------------------------------------------------------------------
// The incoming state: float32 as it is; bf16 as hi at p and lo at p + lo_plane.
__device__ __forceinline__ void store_h(float* p, size_t, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store_h(bf16* p, size_t lo_plane, float4 v) {
  uint2 h, l;
  split_bf16(v.x, v.y, h.x, l.x);
  split_bf16(v.z, v.w, h.y, l.y);
  *reinterpret_cast<uint2*>(p) = h;
  *reinterpret_cast<uint2*>(p + lo_plane) = l;
}

template <typename T>
__global__ void __launch_bounds__(256)
pass_kernel(const float* __restrict__ states, const float* __restrict__ dAc,
            const float* __restrict__ h0, T* __restrict__ hin, size_t lo_plane,
            float* __restrict__ h_last, int BH, int nc, int PN) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int per = PN / 4;
  if (idx >= (size_t)BH * per) return;
  const size_t bh = idx / per, e = (idx % per) * 4;
  float4 h = h0 ? *reinterpret_cast<const float4*>(h0 + bh * PN + e) : make_float4(0.f, 0.f, 0.f, 0.f);
  const float* sp = states + bh * nc * PN + e;
  T* hp = hin + bh * nc * PN + e;
  const float* dp = dAc + bh * nc;
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const float4 s = *reinterpret_cast<const float4*>(sp + (size_t)c * PN);
    const float d = expf(dp[c]);
    store_h(hp + (size_t)c * PN, lo_plane, h);
    h.x = fmaf(d, h.x, s.x);
    h.y = fmaf(d, h.y, s.y);
    h.z = fmaf(d, h.z, s.z);
    h.w = fmaf(d, h.w, s.w);
  }
  *reinterpret_cast<float4*>(h_last + bh * PN + e) = h;
}

// ===========================================================================
// bfloat16 at (P, N) = (64, 128): the forward on wgmma, fed by TMA
// ===========================================================================
//
// Three launches: `state_wg_kernel` (pass 2), `pass_kernel<bf16>` (pass 3,
// the carry, no product) and `out_wg_kernel` (pass 4).  There is no pass 1:
// the output blocks form C.B^T themselves, once for a group of
// FWD_HEAD_GROUP heads, instead of reading a float32 [QP][QP] scratch once
// a head.  A block is a consumer warpgroup (128 threads) and a producer
// warp: one thread of the producer brings every tile in by TMA (boxes of 64
// rows x 64 bf16 columns, swizzled by 128 bytes into the panel layout
// `wgmma` reads, rows past S zero) through a ring of two 32 KB slots under
// `mbarrier`s; the consumers wait on a slot's "full" barrier, run their
// products on `wgmma` with float32 accumulators and arrive on its "empty"
// barrier.  About 86 KB of shared memory a block, so two blocks share an
// SM and one's arithmetic runs while the other's products hold the tensor
// cores; their ten warps put three on some of the SM's four register
// files, which caps a thread at 168 registers (one block an SM, at up to
// 255, made the output pass 1.5x as long).  The tile rows past a ragged
// chunk's end (Q not a multiple of 64) are the next chunk's: every product
// that reads them is masked by row < Q.  The backward's wgmma passes
// (below) are blocks of the same shape.

constexpr int FWD_HEAD_GROUP = 2;   // heads a forward block (state and output passes)
constexpr int HEAD_GROUP = 4;       // heads a backward dB or dC block sums into one partial

namespace wg {
constexpr int P = 64, N = 128;
constexpr int HG = FWD_HEAD_GROUP;
constexpr int NTH = 160;            // a consumer warpgroup and a producer warp
constexpr int BOX = 64 * 64;        // elements of a TMA box, 64 rows x 64 bf16 (8 KB)
constexpr int SLOT = 4 * BOX;       // a ring slot: B and HG x tiles, or h_in hi and lo
constexpr int SLOTS = 2;
constexpr size_t ALIGN = 1024;      // the 128-byte swizzle's alignment
constexpr size_t BARS = 8 * sizeof(uint64_t);
constexpr int CONSUMERS = 1;        // named barrier of the consumer warpgroup
static_assert(HG <= SLOTS, "the carried-state products of a group are in flight together");
// dynamic shared memory: the ring (and C_I for the output pass), cum and dt
// (or w) of the group's heads over QP = Q rounded up to 64, the barriers
constexpr size_t state_smem(int QP) {
  return ALIGN + (size_t)SLOTS * SLOT * 2 + 2 * (size_t)HG * QP * 4 + BARS;
}
constexpr size_t out_smem(int QP) { return state_smem(QP) + 2 * BOX * 2; }
// the backward's row tiles: a dx block takes HG heads; a dB or dC block
// BG heads, HG at a time; a block's `fixed` boxes, the ring, cum and dt of
// its `heads` heads, the barriers
constexpr int BG = HEAD_GROUP;
static_assert(2 + HG <= 4, "a slot holds B or C and HG heads' x or dy tiles");
static_assert(BG % HG == 0 && BG <= 4, "a warp takes each head's cumsum");
constexpr size_t bwd_smem(int QP, int fixed, int heads) {
  return ALIGN + (size_t)fixed * BOX * 2 + (size_t)SLOTS * SLOT * 2 + 2 * (size_t)heads * QP * 4 +
         BARS;
}
}  // namespace wg

__device__ __forceinline__ bf16* align_1024(unsigned char* raw) {
  return reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(raw) + wg::ALIGN - 1) &
                                 ~(uintptr_t)(wg::ALIGN - 1));
}

// The operand descriptors of ../../hopper.cuh's `wgmma` wrappers over the
// 64 x 64 boxes the TMA maps write (128-byte swizzle).  A K-major operand
// of a [2 panels][64 rows][64] tile, depth 128: 16-deep step kk (of 8) is
// 32 bytes into panel kk / 4 (a box alone, depth 64: steps 0-3).
__device__ __forceinline__ uint64_t kdesc(const bf16* s, int kk) {
  return wg_desc(s + (kk >> 2) * wg::BOX + (kk & 3) * 16, 16, 1024);
}
// An MN-major B of a [panels][64 rows][64] tile, its rows [16 kk, 16 kk +
// 16) the depth and its columns across the panels, a panel (8 KB) apart.
__device__ __forceinline__ uint64_t mdesc(const bf16* s, int kk) {
  return wg_desc(s + kk * 16 * 64, wg::BOX * 2, 1024);
}

// The barriers of a wgmma block: `n_full` "full" (one producer arrival
// each) and as many "empty" (the 128 consumers) from `bars`; then the whole
// block meets once.
__device__ __forceinline__ void init_ring(uint64_t* bars, int n_full) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_full; ++i) {
      mbar_init(bars + i, 1);
      mbar_init(bars + n_full + i, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The chunk's cum (inclusive cumsum of dA) and dt of the group's `hv` heads
// over [0, Q), `stride` floats apart in dA and dt, into sCum[g QP + i] and
// sDt[g QP + i], zero on [Q, QP) and for absent heads; warp g takes head g's
// cumsum as `chunk_cum` does, so every pass agrees on it bit for bit.  The
// consumer warpgroup alone; ends with its barrier.
template <int HG>
__device__ __forceinline__ void group_cum_wg(float* sCum, float* sDt, const float* dA,
                                             const float* dt, size_t stride, int Q, int QP,
                                             int hv) {
  for (int idx = threadIdx.x; idx < HG * QP; idx += 128) {
    const int g = idx / QP, i = idx % QP;
    const bool ok = g < hv && i < Q;
    sCum[idx] = ok ? dA[g * stride + i] : 0.f;
    sDt[idx] = ok ? dt[g * stride + i] : 0.f;
  }
  named_sync(wg::CONSUMERS, 128);
  const int warp = threadIdx.x >> 5;
  if (warp < hv) warp_cumsum(sCum + warp * QP, Q, threadIdx.x & 31);
  named_sync(wg::CONSUMERS, 128);
}

// The ring's next slot in the producer: waits until the consumers have
// emptied it, then counts it.
__device__ __forceinline__ int next_slot(uint64_t* empty, int& it) {
  const int st = it % wg::SLOTS;
  if (it >= wg::SLOTS) mbar_wait(empty + st, (it / wg::SLOTS - 1) & 1);
  ++it;
  return st;
}
// The ring's next slot in the consumers: waits until it is full, then counts it.
__device__ __forceinline__ int take_slot(uint64_t* full, int& it) {
  const int st = it % wg::SLOTS;
  mbar_wait(full + st, (it / wg::SLOTS) & 1);
  ++it;
  return st;
}

// The producer's load of a state (h_in or g) of head `bh` of chunk c, its
// hi and lo planes `lo_rows` rows apart in the map, into a ring slot.
__device__ __forceinline__ void load_state_planes(bf16* slot, const CUtensorMap* m, uint64_t* bar,
                                                  size_t bh, int nc, int c, int lo_rows) {
  const int row = (int)((bh * nc + c) * wg::P);
  mbar_expect_tx(bar, 4 * wg::BOX * 2);
  tma2(slot, m, bar, 0, row);
  tma2(slot + wg::BOX, m, bar, 64, row);
  tma2(slot + 2 * wg::BOX, m, bar, 0, row + lo_rows);
  tma2(slot + 3 * wg::BOX, m, bar, 64, row + lo_rows);
}

// The producer's load of the rows [s0, s0 + 64) of the shared tile `mbc` (B
// or C, two boxes) and of the heads' `mh` (x or dy, a box each) into a slot.
__device__ __forceinline__ void load_row_tiles(bf16* slot, const CUtensorMap* mbc,
                                               const CUtensorMap* mh, uint64_t* bar, int s0, int h0,
                                               int hv, int b) {
  mbar_expect_tx(bar, (2 + hv) * wg::BOX * 2);
  tma3(slot, mbc, bar, 0, s0, b);
  tma3(slot + wg::BOX, mbc, bar, 64, s0, b);
  for (int g = 0; g < hv; ++g) tma4(slot + (2 + g) * wg::BOX, mh, bar, 0, s0, h0 + g, b);
}

// ---------------------------------------------------------------------------
// pass 2 (bf16 at (64, 128)): the chunk states of a group of FWD_HEAD_GROUP
// heads, s[P][N] = sum_j (x_j w_j)^T B_j with w_j = exp(cum_Q - cum_j) dt_j.
// The producer brings each 64-row tile of B (once for the group) and of the
// heads' x; the consumers read (x w)^T's A fragments straight from the x
// tile (`ldmatrix.trans`: the tile's rows are the product's depth), scale
// them by w in float32, split them into hi + lo bf16 and accumulate s as two
// m64n128k16 products a 16-deep step, B MN-major.  Writes the states and
// each chunk's cum_Q (dAc).  The two heads' accumulators take 128 registers
// a thread, so at the 168 of two blocks an SM ptxas spills 152 bytes and
// serialises the wgmmas; one head a block (nothing serialised) was slower
// all the same, 0.213 ms a call at S = 32768 against 0.195.  The blocks
// of blockIdx.z = 1 (the backward's, in the same launch) take each chunk's
// dual state sum_i exp(cum_i) dy_i^T C_i into `dual`: the same product with
// dy (`mdy`) for x, C (`mc`) for B and w_i = exp(cum_i); they write no dAc.
// grid (nc * NG, B, 1 or 2), NG = ceil(H / FWD_HEAD_GROUP); block x = c * NG
// + group.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(wg::NTH, 2)
state_wg_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mb,
                const __grid_constant__ CUtensorMap mdy, const __grid_constant__ CUtensorMap mc,
                const float* __restrict__ dA, const float* __restrict__ dt,
                float* __restrict__ states, float* __restrict__ dual, float* __restrict__ dAc,
                int H, int S, int Q) {
  using namespace wg;
  const bool is_dual = blockIdx.z != 0;
  extern __shared__ unsigned char smem_raw[];
  const int nT = (Q + 63) / 64, QP = nT * 64;
  bf16* ring = align_1024(smem_raw);                            // [SLOTS][SLOT]
  float* sCum = reinterpret_cast<float*>(ring + SLOTS * SLOT);  // [HG][QP]
  float* sW = sCum + HG * QP;                                   // [HG][QP]: dt, then w
  uint64_t* full = reinterpret_cast<uint64_t*>(sW + HG * QP);
  uint64_t* empty = full + SLOTS;
  const int NG = (H + HG - 1) / HG, nc = S / Q;
  const int grp = blockIdx.x % NG, c = blockIdx.x / NG, b = blockIdx.y;
  const int h0 = grp * HG, hv = min(HG, H - h0);
  const int t0 = c * Q;
  init_ring(full, SLOTS);

  if (threadIdx.x >= 128) {   // the producer warp
    if (threadIdx.x == 128) {
      int it = 0;
      for (int jt = 0; jt < nT; ++jt) {
        const int st = next_slot(empty, it);
        load_row_tiles(ring + st * SLOT, is_dual ? &mc : &mb, is_dual ? &mdy : &mx, full + st,
                       t0 + jt * 64, h0, hv, b);
      }
    }
    return;
  }

  const size_t bh0 = (size_t)b * H + h0;
  group_cum_wg<HG>(sCum, sW, dA + bh0 * S + t0, dt + bh0 * S + t0, S, Q, QP, hv);
  for (int idx = threadIdx.x; idx < HG * QP; idx += 128) {
    const int g = idx / QP, j = idx % QP;
    sW[idx] = j >= Q    ? 0.f
              : is_dual ? expf(sCum[idx])
                        : expf(sCum[g * QP + Q - 1] - sCum[idx]) * sW[idx];
  }
  named_sync(CONSUMERS, 128);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  // this lane's ldmatrix row: matrix m = lane / 8 holds the fragment's rows
  // (p) [8 (m & 1), +8) and depth (j) [8 (m >> 1), +8), stored as x[j][p]
  const int lm = lane >> 3, lr = lane & 7, chunk = 2 * warp + (lm & 1);
  float acc[HG][64];
#pragma unroll
  for (int g = 0; g < HG; ++g)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[g][i] = 0.f;
  int it = 0;
  for (int jt = 0; jt < nT; ++jt) {
    const int st = take_slot(full, it);
    const bf16* slot = ring + st * SLOT;
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      if (g >= hv) continue;
      const bf16* sx = slot + (2 + g) * BOX;
      const float* w = sW + g * QP + jt * 64;
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int j = 16 * kk + 8 * (lm >> 1) + lr;
        uint32_t r[4];
        ldsm_x4_t(smem_u32(sx + j * 64 + ((chunk ^ (j & 7)) << 3)), r);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int jj = 16 * kk + 8 * (i >> 1) + 2 * t;   // depth of this pair
          const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r[i]));
          const float2 wv = *reinterpret_cast<const float2*>(w + jj);
          const int jq = jt * 64 + jj;
          split_bf16(jq < Q ? xv.x * wv.x : 0.f, jq + 1 < Q ? xv.y * wv.y : 0.f, ah[kk][i],
                     al[kk][i]);
        }
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_tb(acc[g], ah[kk], mdesc(slot, kk));
        wgmma_rs_tb(acc[g], al[kk], mdesc(slot, kk));
      }
      wg_commit();
      wg_wait0();
      fence_regs(acc[g]);
    }
    mbar_arrive(empty + st);
  }

  const int gq = lane >> 2;
#pragma unroll
  for (int g = 0; g < HG; ++g) {
    if (g >= hv) continue;
    float* out = (is_dual ? dual : states) + ((bh0 + g) * nc + c) * P * N;
    float* o0 = out + (size_t)(16 * warp + gq) * N + 2 * t;
    float* o1 = o0 + 8 * N;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      *reinterpret_cast<float2*>(o0 + 8 * n) = make_float2(acc[g][4 * n], acc[g][4 * n + 1]);
      *reinterpret_cast<float2*>(o1 + 8 * n) = make_float2(acc[g][4 * n + 2], acc[g][4 * n + 3]);
    }
    if (!is_dual && threadIdx.x == 0) dAc[(bh0 + g) * nc + c] = sCum[g * QP + Q - 1];
  }
}

// ---------------------------------------------------------------------------
// pass 4 (bf16 at (64, 128)): y of 64 rows I of a chunk for a group of
// FWD_HEAD_GROUP heads.  For each tile J <= I, CB = C_I . B_J^T once for
// the group (m64n64k16 from the bf16 C and B tiles, exact inputs, both
// K-major), and for each head G = CB exp(cum_i - cum_j) dt_j on j <= i < Q
// formed in the accumulator, split into hi + lo in registers and fed as
// the A operand of y += G x_J (x_J MN-major); then each head's carried
// state exp(cum_i) C_I . h_in^T (h_in as its hi and lo planes, two
// products a step) is added.  The producer brings C_I, then B_J with the
// heads' x_J a slot, then each head's h_in, which so loads while the last
// tiles J are multiplied (carried first, the first tile's load waited
// behind h_in's: 0.626 ms a call at S = 32768 against 0.604).
// grid (nI * nc * NG, B); block x = (c * NG + group) * nI + (nI - 1 - I): a
// group's row tiles run together, so h_in and the x tiles they share come
// from L2 (with the row tiles of a chunk launched far apart the pass took
// 0.694 ms a call at S = 32768 against 0.626), the most column tiles first.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(wg::NTH, 2)
out_wg_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mb,
              const __grid_constant__ CUtensorMap mc, const __grid_constant__ CUtensorMap mh,
              const float* __restrict__ dA, const float* __restrict__ dt, bf16* __restrict__ y,
              int H, int S, int Q, int lo_rows) {
  using namespace wg;
  extern __shared__ unsigned char smem_raw[];
  const int nI = (Q + 63) / 64, QP = nI * 64;
  bf16* sC = align_1024(smem_raw);                              // [2][64][64]: C_I
  bf16* ring = sC + 2 * BOX;                                    // [SLOTS][SLOT]
  float* sCum = reinterpret_cast<float*>(ring + SLOTS * SLOT);  // [HG][QP]
  float* sDt = sCum + HG * QP;                                  // [HG][QP]
  uint64_t* full = reinterpret_cast<uint64_t*>(sDt + HG * QP);  // [SLOTS], then C_I's
  uint64_t* empty = full + SLOTS + 1;
  uint64_t* bar_c = full + SLOTS;
  const int NG = (H + HG - 1) / HG, nc = S / Q;
  const int I = nI - 1 - (int)(blockIdx.x % nI), grp = (blockIdx.x / nI) % NG;
  const int c = blockIdx.x / (nI * NG), b = blockIdx.y;
  const int h0 = grp * HG, hv = min(HG, H - h0);
  const int t0 = c * Q, i0 = I * 64;
  init_ring(full, SLOTS + 1);   // C_I's "full" barrier; its "empty" one goes unused

  if (threadIdx.x >= 128) {   // the producer warp
    if (threadIdx.x == 128) {
      mbar_expect_tx(bar_c, 2 * BOX * 2);
      tma3(sC, &mc, bar_c, 0, t0 + i0, b);
      tma3(sC + BOX, &mc, bar_c, 64, t0 + i0, b);
      int it = 0;
      for (int J = 0; J <= I; ++J) {
        const int st = next_slot(empty, it);
        load_row_tiles(ring + st * SLOT, &mb, &mx, full + st, t0 + J * 64, h0, hv, b);
      }
      for (int g = 0; g < hv; ++g) {
        const int st = next_slot(empty, it);
        load_state_planes(ring + st * SLOT, &mh, full + st, (size_t)b * H + h0 + g, nc, c,
                          lo_rows);
      }
    }
    return;
  }

  const size_t bh0 = (size_t)b * H + h0;
  group_cum_wg<HG>(sCum, sDt, dA + bh0 * S + t0, dt + bh0 * S + t0, S, Q, QP, hv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = i0 + 16 * warp + gq, row1 = row0 + 8;   // this thread's rows of the chunk
  float acc[HG][32];
#pragma unroll
  for (int g = 0; g < HG; ++g)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[g][e] = 0.f;
  mbar_wait(bar_c, 0);

  int it = 0;
  for (int J = 0; J <= I; ++J) {
    const int st = take_slot(full, it);
    const bf16* slot = ring + st * SLOT;
    float cb[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_ss(cb, kdesc(sC, kk), kdesc(slot, kk), kk > 0);
    wg_commit();
    wg_wait0();
    fence_regs(cb);
    // G of each head as hi + lo A fragments; one array pair, so a head's
    // products end before the next head's G is formed (a pair a head, to
    // form one head's G while the other's products run, took more
    // registers than two blocks an SM leave: ptxas serialised every wgmma
    // and the pass took 0.702 ms a call at S = 32768 against 0.604)
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      if (g >= hv) continue;
      const float* cum = sCum + g * QP;
      const float* dtg = sDt + g * QP;
      const float c0 = cum[min(row0, Q - 1)], c1 = cum[min(row1, Q - 1)];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // A register q of step kk: row (q & 1 ? row1 : row0), columns
          // 16 kk + 8 (q >> 1) + 2 t and the next: cb[8 kk + 2 q], +1
          const int i = (q & 1) ? row1 : row0;
          const float ci = (q & 1) ? c1 : c0;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = J * 64 + 16 * kk + 8 * (q >> 1) + 2 * t + e;
            const bool ok = j <= i && i < Q;
            const int jj = ok ? j : 0;
            v[e] = ok ? cb[8 * kk + 2 * q + e] * expf(ci - cum[jj]) * dtg[jj] : 0.f;
          }
          split_bf16(v[0], v[1], ah[kk][q], al[kk][q]);
        }
      const bf16* sx = slot + (2 + g) * BOX;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_tb(acc[g], ah[kk], mdesc(sx, kk));
        wgmma_rs_tb(acc[g], al[kk], mdesc(sx, kk));
      }
      wg_commit();
      wg_wait0();
      fence_regs(acc[g]);
    }
    mbar_arrive(empty + st);
  }

  // the carried state of each head, exp(cum_i) C_I . h_in^T (h_in as hi +
  // lo), added last: its h_in comes in while the tiles J are multiplied
#pragma unroll
  for (int g = 0; g < HG; ++g) {
    if (g >= hv) continue;
    const int st = take_slot(full, it);
    const bf16* slot = ring + st * SLOT;
    float ch[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_ss(ch, kdesc(sC, kk), kdesc(slot, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_ss(ch, kdesc(sC, kk), kdesc(slot + 2 * BOX, kk));
    wg_commit();
    wg_wait0();
    fence_regs(ch);
    mbar_arrive(empty + st);
    const float* cum = sCum + g * QP;
    const float e0 = row0 < Q ? expf(cum[row0]) : 0.f, e1 = row1 < Q ? expf(cum[row1]) : 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[g][4 * n] = fmaf(e0, ch[4 * n], acc[g][4 * n]);
      acc[g][4 * n + 1] = fmaf(e0, ch[4 * n + 1], acc[g][4 * n + 1]);
      acc[g][4 * n + 2] = fmaf(e1, ch[4 * n + 2], acc[g][4 * n + 2]);
      acc[g][4 * n + 3] = fmaf(e1, ch[4 * n + 3], acc[g][4 * n + 3]);
    }
  }

#pragma unroll
  for (int g = 0; g < HG; ++g) {
    if (g >= hv) continue;
    bf16* y0 = y + ((bh0 + g) * S + t0 + row0) * P + 2 * t;
    bf16* y1 = y0 + 8 * P;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (row0 < Q) *reinterpret_cast<uint32_t*>(y0 + 8 * n) = pack_bf16(acc[g][4 * n], acc[g][4 * n + 1]);
      if (row1 < Q) *reinterpret_cast<uint32_t*>(y1 + 8 * n) = pack_bf16(acc[g][4 * n + 2], acc[g][4 * n + 3]);
    }
  }
}

// A map over the contiguous bf16 tensor at `ptr` with `rank` dims `dims`
// (innermost first) whose box is 64 x 64 values of its two innermost dims,
// swizzled by 128 bytes; values outside the dims read as zero.
cudaError_t tile_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  cuuint64_t strides[3];
  cuuint64_t pitch = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = pitch *= dims[i];
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor-core route: bf16 at (64, 128).  hin holds two bf16 planes (hi,
// then lo), states float32; no C.B^T scratch.
cudaError_t launch_wg(const bf16* x, const float* dA, const float* dt, const bf16* Bm,
                      const bf16* Cm, const float* h0, bf16* y, float* h_last, float* states,
                      bf16* hin, float* dAc, int B, int H, int S, int Q, cudaStream_t stream) {
  using namespace wg;
  const int nc = S / Q, nI = (Q + 63) / 64, QP = nI * 64, NG = (H + HG - 1) / HG;
  const int lo_rows = B * H * nc * P;
  CUtensorMap mx, mb, mc, mh;
  const cuuint64_t dx[4] = {(cuuint64_t)P, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t dbc[3] = {(cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t dh[2] = {(cuuint64_t)N, 2 * (cuuint64_t)lo_rows};
  cudaError_t err;
  if ((err = tile_map(&mx, x, 4, dx)) != cudaSuccess) return err;
  if ((err = tile_map(&mb, Bm, 3, dbc)) != cudaSuccess) return err;
  if ((err = tile_map(&mc, Cm, 3, dbc)) != cudaSuccess) return err;
  if ((err = tile_map(&mh, hin, 2, dh)) != cudaSuccess) return err;

  if ((err = set_smem(state_wg_kernel, state_smem(QP))) != cudaSuccess) return err;
  state_wg_kernel<<<dim3(nc * NG, B), NTH, state_smem(QP), stream>>>(mx, mb, mx, mb, dA, dt, states,
                                                                     nullptr, dAc, H, S, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int per = B * H * (P * N / 4);
  pass_kernel<bf16><<<(per + 255) / 256, 256, 0, stream>>>(states, dAc, h0, hin,
                                                           (size_t)lo_rows * N, h_last, B * H, nc,
                                                           P * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = set_smem(out_wg_kernel, out_smem(QP))) != cudaSuccess) return err;
  out_wg_kernel<<<dim3(nI * nc * NG, B), NTH, out_smem(QP), stream>>>(mx, mb, mc, mh, dA, dt, y,
                                                                      H, S, Q, lo_rows);
  return cudaGetLastError();
}

// The FMA route: float32, and bf16 at the smoke widths (16, 16); cb, states
// and hin float32.
template <typename T, int P, int N>
cudaError_t launch_fma(const T* x, const float* dA, const float* dt, const T* Bm, const T* Cm,
                       const float* h0, T* y, float* h_last, float* cb, float* states,
                       float* hin, float* dAc, int B, int H, int S, int Q, cudaStream_t stream) {
  const int nc = S / Q, nI = (Q + QT - 1) / QT;
  size_t smem = (size_t)2 * QT * (N + 1) * sizeof(float);
  cudaError_t err = set_smem(cb_f32_kernel<T, N>, smem);
  if (err != cudaSuccess) return err;
  cb_f32_kernel<T, N><<<dim3(nI * nc, B), F32_THREADS, smem, stream>>>(Bm, Cm, cb, S, Q, nI);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  smem = ((size_t)QT * (P + 1) + (size_t)QT * (N + 1) + QT + 2 * (size_t)Q) * sizeof(float);
  if ((err = set_smem(state_f32_kernel<T, P, N>, smem)) != cudaSuccess) return err;
  state_f32_kernel<T, P, N><<<dim3(nc * H, B), F32_THREADS, smem, stream>>>(
      x, dA, dt, Bm, states, dAc, H, S, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int per = B * H * (P * N / 4);
  pass_kernel<float><<<(per + 255) / 256, 256, 0, stream>>>(states, dAc, h0, hin, 0, h_last,
                                                            B * H, nc, P * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  smem = ((size_t)QT * (N + 1) + (size_t)P * (N + 1) + (size_t)QT * (P + 1) +
          (size_t)QT * (QT + 1) + 2 * (size_t)Q) * sizeof(float);
  if ((err = set_smem(out_f32_kernel<T, P, N>, smem)) != cudaSuccess) return err;
  out_f32_kernel<T, P, N><<<dim3(nc * H * nI, B), F32_THREADS, smem, stream>>>(
      x, dA, dt, Cm, cb, hin, y, H, S, Q, nI);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t launch(const void* x, const float* dA, const float* dt, const void* Bm,
                   const void* Cm, const float* h0, void* y, float* h_last, float* cb,
                   float* states, void* hin, float* dAc, int B, int H, int S, int Q, int dtype,
                   cudaStream_t s) {
  if (dtype == 0)
    return launch_fma<float, P, N>(static_cast<const float*>(x), dA, dt,
                                   static_cast<const float*>(Bm), static_cast<const float*>(Cm),
                                   h0, static_cast<float*>(y), h_last, cb, states,
                                   static_cast<float*>(hin), dAc, B, H, S, Q, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  if constexpr (P == 64 && N == 128)
    return launch_wg(static_cast<const bf16*>(x), dA, dt, static_cast<const bf16*>(Bm),
                     static_cast<const bf16*>(Cm), h0, static_cast<bf16*>(y), h_last, states,
                     static_cast<bf16*>(hin), dAc, B, H, S, Q, s);
  else
    return launch_fma<bf16, P, N>(static_cast<const bf16*>(x), dA, dt,
                                  static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), h0,
                                  static_cast<bf16*>(y), h_last, cb, states,
                                  static_cast<float*>(hin), dAc, B, H, S, Q, s);
}

// ===========================================================================
// backward: wgmma for bf16 at (P, N) = (64, 128), float32 FMA for float32
// and for bf16 at the smoke widths (16, 16)
// ===========================================================================
//
// For the cotangents dy (and dh_last), per head, with cum the chunk's
// cumsum, g the gradient reaching the chunk's end from later chunks, h_in
// the chunk's incoming state and, in the chunk, D[s, t] = (dy_s . x_t)
// exp(cum_s - cum_t) dt_t for s >= t:
//
//   z_t   = sum_{s>=t} (C_s . B_t) exp(cum_s - cum_t) dy_s + exp(cum_Q - cum_t) g B_t
//   dx_t  = dt_t z_t,   ddt_t = x_t . z_t
//   dB_t  = sum_h [sum_{s>=t} D[s, t] C_s + dt_t exp(cum_Q - cum_t) x_t^T g]
//   dC_s  = sum_h [sum_{t<=s} D[s, t] B_t + exp(cum_s) dy_s^T h_in]
//   ddA_u = sum_{t>=u} (rowsum M + m1 - colsum M)_t + sum_{r<u} m2_r + m3
//
// with M = D (C.B^T), m1_s = exp(cum_s) dy_s . (h_in C_s), m2_t = dt_t x_t
// . (exp(cum_Q - cum_t) g B_t) and m3 = exp(cum_Q) <g, h_in> (ref.py's
// `ssd_bwd_ref` states the same terms).  dx is itself an SSD scan run
// backward in time with B and C exchanged.  M's row and column sums are
// sums of the same terms that ddA takes the difference of, so both are
// summed in float32 from the products' float32 values, never from an
// operand rounded for the tensor cores: rounded once (hi + lo, about
// 2^-17), they moved ddA by 2e-4 of its largest value in the CPU mirror,
// against 3e-5 for the other gradients.
//
// What bounds it: at Mamba-2 780M's widths (H = 48, chunk 256) and S = 4096
// the function reads x, dy (bf16), B, C, dA, dt and writes dx, dB, dC, ddA,
// ddt, some 88 MB, and needs some 36 GFLOP: 0.036 ms at the bf16
// tensor-core rate against 0.026 ms for the bytes, so operations bound it.
//
// bf16 at (64, 128), the wgmma route (`launch_bwd_wg`), eight launches, all
// products on `wgmma` with float32 accumulators, every tile brought by TMA
// as the forward's are (`wg` above: a consumer warpgroup and a producer
// warp, 64 x 64 boxes swizzled by 128 bytes, rows past S zero, a ring of
// two 32 KB slots under full/empty `mbarrier`s), two blocks an SM:
//
// 1.   the forward's `state_wg_kernel`, in one launch twice over: the
//      chunk states, and each chunk's dual state sum_i exp(cum_i) dy_i^T
//      C_i (the same product with dy for x and C for B, blockIdx.z = 1).
//      No C.B^T pass: each row-tile block forms the C.B^T tiles it needs
//      from the bf16 B and C tiles;
// 2-3. the forward's `pass_kernel<bf16>`, h_in as hi and lo bf16 planes
//      as the forward leaves it, and `rpass_kernel`, g carried backward
//      across the chunks, stored as hi and lo planes; dh0;
// 4.   `dx_wg_kernel`, one block per (batch, chunk, pair of heads, 64-row
//      tile t), the forward's output pass run backward: for each tile J >=
//      t, BC = B_t . C_J^T once for the pair, then each head's T = BC
//      exp(cum_s - cum_t) (s >= t) times dy_J, and colsum M from T and x_t
//      . dy_s; then the carried exp(cum_Q - cum_t) B_t . g^T; dx, ddt, m2;
// 5.   `db_wg_kernel`, per (batch, chunk, group of HEAD_GROUP heads, tile
//      t), a pair of heads at a time: each head's x_t^T g, scaled by dt_t
//      exp(cum_Q - cum_t), then for each tile J >= t the pair's D^T summed
//      over its heads in order before one product with C_J; the group's dB;
// 6.   `dc_wg_kernel`, per (batch, chunk, group, tile s), a pair at a time:
//      each head's exp(cum_s) dy_s^T h_in and m1, then for each tile J <= s,
//      CB = C_s . B_J^T once for the pair and each head's D times B_J;
//      rowsum M + m1 of each head; the group's dC;
// 7.   `dda_kernel`: m3 and the two scans of ddA;
// 8.   `head_sum_kernel`: the groups' dB and dC summed in order.
//
// x, dy, B and C enter the products as the bf16 they are, read straight
// from their tiles in either orientation: the transposed products the
// backward needs (B_t . C_J^T, x_t . dy_s^T, D^T C) take K-major or MN-major
// descriptors of the same boxes, never a copy.  The operands formed in
// float32 (T, the summed D^T, each head's D, x w and dy exp(cum) of the
// states, g and h_in) enter as hi + lo bf16 in two products, formed in
// registers as the A operand or read as the two planes the carries store,
// so the gradients keep the float32 algebra's accuracy (about 2^-17
// relative a term).  Masked before exp, as the forward.  The row sums ddA
// needs (colsum, rowsum, m1, m2) stay float32: each thread sums its
// columns in order, then its quad in a fixed order.  No atomics: every
// block owns its outputs and the groups are summed in a fixed order, so
// two calls give the same bits.
//
// Groups: a slot holds C_J (or B_J) and the tiles of HG = 2 heads (the
// forward's group, FWD_HEAD_GROUP), so a block's fixed tiles, the ring, cum and dt take
// 85-109 KB of shared memory at chunk 256 and two blocks share an SM (at
// 168 registers a thread, two blocks of five warps).  dx takes a pair of
// heads a block (z is a head's own): 1,536 blocks at H = 48, chunk 256 and
// S = 4096.  dB and dC take HEAD_GROUP = 4 heads a block, a pair at a time
// into one accumulator, so they leave 12 partial planes of dB and of dC
// for the head sum to read, not 24 (768 blocks each).  dC adds each head's
// D B_J to the accumulator rather than D summed over the pair first: C.B^T,
// a head's D and their sum would hold 96 registers a thread beside the
// accumulator's 64, 160 of the 168 before any address.
//
// float32 inputs, and bf16 at (16, 16), run the float32 FMA route
// (`launch_bwd`), nine launches, inputs read in their own type:
//
// 1-3. cb_f32_kernel, state_f32_kernel, pass_kernel<float> (h_in float32);
// 4-5. state_f32_kernel<DUAL>, rpass_kernel<float>;
// 6.   dxdb_kernel, one block per (batch, chunk, head, 64-row tile t): dx,
//      ddt, the head's dB, colsum M and m2, over the tiles s >= t;
// 7.   dc_kernel, one block per (batch, chunk, head, 64-row tile s): the
//      head's dC and rowsum M + m1, over the tiles t <= s;
// 8-9. dda_kernel; head_sum_kernel over the heads in order.
//
// It keeps two row-tile blocks on an SM by reusing their first phase's
// shared memory for the tile loop (`TileSmem`).

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The sum over a quad (the four threads that share an accumulator row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// This thread's part of <g, h> over the n values at `ofs` of two stored
// states: float32 one value at a time; bf16 (hi at p, lo at p + lo_plane)
// eight at a time, 16-byte loads of each plane.
__device__ __forceinline__ float state_dot(const float* g, const float* h, size_t, size_t ofs,
                                           int n) {
  float part = 0.f;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x)
    part = fmaf(g[ofs + idx], h[ofs + idx], part);
  return part;
}
__device__ __forceinline__ float state_dot(const bf16* g, const bf16* h, size_t lo_plane,
                                           size_t ofs, int n) {
  float part = 0.f;
  for (int idx = 8 * threadIdx.x; idx < n; idx += 8 * blockDim.x) {
    const uint4 v[4] = {*reinterpret_cast<const uint4*>(g + ofs + idx),
                        *reinterpret_cast<const uint4*>(g + lo_plane + ofs + idx),
                        *reinterpret_cast<const uint4*>(h + ofs + idx),
                        *reinterpret_cast<const uint4*>(h + lo_plane + ofs + idx)};
    const __nv_bfloat162* gh = reinterpret_cast<const __nv_bfloat162*>(&v[0]);
    const __nv_bfloat162* gl = reinterpret_cast<const __nv_bfloat162*>(&v[1]);
    const __nv_bfloat162* hh = reinterpret_cast<const __nv_bfloat162*>(&v[2]);
    const __nv_bfloat162* hl = reinterpret_cast<const __nv_bfloat162*>(&v[3]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 a = __bfloat1622float2(gh[k]), a2 = __bfloat1622float2(gl[k]);
      const float2 c = __bfloat1622float2(hh[k]), c2 = __bfloat1622float2(hl[k]);
      part = fmaf(a.x + a2.x, c.x + c2.x, part);
      part = fmaf(a.y + a2.y, c.y + c2.y, part);
    }
  }
  return part;
}

// pass 5: g_c (the gradient reaching the end of chunk c) for every chunk,
// from g = dh_last after the last one: g_{c-1} = exp(cum_Q,c) g_c + sdy_c;
// g_c stored as the incoming state is (float32, or bf16 hi and lo planes).
template <typename T>
__global__ void __launch_bounds__(256)
rpass_kernel(const float* __restrict__ sdy, const float* __restrict__ dAc,
             const float* __restrict__ dh_last, T* __restrict__ gend, size_t lo_plane,
             float* __restrict__ dh0, int BH, int nc, int PN) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int per = PN / 4;
  if (idx >= (size_t)BH * per) return;
  const size_t bh = idx / per, e = (idx % per) * 4;
  float4 g = dh_last ? *reinterpret_cast<const float4*>(dh_last + bh * PN + e)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  const float* sp = sdy + bh * nc * PN + e;
  T* gp = gend + bh * nc * PN + e;
  const float* dp = dAc + bh * nc;
  for (int c = nc - 1; c >= 0; --c) {
    store_h(gp + (size_t)c * PN, lo_plane, g);
    const float4 s = *reinterpret_cast<const float4*>(sp + (size_t)c * PN);
    const float d = expf(dp[c]);
    g.x = fmaf(d, g.x, s.x);
    g.y = fmaf(d, g.y, s.y);
    g.z = fmaf(d, g.z, s.z);
    g.w = fmaf(d, g.w, s.w);
  }
  *reinterpret_cast<float4*>(dh0 + bh * PN + e) = g;
}

// A [P][N] float32 state into shared memory as [P][N + 1].
template <int P, int N>
__device__ __forceinline__ void load_state(float* s, const float* g) {
  for (int idx = threadIdx.x; idx < P * N; idx += blockDim.x)
    s[(idx / N) * (N + 1) + idx % N] = g[idx];
}

// Shared memory of a row-tile block (dxdb_kernel, dc_kernel): a [QT][P + 1]
// tile kept throughout; region 1, a [QT][N + 1] tile, and region 2, a
// [P][N + 1] state, in the first phase; in the tile loop region 1 holds the
// other [QT][N + 1] tile and region 2 a [QT][P + 1] tile and the [QT][QT + 1]
// tile sT; then sU [QT][QT + 1] and the chunk's cum and dt.  About 101 KB at
// (P, N) = (64, 128), chunk 256, so two blocks share an SM.
template <int P, int N>
struct TileSmem {
  static constexpr size_t KEEP = (size_t)QT * (P + 1);
  static constexpr size_t R1 = (size_t)QT * (N + 1);
  static constexpr size_t R2 = (size_t)P * (N + 1) > KEEP + (size_t)QT * (QT + 1)
                                   ? (size_t)P * (N + 1)
                                   : KEEP + (size_t)QT * (QT + 1);
  static constexpr size_t U = (size_t)QT * (QT + 1);
  static constexpr size_t bytes(int Q) {
    return (KEEP + R1 + R2 + U + 2 * (size_t)Q) * sizeof(float);
  }
};

// pass 6: rows t of tile I of a (batch, chunk, head); grid (nc * H * nI, B),
// block x = (c * H + h) * nI + I (I = 0, the most tiles s >= t, first).
// Thread (ty, tx) owns rows ty * 4 + i and columns tx + 16 m.
template <typename T, int P, int N>
__global__ void __launch_bounds__(F32_THREADS, 2)
dxdb_kernel(const T* __restrict__ x, const float* __restrict__ dA, const float* __restrict__ dt,
            const T* __restrict__ Bm, const T* __restrict__ Cm, const T* __restrict__ dy,
            const float* __restrict__ cb, const float* __restrict__ gend, T* __restrict__ dx,
            float* __restrict__ ddt, float* __restrict__ dBp, float* __restrict__ colsum,
            float* __restrict__ m2, int H, int S, int Q, int nI) {
  constexpr int LDX = P + 1, LDN = N + 1, LDG = QT + 1, PR = P / 16, NR = N / 16;
  using L = TileSmem<P, N>;
  extern __shared__ float smem[];
  float* sX = smem;               // [QT][LDX]: x of the rows t
  float* r1 = sX + L::KEEP;
  float* r2 = r1 + L::R1;
  float* sB = r1;                 // first phase: [QT][LDN], B of the rows t
  float* sG = r2;                 //              [P][LDN], g
  float* sC = r1;                 // tile loop: [QT][LDN], C of the rows s
  float* sDy = r2;                //            [QT][LDX], dy of the rows s
  float* sT = r2 + L::KEEP;       //            [QT][LDG], (C_s . B_t) exp(cum_s - cum_t), s >= t
  float* sU = r2 + L::R2;         // [QT][LDG]: D[s, t]
  float* sCum = sU + L::U;        // [Q]
  float* sDt = sCum + Q;          // [Q]
  const int nc = S / Q, QP = nI * QT;
  const int I = blockIdx.x % nI;
  const int h = (blockIdx.x / nI) % H, c = blockIdx.x / (nI * H), b = blockIdx.y;
  const size_t bh = (size_t)b * H + h;
  const size_t t0 = (size_t)c * Q;
  const int i0 = I * QT;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* xb = x + (bh * S + t0) * P;
  const T* dyb = dy + (bh * S + t0) * P;
  const float* cbb = cb + ((size_t)b * nc + c) * QP * QP;

  chunk_cum(sCum, sDt, dA + bh * S + t0, dt + bh * S + t0, Q);
  const float cum_last = sCum[Q - 1];
  load_rows<T, P>(sX, xb + (size_t)i0 * P, Q - i0);
  load_rows<T, N>(sB, Bm + ((size_t)b * S + t0 + i0) * N, Q - i0);
  load_state<P, N>(sG, gend + (bh * nc + c) * P * N);
  __syncthreads();

  // g B_t and x_t^T g, scaled by exp(cum_Q - cum_t) (and dt_t for dB)
  float z[4][PR], db[4][NR];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int m = 0; m < PR; ++m) z[i][m] = 0.f;
#pragma unroll
    for (int m = 0; m < NR; ++m) db[i][m] = 0.f;
  }
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float bv[4], gv[PR];
#pragma unroll
    for (int i = 0; i < 4; ++i) bv[i] = sB[(ty * 4 + i) * LDN + n];
#pragma unroll
    for (int m = 0; m < PR; ++m) gv[m] = sG[(tx + 16 * m) * LDN + n];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < PR; ++m) z[i][m] = fmaf(bv[i], gv[m], z[i][m]);
  }
#pragma unroll 4
  for (int p = 0; p < P; ++p) {
    float xv[4], gv[NR];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = sX[(ty * 4 + i) * LDX + p];
#pragma unroll
    for (int m = 0; m < NR; ++m) gv[m] = sG[p * LDN + tx + 16 * m];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < NR; ++m) db[i][m] = fmaf(xv[i], gv[m], db[i][m]);
  }
  float m2v[4], cs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = i0 + ty * 4 + i;
    const float e = t < Q ? expf(cum_last - sCum[t]) : 0.f;
    const float dtt = t < Q ? sDt[t] : 0.f;
    float part = 0.f;
#pragma unroll
    for (int m = 0; m < PR; ++m) {
      z[i][m] *= e;
      part = fmaf(sX[(ty * 4 + i) * LDX + tx + 16 * m], z[i][m], part);
    }
#pragma unroll
    for (int m = 0; m < NR; ++m) db[i][m] *= e * dtt;
    m2v[i] = dtt * half_warp_sum(part);
    cs[i] = 0.f;
  }

  for (int J = I; J < nI; ++J) {
    const int j0 = J * QT;
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, P>(sDy, dyb + (size_t)j0 * P, Q - j0);
    load_rows<T, N>(sC, Cm + ((size_t)b * S + t0 + j0) * N, Q - j0);
    for (int idx = threadIdx.x; idx < QT * QT; idx += blockDim.x) {
      const int r = idx % QT, jj = idx / QT;   // consecutive threads, consecutive t
      const int t = i0 + r, s_ = j0 + jj;
      const bool ok = s_ >= t && s_ < Q;
      sT[r * LDG + jj] = ok ? cbb[(size_t)s_ * QP + t] * expf(sCum[s_] - sCum[t]) : 0.f;
    }
    __syncthreads();
    // (x_t . dy_s) for this thread's 4 x 4
    float raw[4][4] = {};
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      float xv[4], yv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xv[i] = sX[(ty * 4 + i) * LDX + p];
        yv[i] = sDy[(tx + 16 * i) * LDX + p];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) raw[i][j] = fmaf(xv[i], yv[j], raw[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, t = i0 + r;
      const float dtt = t < Q ? sDt[t] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = tx + 16 * j, s_ = j0 + jj;
        const bool ok = s_ >= t && s_ < Q;
        const float d = ok ? raw[i][j] * expf(sCum[s_] - sCum[t]) * dtt : 0.f;
        sU[r * LDG + jj] = d;
        cs[i] = fmaf(raw[i][j] * dtt, sT[r * LDG + jj], cs[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < QT; ++jj) {
      float tv[4], uv[4], yv[PR], cv[NR];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tv[i] = sT[(ty * 4 + i) * LDG + jj];
        uv[i] = sU[(ty * 4 + i) * LDG + jj];
      }
#pragma unroll
      for (int m = 0; m < PR; ++m) yv[m] = sDy[jj * LDX + tx + 16 * m];
#pragma unroll
      for (int m = 0; m < NR; ++m) cv[m] = sC[jj * LDN + tx + 16 * m];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int m = 0; m < PR; ++m) z[i][m] = fmaf(tv[i], yv[m], z[i][m]);
#pragma unroll
        for (int m = 0; m < NR; ++m) db[i][m] = fmaf(uv[i], cv[m], db[i][m]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = i0 + ty * 4 + i;
    float part = 0.f;
#pragma unroll
    for (int m = 0; m < PR; ++m) part = fmaf(sX[(ty * 4 + i) * LDX + tx + 16 * m], z[i][m], part);
    const float dd = half_warp_sum(part);
    const float col = half_warp_sum(cs[i]);
    if (t >= Q) continue;
    const size_t row = bh * S + t0 + t;
    const float dtt = sDt[t];
#pragma unroll
    for (int m = 0; m < PR; ++m) dx[row * P + tx + 16 * m] = to_t<T>(dtt * z[i][m]);
#pragma unroll
    for (int m = 0; m < NR; ++m) dBp[row * N + tx + 16 * m] = db[i][m];
    if (tx == 0) {
      ddt[row] = dd;
      colsum[row] = col;
      m2[row] = m2v[i];
    }
  }
}

// pass 7: rows s of tile I of a (batch, chunk, head); grid (nc * H * nI, B),
// block x = (c * H + h) * nI + (nI - 1 - I) (the most tiles t <= s first).
template <typename T, int P, int N>
__global__ void __launch_bounds__(F32_THREADS, 2)
dc_kernel(const T* __restrict__ x, const float* __restrict__ dA, const float* __restrict__ dt,
          const T* __restrict__ Bm, const T* __restrict__ Cm, const T* __restrict__ dy,
          const float* __restrict__ cb, const float* __restrict__ hin, float* __restrict__ dCp,
          float* __restrict__ rowm1, int H, int S, int Q, int nI) {
  constexpr int LDX = P + 1, LDN = N + 1, LDG = QT + 1, NR = N / 16;
  using L = TileSmem<P, N>;
  extern __shared__ float smem[];
  float* sDy = smem;              // [QT][LDX]: dy of the rows s
  float* r1 = sDy + L::KEEP;
  float* r2 = r1 + L::R1;
  float* sC = r1;                 // first phase: [QT][LDN], C of the rows s
  float* sH = r2;                 //              [P][LDN], h_in
  float* sB = r1;                 // tile loop: [QT][LDN], B of the rows t
  float* sX = r2;                 //            [QT][LDX], x of the rows t
  float* sT = r2 + L::KEEP;       //            [QT][LDG], (C_s . B_t) exp(cum_s - cum_t), t <= s
  float* sU = r2 + L::R2;         // [QT][LDG]: D[s, t]
  float* sCum = sU + L::U;        // [Q]
  float* sDt = sCum + Q;          // [Q]
  const int nc = S / Q, QP = nI * QT;
  const int I = nI - 1 - (int)(blockIdx.x % nI);
  const int h = (blockIdx.x / nI) % H, c = blockIdx.x / (nI * H), b = blockIdx.y;
  const size_t bh = (size_t)b * H + h;
  const size_t t0 = (size_t)c * Q;
  const int i0 = I * QT;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* xb = x + (bh * S + t0) * P;
  const float* cbb = cb + ((size_t)b * nc + c) * QP * QP;

  chunk_cum(sCum, sDt, dA + bh * S + t0, dt + bh * S + t0, Q);
  load_rows<T, P>(sDy, dy + (bh * S + t0 + i0) * P, Q - i0);
  load_rows<T, N>(sC, Cm + ((size_t)b * S + t0 + i0) * N, Q - i0);
  load_state<P, N>(sH, hin + (bh * nc + c) * P * N);
  __syncthreads();

  // exp(cum_s) dy_s^T h_in, and m1_s = C_s . that
  float dc[4][NR];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < NR; ++m) dc[i][m] = 0.f;
#pragma unroll 4
  for (int p = 0; p < P; ++p) {
    float yv[4], hv[NR];
#pragma unroll
    for (int i = 0; i < 4; ++i) yv[i] = sDy[(ty * 4 + i) * LDX + p];
#pragma unroll
    for (int m = 0; m < NR; ++m) hv[m] = sH[p * LDN + tx + 16 * m];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < NR; ++m) dc[i][m] = fmaf(yv[i], hv[m], dc[i][m]);
  }
  float m1v[4], rs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s_ = i0 + ty * 4 + i;
    const float e = s_ < Q ? expf(sCum[s_]) : 0.f;
    float part = 0.f;
#pragma unroll
    for (int m = 0; m < NR; ++m) {
      dc[i][m] *= e;
      part = fmaf(sC[(ty * 4 + i) * LDN + tx + 16 * m], dc[i][m], part);
    }
    m1v[i] = half_warp_sum(part);
    rs[i] = 0.f;
  }

  for (int J = 0; J <= I; ++J) {
    const int j0 = J * QT;
    __syncthreads();
    load_rows<T, P>(sX, xb + (size_t)j0 * P, Q - j0);
    load_rows<T, N>(sB, Bm + ((size_t)b * S + t0 + j0) * N, Q - j0);
    for (int idx = threadIdx.x; idx < QT * QT; idx += blockDim.x) {
      const int r = idx / QT, jj = idx % QT;   // consecutive threads, consecutive t
      const int s_ = i0 + r, t = j0 + jj;
      const bool ok = t <= s_ && s_ < Q;
      sT[r * LDG + jj] = ok ? cbb[(size_t)s_ * QP + t] * expf(sCum[s_] - sCum[t]) : 0.f;
    }
    __syncthreads();
    float raw[4][4] = {};
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      float yv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        yv[i] = sDy[(ty * 4 + i) * LDX + p];
        xv[i] = sX[(tx + 16 * i) * LDX + p];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) raw[i][j] = fmaf(yv[i], xv[j], raw[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, s_ = i0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = tx + 16 * j, t = j0 + jj;
        const bool ok = t <= s_ && s_ < Q;
        const float dtt = ok ? sDt[t] : 0.f;
        sU[r * LDG + jj] = ok ? raw[i][j] * expf(sCum[s_] - sCum[t]) * dtt : 0.f;
        rs[i] = fmaf(raw[i][j] * dtt, sT[r * LDG + jj], rs[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < QT; ++jj) {
      float uv[4], bv[NR];
#pragma unroll
      for (int i = 0; i < 4; ++i) uv[i] = sU[(ty * 4 + i) * LDG + jj];
#pragma unroll
      for (int m = 0; m < NR; ++m) bv[m] = sB[jj * LDN + tx + 16 * m];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int m = 0; m < NR; ++m) dc[i][m] = fmaf(uv[i], bv[m], dc[i][m]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s_ = i0 + ty * 4 + i;
    const float row_sum = half_warp_sum(rs[i]);
    if (s_ >= Q) continue;
    const size_t row = bh * S + t0 + s_;
#pragma unroll
    for (int m = 0; m < NR; ++m) dCp[row * N + tx + 16 * m] = dc[i][m];
    if (tx == 0) rowm1[row] = row_sum + m1v[i];
  }
}

// ---------------------------------------------------------------------------
// the wgmma route's row tiles (bf16 at (64, 128), passes 4-6): blocks of
// the forward's shape (`wg`), each taking one 64-row tile I of a chunk and
// a group of heads, whose tiles come HG heads a slot.  Thread rows: warp w
// of the consumer warpgroup holds rows 16 w + lane / 4 and 8 more of every
// accumulator.
// ---------------------------------------------------------------------------

// Elements (col, col + 1) of row r (col even) of a [panels][64][64] tile as
// the 128-byte swizzle lays it out (16-byte chunk c of a row at c ^ (r & 7)).
__device__ __forceinline__ float2 box_pair(const bf16* s, int r, int col) {
  const bf16* p = s + (col >> 6) * wg::BOX + r * 64 + ((((col & 63) >> 3) ^ (r & 7)) << 3) +
                  (col & 7);
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// This thread's parts of rows r0 and r1 of the tile `s` dotted with an
// m64nW accumulator `a` (W / 8 columns blocks): p0 for r0, p1 for r1; the
// quad's four parts make the whole dot.
template <int K>
__device__ __forceinline__ void acc_dots(const bf16* s, const float (&a)[K], int r0, int r1, int t,
                                         float& p0, float& p1) {
#pragma unroll
  for (int n = 0; n < K / 4; ++n) {
    const float2 v0 = box_pair(s, r0, 8 * n + 2 * t), v1 = box_pair(s, r1, 8 * n + 2 * t);
    p0 = fmaf(v0.y, a[4 * n + 1], fmaf(v0.x, a[4 * n], p0));
    p1 = fmaf(v1.y, a[4 * n + 3], fmaf(v1.x, a[4 * n + 2], p1));
  }
}

// An m64n64 accumulator `v`, formed in float32 with the thread's rows and
// columns, as the hi and lo A fragments of four 16-deep steps: register q
// of step kk holds row (q & 1 ? r1 : r0), columns 16 kk + 8 (q >> 1) + 2 t
// and the next, which are v[8 kk + 2 q] and v[8 kk + 2 q + 1].
__device__ __forceinline__ void split_frags(const float (&v)[32], uint32_t (&ah)[4][4],
                                            uint32_t (&al)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) split_bf16(v[8 * kk + 2 * q], v[8 * kk + 2 * q + 1], ah[kk][q], al[kk][q]);
}

// acc += (hi + lo) B for an MN-major B tile `sb`: two products a 16-deep step.
template <int K>
__device__ __forceinline__ void frags_times(float (&acc)[K], const uint32_t (&ah)[4][4],
                                            const uint32_t (&al)[4][4], const bf16* sb) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs_tb(acc, ah[kk], mdesc(sb, kk));
    wgmma_rs_tb(acc, al[kk], mdesc(sb, kk));
  }
  wg_commit();
  wg_wait0();
  fence_regs(acc);
}

// d = A . B^T for A and B K-major over KK 16-deep steps (a box of 64
// columns: 4; two panels: 8), m64n64.
template <int KK>
__device__ __forceinline__ void tiles_times_t(float (&d)[32], const bf16* sa, const bf16* sb) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) wgmma_ss(d, kdesc(sa, kk), kdesc(sb, kk), kk > 0);
  wg_commit();
  wg_wait0();
  fence_regs(d);
}

// d = A . (S_hi + S_lo) for A K-major (a box, depth 64) and the [64][128]
// state S as its two planes `sh`, `sh + 2 BOX`, MN-major: m64n128.
__device__ __forceinline__ void tile_times_state(float (&d)[64], const bf16* sa, const bf16* sh) {
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss_n128_tb(d, kdesc(sa, kk), mdesc(sh, kk));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss_n128_tb(d, kdesc(sa, kk), mdesc(sh + 2 * wg::BOX, kk));
  wg_commit();
  wg_wait0();
  fence_regs(d);
}


// The shared memory of a backward row-tile block: its fixed tiles (`fixed`
// boxes), the ring, then cum and dt of its `heads` heads over QP floats
// each, then the barriers (SLOTS + 1 "full", as many "empty"): the fixed
// tiles' "full" barrier `bar_fix` and "empty" barrier `empty_fix`, which
// the consumers arrive on when they are done with a sub-group's tiles.
struct BwdBlock {
  bf16* fix;
  bf16* ring;
  float* cum;
  float* dt;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* bar_fix;
  uint64_t* empty_fix;
  __device__ BwdBlock(unsigned char* raw, int fixed, int QP, int heads) {
    using namespace wg;
    fix = align_1024(raw);
    ring = fix + fixed * BOX;
    cum = reinterpret_cast<float*>(ring + SLOTS * SLOT);
    dt = cum + heads * QP;
    full = reinterpret_cast<uint64_t*>(dt + heads * QP);
    empty = full + SLOTS + 1;
    bar_fix = full + SLOTS;
    empty_fix = empty + SLOTS;
  }
};


// ---------------------------------------------------------------------------
// pass 4 (bf16): dx, ddt, colsum M and m2 of the rows t of tile I of a
// (batch, chunk, group of HG heads), the forward's output pass run
// backward with B and C exchanged.  For each tile J >= I, BC = B_I . C_J^T
// once for the group (m64n64k16, both K-major), then for each head T = BC
// exp(cum_s - cum_t) on t <= s < Q formed in the accumulator, split into hi
// + lo and fed as the A operand of z += T dy_J (dy_J MN-major); colsum_t =
// dt_t sum_s T[t, s] (x_t . dy_s) from T before its split (x_I and dy_J
// both K-major).  Then each head's carried gradient exp(cum_Q - cum_t) B_I
// . g^T (g as its hi and lo planes) is added, with m2_t = dt_t x_t . that.
// The producer brings B_I and the heads' x_I once, then C_J with the
// heads' dy_J a slot, then each head's g, which so loads while the last
// tiles J are multiplied.
// grid (nI * nc * NG, B), NG = ceil(H / HG); block x = (c * NG + group) *
// nI + I: the most tiles J first.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(wg::NTH, 2)
dx_wg_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mdy,
             const __grid_constant__ CUtensorMap mb, const __grid_constant__ CUtensorMap mc,
             const __grid_constant__ CUtensorMap mg, const float* __restrict__ dA,
             const float* __restrict__ dt, bf16* __restrict__ dx, float* __restrict__ ddt,
             float* __restrict__ colsum, float* __restrict__ m2, int H, int S, int Q,
             int lo_rows) {
  using namespace wg;
  extern __shared__ unsigned char smem_raw[];
  const int nI = (Q + 63) / 64, QP = nI * 64;
  const BwdBlock L(smem_raw, 2 + HG, QP, HG);
  const bf16* sB = L.fix;                 // [2][64][64]: B_I
  const bf16* sX = L.fix + 2 * BOX;       // [HG][64][64]: x_I of each head
  const int NG = (H + HG - 1) / HG, nc = S / Q;
  const int I = blockIdx.x % nI, grp = (blockIdx.x / nI) % NG;
  const int c = blockIdx.x / (nI * NG), b = blockIdx.y;
  const int h0 = grp * HG, hv = min(HG, H - h0);
  const int t0 = c * Q, i0 = I * 64;
  const size_t bh0 = (size_t)b * H + h0;
  init_ring(L.full, SLOTS + 1);   // the fixed tiles' "full" barrier; its "empty" one goes unused

  if (threadIdx.x >= 128) {   // the producer warp
    if (threadIdx.x == 128) {
      load_row_tiles(L.fix, &mb, &mx, L.bar_fix, t0 + i0, h0, hv, b);
      int it = 0;
      for (int J = I; J < nI; ++J) {
        const int st = next_slot(L.empty, it);
        load_row_tiles(L.ring + st * SLOT, &mc, &mdy, L.full + st, t0 + J * 64, h0, hv, b);
      }
      for (int g = 0; g < hv; ++g) {
        const int st = next_slot(L.empty, it);
        load_state_planes(L.ring + st * SLOT, &mg, L.full + st, bh0 + g, nc, c, lo_rows);
      }
    }
    return;
  }

  group_cum_wg<HG>(L.cum, L.dt, dA + bh0 * S + t0, dt + bh0 * S + t0, S, Q, QP, hv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + gq, r1 = r0 + 8;      // this thread's rows of the tile
  const int row0 = i0 + r0, row1 = i0 + r1;        // and of the chunk
  float z[HG][32];
  float cs[HG][2];                                 // colsum M / dt_t, this thread's part
#pragma unroll
  for (int g = 0; g < HG; ++g) {
    cs[g][0] = cs[g][1] = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) z[g][e] = 0.f;
  }
  mbar_wait(L.bar_fix, 0);

  int it = 0;
  for (int J = I; J < nI; ++J) {
    const int st = take_slot(L.full, it);
    const bf16* slot = L.ring + st * SLOT;
    float bc[32];
    tiles_times_t<8>(bc, sB, slot);
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      if (g >= hv) continue;
      // x_t . dy_s, for colsum M = sum_s T (x_t . dy_s) dt_t from T as it
      // is: rowsum M in the dC pass sums the same terms, and ddA takes
      // their difference
      float raw[32];
      tiles_times_t<4>(raw, sX + g * BOX, slot + (2 + g) * BOX);
      const float* cum = L.cum + g * QP;
      const float c0 = cum[min(row0, Q - 1)], c1 = cum[min(row1, Q - 1)];
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = (q & 1) ? row1 : row0;
          const float ci = (q & 1) ? c1 : c0;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = J * 64 + 16 * kk + 8 * (q >> 1) + 2 * t + e;
            const bool ok = j >= i && j < Q;
            const int k = 8 * kk + 2 * q + e;
            v[e] = ok ? bc[k] * expf(cum[ok ? j : 0] - ci) : 0.f;
            cs[g][q & 1] = fmaf(v[e], raw[k], cs[g][q & 1]);
          }
          split_bf16(v[0], v[1], ah[kk][q], al[kk][q]);
        }
      frags_times(z[g], ah, al, slot + (2 + g) * BOX);
    }
    mbar_arrive(L.empty + st);
  }

  // x_t . z_t before the carry is added, for ddt
  float xz[HG][2];
#pragma unroll
  for (int g = 0; g < HG; ++g) {
    xz[g][0] = xz[g][1] = 0.f;
    if (g >= hv) continue;
    acc_dots(sX + g * BOX, z[g], r0, r1, t, xz[g][0], xz[g][1]);
    xz[g][0] = quad_sum(xz[g][0]);
    xz[g][1] = quad_sum(xz[g][1]);
  }

#pragma unroll
  for (int g = 0; g < HG; ++g) {
    if (g >= hv) continue;
    const int st = take_slot(L.full, it);
    const bf16* slot = L.ring + st * SLOT;
    float ch[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_ss(ch, kdesc(sB, kk), kdesc(slot, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_ss(ch, kdesc(sB, kk), kdesc(slot + 2 * BOX, kk));
    wg_commit();
    wg_wait0();
    fence_regs(ch);
    mbar_arrive(L.empty + st);
    const float* cum = L.cum + g * QP;
    const float* dtg = L.dt + g * QP;
    const float last = cum[Q - 1];
    const float e0 = row0 < Q ? expf(last - cum[row0]) : 0.f;
    const float e1 = row1 < Q ? expf(last - cum[row1]) : 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      ch[4 * n] *= e0;
      ch[4 * n + 1] *= e0;
      ch[4 * n + 2] *= e1;
      ch[4 * n + 3] *= e1;
    }
    float xc0 = 0.f, xc1 = 0.f;
    acc_dots(sX + g * BOX, ch, r0, r1, t, xc0, xc1);
    xc0 = quad_sum(xc0);
    xc1 = quad_sum(xc1);
    const float cs0 = quad_sum(cs[g][0]), cs1 = quad_sum(cs[g][1]);
    const float dt0 = row0 < Q ? dtg[row0] : 0.f, dt1 = row1 < Q ? dtg[row1] : 0.f;
    bf16* d0 = dx + ((bh0 + g) * S + t0 + row0) * P + 2 * t;
    bf16* d1 = d0 + 8 * P;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float a0 = z[g][4 * n] + ch[4 * n], a1 = z[g][4 * n + 1] + ch[4 * n + 1];
      const float b0 = z[g][4 * n + 2] + ch[4 * n + 2], b1 = z[g][4 * n + 3] + ch[4 * n + 3];
      if (row0 < Q) *reinterpret_cast<uint32_t*>(d0 + 8 * n) = pack_bf16(dt0 * a0, dt0 * a1);
      if (row1 < Q) *reinterpret_cast<uint32_t*>(d1 + 8 * n) = pack_bf16(dt1 * b0, dt1 * b1);
    }
    if (t == 0) {
      const size_t o = (bh0 + g) * S + t0;
      if (row0 < Q) {
        ddt[o + row0] = xz[g][0] + xc0;
        colsum[o + row0] = dt0 * cs0;
        m2[o + row0] = dt0 * xc0;
      }
      if (row1 < Q) {
        ddt[o + row1] = xz[g][1] + xc1;
        colsum[o + row1] = dt1 * cs1;
        m2[o + row1] = dt1 * xc1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pass 5 (bf16): the group's dB for the rows t of tile I of a (batch,
// chunk, group of HEAD_GROUP heads), its heads HG at a time.  For each
// sub-group, first each head's x_t^T g (x_I K-major times g's hi and lo
// planes, MN-major, m64n128), scaled by dt_t exp(cum_Q - cum_t) into the
// accumulator; then for each tile J >= I and each head in order D^T[t, s]
// = (x_t . dy_s) exp(cum_s - cum_t) dt_t (x_I and dy_J both K-major),
// summed over the sub-group's heads in float32 before one product with C_J
// (hi + lo A fragments, C_J MN-major).  The producer brings a sub-group's
// x_I (once its consumers are done with the last sub-group's), then each
// of its heads' g, then C_J with its heads' dy_J a slot.
// grid (nI * nc * NG, B), NG = ceil(H / HEAD_GROUP); block x = (c * NG +
// group) * nI + I: the most tiles J first.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(wg::NTH, 2)
db_wg_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mdy,
             const __grid_constant__ CUtensorMap mc, const __grid_constant__ CUtensorMap mg,
             const float* __restrict__ dA, const float* __restrict__ dt, float* __restrict__ dBp,
             int H, int S, int Q, int lo_rows) {
  using namespace wg;
  extern __shared__ unsigned char smem_raw[];
  const int nI = (Q + 63) / 64, QP = nI * 64;
  const BwdBlock L(smem_raw, HG, QP, BG);
  const bf16* sX = L.fix;                 // [HG][64][64]: x_I of the sub-group's heads
  const int NG = (H + BG - 1) / BG, nc = S / Q;
  const int I = blockIdx.x % nI, grp = (blockIdx.x / nI) % NG;
  const int c = blockIdx.x / (nI * NG), b = blockIdx.y;
  const int h0 = grp * BG, hv = min(BG, H - h0), nsg = (hv + HG - 1) / HG;
  const int t0 = c * Q, i0 = I * 64;
  const size_t bh0 = (size_t)b * H + h0;
  init_ring(L.full, SLOTS + 1);

  if (threadIdx.x >= 128) {   // the producer warp
    if (threadIdx.x == 128) {
      int it = 0;
      for (int sg = 0; sg < nsg; ++sg) {
        const int hs = h0 + sg * HG, sv = min(HG, hv - sg * HG);
        if (sg) mbar_wait(L.empty_fix, (sg - 1) & 1);
        mbar_expect_tx(L.bar_fix, sv * BOX * 2);
        for (int g = 0; g < sv; ++g) tma4(L.fix + g * BOX, &mx, L.bar_fix, 0, t0 + i0, hs + g, b);
        for (int g = 0; g < sv; ++g) {
          const int st = next_slot(L.empty, it);
          load_state_planes(L.ring + st * SLOT, &mg, L.full + st, (size_t)b * H + hs + g, nc, c,
                            lo_rows);
        }
        for (int J = I; J < nI; ++J) {
          const int st = next_slot(L.empty, it);
          load_row_tiles(L.ring + st * SLOT, &mc, &mdy, L.full + st, t0 + J * 64, hs, sv, b);
        }
      }
    }
    return;
  }

  group_cum_wg<BG>(L.cum, L.dt, dA + bh0 * S + t0, dt + bh0 * S + t0, S, Q, QP, hv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = i0 + 16 * warp + gq, row1 = row0 + 8;   // this thread's rows of the chunk
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;

  int it = 0;
  for (int sg = 0; sg < nsg; ++sg) {
    const int sv = min(HG, hv - sg * HG);
    mbar_wait(L.bar_fix, sg & 1);
    // dt_t exp(cum_Q - cum_t) x_t^T g of each head
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      if (g >= sv) continue;
      const int st = take_slot(L.full, it);
      float tmp[64];
      tile_times_state(tmp, sX + g * BOX, L.ring + st * SLOT);
      mbar_arrive(L.empty + st);
      const float* cum = L.cum + (sg * HG + g) * QP;
      const float* dtg = L.dt + (sg * HG + g) * QP;
      const float last = cum[Q - 1];
      const float w0 = row0 < Q ? dtg[row0] * expf(last - cum[row0]) : 0.f;
      const float w1 = row1 < Q ? dtg[row1] * expf(last - cum[row1]) : 0.f;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        acc[4 * n] = fmaf(w0, tmp[4 * n], acc[4 * n]);
        acc[4 * n + 1] = fmaf(w0, tmp[4 * n + 1], acc[4 * n + 1]);
        acc[4 * n + 2] = fmaf(w1, tmp[4 * n + 2], acc[4 * n + 2]);
        acc[4 * n + 3] = fmaf(w1, tmp[4 * n + 3], acc[4 * n + 3]);
      }
    }

    for (int J = I; J < nI; ++J) {
      const int st = take_slot(L.full, it);
      const bf16* slot = L.ring + st * SLOT;
      float ub[32];   // the sub-group's D^T, summed over its heads in order
#pragma unroll
      for (int e = 0; e < 32; ++e) ub[e] = 0.f;
#pragma unroll
      for (int g = 0; g < HG; ++g) {
        if (g >= sv) continue;
        float raw[32];
        tiles_times_t<4>(raw, sX + g * BOX, slot + (2 + g) * BOX);
        const float* cum = L.cum + (sg * HG + g) * QP;
        const float* dtg = L.dt + (sg * HG + g) * QP;
        const float c0 = cum[min(row0, Q - 1)], c1 = cum[min(row1, Q - 1)];
        const float d0 = row0 < Q ? dtg[row0] : 0.f, d1 = row1 < Q ? dtg[row1] : 0.f;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const bool second = (e >> 1) & 1;
          const int i = second ? row1 : row0;
          const int j = J * 64 + 8 * (e >> 2) + 2 * t + (e & 1);
          const bool ok = j >= i && j < Q;
          ub[e] += ok ? raw[e] * expf(cum[ok ? j : 0] - (second ? c1 : c0)) * (second ? d1 : d0)
                      : 0.f;
        }
      }
      uint32_t ah[4][4], al[4][4];
      split_frags(ub, ah, al);
      frags_times(acc, ah, al, slot);
      mbar_arrive(L.empty + st);
    }
    mbar_arrive(L.empty_fix);   // done with the sub-group's x_I
  }

  float* o0 = dBp + (((size_t)b * NG + grp) * S + t0 + row0) * N + 2 * t;
  float* o1 = o0 + 8 * N;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    if (row0 < Q) *reinterpret_cast<float2*>(o0 + 8 * n) = make_float2(acc[4 * n], acc[4 * n + 1]);
    if (row1 < Q) *reinterpret_cast<float2*>(o1 + 8 * n) = make_float2(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// ---------------------------------------------------------------------------
// pass 6 (bf16): the group's dC and each head's rowsum M + m1 for the rows
// s of tile I of a (batch, chunk, group of HEAD_GROUP heads), its heads HG
// at a time.  For each sub-group, first each head's exp(cum_s) dy_s^T h_in
// (dy_I K-major times h_in's hi and lo planes, MN-major, m64n128) into the
// accumulator, and m1_s = C_s . that; then for each tile J <= I, CB = C_I
// . B_J^T (both K-major), and for each head in order D[s, t] = (dy_s .
// x_t) exp(cum_s - cum_t) dt_t (dy_I and x_J both K-major), rowsum M += D
// CB, and D as hi + lo A fragments times B_J (MN-major) into the
// accumulator.  The producer brings C_I with the first sub-group's dy_I
// (a later sub-group's dy_I once its consumers are done with the last
// one's), then each of its heads' h_in, then B_J with its heads' x_J a
// slot.
// grid (nI * nc * NG, B); block x = (c * NG + group) * nI + (nI - 1 - I):
// the most tiles J first.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(wg::NTH, 2)
dc_wg_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mdy,
             const __grid_constant__ CUtensorMap mb, const __grid_constant__ CUtensorMap mc,
             const __grid_constant__ CUtensorMap mh, const float* __restrict__ dA,
             const float* __restrict__ dt, float* __restrict__ dCp, float* __restrict__ rowm1,
             int H, int S, int Q, int lo_rows) {
  using namespace wg;
  extern __shared__ unsigned char smem_raw[];
  const int nI = (Q + 63) / 64, QP = nI * 64;
  const BwdBlock L(smem_raw, 2 + HG, QP, BG);
  const bf16* sC = L.fix;                 // [2][64][64]: C_I
  const bf16* sDy = L.fix + 2 * BOX;      // [HG][64][64]: dy_I of the sub-group's heads
  const int NG = (H + BG - 1) / BG, nc = S / Q;
  const int I = nI - 1 - (int)(blockIdx.x % nI), grp = (blockIdx.x / nI) % NG;
  const int c = blockIdx.x / (nI * NG), b = blockIdx.y;
  const int h0 = grp * BG, hv = min(BG, H - h0), nsg = (hv + HG - 1) / HG;
  const int t0 = c * Q, i0 = I * 64;
  const size_t bh0 = (size_t)b * H + h0;
  init_ring(L.full, SLOTS + 1);

  if (threadIdx.x >= 128) {   // the producer warp
    if (threadIdx.x == 128) {
      int it = 0;
      for (int sg = 0; sg < nsg; ++sg) {
        const int hs = h0 + sg * HG, sv = min(HG, hv - sg * HG);
        if (sg == 0) {
          load_row_tiles(L.fix, &mc, &mdy, L.bar_fix, t0 + i0, hs, sv, b);
        } else {
          mbar_wait(L.empty_fix, (sg - 1) & 1);
          mbar_expect_tx(L.bar_fix, sv * BOX * 2);
          for (int g = 0; g < sv; ++g)
            tma4(L.fix + (2 + g) * BOX, &mdy, L.bar_fix, 0, t0 + i0, hs + g, b);
        }
        for (int g = 0; g < sv; ++g) {
          const int st = next_slot(L.empty, it);
          load_state_planes(L.ring + st * SLOT, &mh, L.full + st, (size_t)b * H + hs + g, nc, c,
                            lo_rows);
        }
        for (int J = 0; J <= I; ++J) {
          const int st = next_slot(L.empty, it);
          load_row_tiles(L.ring + st * SLOT, &mb, &mx, L.full + st, t0 + J * 64, hs, sv, b);
        }
      }
    }
    return;
  }

  group_cum_wg<BG>(L.cum, L.dt, dA + bh0 * S + t0, dt + bh0 * S + t0, S, Q, QP, hv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + gq, r1 = r0 + 8;      // this thread's rows of the tile
  const int row0 = i0 + r0, row1 = i0 + r1;        // and of the chunk
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;

  int it = 0;
  for (int sg = 0; sg < nsg; ++sg) {
    const int sv = min(HG, hv - sg * HG);
    float rs[HG][2];                              // rowsum M + m1, this thread's part
    mbar_wait(L.bar_fix, sg & 1);
    // exp(cum_s) dy_s^T h_in of each head, and m1_s = C_s . that
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      rs[g][0] = rs[g][1] = 0.f;
      if (g >= sv) continue;
      const int st = take_slot(L.full, it);
      float tmp[64];
      tile_times_state(tmp, sDy + g * BOX, L.ring + st * SLOT);
      mbar_arrive(L.empty + st);
      const float* cum = L.cum + (sg * HG + g) * QP;
      const float e0 = row0 < Q ? expf(cum[row0]) : 0.f, e1 = row1 < Q ? expf(cum[row1]) : 0.f;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        tmp[4 * n] *= e0;
        tmp[4 * n + 1] *= e0;
        tmp[4 * n + 2] *= e1;
        tmp[4 * n + 3] *= e1;
      }
      acc_dots(sC, tmp, r0, r1, t, rs[g][0], rs[g][1]);
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] += tmp[e];
    }

    for (int J = 0; J <= I; ++J) {
      const int st = take_slot(L.full, it);
      const bf16* slot = L.ring + st * SLOT;
      float cb[32];
      tiles_times_t<8>(cb, sC, slot);
#pragma unroll
      for (int g = 0; g < HG; ++g) {
        if (g >= sv) continue;
        float raw[32];
        tiles_times_t<4>(raw, sDy + g * BOX, slot + (2 + g) * BOX);
        const float* cum = L.cum + (sg * HG + g) * QP;
        const float* dtg = L.dt + (sg * HG + g) * QP;
        const float c0 = cum[min(row0, Q - 1)], c1 = cum[min(row1, Q - 1)];
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = (q & 1) ? row1 : row0;
            const float ci = (q & 1) ? c1 : c0;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = J * 64 + 16 * kk + 8 * (q >> 1) + 2 * t + e;
              const bool ok = j <= i && i < Q;
              const int jj = ok ? j : 0;
              const int k = 8 * kk + 2 * q + e;
              v[e] = ok ? raw[k] * expf(ci - cum[jj]) * dtg[jj] : 0.f;
              rs[g][q & 1] = fmaf(v[e], cb[k], rs[g][q & 1]);
            }
            split_bf16(v[0], v[1], ah[kk][q], al[kk][q]);
          }
        frags_times(acc, ah, al, slot);
      }
      mbar_arrive(L.empty + st);
    }
    mbar_arrive(L.empty_fix);   // done with the sub-group's dy_I

#pragma unroll
    for (int g = 0; g < HG; ++g) {
      const float a = quad_sum(rs[g][0]), bsum = quad_sum(rs[g][1]);
      if (g < sv && t == 0) {
        const size_t o = (bh0 + sg * HG + g) * S + t0;
        if (row0 < Q) rowm1[o + row0] = a;
        if (row1 < Q) rowm1[o + row1] = bsum;
      }
    }
  }

  float* o0 = dCp + (((size_t)b * NG + grp) * S + t0 + row0) * N + 2 * t;
  float* o1 = o0 + 8 * N;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    if (row0 < Q) *reinterpret_cast<float2*>(o0 + 8 * n) = make_float2(acc[4 * n], acc[4 * n + 1]);
    if (row1 < Q) *reinterpret_cast<float2*>(o1 + 8 * n) = make_float2(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// pass 8 of the FMA route, 7 of the wgmma route: ddA of a (batch,
// head, chunk): m3 = exp(cum_Q) <g, h_in>, then ddA_u = sum_{t>=u} (rowm1 -
// colsum)_t + sum_{r<u} m2_r + m3, the suffix and prefix sums in order; g
// and h_in stored as T (float32, or bf16 hi and lo planes); grid (nc * H,
// B), block 256.
template <int P, int N, typename T>
__global__ void __launch_bounds__(256)
dda_kernel(const T* __restrict__ gend, const T* __restrict__ hin, size_t lo_plane,
           const float* __restrict__ dAc, const float* __restrict__ rowm1,
           const float* __restrict__ colsum, const float* __restrict__ m2,
           float* __restrict__ ddA, int H, int S, int Q) {
  __shared__ float sA[1024], sM[1024], sW[8];
  const int nc = S / Q;
  const int h = blockIdx.x % H, c = blockIdx.x / H, b = blockIdx.y;
  const size_t bh = (size_t)b * H + h;
  const size_t t0 = (size_t)c * Q;
  const size_t ofs = (bh * nc + c) * P * N;
  float part = state_dot(gend, hin, lo_plane, ofs, P * N);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if ((threadIdx.x & 31) == 0) sW[threadIdx.x >> 5] = part;
  const float* rb = rowm1 + bh * S + t0;
  const float* cb_ = colsum + bh * S + t0;
  const float* mb = m2 + bh * S + t0;
  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    sA[i] = rb[Q - 1 - i] - cb_[Q - 1 - i];  // reversed: its cumsum is the suffix sum
    sM[i] = i > 0 ? mb[i - 1] : 0.f;          // shifted: its cumsum is the exclusive prefix
  }
  __syncthreads();
  if (threadIdx.x < 32)
    warp_cumsum(sA, Q, threadIdx.x);
  else if (threadIdx.x < 64)
    warp_cumsum(sM, Q, threadIdx.x - 32);
  __syncthreads();
  float dot = 0.f;
  for (int w = 0; w < 8; ++w) dot += sW[w];
  const float m3 = expf(dAc[bh * nc + c]) * dot;
  for (int u = threadIdx.x; u < Q; u += blockDim.x)
    ddA[bh * S + t0 + u] = sA[Q - 1 - u] + sM[u] + m3;
}

// the last pass: dB and dC, [B, S, N], each the sum in order of the
// `planes` partials [B, planes, S, N] (one a head on the FMA route, one a
// group of heads on the tensor-core route); grid (ceil(B S N / 256), 2).
template <typename T>
__global__ void __launch_bounds__(256)
head_sum_kernel(const float* __restrict__ dBp, const float* __restrict__ dCp, T* __restrict__ dB,
                T* __restrict__ dC, int planes, size_t SN, size_t total) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const float* p = (blockIdx.y ? dCp : dBp) + (idx / SN) * planes * SN + idx % SN;
  float acc = 0.f;
  for (int h = 0; h < planes; ++h) acc += p[(size_t)h * SN];
  (blockIdx.y ? dC : dB)[idx] = to_t<T>(acc);
}

// The FMA route: float32 inputs, and bf16 at the smoke widths.
template <typename T, int P, int N>
cudaError_t launch_bwd(const T* x, const float* dA, const float* dt, const T* Bm, const T* Cm,
                       const float* h0, const T* dy, const float* dh_last, T* dx, float* ddA,
                       float* ddt, T* dB, T* dC, float* dh0, float* cb, float* states,
                       float* hin, float* gend, float* dAc, float* h_last, float* dBp,
                       float* dCp, float* colsum, float* rowm1, float* m2, int B, int H, int S,
                       int Q, cudaStream_t stream) {
  const int nc = S / Q, nI = (Q + QT - 1) / QT;
  const int per = B * H * (P * N / 4);
  // 1-3: C.B^T, the chunk states and the carry, h_in in float32
  size_t smem = (size_t)2 * QT * (N + 1) * sizeof(float);
  cudaError_t err = set_smem(cb_f32_kernel<T, N>, smem);
  if (err != cudaSuccess) return err;
  cb_f32_kernel<T, N><<<dim3(nI * nc, B), F32_THREADS, smem, stream>>>(Bm, Cm, cb, S, Q, nI);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  smem = ((size_t)QT * (P + 1) + (size_t)QT * (N + 1) + QT + 2 * (size_t)Q) * sizeof(float);
  if ((err = set_smem(state_f32_kernel<T, P, N>, smem)) != cudaSuccess) return err;
  state_f32_kernel<T, P, N><<<dim3(nc * H, B), F32_THREADS, smem, stream>>>(x, dA, dt, Bm, states,
                                                                           dAc, H, S, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  pass_kernel<float><<<(per + 255) / 256, 256, 0, stream>>>(states, dAc, h0, hin, 0, h_last,
                                                            B * H, nc, P * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 4-5: the dual states (into `states`, no longer needed) and g
  if ((err = set_smem(state_f32_kernel<T, P, N, true>, smem)) != cudaSuccess) return err;
  state_f32_kernel<T, P, N, true><<<dim3(nc * H, B), F32_THREADS, smem, stream>>>(
      dy, dA, dt, Cm, states, nullptr, H, S, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rpass_kernel<float><<<(per + 255) / 256, 256, 0, stream>>>(states, dAc, dh_last, gend, 0, dh0,
                                                             B * H, nc, P * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 6-7: the row tiles
  smem = TileSmem<P, N>::bytes(Q);
  if ((err = set_smem(dxdb_kernel<T, P, N>, smem)) != cudaSuccess) return err;
  dxdb_kernel<T, P, N><<<dim3(nc * H * nI, B), F32_THREADS, smem, stream>>>(
      x, dA, dt, Bm, Cm, dy, cb, gend, dx, ddt, dBp, colsum, m2, H, S, Q, nI);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(dc_kernel<T, P, N>, smem)) != cudaSuccess) return err;
  dc_kernel<T, P, N><<<dim3(nc * H * nI, B), F32_THREADS, smem, stream>>>(
      x, dA, dt, Bm, Cm, dy, cb, hin, dCp, rowm1, H, S, Q, nI);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 8-9: ddA; dB and dC over the heads
  dda_kernel<P, N, float><<<dim3(nc * H, B), 256, 0, stream>>>(gend, hin, 0, dAc, rowm1, colsum,
                                                               m2, ddA, H, S, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t SN = (size_t)S * N, total = (size_t)B * SN;
  head_sum_kernel<T><<<dim3((unsigned)((total + 255) / 256), 2), 256, 0, stream>>>(
      dBp, dCp, dB, dC, H, SN, total);
  return cudaGetLastError();
}

// The wgmma route: bf16 at (P, N) = (64, 128).  hin and gend hold two bf16
// planes each (hi, then lo), states two float32 planes (the chunk states,
// then the dual states); dBp and dCp hold ceil(H / HEAD_GROUP) partials; no
// C.B^T scratch.
cudaError_t launch_bwd_wg(const bf16* x, const float* dA, const float* dt, const bf16* Bm,
                          const bf16* Cm, const float* h0, const bf16* dy, const float* dh_last,
                          bf16* dx, float* ddA, float* ddt, bf16* dB, bf16* dC, float* dh0,
                          float* states, bf16* hin, bf16* gend, float* dAc, float* h_last,
                          float* dBp, float* dCp, float* colsum, float* rowm1, float* m2, int B,
                          int H, int S, int Q, cudaStream_t stream) {
  using namespace wg;
  const int nc = S / Q, nI = (Q + 63) / 64, QP = nI * 64;
  const int NG = (H + HG - 1) / HG, NGB = (H + BG - 1) / BG;
  const int lo_rows = B * H * nc * P;
  const size_t lo_plane = (size_t)lo_rows * N;
  const int per = B * H * (P * N / 4);
  CUtensorMap mx, mdy, mb, mc, mh, mg;
  const cuuint64_t dx4[4] = {(cuuint64_t)P, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t dbc[3] = {(cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t dh[2] = {(cuuint64_t)N, 2 * (cuuint64_t)lo_rows};
  cudaError_t err;
  if ((err = tile_map(&mx, x, 4, dx4)) != cudaSuccess) return err;
  if ((err = tile_map(&mdy, dy, 4, dx4)) != cudaSuccess) return err;
  if ((err = tile_map(&mb, Bm, 3, dbc)) != cudaSuccess) return err;
  if ((err = tile_map(&mc, Cm, 3, dbc)) != cudaSuccess) return err;
  if ((err = tile_map(&mh, hin, 2, dh)) != cudaSuccess) return err;
  if ((err = tile_map(&mg, gend, 2, dh)) != cudaSuccess) return err;

  // 1: the chunk states and the dual states, in one launch
  float* sdy = states + (size_t)B * H * nc * P * N;
  if ((err = set_smem(state_wg_kernel, state_smem(QP))) != cudaSuccess) return err;
  state_wg_kernel<<<dim3(nc * NG, B, 2), NTH, state_smem(QP), stream>>>(mx, mb, mdy, mc, dA, dt,
                                                                        states, sdy, dAc, H, S, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 2-3: the carry, h_in as hi + lo; g carried backward, as hi + lo
  pass_kernel<bf16><<<(per + 255) / 256, 256, 0, stream>>>(states, dAc, h0, hin, lo_plane, h_last,
                                                           B * H, nc, P * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rpass_kernel<bf16><<<(per + 255) / 256, 256, 0, stream>>>(sdy, dAc, dh_last, gend, lo_plane,
                                                            dh0, B * H, nc, P * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 4-6: the row tiles: dx in blocks of HG heads, dB and dC of BG
  const dim3 gx(nI * nc * ((H + HG - 1) / HG), B), grid(nI * nc * NGB, B);
  const size_t sx = bwd_smem(QP, 2 + HG, HG), sb = bwd_smem(QP, HG, BG),
               sc = bwd_smem(QP, 2 + HG, BG);
  if ((err = set_smem(dx_wg_kernel, sx)) != cudaSuccess) return err;
  dx_wg_kernel<<<gx, NTH, sx, stream>>>(mx, mdy, mb, mc, mg, dA, dt, dx, ddt, colsum, m2, H, S, Q,
                                        lo_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(db_wg_kernel, sb)) != cudaSuccess) return err;
  db_wg_kernel<<<grid, NTH, sb, stream>>>(mx, mdy, mc, mg, dA, dt, dBp, H, S, Q, lo_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(dc_wg_kernel, sc)) != cudaSuccess) return err;
  dc_wg_kernel<<<grid, NTH, sc, stream>>>(mx, mdy, mb, mc, mh, dA, dt, dCp, rowm1, H, S, Q,
                                          lo_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 7-8: ddA; dB and dC over the groups
  dda_kernel<P, N, bf16><<<dim3(nc * H, B), 256, 0, stream>>>(gend, hin, lo_plane, dAc, rowm1,
                                                              colsum, m2, ddA, H, S, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t SN = (size_t)S * N, total = (size_t)B * SN;
  head_sum_kernel<bf16><<<dim3((unsigned)((total + 255) / 256), 2), 256, 0, stream>>>(
      dBp, dCp, dB, dC, NGB, SN, total);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t launch_bwd_any(const void* x, const float* dA, const float* dt, const void* Bm,
                           const void* Cm, const float* h0, const void* dy, const float* dh_last,
                           void* dx, float* ddA, float* ddt, void* dB, void* dC, float* dh0,
                           float* cb, float* states, float* hin, float* gend, float* dAc,
                           float* h_last, float* dBp, float* dCp, float* colsum, float* rowm1,
                           float* m2, int B, int H, int S, int Q, int dtype, cudaStream_t s) {
  if (dtype == 0)
    return launch_bwd<float, P, N>(
        static_cast<const float*>(x), dA, dt, static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), h0, static_cast<const float*>(dy), dh_last,
        static_cast<float*>(dx), ddA, ddt, static_cast<float*>(dB), static_cast<float*>(dC), dh0,
        cb, states, hin, gend, dAc, h_last, dBp, dCp, colsum, rowm1, m2, B, H, S, Q, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  if constexpr (P == 64 && N == 128)
    return launch_bwd_wg(static_cast<const bf16*>(x), dA, dt, static_cast<const bf16*>(Bm),
                         static_cast<const bf16*>(Cm), h0, static_cast<const bf16*>(dy), dh_last,
                         static_cast<bf16*>(dx), ddA, ddt, static_cast<bf16*>(dB),
                         static_cast<bf16*>(dC), dh0, states, reinterpret_cast<bf16*>(hin),
                         reinterpret_cast<bf16*>(gend), dAc, h_last, dBp, dCp, colsum, rowm1, m2,
                         B, H, S, Q, s);
  else
    return launch_bwd<bf16, P, N>(
        static_cast<const bf16*>(x), dA, dt, static_cast<const bf16*>(Bm),
        static_cast<const bf16*>(Cm), h0, static_cast<const bf16*>(dy), dh_last,
        static_cast<bf16*>(dx), ddA, ddt, static_cast<bf16*>(dB), static_cast<bf16*>(dC), dh0,
        cb, states, hin, gend, dAc, h_last, dBp, dCp, colsum, rowm1, m2, B, H, S, Q, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C and y); (P, N) = (64, 128) or
// (16, 16); S a multiple of Q, Q at most 1024; h0 may be null (zeros).
// Scratch, allocated by the caller: states float32 [B, H, S / Q, P, N];
// hin the same shape, two bf16 planes (hi, lo) on the wgmma route (bf16
// at (64, 128)) and float32 on the FMA route; there cb float32 [B, S / Q,
// QP, QP] with QP = Q rounded up to 64 (null on the wgmma route); dAc
// float32 [B, H, S / Q].  The wrapper checks all of it.
extern "C" int ssd_fwd(const void* x, const float* dA, const float* dt, const void* Bm,
                       const void* Cm, const float* h0, void* y, float* h_last, float* cb,
                       float* states, void* hin, float* dAc, int B, int H, int S, int P, int N,
                       int Q, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q < 1 || Q > 1024 || S % Q) return cudaErrorInvalidValue;
  if (P == 64 && N == 128)
    return launch<64, 128>(x, dA, dt, Bm, Cm, h0, y, h_last, cb, states, hin, dAc, B, H, S, Q,
                           dtype, s);
  if (P == 16 && N == 16)
    return launch<16, 16>(x, dA, dt, Bm, Cm, h0, y, h_last, cb, states, hin, dAc, B, H, S, Q,
                          dtype, s);
  return cudaErrorInvalidValue;
}

// The gradient of `ssd_fwd` for dy (x's type) and dh_last (float32 [B, H,
// P, N], or null): dx (x's type), ddA and ddt (float32 [B, H, S]), dB and
// dC (B's type [B, S, N]), dh0 (float32 [B, H, P, N]).  h0 may be null.
// Scratch, allocated by the caller, by route.  The wgmma route (bf16 at
// (64, 128)): cb null; states float32 [2, B, H, S / Q, P, N] (the chunk
// states, then the dual states); hin and gend bf16 [2, B, H, S / Q, P, N]
// (hi, then lo planes); dBp and dCp [B, ceil(H / HEAD_GROUP), S, N].  The
// FMA route: cb [B, S / Q, QP, QP]; states, hin and gend float32 [B, H,
// S / Q, P, N]; dBp and dCp [B, H, S, N].  Both, float32: dAc [B, H, S /
// Q]; h_last [B, H, P, N]; colsum, rowm1 and m2 [B, H, S].
extern "C" int ssd_bwd(const void* x, const float* dA, const float* dt, const void* Bm,
                       const void* Cm, const float* h0, const void* dy, const float* dh_last,
                       void* dx, float* ddA, float* ddt, void* dB, void* dC, float* dh0,
                       float* cb, float* states, float* hin, float* gend, float* dAc,
                       float* h_last, float* dBp, float* dCp, float* colsum, float* rowm1,
                       float* m2, int B, int H, int S, int P, int N, int Q, int dtype,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q < 1 || Q > 1024 || S % Q) return cudaErrorInvalidValue;
  if (P == 64 && N == 128)
    return launch_bwd_any<64, 128>(x, dA, dt, Bm, Cm, h0, dy, dh_last, dx, ddA, ddt, dB, dC, dh0,
                                   cb, states, hin, gend, dAc, h_last, dBp, dCp, colsum, rowm1,
                                   m2, B, H, S, Q, dtype, s);
  if (P == 16 && N == 16)
    return launch_bwd_any<16, 16>(x, dA, dt, Bm, Cm, h0, dy, dh_last, dx, ddA, ddt, dB, dC, dh0,
                                  cb, states, hin, gend, dAc, h_last, dBp, dCp, colsum, rowm1,
                                  m2, B, H, S, Q, dtype, s);
  return cudaErrorInvalidValue;
}
