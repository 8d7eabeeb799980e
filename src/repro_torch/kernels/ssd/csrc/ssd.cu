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
// chunks run in parallel, in four passes (Mamba-2's own chunked
// decomposition):
//
// 1. cb:    C.B^T of each (batch, chunk), once for all heads, into a float32
//           scratch [B, nc, QP, QP] (QP: Q rounded up to 64); only the
//           64 x 64 tiles on or below the diagonal are formed.
// 2. state: one block per (batch, chunk, head): the chunk's own state
//           s_c = sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T, a [P x Q].[Q x N]
//           product, into a float32 scratch [B, H, nc, P, N], and cum_Q.
// 3. pass:  the carry across chunks, h_c = exp(cum_Q,c) h_{c-1} + s_c,
//           sequential over the chunks and parallel over B.H.P.N; it writes
//           each chunk's incoming state (float32, or hi and lo bf16 planes
//           for bf16 inputs) and h_last.  Memory bound: it reads and writes
//           the scratch once.
// 4. out:   one block per (batch, chunk, head, 64-row tile I):
//           y_I = exp(cum_I) C_I . h_in^T + sum_{J <= I} G_IJ x_J with
//           G_IJ = CB_IJ exp(cum_i - cum_j) dt_j on j <= i, read from pass 1.
//
// bfloat16 inputs run every product on the tensor cores
// (`mma.sync.m16n8k16`, float32 accumulators) from bf16 tiles in swizzled
// shared memory fed by `cp.async`; cumsum, decays and the carried state stay
// float32, and only the operands fed to the tensor cores are bf16.  x, B
// and C enter as they are; the operands formed in float32 (x.w with w the
// decay times dt, G, and the incoming state) enter as the sum of two bf16
// values, hi + lo, in two products.  So the passes keep the float32
// algebra's accuracy (about 2^-17 relative a term) and y differs from the
// plain version only where the two round it to bf16.  Rounding G and the
// incoming state once instead moved y by 2.7e-3 relative L2 at S=32768 (50
// times the float32 FMA kernel's 5.3e-5), and rounding x.w once put h_last
// outside its limit in a CPU emulation.  The products are cheap beside the
// loads, so the second one costs little.  float32
// inputs run the same passes with float32 FMA on the CUDA cores (IEEE, no
// TF32).  Masked before exp: above the diagonal cum_i - cum_j > 0 may
// overflow, and inf * 0 is NaN, so those entries are selected to 0.
//
// `ssd_fwd` and `ssd_bwd` return the `cudaError_t` of their launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int QT = 64;          // rows of a chunk tile
constexpr int F32_THREADS = 256;  // float32 passes: 16 x 16 threads

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

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
// bfloat16: tensor-core helpers (mma.sync m16n8k16, ldmatrix, cp.async), as
// in flash_attention.cu's `tc` namespace
// ===========================================================================
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
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
// (a, b) as two bf16 pairs: hi = (a, b) rounded, lo = what hi missed.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// Element offset of 16-byte chunk `c` of row `r` in a [rows][W] bf16 tile.
// Rows of at least eight chunks are swizzled (chunk c at c ^ (r & 7)) so the
// eight rows an `ldmatrix` reads fall in eight bank groups; narrower rows
// (W = 16, the smoke widths) are left in place.
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CH = W / 8;
  return r * W + ((CH >= 8 ? (c ^ (r & 7)) : c) << 3);
}

// Rows [0, ROWS) of a [rows][W] bf16 block, rows `pitch` elements apart from
// `g`, into the tile `s`; rows at or beyond `n_valid` read zeros.
// Asynchronous: the caller commits and waits.
template <int ROWS, int W>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, size_t pitch, int n_valid) {
  constexpr int CH = W / 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = r < n_valid;
    cp_async16(smem_u32(s + swz<W>(r, c)), ok ? g + r * pitch + c * 8 : g, ok);
  }
}

// Fragments of one 16-deep step `kk` of a [rows][W] tile: a_frag, A rows
// [r0, r0 + 16) with the depth along the row; b_frag, B of two n-tiles
// [n0, n0 + 16) with the tile's rows being n (b[0], b[1] for n0; b[2], b[3]
// for n0 + 8); bt_frag, B of two n-tiles [n0, n0 + 16) of the tile's
// columns, its rows being the depth.
template <int W>
__device__ __forceinline__ void a_frag(const bf16* s, int r0, int kk, int lane, uint32_t (&a)[4]) {
  ldsm_x4(smem_u32(s + swz<W>(r0 + (lane & 15), 2 * kk + (lane >> 4))), a);
}
template <int W>
__device__ __forceinline__ void b_frag(const bf16* s, int n0, int kk, int lane, uint32_t (&b)[4]) {
  ldsm_x4(smem_u32(s + swz<W>(n0 + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1))),
          b);
}
template <int W>
__device__ __forceinline__ void bt_frag(const bf16* s, int n0, int kk, int lane,
                                        uint32_t (&b)[4]) {
  ldsm_x4_t(smem_u32(s + swz<W>(16 * kk + (lane & 15), (n0 >> 3) + (lane >> 4))), b);
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// c += A B^T for a warp's 16 rows: A rows [r0, r0 + 16) of `sa`, B rows
// [0, 8 NT) of `sb`, both [rows][W] with the depth W along the row.
template <int W, int NT>
__device__ __forceinline__ void rows_times_rows_t(float (&c)[NT][4], const bf16* sa, int r0,
                                                  const bf16* sb, int lane) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    uint32_t a[4];
    a_frag<W>(sa, r0, kk, lane, a);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      b_frag<W>(sb, n * 8, kk, lane, b);
      mma(c[n], a, b[0], b[1]);
      mma(c[n + 1], a, b[2], b[3]);
    }
  }
}

// c += A B for a warp's 16 rows: A in registers as m16n8 accumulators
// x[2 kk], x[2 kk + 1], entering as hi + lo bf16 (two products), B the
// [KSTEPS * 16][W] tile `s`.
template <int W, int KSTEPS, int NT>
__device__ __forceinline__ void regs_times_tile(float (&c)[NT][4], const float (&x)[2 * KSTEPS][4],
                                                const bf16* s, int lane) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t ah[4], al[4];
    split_bf16(x[2 * kk][0], x[2 * kk][1], ah[0], al[0]);
    split_bf16(x[2 * kk][2], x[2 * kk][3], ah[1], al[1]);
    split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], ah[2], al[2]);
    split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      bt_frag<W>(s, n * 8, kk, lane, b);
      mma(c[n], ah, b[0], b[1]);
      mma(c[n + 1], ah, b[2], b[3]);
      mma(c[n], al, b[0], b[1]);
      mma(c[n + 1], al, b[2], b[3]);
    }
  }
}

// A warp's 16 x 8 NT accumulators to rows r0 + g and r0 + g + 8 of the
// row-major float32 block `o` (rows `ld` apart); `keep` 0 stores them all,
// 1 only column <= row, 2 only column > row (rows and columns of the tile).
template <int NT>
__device__ __forceinline__ void store_acc(float* o, size_t ld, const float (&s)[NT][4], int r0,
                                          int lane, int keep) {
  const int g = lane >> 2, t = lane & 3;
  float* o0 = o + (size_t)(r0 + g) * ld + 2 * t;
  float* o1 = o0 + 8 * ld;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (keep == 0) {
      *reinterpret_cast<float2*>(o0 + 8 * n) = make_float2(s[n][0], s[n][1]);
      *reinterpret_cast<float2*>(o1 + 8 * n) = make_float2(s[n][2], s[n][3]);
      continue;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e >> 1), col = 8 * n + 2 * t + (e & 1);
      if (keep == 1 ? col <= row : col > row) ((e >> 1) ? o1 : o0)[8 * n + (e & 1)] = s[n][e];
    }
  }
}

// ---------------------------------------------------------------------------
// pass 1 (bf16): C.B^T of a (batch, chunk) for row tile I and every column
// tile J <= I; 4 warps of 16 rows, B_J in a ring of two.  FULL (the
// backward) also forms B_J.C_I^T into the tile (J, I), so that the whole
// [QP][QP] block holds C_max(a,b) . B_min(a,b) at (a, b): the tiles t <= s
// read by rows s and the tiles s >= t read by rows t are both row-major
// (on the diagonal tile, C.B^T fills column <= row and B.C^T the rest).
// grid (nI * nc, B); block x = c * nI + I.
// ---------------------------------------------------------------------------
template <int N, bool FULL>
__global__ void __launch_bounds__(128)
cb_tc_kernel(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, float* __restrict__ cb,
             int S, int Q, int nI) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);  // [QT][N]
  bf16* sB = sC + QT * N;                        // [2][QT][N]
  const int I = blockIdx.x % nI, c = blockIdx.x / nI, b = blockIdx.y;
  const int nc = S / Q, QP = nI * QT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, r0 = warp * 16;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  const int i0 = I * QT;
  float* out = cb + ((size_t)b * nc + c) * QP * QP;

  load_tile<QT, N>(sC, Cm + (t0 + i0) * N, N, Q - i0);
  load_tile<QT, N>(sB, Bm + t0 * N, N, Q);
  cp_async_commit();
  for (int J = 0; J <= I; ++J) {
    const int st = J & 1;
    if (J < I)
      load_tile<QT, N>(sB + (st ^ 1) * QT * N, Bm + (t0 + (J + 1) * QT) * N, N,
                       Q - (J + 1) * QT);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[QT / 8][4];
    zero(s);
    rows_times_rows_t<N, QT / 8>(s, sC, r0, sB + st * QT * N, lane);
    const bool diag = FULL && J == I;
    store_acc(out + (size_t)i0 * QP + J * QT, QP, s, r0, lane, diag ? 1 : 0);
    if (FULL) {
      zero(s);
      rows_times_rows_t<N, QT / 8>(s, sB + st * QT * N, r0, sC, lane);
      store_acc(out + (size_t)J * QT * QP + i0, QP, s, r0, lane, diag ? 2 : 0);
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// pass 2 (bf16): the chunk's own state s[P][N] = sum_j (x_j w_j)^T B_j with
// w_j = exp(cum_Q - cum_j) dt_j; x w enters as hi + lo, both bf16.  Warps
// split P into 16-row groups and N into groups of WN columns.  DUAL (the
// backward): the chunk's dual state sum_i exp(cum_i) dy_i^T C_i, called with
// dy for x and C for B; it writes no dAc.
// grid (nc * H, B); block x = c * H + h.
// ---------------------------------------------------------------------------
template <int P, int N>
struct StateShape {
  static constexpr int WN = N < 64 ? N : 64;          // columns a warp
  static constexpr int WARPS = (P / 16) * (N / WN);
  static constexpr int THREADS = 32 * WARPS;
};

template <int P, int N, bool DUAL = false>
__global__ void __launch_bounds__(StateShape<P, N>::THREADS)
state_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dA,
                const float* __restrict__ dt, const bf16* __restrict__ Bm,
                float* __restrict__ states, float* __restrict__ dAc, int H, int S, int Q) {
  constexpr int WN = StateShape<P, N>::WN;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sXh = reinterpret_cast<bf16*>(smem_raw);  // [P][QT]: (x w)^T, hi
  bf16* sXl = sXh + P * QT;                       // [P][QT]: (x w)^T, lo
  bf16* sB = sXl + P * QT;                        // [QT][N]
  float* sCum = reinterpret_cast<float*>(sB + QT * N);  // [Q]
  float* sDt = sCum + Q;                          // [Q]

  const int nc = S / Q;
  const int h = blockIdx.x % H, c = blockIdx.x / H, b = blockIdx.y;
  const size_t bh = (size_t)b * H + h;
  const size_t t0 = (size_t)c * Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pr0 = (warp % (P / 16)) * 16, nc0 = (warp / (P / 16)) * WN;
  const bf16* xb = x + (bh * S + t0) * P;
  const bf16* Bb = Bm + ((size_t)b * S + t0) * N;

  chunk_cum(sCum, sDt, dA + bh * S + t0, dt + bh * S + t0, Q);
  const float cum_last = sCum[Q - 1];

  float acc[WN / 8][4];
  zero(acc);
  for (int j0 = 0; j0 < Q; j0 += QT) {
    const int nj = min(QT, Q - j0);
    __syncthreads();  // the previous tile's readers are done
    load_tile<QT, N>(sB, Bb + (size_t)j0 * N, N, nj);
    cp_async_commit();
    // (x w)^T as hi + lo, w_j = exp(cum_Q - cum_j) dt_j
    for (int idx = threadIdx.x; idx < QT * P; idx += blockDim.x) {
      const int j = idx / P, p = idx % P;
      const float v = j < nj ? to_f(xb[(size_t)(j0 + j) * P + p]) *
                                   (DUAL ? expf(sCum[j0 + j])
                                         : expf(cum_last - sCum[j0 + j]) * sDt[j0 + j])
                             : 0.f;
      const bf16 hi = __float2bfloat16(v);
      const int at = swz<QT>(p, j >> 3) + (j & 7);
      sXh[at] = hi;
      sXl[at] = __float2bfloat16(v - __bfloat162float(hi));
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      uint32_t ah[4], al[4];
      a_frag<QT>(sXh, pr0, kk, lane, ah);
      a_frag<QT>(sXl, pr0, kk, lane, al);
#pragma unroll
      for (int n = 0; n < WN / 8; n += 2) {
        uint32_t bq[4];
        bt_frag<N>(sB, nc0 + n * 8, kk, lane, bq);
        mma(acc[n], ah, bq[0], bq[1]);
        mma(acc[n + 1], ah, bq[2], bq[3]);
        mma(acc[n], al, bq[0], bq[1]);
        mma(acc[n + 1], al, bq[2], bq[3]);
      }
    }
  }
  float* o0 = states + (bh * nc + c) * P * N + (size_t)(pr0 + g) * N + nc0 + 2 * t;
  float* o1 = o0 + 8 * N;
#pragma unroll
  for (int n = 0; n < WN / 8; ++n) {
    *reinterpret_cast<float2*>(o0 + 8 * n) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(o1 + 8 * n) = make_float2(acc[n][2], acc[n][3]);
  }
  if (!DUAL && threadIdx.x == 0) dAc[bh * nc + c] = cum_last;
}

// ---------------------------------------------------------------------------
// pass 4 (bf16): y of 64 rows of a chunk for one head; 4 warps of 16 rows.
// y_I = exp(cum_i) C_I . h_in^T + sum_{J <= I} G_IJ x_J.
// grid (nc * H * nI, B); block x = (c * H + h) * nI + (nI - 1 - I): the
// heads of a chunk run together (they read the same C.B^T), longest first.
// ---------------------------------------------------------------------------
template <int P, int N>
__global__ void __launch_bounds__(128)
out_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dA,
              const float* __restrict__ dt, const bf16* __restrict__ Cm,
              const float* __restrict__ cb, const bf16* __restrict__ hin, size_t lo_plane,
              bf16* __restrict__ y, int H, int S, int Q, int nI) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);   // [QT][N]
  bf16* sHh = sC + QT * N;                        // [P][N], h_in hi
  bf16* sHl = sHh + P * N;                        // [P][N], h_in lo
  bf16* sX = sHl + P * N;                         // [2][QT][P]
  float* sCum = reinterpret_cast<float*>(sX + 2 * QT * P);  // [Q]
  float* sDt = sCum + Q;                          // [Q]

  const int nc = S / Q, QP = nI * QT;
  const int I = nI - 1 - (int)(blockIdx.x % nI);
  const int h = (blockIdx.x / nI) % H, c = blockIdx.x / (nI * H), b = blockIdx.y;
  const size_t bh = (size_t)b * H + h;
  const size_t t0 = (size_t)c * Q;
  const int i0 = I * QT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const bf16* xb = x + (bh * S + t0) * P;
  const float* cbb = cb + ((size_t)b * nc + c) * QP * QP;

  load_tile<QT, N>(sC, Cm + ((size_t)b * S + t0 + i0) * N, N, Q - i0);
  load_tile<P, N>(sHh, hin + (bh * nc + c) * P * N, N, P);
  load_tile<P, N>(sHl, hin + lo_plane + (bh * nc + c) * P * N, N, P);
  load_tile<QT, P>(sX, xb, P, Q);
  cp_async_commit();
  chunk_cum(sCum, sDt, dA + bh * S + t0, dt + bh * S + t0, Q);

  const int row0 = i0 + r0 + g, row1 = row0 + 8;  // this thread's two rows
  const float cum0 = sCum[min(row0, Q - 1)], cum1 = sCum[min(row1, Q - 1)];
  float acc[P / 8][4];
  zero(acc);
  const float* c0 = cbb + (size_t)row0 * QP + 2 * t;
  const float* c1 = c0 + 8 * QP;
  for (int J = 0; J <= I; ++J) {
    const int st = J & 1, j0 = J * QT;
    // this tile's C.B^T, loaded before the wait so the two overlap
    float2 cv[QT / 8][2];
#pragma unroll
    for (int n = 0; n < QT / 8; ++n) {
      cv[n][0] = *reinterpret_cast<const float2*>(c0 + j0 + 8 * n);
      cv[n][1] = *reinterpret_cast<const float2*>(c1 + j0 + 8 * n);
    }
    if (J < I)
      load_tile<QT, P>(sX + (st ^ 1) * QT * P, xb + (size_t)(j0 + QT) * P, P, Q - j0 - QT);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (J == 0) {
      // the carried state: exp(cum_i) C_i . h_in, h_in as hi + lo
      rows_times_rows_t<N, P / 8>(acc, sC, r0, sHh, lane);
      rows_times_rows_t<N, P / 8>(acc, sC, r0, sHl, lane);
      const float e0 = row0 < Q ? expf(cum0) : 0.f, e1 = row1 < Q ? expf(cum1) : 0.f;
#pragma unroll
      for (int n = 0; n < P / 8; ++n) {
        acc[n][0] *= e0;
        acc[n][1] *= e0;
        acc[n][2] *= e1;
        acc[n][3] *= e1;
      }
    }
    // G = CB exp(cum_i - cum_j) dt_j on j <= i < Q, else 0
    float gm[QT / 8][4];
#pragma unroll
    for (int n = 0; n < QT / 8; ++n) {
      const float v[4] = {cv[n][0].x, cv[n][0].y, cv[n][1].x, cv[n][1].y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = (e >> 1) ? row1 : row0;
        const int j = j0 + 8 * n + 2 * t + (e & 1);
        const bool ok = j <= i && i < Q;
        const int jj = ok ? j : 0;
        gm[n][e] = ok ? v[e] * expf(((e >> 1) ? cum1 : cum0) - sCum[jj]) * sDt[jj] : 0.f;
      }
    }
    regs_times_tile<P, QT / 16, P / 8>(acc, gm, sX + st * QT * P, lane);
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  cp_async_wait<0>();

  bf16* y0 = y + (bh * S + t0 + row0) * P + 2 * t;
  bf16* y1 = y0 + 8 * P;
#pragma unroll
  for (int n = 0; n < P / 8; ++n) {
    if (row0 < Q) *reinterpret_cast<uint32_t*>(y0 + 8 * n) = pack_bf16(acc[n][0], acc[n][1]);
    if (row1 < Q) *reinterpret_cast<uint32_t*>(y1 + 8 * n) = pack_bf16(acc[n][2], acc[n][3]);
  }
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

// pass 1 (float32 FMA on inputs of type T: the float32 forward, and the
// backward's recompute for both types); grid (nI * nc, B) as cb_tc_kernel.
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

// pass 2 (float32 FMA on inputs of type T); grid (nc * H, B) as
// state_tc_kernel.  Thread (ty, tx) owns rows ty * PR + a of P and columns
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

// pass 4 (float32); grid (nc * H * nI, B) as out_tc_kernel.  Thread (ty, tx)
// owns rows ty * 4 + i of the tile and columns tx + 16 m of P.
template <int P, int N>
__global__ void __launch_bounds__(F32_THREADS)
out_f32_kernel(const float* __restrict__ x, const float* __restrict__ dA,
               const float* __restrict__ dt, const float* __restrict__ Cm,
               const float* __restrict__ cb, const float* __restrict__ hin,
               float* __restrict__ y, int H, int S, int Q, int nI) {
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
  const float* xb = x + (bh * S + t0) * P;
  const float* cbb = cb + ((size_t)b * nc + c) * QP * QP;

  chunk_cum(sCum, sDt, dA + bh * S + t0, dt + bh * S + t0, Q);
  load_rows<float, N>(sC, Cm + ((size_t)b * S + t0 + i0) * N, Q - i0);
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
    load_rows<float, P>(sX, xb + (size_t)j0 * P, Q - j0);
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
    float* yrow = y + (bh * S + t0 + row) * P;
#pragma unroll
    for (int m = 0; m < PR; ++m) yrow[tx + 16 * m] = acc[i][m];
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

template <typename K>
cudaError_t set_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int P, int N>
cudaError_t launch_tc(const bf16* x, const float* dA, const float* dt, const bf16* Bm,
                      const bf16* Cm, const float* h0, bf16* y, float* h_last, float* cb,
                      float* states, bf16* hin, float* dAc, int B, int H, int S, int Q,
                      cudaStream_t stream) {
  const int nc = S / Q, nI = (Q + QT - 1) / QT;
  size_t smem = (size_t)3 * QT * N * sizeof(bf16);
  cudaError_t err = set_smem(cb_tc_kernel<N, false>, smem);
  if (err != cudaSuccess) return err;
  cb_tc_kernel<N, false><<<dim3(nI * nc, B), 128, smem, stream>>>(Bm, Cm, cb, S, Q, nI);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  smem = (size_t)(2 * P * QT + QT * N) * sizeof(bf16) + 2 * (size_t)Q * sizeof(float);
  if ((err = set_smem(state_tc_kernel<P, N>, smem)) != cudaSuccess) return err;
  state_tc_kernel<P, N><<<dim3(nc * H, B), StateShape<P, N>::THREADS, smem, stream>>>(
      x, dA, dt, Bm, states, dAc, H, S, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int per = B * H * (P * N / 4);
  const size_t lo_plane = (size_t)B * H * nc * P * N;
  pass_kernel<bf16><<<(per + 255) / 256, 256, 0, stream>>>(states, dAc, h0, hin, lo_plane, h_last,
                                                           B * H, nc, P * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  smem = (size_t)(QT * N + 2 * P * N + 2 * QT * P) * sizeof(bf16) + 2 * (size_t)Q * sizeof(float);
  if ((err = set_smem(out_tc_kernel<P, N>, smem)) != cudaSuccess) return err;
  out_tc_kernel<P, N><<<dim3(nc * H * nI, B), 128, smem, stream>>>(x, dA, dt, Cm, cb, hin, lo_plane,
                                                                   y, H, S, Q, nI);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t launch_f32(const float* x, const float* dA, const float* dt, const float* Bm,
                       const float* Cm, const float* h0, float* y, float* h_last, float* cb,
                       float* states, float* hin, float* dAc, int B, int H, int S, int Q,
                       cudaStream_t stream) {
  const int nc = S / Q, nI = (Q + QT - 1) / QT;
  size_t smem = (size_t)2 * QT * (N + 1) * sizeof(float);
  cudaError_t err = set_smem(cb_f32_kernel<float, N>, smem);
  if (err != cudaSuccess) return err;
  cb_f32_kernel<float, N><<<dim3(nI * nc, B), F32_THREADS, smem, stream>>>(Bm, Cm, cb, S, Q, nI);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  smem = ((size_t)QT * (P + 1) + (size_t)QT * (N + 1) + QT + 2 * (size_t)Q) * sizeof(float);
  if ((err = set_smem(state_f32_kernel<float, P, N>, smem)) != cudaSuccess) return err;
  state_f32_kernel<float, P, N><<<dim3(nc * H, B), F32_THREADS, smem, stream>>>(
      x, dA, dt, Bm, states, dAc, H, S, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int per = B * H * (P * N / 4);
  pass_kernel<float><<<(per + 255) / 256, 256, 0, stream>>>(states, dAc, h0, hin, 0, h_last,
                                                            B * H, nc, P * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  smem = ((size_t)QT * (N + 1) + (size_t)P * (N + 1) + (size_t)QT * (P + 1) +
          (size_t)QT * (QT + 1) + 2 * (size_t)Q) * sizeof(float);
  if ((err = set_smem(out_f32_kernel<P, N>, smem)) != cudaSuccess) return err;
  out_f32_kernel<P, N><<<dim3(nc * H * nI, B), F32_THREADS, smem, stream>>>(x, dA, dt, Cm, cb,
                                                                          hin, y, H, S, Q, nI);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t launch(const void* x, const float* dA, const float* dt, const void* Bm,
                   const void* Cm, const float* h0, void* y, float* h_last, float* cb,
                   float* states, void* hin, float* dAc, int B, int H, int S, int Q, int dtype,
                   cudaStream_t s) {
  if (dtype == 0)
    return launch_f32<P, N>(static_cast<const float*>(x), dA, dt, static_cast<const float*>(Bm),
                            static_cast<const float*>(Cm), h0, static_cast<float*>(y), h_last,
                            cb, states, static_cast<float*>(hin), dAc, B, H, S, Q, s);
  if (dtype == 1)
    return launch_tc<P, N>(static_cast<const bf16*>(x), dA, dt, static_cast<const bf16*>(Bm),
                           static_cast<const bf16*>(Cm), h0, static_cast<bf16*>(y), h_last, cb,
                           states, static_cast<bf16*>(hin), dAc, B, H, S, Q, s);
  return cudaErrorInvalidValue;
}

// ===========================================================================
// backward: the tensor cores for bf16 at (P, N) = (64, 128), float32 FMA
// for float32 and for bf16 at the smoke widths (16, 16)
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
// backward in time with B and C exchanged.
//
// What bounds it: at Mamba-2 780M's widths (H = 48, chunk 256) and S = 4096
// the function reads x, dy (bf16), B, C, dA, dt and writes dx, dB, dC, ddA,
// ddt, some 88 MB, and needs some 36 GFLOP: 0.036 ms at the bf16
// tensor-core rate against 0.026 ms for the bytes, so operations bound it.
//
// bf16 at (64, 128), the tensor-core route (`launch_bwd_tc`), ten launches:
//
// 1-3. C.B^T of each chunk in full (`cb_tc_kernel<N, true>`: the tiles
//      t <= s that rows s read and the tiles s >= t that rows t read, both
//      row-major), the chunk states (`state_tc_kernel`) and the carry
//      (`pass_kernel<bf16>`): h_in as hi and lo bf16 planes, as the
//      forward leaves it;
// 4-5. each chunk's dual state sum_i exp(cum_i) dy_i^T C_i
//      (`state_tc_kernel<DUAL>`: dy for x, C for B), and `rpass_kernel`,
//      g carried backward across the chunks, stored as hi and lo planes;
//      dh0;
// 6.   `dx_tc_kernel`, one block per (batch, chunk, head, 64-row tile t),
//      the forward's output pass run backward: z from g B_t, then T dy_J
//      over the tiles J >= t; dx, ddt, m2;
// 7.   `db_tc_kernel`, one block per (batch, chunk, group of HEAD_GROUP
//      heads, tile t): x_t^T g of each head, then for each tile J >= t the
//      group's D^T summed over its heads in order, in registers, before
//      one product with C_J; colsum M of each head; the group's dB;
// 8.   `dc_tc_kernel`, the same for the rows s over the tiles J <= s: dy_s^T
//      h_in of each head, the group's D summed before one product with B_J;
//      rowsum M + m1 of each head; the group's dC;
// 9.   `dda_kernel`: m3 and the two scans of ddA;
// 10.  `head_sum_kernel`: the groups' dB and dC summed in order.
//
// Every product runs on `mma.sync.m16n8k16` (float32 accumulators) from the
// forward's swizzled bf16 tiles, fed by `cp.async` with the next tile in
// flight.  x, dy, B and C enter as the bf16 they are; the operands formed
// in float32 (T = C.B^T exp(cum_s - cum_t), the summed D, x w and dy
// exp(cum) of the states, g and h_in) enter as hi + lo bf16 in two
// products, so the gradients keep the float32 algebra's accuracy (about
// 2^-17 relative a term).  Masked before exp, as the forward.  The row sums
// ddA needs (colsum, rowsum, m1, m2) stay float32: each thread sums its
// columns in order, then its quad in a fixed order.  No atomics: every
// block owns its outputs and the groups are summed in a fixed order, so
// two calls give the same bits.
//
// Summing D over a group before the product with C or B cuts that product,
// the largest, by the group's size, and loads the group's B and C tiles
// once; each group block writes one float32 partial [B, H / G, S, N] of dB
// and of dC instead of one a head.  HEAD_GROUP = 4: at H = 48, chunk 256
// and S = 4096 it leaves 768 group blocks (12 groups x 16 chunks x 4 tiles)
// for 132 SMs at two blocks an SM (88 and 104 KB of shared memory), some
// three waves, where 8 would leave under one and a half with an uneven
// tail; and four heads are the block's four warps when the block takes
// their cumsums, one a warp.  dx keeps one head a block (3,072 blocks),
// since its z is a head's own.
//
// What it still leaves: hi + lo doubles the tensor-core work of every
// product with an operand formed in float32; the products are `mma.sync`
// from shared memory through `ldmatrix`, not `wgmma`; the blocks of a group
// are 4 warps of 16 rows, two to an SM, with no warp specialisation.
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

constexpr int HEAD_GROUP = 4;   // heads a tensor-core row-tile block sums dB, dC over

template <typename T>
__device__ __forceinline__ T to_t(float v);
template <>
__device__ __forceinline__ float to_t<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 to_t<bf16>(float v) { return __float2bfloat16(v); }

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

// A stored state: float32 as it is; bf16 as hi at p and lo at p + lo_plane.
__device__ __forceinline__ float load_h(const float* p, size_t, size_t i) { return p[i]; }
__device__ __forceinline__ float load_h(const bf16* p, size_t lo_plane, size_t i) {
  return __bfloat162float(p[i]) + __bfloat162float(p[i + lo_plane]);
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
// the tensor-core route's row tiles (bf16, passes 6-8): 4 warps of 16 rows
// of a 64-row tile, each thread holding rows r0 + g and r0 + g + 8 of its
// warp's m16n8 accumulators.
// ---------------------------------------------------------------------------

// Elements (col, col + 1) of row r of a [rows][W] bf16 tile, col even.
template <int W>
__device__ __forceinline__ float2 tile_pair(const bf16* s, int r, int col) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(s + swz<W>(r, col >> 3) + (col & 7)));
}

// This thread's part of row r of the [rows][W] tile `s` dotted with its
// accumulators a[n][2 half], a[n][2 half + 1] (the tile's columns 8 n + 2 t
// and the next); the quad's four parts make the whole dot.
template <int W, int NT>
__device__ __forceinline__ float row_dot(const bf16* s, int r, const float (&a)[NT][4], int half,
                                         int t) {
  float part = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 v = tile_pair<W>(s, r, 8 * n + 2 * t);
    part = fmaf(v.x, a[n][2 * half], part);
    part = fmaf(v.y, a[n][2 * half + 1], part);
  }
  return part;
}

// The chunk's cum and dt of `ng` heads, `stride` floats apart in dA and dt,
// into sCum[k Q + i] and sDt[k Q + i]; one warp takes a head's cumsum, as
// `chunk_cum` does, so every pass agrees on it bit for bit.  Ends with a
// barrier.
__device__ __forceinline__ void group_cum(float* sCum, float* sDt, const float* dA,
                                          const float* dt, size_t stride, int Q, int ng) {
  for (int idx = threadIdx.x; idx < ng * Q; idx += blockDim.x) {
    const int k = idx / Q, i = idx % Q;
    sCum[idx] = dA[k * stride + i];
    sDt[idx] = dt[k * stride + i];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp < ng) warp_cumsum(sCum + warp * Q, Q, threadIdx.x & 31);
  __syncthreads();
}

// c = A S for a warp's 16 rows and the 32 columns [n0, n0 + 32) of a [P][N]
// float32 state S given as its hi and lo bf16 tiles (two products), A in
// the fragments a[kk] of its depth steps.
template <int P, int N>
__device__ __forceinline__ void frags_times_state(float (&c)[4][4], const uint32_t (&a)[P / 16][4],
                                                  const bf16* sh, const bf16* sl, int n0,
                                                  int lane) {
  zero(c);
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk)
#pragma unroll
    for (int n = 0; n < 4; n += 2) {
      uint32_t bq[4];
      bt_frag<N>(sh, n0 + n * 8, kk, lane, bq);
      mma(c[n], a[kk], bq[0], bq[1]);
      mma(c[n + 1], a[kk], bq[2], bq[3]);
      bt_frag<N>(sl, n0 + n * 8, kk, lane, bq);
      mma(c[n], a[kk], bq[0], bq[1]);
      mma(c[n + 1], a[kk], bq[2], bq[3]);
    }
}

// Shared memory of the three kernels (bf16 tiles, then float32 cum and dt).
// A group block's first phase (a head's g or h_in, hi and lo [P][N]) and its
// tile loop (rings of two [QT][N] and two [QT][P] tiles) share one region.
template <int P, int N>
struct BwdSmem {
  static constexpr int G = HEAD_GROUP;
  static constexpr int REGION = 2 * P * N > 2 * QT * (N + P) ? 2 * P * N : 2 * QT * (N + P);
  static constexpr size_t dx(int Q) {
    return (size_t)(QT * N + 2 * P * N + 3 * QT * P) * sizeof(bf16) + 2 * (size_t)Q * sizeof(float);
  }
  static constexpr size_t db(int Q) {
    return (size_t)(G * QT * P + REGION) * sizeof(bf16) + 2 * (size_t)G * Q * sizeof(float);
  }
  static constexpr size_t dc(int Q) {
    return (size_t)(G * QT * P + QT * N + REGION) * sizeof(bf16) +
           2 * (size_t)G * Q * sizeof(float);
  }
};

// pass 6 (bf16): dx, ddt and m2 of the rows t of tile I of a (batch, chunk,
// head): z = exp(cum_Q - cum_t) g B_t (g as hi + lo), then z += T_IJ dy_J
// for J >= I with T[t, s] = (C_s . B_t) exp(cum_s - cum_t) on s >= t, from
// pass 1's tiles s >= t, entering as hi + lo; dy_J in a ring of two.
// grid (nc * H * nI, B); block x = (c * H + h) * nI + I (the most tiles first).
template <int P, int N>
__global__ void __launch_bounds__(128)
dx_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dA,
             const float* __restrict__ dt, const bf16* __restrict__ Bm,
             const bf16* __restrict__ dy, const float* __restrict__ cb,
             const bf16* __restrict__ gend, size_t lo_plane, bf16* __restrict__ dx,
             float* __restrict__ ddt, float* __restrict__ m2, int H, int S, int Q, int nI) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sB = reinterpret_cast<bf16*>(smem_raw);   // [QT][N]: B of the rows t
  bf16* sGh = sB + QT * N;                        // [P][N]: g, hi
  bf16* sGl = sGh + P * N;                        // [P][N]: g, lo
  bf16* sX = sGl + P * N;                         // [QT][P]: x of the rows t
  bf16* sDy = sX + QT * P;                        // [2][QT][P]: dy of the rows s
  float* sCum = reinterpret_cast<float*>(sDy + 2 * QT * P);  // [Q]
  float* sDt = sCum + Q;                          // [Q]

  const int nc = S / Q, QP = nI * QT;
  const int I = blockIdx.x % nI;
  const int h = (blockIdx.x / nI) % H, c = blockIdx.x / (nI * H), b = blockIdx.y;
  const size_t bh = (size_t)b * H + h;
  const size_t t0 = (size_t)c * Q;
  const int i0 = I * QT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const bf16* dyb = dy + (bh * S + t0) * P;
  const size_t gofs = (bh * nc + c) * P * N;

  load_tile<QT, N>(sB, Bm + ((size_t)b * S + t0 + i0) * N, N, Q - i0);
  load_tile<P, N>(sGh, gend + gofs, N, P);
  load_tile<P, N>(sGl, gend + lo_plane + gofs, N, P);
  load_tile<QT, P>(sX, x + (bh * S + t0 + i0) * P, P, Q - i0);
  load_tile<QT, P>(sDy, dyb + (size_t)i0 * P, P, Q - i0);
  cp_async_commit();
  chunk_cum(sCum, sDt, dA + bh * S + t0, dt + bh * S + t0, Q);
  cp_async_wait<0>();
  __syncthreads();

  const int row0 = r0 + g, row1 = row0 + 8;           // in the tile
  const int ta = i0 + row0, tb = i0 + row1;           // in the chunk
  const float cum0 = sCum[min(ta, Q - 1)], cum1 = sCum[min(tb, Q - 1)];
  const float dt0 = ta < Q ? sDt[ta] : 0.f, dt1 = tb < Q ? sDt[tb] : 0.f;
  const float cum_last = sCum[Q - 1];
  float z[P / 8][4];
  zero(z);
  rows_times_rows_t<N, P / 8>(z, sB, r0, sGh, lane);
  rows_times_rows_t<N, P / 8>(z, sB, r0, sGl, lane);
  const float e0 = ta < Q ? expf(cum_last - cum0) : 0.f, e1 = tb < Q ? expf(cum_last - cum1) : 0.f;
#pragma unroll
  for (int n = 0; n < P / 8; ++n) {
    z[n][0] *= e0;
    z[n][1] *= e0;
    z[n][2] *= e1;
    z[n][3] *= e1;
  }
  const float m2a = dt0 * quad_sum(row_dot<P>(sX, row0, z, 0, t));
  const float m2b = dt1 * quad_sum(row_dot<P>(sX, row1, z, 1, t));

  const float* cr0 = cb + ((size_t)b * nc + c) * QP * QP + (size_t)ta * QP + 2 * t;
  const float* cr1 = cr0 + 8 * QP;
  for (int J = I; J < nI; ++J) {
    const int st = (J - I) & 1, j0 = J * QT;
    // this tile's C.B^T, loaded before the wait so the two overlap
    float2 cv[QT / 8][2];
#pragma unroll
    for (int n = 0; n < QT / 8; ++n) {
      cv[n][0] = *reinterpret_cast<const float2*>(cr0 + j0 + 8 * n);
      cv[n][1] = *reinterpret_cast<const float2*>(cr1 + j0 + 8 * n);
    }
    if (J + 1 < nI)
      load_tile<QT, P>(sDy + (st ^ 1) * QT * P, dyb + (size_t)(j0 + QT) * P, P, Q - j0 - QT);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // T = C.B^T exp(cum_s - cum_t) on t <= s < Q, else 0
    float tm[QT / 8][4];
#pragma unroll
    for (int n = 0; n < QT / 8; ++n) {
      const float v[4] = {cv[n][0].x, cv[n][0].y, cv[n][1].x, cv[n][1].y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = (e >> 1) ? tb : ta;
        const int j = j0 + 8 * n + 2 * t + (e & 1);
        const bool ok = j >= i && j < Q;
        tm[n][e] = ok ? v[e] * expf(sCum[ok ? j : 0] - ((e >> 1) ? cum1 : cum0)) : 0.f;
      }
    }
    regs_times_tile<P, QT / 16, P / 8>(z, tm, sDy + st * QT * P, lane);
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  cp_async_wait<0>();

  const float dda = quad_sum(row_dot<P>(sX, row0, z, 0, t));
  const float ddb = quad_sum(row_dot<P>(sX, row1, z, 1, t));
  bf16* d0 = dx + (bh * S + t0 + ta) * P + 2 * t;
  bf16* d1 = d0 + 8 * P;
#pragma unroll
  for (int n = 0; n < P / 8; ++n) {
    if (ta < Q) *reinterpret_cast<uint32_t*>(d0 + 8 * n) = pack_bf16(dt0 * z[n][0], dt0 * z[n][1]);
    if (tb < Q) *reinterpret_cast<uint32_t*>(d1 + 8 * n) = pack_bf16(dt1 * z[n][2], dt1 * z[n][3]);
  }
  if (t == 0) {
    if (ta < Q) {
      ddt[bh * S + t0 + ta] = dda;
      m2[bh * S + t0 + ta] = m2a;
    }
    if (tb < Q) {
      ddt[bh * S + t0 + tb] = ddb;
      m2[bh * S + t0 + tb] = m2b;
    }
  }
}

// pass 7 (bf16): the group's dB and each head's colsum M for the rows t of
// tile I of a (batch, chunk, group of HEAD_GROUP heads).  First each head's
// dt_t exp(cum_Q - cum_t) x_t^T g (g as hi + lo), then for each tile J >= I
// and each head in order D^T[t, s] = (x_t . dy_s) exp(cum_s - cum_t) dt_t,
// summed over the heads in float32 before one product with C_J (hi + lo).
// dy of each (J, head) in a ring of two, C_J in another.
// grid (nc * HG * nI, B), HG = ceil(H / HEAD_GROUP); block x = (c * HG +
// group) * nI + I (the most tiles first).
template <int P, int N>
__global__ void __launch_bounds__(128)
db_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dA,
             const float* __restrict__ dt, const bf16* __restrict__ Cm,
             const bf16* __restrict__ dy, const float* __restrict__ cb,
             const bf16* __restrict__ gend, size_t lo_plane, float* __restrict__ dBp,
             float* __restrict__ colsum, int H, int S, int Q, int nI) {
  constexpr int G = HEAD_GROUP;
  using L = BwdSmem<P, N>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sX = reinterpret_cast<bf16*>(smem_raw);   // [G][QT][P]: x of the rows t, each head
  bf16* sR = sX + G * QT * P;
  bf16* sGh = sR;                                 // first phase: [P][N], g hi
  bf16* sGl = sR + P * N;                         //              [P][N], g lo
  bf16* sC = sR;                                  // tile loop: [2][QT][N], C of the rows s
  bf16* sDy = sR + 2 * QT * N;                    //            [2][QT][P], dy of the rows s
  float* sCum = reinterpret_cast<float*>(sR + L::REGION);  // [G][Q]
  float* sDt = sCum + G * Q;                      // [G][Q]

  const int nc = S / Q, QP = nI * QT, HG = (H + G - 1) / G;
  const int I = blockIdx.x % nI;
  const int hg = (blockIdx.x / nI) % HG, c = blockIdx.x / (nI * HG), b = blockIdx.y;
  const int ng = min(G, H - hg * G);
  const size_t bh0 = (size_t)b * H + hg * G;
  const size_t t0 = (size_t)c * Q;
  const int i0 = I * QT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int ta = i0 + r0 + g, tb = ta + 8;         // this thread's rows in the chunk

#pragma unroll
  for (int k = 0; k < G; ++k)
    if (k < ng) load_tile<QT, P>(sX + k * QT * P, x + ((bh0 + k) * S + t0 + i0) * P, P, Q - i0);
  cp_async_commit();
  group_cum(sCum, sDt, dA + bh0 * S + t0, dt + bh0 * S + t0, S, Q, ng);

  float acc[N / 8][4];
  zero(acc);
  // dt_t exp(cum_Q - cum_t) x_t^T g of each head, 32 columns at a time
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (k >= ng) continue;
    __syncthreads();  // the previous head's readers of g are done
    const size_t gofs = ((bh0 + k) * nc + c) * P * N;
    load_tile<P, N>(sGh, gend + gofs, N, P);
    load_tile<P, N>(sGl, gend + lo_plane + gofs, N, P);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float* cum = sCum + k * Q;
    const float* dtk = sDt + k * Q;
    const float wa = ta < Q ? dtk[ta] * expf(cum[Q - 1] - cum[ta]) : 0.f;
    const float wb = tb < Q ? dtk[tb] * expf(cum[Q - 1] - cum[tb]) : 0.f;
    uint32_t ax[P / 16][4];
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) a_frag<P>(sX + k * QT * P, r0, kk, lane, ax[kk]);
#pragma unroll
    for (int nb = 0; nb < N / 32; ++nb) {
      float tmp[4][4];
      frags_times_state<P, N>(tmp, ax, sGh, sGl, nb * 32, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        acc[nb * 4 + n][0] = fmaf(wa, tmp[n][0], acc[nb * 4 + n][0]);
        acc[nb * 4 + n][1] = fmaf(wa, tmp[n][1], acc[nb * 4 + n][1]);
        acc[nb * 4 + n][2] = fmaf(wb, tmp[n][2], acc[nb * 4 + n][2]);
        acc[nb * 4 + n][3] = fmaf(wb, tmp[n][3], acc[nb * 4 + n][3]);
      }
    }
  }

  __syncthreads();  // the readers of g are done: the rings take its region
  load_tile<QT, N>(sC, Cm + ((size_t)b * S + t0 + i0) * N, N, Q - i0);
  load_tile<QT, P>(sDy, dy + (bh0 * S + t0 + i0) * P, P, Q - i0);
  cp_async_commit();
  float cs[G][2];
#pragma unroll
  for (int k = 0; k < G; ++k) cs[k][0] = cs[k][1] = 0.f;
  const float* cr0 = cb + ((size_t)b * nc + c) * QP * QP + (size_t)ta * QP + 2 * t;
  const float* cr1 = cr0 + 8 * QP;
  int step = 0;
  for (int J = I; J < nI; ++J) {
    const int j0 = J * QT, cst = (J - I) & 1;
    float2 cv[QT / 8][2];
#pragma unroll
    for (int n = 0; n < QT / 8; ++n) {
      cv[n][0] = *reinterpret_cast<const float2*>(cr0 + j0 + 8 * n);
      cv[n][1] = *reinterpret_cast<const float2*>(cr1 + j0 + 8 * n);
    }
    float ub[QT / 8][4];
    zero(ub);
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (k >= ng) continue;
      const int st = step & 1;
      if (k + 1 < ng) {
        load_tile<QT, P>(sDy + (st ^ 1) * QT * P, dy + ((bh0 + k + 1) * S + t0 + j0) * P, P,
                         Q - j0);
      } else if (J + 1 < nI) {
        load_tile<QT, P>(sDy + (st ^ 1) * QT * P, dy + (bh0 * S + t0 + j0 + QT) * P, P,
                         Q - j0 - QT);
        load_tile<QT, N>(sC + (cst ^ 1) * QT * N, Cm + ((size_t)b * S + t0 + j0 + QT) * N, N,
                         Q - j0 - QT);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      float raw[QT / 8][4];
      zero(raw);
      rows_times_rows_t<P, QT / 8>(raw, sX + k * QT * P, r0, sDy + st * QT * P, lane);
      const float* cum = sCum + k * Q;
      const float* dtk = sDt + k * Q;
      const float ca = cum[min(ta, Q - 1)], cbv = cum[min(tb, Q - 1)];
      const float da = ta < Q ? dtk[ta] : 0.f, db = tb < Q ? dtk[tb] : 0.f;
#pragma unroll
      for (int n = 0; n < QT / 8; ++n) {
        const float v[4] = {cv[n][0].x, cv[n][0].y, cv[n][1].x, cv[n][1].y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (e >> 1) ? tb : ta;
          const int j = j0 + 8 * n + 2 * t + (e & 1);
          const bool ok = j >= i && j < Q;
          const float u = ok ? raw[n][e] * expf(cum[ok ? j : 0] - ((e >> 1) ? cbv : ca)) *
                                   ((e >> 1) ? db : da)
                             : 0.f;
          cs[k][e >> 1] = fmaf(u, v[e], cs[k][e >> 1]);
          ub[n][e] += u;
        }
      }
      __syncthreads();  // every warp is done with dy stage st before it is refilled
      ++step;
    }
    regs_times_tile<N, QT / 16, N / 8>(acc, ub, sC + cst * QT * N, lane);
    __syncthreads();  // every warp is done with C stage cst before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int k = 0; k < G; ++k) {
    const float a = quad_sum(cs[k][0]), bsum = quad_sum(cs[k][1]);
    if (k < ng && t == 0) {
      if (ta < Q) colsum[(bh0 + k) * S + t0 + ta] = a;
      if (tb < Q) colsum[(bh0 + k) * S + t0 + tb] = bsum;
    }
  }
  float* o0 = dBp + (((size_t)b * HG + hg) * S + t0 + ta) * N + 2 * t;
  float* o1 = o0 + 8 * N;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    if (ta < Q) *reinterpret_cast<float2*>(o0 + 8 * n) = make_float2(acc[n][0], acc[n][1]);
    if (tb < Q) *reinterpret_cast<float2*>(o1 + 8 * n) = make_float2(acc[n][2], acc[n][3]);
  }
}

// pass 8 (bf16): the group's dC and each head's rowsum M + m1 for the rows
// s of tile I of a (batch, chunk, group of heads).  First each head's
// exp(cum_s) dy_s^T h_in (h_in as hi + lo) and m1_s = C_s . that, then for
// each tile J <= I and each head in order D[s, t] = (dy_s . x_t) exp(cum_s -
// cum_t) dt_t, summed over the heads in float32 before one product with B_J
// (hi + lo).  x of each (J, head) in a ring of two, B_J in another.
// grid (nc * HG * nI, B); block x = (c * HG + group) * nI + (nI - 1 - I)
// (the most tiles first).
template <int P, int N>
__global__ void __launch_bounds__(128)
dc_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dA,
             const float* __restrict__ dt, const bf16* __restrict__ Bm,
             const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
             const float* __restrict__ cb, const bf16* __restrict__ hin, size_t lo_plane,
             float* __restrict__ dCp, float* __restrict__ rowm1, int H, int S, int Q, int nI) {
  constexpr int G = HEAD_GROUP;
  using L = BwdSmem<P, N>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sDy = reinterpret_cast<bf16*>(smem_raw);  // [G][QT][P]: dy of the rows s, each head
  bf16* sC = sDy + G * QT * P;                    // [QT][N]: C of the rows s
  bf16* sR = sC + QT * N;
  bf16* sHh = sR;                                 // first phase: [P][N], h_in hi
  bf16* sHl = sR + P * N;                         //              [P][N], h_in lo
  bf16* sB = sR;                                  // tile loop: [2][QT][N], B of the rows t
  bf16* sX = sR + 2 * QT * N;                     //            [2][QT][P], x of the rows t
  float* sCum = reinterpret_cast<float*>(sR + L::REGION);  // [G][Q]
  float* sDt = sCum + G * Q;                      // [G][Q]

  const int nc = S / Q, QP = nI * QT, HG = (H + G - 1) / G;
  const int I = nI - 1 - (int)(blockIdx.x % nI);
  const int hg = (blockIdx.x / nI) % HG, c = blockIdx.x / (nI * HG), b = blockIdx.y;
  const int ng = min(G, H - hg * G);
  const size_t bh0 = (size_t)b * H + hg * G;
  const size_t t0 = (size_t)c * Q;
  const int i0 = I * QT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int row0 = r0 + g, row1 = row0 + 8;         // in the tile
  const int sa = i0 + row0, sb = i0 + row1;         // in the chunk

#pragma unroll
  for (int k = 0; k < G; ++k)
    if (k < ng) load_tile<QT, P>(sDy + k * QT * P, dy + ((bh0 + k) * S + t0 + i0) * P, P, Q - i0);
  load_tile<QT, N>(sC, Cm + ((size_t)b * S + t0 + i0) * N, N, Q - i0);
  cp_async_commit();
  group_cum(sCum, sDt, dA + bh0 * S + t0, dt + bh0 * S + t0, S, Q, ng);

  float acc[N / 8][4];
  zero(acc);
  float rs[G][2], m1[G][2];
#pragma unroll
  for (int k = 0; k < G; ++k) rs[k][0] = rs[k][1] = m1[k][0] = m1[k][1] = 0.f;
  // exp(cum_s) dy_s^T h_in of each head and m1_s, 32 columns at a time
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (k >= ng) continue;
    __syncthreads();  // the previous head's readers of h_in are done
    const size_t hofs = ((bh0 + k) * nc + c) * P * N;
    load_tile<P, N>(sHh, hin + hofs, N, P);
    load_tile<P, N>(sHl, hin + lo_plane + hofs, N, P);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float* cum = sCum + k * Q;
    const float ea = sa < Q ? expf(cum[sa]) : 0.f, eb = sb < Q ? expf(cum[sb]) : 0.f;
    uint32_t ay[P / 16][4];
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) a_frag<P>(sDy + k * QT * P, r0, kk, lane, ay[kk]);
#pragma unroll
    for (int nb = 0; nb < N / 32; ++nb) {
      float tmp[4][4];
      frags_times_state<P, N>(tmp, ay, sHh, sHl, nb * 32, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = nb * 32 + n * 8 + 2 * t;
        const float2 ca = tile_pair<N>(sC, row0, col), cbb = tile_pair<N>(sC, row1, col);
        const float v[4] = {ea * tmp[n][0], ea * tmp[n][1], eb * tmp[n][2], eb * tmp[n][3]};
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb * 4 + n][e] += v[e];
        m1[k][0] = fmaf(v[1], ca.y, fmaf(v[0], ca.x, m1[k][0]));
        m1[k][1] = fmaf(v[3], cbb.y, fmaf(v[2], cbb.x, m1[k][1]));
      }
    }
  }

  __syncthreads();  // the readers of h_in are done: the rings take its region
  load_tile<QT, N>(sB, Bm + ((size_t)b * S + t0) * N, N, Q);
  load_tile<QT, P>(sX, x + (bh0 * S + t0) * P, P, Q);
  cp_async_commit();
  const float* cr0 = cb + ((size_t)b * nc + c) * QP * QP + (size_t)sa * QP + 2 * t;
  const float* cr1 = cr0 + 8 * QP;
  int step = 0;
  for (int J = 0; J <= I; ++J) {
    const int j0 = J * QT, cst = J & 1;
    float2 cv[QT / 8][2];
#pragma unroll
    for (int n = 0; n < QT / 8; ++n) {
      cv[n][0] = *reinterpret_cast<const float2*>(cr0 + j0 + 8 * n);
      cv[n][1] = *reinterpret_cast<const float2*>(cr1 + j0 + 8 * n);
    }
    float dbar[QT / 8][4];
    zero(dbar);
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (k >= ng) continue;
      const int st = step & 1;
      if (k + 1 < ng) {
        load_tile<QT, P>(sX + (st ^ 1) * QT * P, x + ((bh0 + k + 1) * S + t0 + j0) * P, P,
                         Q - j0);
      } else if (J < I) {
        load_tile<QT, P>(sX + (st ^ 1) * QT * P, x + (bh0 * S + t0 + j0 + QT) * P, P,
                         Q - j0 - QT);
        load_tile<QT, N>(sB + (cst ^ 1) * QT * N, Bm + ((size_t)b * S + t0 + j0 + QT) * N, N,
                         Q - j0 - QT);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      float raw[QT / 8][4];
      zero(raw);
      rows_times_rows_t<P, QT / 8>(raw, sDy + k * QT * P, r0, sX + st * QT * P, lane);
      const float* cum = sCum + k * Q;
      const float* dtk = sDt + k * Q;
      const float ca = cum[min(sa, Q - 1)], cbv = cum[min(sb, Q - 1)];
#pragma unroll
      for (int n = 0; n < QT / 8; ++n) {
        const float v[4] = {cv[n][0].x, cv[n][0].y, cv[n][1].x, cv[n][1].y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (e >> 1) ? sb : sa;
          const int j = j0 + 8 * n + 2 * t + (e & 1);
          const bool ok = j <= i && i < Q;
          const int jj = ok ? j : 0;
          const float d = ok ? raw[n][e] * expf(((e >> 1) ? cbv : ca) - cum[jj]) * dtk[jj] : 0.f;
          rs[k][e >> 1] = fmaf(d, v[e], rs[k][e >> 1]);
          dbar[n][e] += d;
        }
      }
      __syncthreads();  // every warp is done with x stage st before it is refilled
      ++step;
    }
    regs_times_tile<N, QT / 16, N / 8>(acc, dbar, sB + cst * QT * N, lane);
    __syncthreads();  // every warp is done with B stage cst before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int k = 0; k < G; ++k) {
    const float a = quad_sum(rs[k][0]) + quad_sum(m1[k][0]);
    const float bsum = quad_sum(rs[k][1]) + quad_sum(m1[k][1]);
    if (k < ng && t == 0) {
      if (sa < Q) rowm1[(bh0 + k) * S + t0 + sa] = a;
      if (sb < Q) rowm1[(bh0 + k) * S + t0 + sb] = bsum;
    }
  }
  float* o0 = dCp + (((size_t)b * HG + hg) * S + t0 + sa) * N + 2 * t;
  float* o1 = o0 + 8 * N;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    if (sa < Q) *reinterpret_cast<float2*>(o0 + 8 * n) = make_float2(acc[n][0], acc[n][1]);
    if (sb < Q) *reinterpret_cast<float2*>(o1 + 8 * n) = make_float2(acc[n][2], acc[n][3]);
  }
}

// pass 8 of the FMA route, 9 of the tensor-core route: ddA of a (batch,
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
  float part = 0.f;
  for (int idx = threadIdx.x; idx < P * N; idx += blockDim.x)
    part = fmaf(load_h(gend, lo_plane, ofs + idx), load_h(hin, lo_plane, ofs + idx), part);
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

// The tensor-core route: bf16 at (P, N) = (64, 128).  hin and gend hold two
// bf16 planes each (hi, then lo `lo_plane` elements on) in the float32
// scratch the caller sizes for one float32 plane; dBp and dCp hold
// ceil(H / HEAD_GROUP) partials.
template <int P, int N>
cudaError_t launch_bwd_tc(const bf16* x, const float* dA, const float* dt, const bf16* Bm,
                          const bf16* Cm, const float* h0, const bf16* dy, const float* dh_last,
                          bf16* dx, float* ddA, float* ddt, bf16* dB, bf16* dC, float* dh0,
                          float* cb, float* states, bf16* hin, bf16* gend, float* dAc,
                          float* h_last, float* dBp, float* dCp, float* colsum, float* rowm1,
                          float* m2, int B, int H, int S, int Q, cudaStream_t stream) {
  using L = BwdSmem<P, N>;
  const int nc = S / Q, nI = (Q + QT - 1) / QT, HG = (H + HEAD_GROUP - 1) / HEAD_GROUP;
  const int per = B * H * (P * N / 4);
  const size_t lo_plane = (size_t)B * H * nc * P * N;
  // 1-3: C.B^T in full, the chunk states and the carry, h_in as hi + lo
  size_t smem = (size_t)3 * QT * N * sizeof(bf16);
  cudaError_t err = set_smem(cb_tc_kernel<N, true>, smem);
  if (err != cudaSuccess) return err;
  cb_tc_kernel<N, true><<<dim3(nI * nc, B), 128, smem, stream>>>(Bm, Cm, cb, S, Q, nI);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  smem = (size_t)(2 * P * QT + QT * N) * sizeof(bf16) + 2 * (size_t)Q * sizeof(float);
  if ((err = set_smem(state_tc_kernel<P, N>, smem)) != cudaSuccess) return err;
  state_tc_kernel<P, N><<<dim3(nc * H, B), StateShape<P, N>::THREADS, smem, stream>>>(
      x, dA, dt, Bm, states, dAc, H, S, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  pass_kernel<bf16><<<(per + 255) / 256, 256, 0, stream>>>(states, dAc, h0, hin, lo_plane, h_last,
                                                           B * H, nc, P * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 4-5: the dual states (into `states`, no longer needed) and g as hi + lo
  if ((err = set_smem(state_tc_kernel<P, N, true>, smem)) != cudaSuccess) return err;
  state_tc_kernel<P, N, true><<<dim3(nc * H, B), StateShape<P, N>::THREADS, smem, stream>>>(
      dy, dA, dt, Cm, states, nullptr, H, S, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rpass_kernel<bf16><<<(per + 255) / 256, 256, 0, stream>>>(states, dAc, dh_last, gend, lo_plane,
                                                            dh0, B * H, nc, P * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 6-8: the row tiles
  smem = L::dx(Q);
  if ((err = set_smem(dx_tc_kernel<P, N>, smem)) != cudaSuccess) return err;
  dx_tc_kernel<P, N><<<dim3(nc * H * nI, B), 128, smem, stream>>>(
      x, dA, dt, Bm, dy, cb, gend, lo_plane, dx, ddt, m2, H, S, Q, nI);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  smem = L::db(Q);
  if ((err = set_smem(db_tc_kernel<P, N>, smem)) != cudaSuccess) return err;
  db_tc_kernel<P, N><<<dim3(nc * HG * nI, B), 128, smem, stream>>>(
      x, dA, dt, Cm, dy, cb, gend, lo_plane, dBp, colsum, H, S, Q, nI);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  smem = L::dc(Q);
  if ((err = set_smem(dc_tc_kernel<P, N>, smem)) != cudaSuccess) return err;
  dc_tc_kernel<P, N><<<dim3(nc * HG * nI, B), 128, smem, stream>>>(
      x, dA, dt, Bm, Cm, dy, cb, hin, lo_plane, dCp, rowm1, H, S, Q, nI);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 9-10: ddA; dB and dC over the groups
  dda_kernel<P, N, bf16><<<dim3(nc * H, B), 256, 0, stream>>>(gend, hin, lo_plane, dAc, rowm1,
                                                              colsum, m2, ddA, H, S, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t SN = (size_t)S * N, total = (size_t)B * SN;
  head_sum_kernel<bf16><<<dim3((unsigned)((total + 255) / 256), 2), 256, 0, stream>>>(
      dBp, dCp, dB, dC, HG, SN, total);
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
    return launch_bwd_tc<P, N>(
        static_cast<const bf16*>(x), dA, dt, static_cast<const bf16*>(Bm),
        static_cast<const bf16*>(Cm), h0, static_cast<const bf16*>(dy), dh_last,
        static_cast<bf16*>(dx), ddA, ddt, static_cast<bf16*>(dB), static_cast<bf16*>(dC), dh0,
        cb, states, reinterpret_cast<bf16*>(hin), reinterpret_cast<bf16*>(gend), dAc, h_last,
        dBp, dCp, colsum, rowm1, m2, B, H, S, Q, s);
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
// Scratch, allocated by the caller: cb float32 [B, S / Q, QP, QP] with QP =
// Q rounded up to 64; states float32 [B, H, S / Q, P, N]; hin the same,
// float32 for float32 inputs and two bf16 planes (hi, lo) for bf16 inputs;
// dAc float32 [B, H, S / Q].  The wrapper checks all of it.
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
// Scratch, float32, allocated by the caller: cb [B, S / Q, QP, QP]; states,
// hin and gend [B, H, S / Q, P, N] (on the tensor-core route, bf16 at (64,
// 128), hin and gend each hold two bf16 planes there); dAc [B, H, S / Q];
// h_last [B, H, P, N]; dBp and dCp [B, planes, S, N] with planes = ceil(H /
// HEAD_GROUP) on the tensor-core route and H on the FMA route; colsum,
// rowm1 and m2 [B, H, S].
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
