// Mamba-2 SSD chunk scan (state-space duality), forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_call` (`_ssd_kernel`) of
// src/repro/kernels/ssd/kernel.py.  Per head, with the state h [P, N]:
//
//   cum_t  = cumsum(dA_t) within the chunk                  (log decay, <= 0)
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//            + exp(cum_i) C_i . h                           (carried state)
//   h'     = exp(cum_Q) h + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T
//
// Layout (all contiguous): x, y [B, H, S, P]; dA, dt [B, H, S] float32;
// B, C [B, S, N] (one group, shared by the heads) in x's type; h0, h_last
// [B, H, P, N] float32.  Sums are float32 whatever the input type.
//
// What bounds it: at Mamba-2 780M's widths (H = 48, P = 64, N = 128, chunk
// Q = 256) and S = 32768 the function moves about 432 MB (x and y in bf16,
// B, C, dA, dt) and needs about 80 GFLOP (the causal half of the chunk
// term, the carried-state term and the state update; C.B^T once per chunk),
// so memory bounds it on this card: 0.13 ms at 3.35 TB/s.  This first
// version is simple and exact instead of fast:
//
// - One block per (batch, head) walks the chunks in order and keeps h in
//   shared memory, as the TPU grid carried it in scratch from one chunk to
//   the next.  At B = 1 that is 48 blocks on 132 SMs: the card is
//   underfilled (one block of 256 threads per SM, about 134 KB of shared
//   memory each).
// - The TPU kernel built the Q x Q chunk term whole in VMEM; 256 x 256
//   float32 is 256 KB, more than a block's 227 KB of shared memory.  Here
//   the chunk is cut into 64-row tiles: for each row tile I and each column
//   tile J <= I, G = C_I B_J^T is formed in registers, decayed, masked and
//   multiplied into x_J.  The state update runs during the last row tile,
//   which visits every column tile.
// - Masked before exp: above the diagonal cum_i - cum_j > 0 may overflow,
//   and inf * 0 is NaN, so those entries are set to 0 without an exp.
// - C.B^T is the same for every head of a (batch, chunk); each head's block
//   recomputes it (the bound above counts it once).
// - float32 FMA on the CUDA cores; no tensor cores, no TMA.
//
// `ssd_fwd` returns the `cudaError_t` of its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int QT = 64;        // rows of a chunk tile
constexpr int THREADS = 256;  // 16 x 16 threads; each owns 4 rows of a tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [0, QT) of a [rows, W] row-major block into shared memory as float32
// [QT][W + 1]; rows at or beyond `n_valid` are zero.
template <typename T, int W>
__device__ __forceinline__ void load_rows(float* s, const T* g, int n_valid) {
  for (int idx = threadIdx.x; idx < QT * W; idx += THREADS) {
    const int r = idx / W, c = idx % W;
    s[r * (W + 1) + c] = r < n_valid ? to_f(g[(size_t)r * W + c]) : 0.f;
  }
}

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

template <int P, int N>
constexpr size_t smem_floats(int Q) {
  return (size_t)2 * QT * (N + 1)   // C_I, B_J
         + (size_t)P * (N + 1)      // h
         + (size_t)QT * (P + 1)     // x_J
         + (size_t)QT * (QT + 1)    // G
         + QT                       // state-update weights of J's rows
         + 2 * (size_t)Q;           // cum, dt of the chunk
}

// One block per (batch, head): blockIdx.x = b * H + h.
template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dA,
           const float* __restrict__ dt, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ h0,
           T* __restrict__ y, float* __restrict__ h_last, int H, int S, int Q) {
  constexpr int LDN = N + 1, LDX = P + 1, LDG = QT + 1;
  constexpr int PR = P / 16;  // y columns per thread; rows of h per thread
  constexpr int NR = N / 16;  // columns of h per thread
  extern __shared__ float smem[];
  float* sC = smem;
  float* sB = sC + QT * LDN;
  float* sH = sB + QT * LDN;
  float* sX = sH + P * LDN;
  float* sG = sX + QT * LDX;
  float* sW = sG + QT * LDG;
  float* sCum = sW + QT;
  float* sDt = sCum + Q;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t bh = blockIdx.x;
  const int b = blockIdx.x / H;
  const T* xb = x + bh * S * P;
  T* yb = y + bh * S * P;
  const float* dAb = dA + bh * S;
  const float* dtb = dt + bh * S;
  const T* Bb = Bm + (size_t)b * S * N;
  const T* Cb = Cm + (size_t)b * S * N;

  for (int idx = tid; idx < P * N; idx += THREADS)
    sH[(idx / N) * LDN + idx % N] = h0 ? h0[bh * P * N + idx] : 0.f;

  const int nI = (Q + QT - 1) / QT;
  for (int t0 = 0; t0 < S; t0 += Q) {
    __syncthreads();  // the previous chunk's readers of sCum / sDt are done
    for (int i = tid; i < Q; i += THREADS) {
      sCum[i] = dAb[t0 + i];
      sDt[i] = dtb[t0 + i];
    }
    __syncthreads();
    if (tid < 32) warp_cumsum(sCum, Q, tid);
    __syncthreads();
    const float cum_last = sCum[Q - 1];

    float hacc[PR][NR];
#pragma unroll
    for (int a = 0; a < PR; ++a)
#pragma unroll
      for (int c = 0; c < NR; ++c) hacc[a][c] = 0.f;

    for (int I = 0; I < nI; ++I) {
      const int i0 = I * QT;
      __syncthreads();
      load_rows<T, N>(sC, Cb + (size_t)(t0 + i0) * N, Q - i0);
      __syncthreads();

      // carried state: acc[i][c] = exp(cum_i) * C_i . h[p]
      float acc[4][PR];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < PR; ++c) acc[i][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[PR];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sC[(ty * 4 + i) * LDN + n];
#pragma unroll
        for (int c = 0; c < PR; ++c) hv[c] = sH[(tx + 16 * c) * LDN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < PR; ++c) acc[i][c] = fmaf(cv[i], hv[c], acc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i0 + ty * 4 + i;
        const float e = row < Q ? expf(sCum[row]) : 0.f;
#pragma unroll
        for (int c = 0; c < PR; ++c) acc[i][c] *= e;
      }

      for (int J = 0; J <= I; ++J) {
        const int j0 = J * QT, nj = min(QT, Q - j0);
        __syncthreads();  // readers of the previous sB / sX / sG are done
        load_rows<T, N>(sB, Bb + (size_t)(t0 + j0) * N, nj);
        load_rows<T, P>(sX, xb + (size_t)(t0 + j0) * P, nj);
        if (tid < QT)
          sW[tid] = tid < nj ? expf(cum_last - sCum[j0 + tid]) * sDt[j0 + tid] : 0.f;
        __syncthreads();

        // G[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j on j <= i, else 0
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
        for (int i = 0; i < 4; ++i) {
          const int gi = i0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int gj = j0 + tx + 16 * j;
            const bool ok = gi < Q && gj <= gi;
            sG[(ty * 4 + i) * LDG + tx + 16 * j] =
                ok ? s[i][j] * expf(sCum[gi] - sCum[gj]) * sDt[gj] : 0.f;
          }
        }
        __syncthreads();

        // y_I += G x_J
#pragma unroll 4
        for (int jj = 0; jj < QT; ++jj) {
          float gv[4], xv[PR];
#pragma unroll
          for (int i = 0; i < 4; ++i) gv[i] = sG[(ty * 4 + i) * LDG + jj];
#pragma unroll
          for (int c = 0; c < PR; ++c) xv[c] = sX[jj * LDX + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < PR; ++c) acc[i][c] = fmaf(gv[i], xv[c], acc[i][c]);
        }
        // the last row tile visits every column tile: the state update
        if (I == nI - 1) {
          for (int jj = 0; jj < nj; ++jj) {
            const float w = sW[jj];
            float xv[PR], bv[NR];
#pragma unroll
            for (int a = 0; a < PR; ++a) xv[a] = sX[jj * LDX + ty * PR + a] * w;
#pragma unroll
            for (int c = 0; c < NR; ++c) bv[c] = sB[jj * LDN + tx + 16 * c];
#pragma unroll
            for (int a = 0; a < PR; ++a)
#pragma unroll
              for (int c = 0; c < NR; ++c) hacc[a][c] = fmaf(xv[a], bv[c], hacc[a][c]);
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i0 + ty * 4 + i;
        if (row >= Q) continue;
        T* yrow = yb + (size_t)(t0 + row) * P;
#pragma unroll
        for (int c = 0; c < PR; ++c) yrow[tx + 16 * c] = from_f<T>(acc[i][c]);
      }
    }

    __syncthreads();  // every reader of the old h is done
    const float chunk_decay = expf(cum_last);
#pragma unroll
    for (int a = 0; a < PR; ++a)
#pragma unroll
      for (int c = 0; c < NR; ++c) {
        float* hp = sH + (ty * PR + a) * LDN + tx + 16 * c;
        *hp = *hp * chunk_decay + hacc[a][c];
      }
  }

  __syncthreads();
  for (int idx = tid; idx < P * N; idx += THREADS)
    h_last[bh * P * N + idx] = sH[(idx / N) * LDN + idx % N];
}

template <typename T, int P, int N>
cudaError_t launch(const void* x, const float* dA, const float* dt, const void* Bm,
                   const void* Cm, const float* h0, void* y, float* h_last, int B, int H,
                   int S, int Q, cudaStream_t stream) {
  auto kern = ssd_kernel<T, P, N>;
  const size_t smem = smem_floats<P, N>(Q) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dA, dt, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      h0, static_cast<T*>(y), h_last, H, S, Q);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C and y); (P, N) = (64, 128), Mamba-2's
// widths, the only ones built (two instantiations) and the only ones the
// wrapper and this entry accept; S a multiple of Q; h0 may be null (zeros).
// The wrapper checks all of it.
extern "C" int ssd_fwd(const void* x, const float* dA, const float* dt, const void* Bm,
                       const void* Cm, const float* h0, void* y, float* h_last, int B, int H,
                       int S, int P, int N, int Q, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P != 64 || N != 128) return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float, 64, 128>(x, dA, dt, Bm, Cm, h0, y, h_last, B, H, S, Q, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 64, 128>(x, dA, dt, Bm, Cm, h0, y, h_last, B, H, S, Q, s);
  return cudaErrorInvalidValue;
}
