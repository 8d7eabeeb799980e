// RG-LRU diagonal linear recurrence, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `rglru_call` (`_rglru_kernel`) of
// src/repro/kernels/rglru/kernel.py:  h_t = a_t * h_{t-1} + b_t, with a, b,
// h [B, S, L] float32 (contiguous) and h_last [B, L] float32.  The gated
// input b is prefolded by the caller, and so is an initial state (as a
// virtual first step).
//
// What bounds it: it reads a and b and writes h, 12 bytes per element and
// one FMA, so memory bounds it on this card: at RecurrentGemma-9B's width
// (L = 4096) and S = 32768, 1.61 GB, 0.48 ms at 3.35 TB/s.
//
// Design: one thread per (batch, channel) walks the sequence, so the carry
// stays in a register and no chunk or second pass is needed; neighbouring
// threads read neighbouring channels, so each warp's loads are 128-byte
// coalesced rows.  The TPU kernel's Hillis-Steele doubling over a chunk
// gave the VPU parallel work; here the channels give it, and the sum is
// the exact sequential order (the TPU kernel summed in another order, so
// the two agree within a float32 tolerance, not bit for bit).  Blocks are
// one warp, so B * L / 32 blocks spread over the SMs, and each thread
// issues the loads of UNROLL steps before it uses them, which keeps
// UNROLL * 2 * 128 bytes per warp in flight.  B * L = 4096 threads still
// underfill the card: 128 warps on 132 SMs, one warp per SM, far below the
// memory parallelism the HBM rate needs; the design gives up rate for
// simplicity here.
//
// `rglru_fwd` returns the `cudaError_t` of its launch.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 32;
constexpr int UNROLL = 16;

__global__ void __launch_bounds__(THREADS)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ h,
             float* __restrict__ h_last, int S, int L) {
  const int l = blockIdx.x * THREADS + threadIdx.x;
  if (l >= L) return;
  const size_t base = (size_t)blockIdx.y * S * L + l;
  float carry = 0.f;
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      av[u] = a[base + (size_t)(t + u) * L];
      bv[u] = b[base + (size_t)(t + u) * L];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      carry = fmaf(av[u], carry, bv[u]);
      h[base + (size_t)(t + u) * L] = carry;
    }
  }
  for (; t < S; ++t) {
    carry = fmaf(a[base + (size_t)t * L], carry, b[base + (size_t)t * L]);
    h[base + (size_t)t * L] = carry;
  }
  h_last[(size_t)blockIdx.y * L + l] = carry;
}

}  // namespace

extern "C" int rglru_fwd(const float* a, const float* b, float* h, float* h_last, int B, int S,
                         int L, void* stream) {
  const dim3 grid((L + THREADS - 1) / THREADS, B);
  rglru_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a, b, h, h_last, S, L);
  return cudaGetLastError();
}
