// Crossbar-dispatch kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes).  Three kernels, one build:
//
// 1. plan_multi  replaces repro/kernels/crossbar_dispatch/kernel.py
//    plan_multi_call / _plan_multi_kernel.  The TPU kernel walks token
//    blocks in order and carries the [S*S] per-pair live counts in VMEM
//    scratch.  Blocks on the GPU run in no order, so the carry becomes
//    three passes: a per-block histogram of isolation-passing packets per
//    pair, an exclusive prefix over blocks, and a rank pass that adds each
//    packet's in-block exclusive count (warp __match_any_sync + __popc of
//    the lower lanes, then a prefix over the block's warps in shared
//    memory).  Integer throughout, so bit-exact.  Bound: launch latency at
//    the served shapes (a few hundred bytes); bytes at T = 64k.
//
// 2. scatter     replaces kernel.py scatter_call / _scatter_kernel.  The
//    TPU version builds a [bT, C] one-hot and runs it through the MXU; here
//    a granted packet's row is copied straight to slab row dst*C+slot with
//    16-byte vector loads.  Slots are unique, so no atomics.  The one-hot
//    silently dropped packets with slot >= C or dst outside [0, S); the
//    copy bounds-checks both.  Bound: bytes (read x, write the slabs).
//
// 3. combine     replaces kernel.py combine_call / _combine_kernel: the
//    weighted gather back to packet order, out[t] = (f32(w[t]) *
//    f32(y[dst, slot])) rounded once to y's type, zeros for dropped
//    packets.  One block per packet row, 16-byte vectors.  Bound: bytes.
//
// scatter and combine take float32 or bfloat16 rows that are a multiple of
// 16 bytes at 16-byte aligned addresses (the served rows are 8 KiB); the
// Python wrapper checks this before it launches.
//
// Every launcher returns cudaGetLastError() so a refused launch surfaces
// in the Python wrapper, which raises on a non-zero code.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kPlanBlock = 256;                 // tokens (= threads) per block
constexpr int kPlanWarps = kPlanBlock / 32;
constexpr int kRowThreads = 128;

__device__ __forceinline__ bool packet_pair(const int32_t* dst,
                                            const int32_t* src,
                                            const int32_t* allowed, int t,
                                            int T, int S, int* pair) {
  if (t >= T) return false;
  const int d = dst[t], s = src[t];
  const bool valid = d >= 0 && d < S && s >= 0 && s < S;
  const int dc = min(max(d, 0), S - 1), sc = min(max(s, 0), S - 1);
  *pair = sc * S + dc;
  return valid && allowed[*pair] > 0;
}

// Pass 1: per-block count of isolation-passing packets for every pair.
__global__ void plan_hist_kernel(const int32_t* __restrict__ dst,
                                 const int32_t* __restrict__ src,
                                 const int32_t* __restrict__ allowed,
                                 int32_t* __restrict__ hist, int T, int S) {
  extern __shared__ int32_t sh[];
  const int n2 = S * S;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  int pair;
  const int t = blockIdx.x * kPlanBlock + threadIdx.x;
  if (packet_pair(dst, src, allowed, t, T, S, &pair)) atomicAdd(&sh[pair], 1);
  __syncthreads();
  for (int i = threadIdx.x; i < n2; i += blockDim.x)
    hist[(size_t)blockIdx.x * n2 + i] = sh[i];
}

// Pass 2: exclusive prefix over blocks, in place, one thread per pair.
__global__ void plan_prefix_kernel(int32_t* __restrict__ hist, int n_blocks,
                                   int n2) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n2) return;
  int32_t run = 0;
  for (int b = 0; b < n_blocks; ++b) {
    const int32_t c = hist[(size_t)b * n2 + p];
    hist[(size_t)b * n2 + p] = run;
    run += c;
  }
}

// Pass 3: rank = carry from earlier blocks + in-block exclusive count;
// quota verdict, error code, and the granted [S, S] histogram.
__global__ void plan_rank_kernel(const int32_t* __restrict__ dst,
                                 const int32_t* __restrict__ src,
                                 const int32_t* __restrict__ allowed,
                                 const int32_t* __restrict__ quota,
                                 const int32_t* __restrict__ carry,
                                 int32_t* __restrict__ keep_out,
                                 int32_t* __restrict__ rank_out,
                                 int32_t* __restrict__ err_out,
                                 int32_t* __restrict__ granted, int T,
                                 int S) {
  extern __shared__ int32_t sh[];
  const int n2 = S * S;
  int32_t* warp_cnt = sh;                        // [kPlanWarps, n2]
  int32_t* block_granted = sh + kPlanWarps * n2; // [n2]
  for (int i = threadIdx.x; i < (kPlanWarps + 1) * n2; i += blockDim.x)
    sh[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x * kPlanBlock + threadIdx.x;
  int pair = 0;
  const bool live = packet_pair(dst, src, allowed, t, T, S, &pair);
  // Dead lanes take keys no live lane can hold, so they match only
  // themselves.
  const unsigned key = live ? (unsigned)pair : (unsigned)(n2 + lane);
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const unsigned lower = (1u << lane) - 1u;
  int32_t rank = __popc(peers & lower);
  if (live && (peers & lower) == 0u)             // lowest lane of its group
    warp_cnt[warp * n2 + pair] = __popc(peers);
  __syncthreads();

  bool keep = false;
  if (live) {
    for (int w = 0; w < warp; ++w) rank += warp_cnt[w * n2 + pair];
    rank += carry[(size_t)blockIdx.x * n2 + pair];
    const int32_t q = quota[pair];
    keep = (q == 0) || (rank < q);
    if (keep) atomicAdd(&block_granted[pair], 1);
  }
  if (t < T) {
    keep_out[t] = keep ? 1 : 0;
    rank_out[t] = live ? rank : 0;
    err_out[t] = !live ? 1 : (keep ? 0 : 2);     // INVALID_DEST, GRANT_TIMEOUT
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n2; i += blockDim.x)
    if (block_granted[i]) atomicAdd(&granted[i], block_granted[i]);
}

__device__ __forceinline__ bool row_target(const int32_t* dst,
                                           const int32_t* keep,
                                           const int32_t* slot, int t, int S,
                                           int C, int64_t* row) {
  const int d = dst[t], s = slot[t];
  if (keep[t] <= 0 || d < 0 || d >= S || s < 0 || s >= C) return false;
  *row = (int64_t)d * C + s;
  return true;
}

// One block per packet: copy x[t] to slabs[dst*C+slot] as uint4 vectors.
__global__ void scatter_kernel(const uint4* __restrict__ x,
                               const int32_t* __restrict__ dst,
                               const int32_t* __restrict__ keep,
                               const int32_t* __restrict__ slot,
                               uint4* __restrict__ slabs, int S, int C,
                               int64_t row_vecs) {
  const int t = blockIdx.x;
  int64_t row;
  if (!row_target(dst, keep, slot, t, S, C, &row)) return;
  const uint4* in = x + (int64_t)t * row_vecs;
  uint4* out = slabs + row * row_vecs;
  for (int64_t i = threadIdx.x; i < row_vecs; i += blockDim.x) out[i] = in[i];
}

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One block per packet: out[t] = (w * y[row]) rounded once, or zeros.
// Rows are a multiple of 16 bytes and move as uint4.
template <typename T>
__global__ void combine_kernel(const T* __restrict__ y,
                               const int32_t* __restrict__ dst,
                               const int32_t* __restrict__ keep,
                               const int32_t* __restrict__ slot,
                               const float* __restrict__ weights,
                               T* __restrict__ out, int S, int C, int D) {
  const int t = blockIdx.x;
  int64_t row;
  const bool ok = row_target(dst, keep, slot, t, S, C, &row);
  const float w = weights[t];
  constexpr int kPer = 16 / sizeof(T);
  const int n_vec = D / kPer;
  const uint4* in = reinterpret_cast<const uint4*>(y + (ok ? row : 0) * D);
  uint4* ov = reinterpret_cast<uint4*>(out + (int64_t)t * D);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (ok) {
      uint4 v = in[i];
      const T* e = reinterpret_cast<const T*>(&v);
      T* re = reinterpret_cast<T*>(&r);
#pragma unroll
      for (int j = 0; j < kPer; ++j) re[j] = from_f32<T>(w * to_f32<T>(e[j]));
    }
    ov[i] = r;
  }
}

template <typename T>
cudaError_t launch_combine(const void* y, const int32_t* dst,
                           const int32_t* keep, const int32_t* slot,
                           const float* w, void* out, int T_, int S, int C,
                           int D, cudaStream_t stream) {
  combine_kernel<T><<<T_, kRowThreads, 0, stream>>>(
      static_cast<const T*>(y), dst, keep, slot, w, static_cast<T*>(out), S,
      C, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch ``hist`` holds ceil(T / 256) * S * S int32; ``granted`` must be
// zeroed by the caller.
int crossbar_plan_multi(const void* dst, const void* src, const void* allowed,
                        const void* quota, void* keep, void* rank, void* err,
                        void* granted, void* hist, int T, int S,
                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n2 = S * S;
  const int n_blocks = (T + kPlanBlock - 1) / kPlanBlock;
  const auto* d = static_cast<const int32_t*>(dst);
  const auto* s = static_cast<const int32_t*>(src);
  const auto* a = static_cast<const int32_t*>(allowed);
  auto* h = static_cast<int32_t*>(hist);
  plan_hist_kernel<<<n_blocks, kPlanBlock, n2 * sizeof(int32_t), stream>>>(
      d, s, a, h, T, S);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  plan_prefix_kernel<<<(n2 + 255) / 256, 256, 0, stream>>>(h, n_blocks, n2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)(kPlanWarps + 1) * n2 * sizeof(int32_t);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(plan_rank_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  plan_rank_kernel<<<n_blocks, kPlanBlock, smem, stream>>>(
      d, s, a, static_cast<const int32_t*>(quota), h,
      static_cast<int32_t*>(keep), static_cast<int32_t*>(rank),
      static_cast<int32_t*>(err), static_cast<int32_t*>(granted), T, S);
  return (int)cudaGetLastError();
}

// ``slabs`` must be zeroed by the caller; ``row_vecs`` = row bytes / 16.
int crossbar_scatter(const void* x, const void* dst, const void* keep,
                     const void* slot, void* slabs, int T, int S, int C,
                     long long row_vecs, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  scatter_kernel<<<T, kRowThreads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<const int32_t*>(dst),
      static_cast<const int32_t*>(keep), static_cast<const int32_t*>(slot),
      static_cast<uint4*>(slabs), S, C, row_vecs);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.  ``weights`` is float32.
int crossbar_combine(const void* y, const void* dst, const void* keep,
                     const void* slot, const void* weights, void* out, int T,
                     int S, int C, int D, int dtype, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* d = static_cast<const int32_t*>(dst);
  const auto* k = static_cast<const int32_t*>(keep);
  const auto* sl = static_cast<const int32_t*>(slot);
  const auto* w = static_cast<const float*>(weights);
  switch (dtype) {
    case 0: return (int)launch_combine<float>(y, d, k, sl, w, out, T, S, C, D, stream);
    case 1: return (int)launch_combine<__nv_bfloat16>(y, d, k, sl, w, out, T, S, C, D, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
