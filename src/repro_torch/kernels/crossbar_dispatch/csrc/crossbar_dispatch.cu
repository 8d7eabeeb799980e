// Crossbar-dispatch kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes).  Four kernels, one build:
//
// 1. plan_multi  replaces repro/kernels/crossbar_dispatch/kernel.py
//    plan_multi_call / _plan_multi_kernel.  The TPU kernel walks token
//    blocks in order and carries the [S*S] per-pair live counts in VMEM
//    scratch.  Blocks on the GPU run in no order, so the carry becomes
//    three passes: a per-block histogram of isolation-passing packets per
//    pair, an exclusive prefix over blocks (one block per pair scans its
//    row, with as many warps as the row needs), and a rank pass that adds
//    each packet's in-block exclusive count (warp __match_any_sync +
//    __popc of the lower lanes, then a prefix over the block's warps in
//    shared memory).  Integer throughout, so bit-exact.  Bound: launch
//    latency at the served shapes (a few hundred bytes); bytes at T = 64k.
//
// 1b. plan       replaces kernel.py plan_call / _plan_kernel: one source's
//    plan, whose [S] count vector the TPU kernel carried across token
//    blocks.  The same three passes over S streams (one per dst), with
//    capacity checked in the rank pass (ACK_TIMEOUT after GRANT_TIMEOUT),
//    slot = keep ? rank : 0, and the granted counts [S].  A quota or
//    capacity drop still takes up a rank: ranks count isolation-passing
//    packets, as the TPU kernel's carry did.  Bound: bytes, 16 per packet
//    (dst read, keep, slot and err written).
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
constexpr int kScanThreads = 1024;            // most threads of the prefix pass
constexpr int kRowThreads = 128;

// Which stream a packet belongs to, and whether it passes isolation.  A
// stream is a (src, dst) pair for plan_multi and a dst for plan, whose
// packets all come from one source.
struct PairKey {                                 // n_keys = S * S
  const int32_t* dst;
  const int32_t* src;
  const int32_t* allowed;                        // [S * S], [src, dst]
  int S;
  __device__ __forceinline__ bool operator()(int t, int* key) const {
    const int d = dst[t], s = src[t];
    const bool valid = d >= 0 && d < S && s >= 0 && s < S;
    *key = min(max(s, 0), S - 1) * S + min(max(d, 0), S - 1);
    return valid && allowed[*key] > 0;
  }
};

struct DstKey {                                  // n_keys = S
  const int32_t* dst;
  const int32_t* allowed;                        // [S], this source's row
  int S;
  __device__ __forceinline__ bool operator()(int t, int* key) const {
    const int d = dst[t];
    *key = min(max(d, 0), S - 1);
    return d >= 0 && d < S && allowed[*key] > 0;
  }
};

// Pass 1: per-block count of isolation-passing packets for every stream,
// into hist[key, block].
template <typename Key>
__global__ void plan_hist_kernel(Key key, int32_t* __restrict__ hist, int T,
                                 int n_keys, int n_blocks) {
  extern __shared__ int32_t sh[];
  for (int i = threadIdx.x; i < n_keys; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  int k;
  const int t = blockIdx.x * kPlanBlock + threadIdx.x;
  if (t < T && key(t, &k)) atomicAdd(&sh[k], 1);
  __syncthreads();
  for (int i = threadIdx.x; i < n_keys; i += blockDim.x)
    hist[(size_t)i * n_blocks + blockIdx.x] = sh[i];
}

// Pass 2: exclusive prefix over blocks, in place, one block per stream
// scanning its contiguous row blockDim.x entries at a time (warp shuffles,
// then a scan of the warps' sums).  The block has as many warps as the row
// needs, up to kScanThreads threads (scan_threads), so a served decode
// plan, one token block, scans with one warp per stream.
__global__ void __launch_bounds__(kScanThreads)
plan_prefix_kernel(int32_t* __restrict__ hist, int n_blocks) {
  __shared__ int32_t warp_sum[kScanThreads / 32];
  int32_t* row = hist + (size_t)blockIdx.x * n_blocks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int32_t carry = 0;
  for (int base = 0; base < n_blocks; base += blockDim.x) {
    const int b = base + threadIdx.x;
    const int32_t v = b < n_blocks ? row[b] : 0;
    int32_t incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int32_t w = lane < n_warps ? warp_sum[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t up = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += up;
      }
      warp_sum[lane] = w;                        // inclusive over warps
    }
    __syncthreads();
    const int32_t before = warp == 0 ? 0 : warp_sum[warp - 1];
    if (b < n_blocks) row[b] = carry + before + incl - v;
    carry += warp_sum[n_warps - 1];
    __syncthreads();                             // warp_sum is reused
  }
}

// Threads of the prefix pass for a row of n_blocks: whole warps covering
// the row once, at most kScanThreads.
inline int scan_threads(int n_blocks) {
  const int warps = (n_blocks + 31) / 32;
  if (warps >= kScanThreads / 32) return kScanThreads;
  return (warps > 0 ? warps : 1) * 32;
}

// Pass 3: rank = carry from earlier blocks + in-block exclusive count of
// the packet's stream; the quota verdict (0 = unlimited), the capacity
// verdict where ``cap`` is given, the error code, and the granted count
// per stream.  kSlot writes slot = keep ? rank : 0 (plan); otherwise
// rank = live ? rank : 0 (plan_multi).
template <typename Key, bool kSlot>
__global__ void plan_rank_kernel(Key key, const int32_t* __restrict__ quota,
                                 const int32_t* __restrict__ cap,
                                 const int32_t* __restrict__ carry,
                                 int32_t* __restrict__ keep_out,
                                 int32_t* __restrict__ rank_out,
                                 int32_t* __restrict__ err_out,
                                 int32_t* __restrict__ granted, int T,
                                 int n_keys, int n_blocks) {
  extern __shared__ int32_t sh[];
  int32_t* warp_cnt = sh;                            // [kPlanWarps, n_keys]
  int32_t* block_granted = sh + kPlanWarps * n_keys; // [n_keys]
  for (int i = threadIdx.x; i < (kPlanWarps + 1) * n_keys; i += blockDim.x)
    sh[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x * kPlanBlock + threadIdx.x;
  int k = 0;
  const bool live = t < T && key(t, &k);
  // Dead lanes take keys no live lane can hold, so they match only
  // themselves.
  const unsigned match = live ? (unsigned)k : (unsigned)(n_keys + lane);
  const unsigned peers = __match_any_sync(0xffffffffu, match);
  const unsigned lower = (1u << lane) - 1u;
  int32_t rank = __popc(peers & lower);
  if (live && (peers & lower) == 0u)             // lowest lane of its group
    warp_cnt[warp * n_keys + k] = __popc(peers);
  __syncthreads();

  bool quota_ok = true, cap_ok = true;
  if (live) {
    for (int w = 0; w < warp; ++w) rank += warp_cnt[w * n_keys + k];
    rank += carry[(size_t)k * n_blocks + blockIdx.x];
    const int32_t q = quota[k];
    quota_ok = (q == 0) || (rank < q);
    cap_ok = cap == nullptr || rank < cap[k];
    if (quota_ok && cap_ok) atomicAdd(&block_granted[k], 1);
  }
  const bool keep = live && quota_ok && cap_ok;
  if (t < T) {
    keep_out[t] = keep ? 1 : 0;
    rank_out[t] = (kSlot ? keep : live) ? rank : 0;
    // INVALID_DEST, GRANT_TIMEOUT, ACK_TIMEOUT, OK
    err_out[t] = !live ? 1 : (!quota_ok ? 2 : (!cap_ok ? 3 : 0));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_keys; i += blockDim.x)
    if (block_granted[i]) atomicAdd(&granted[i], block_granted[i]);
}

// The three passes of a plan; ``hist`` holds n_keys * ceil(T / 256) int32
// and ``granted`` [n_keys] must be zeroed by the caller.
template <typename Key, bool kSlot>
cudaError_t launch_plan(Key key, const int32_t* quota, const int32_t* cap,
                        int32_t* hist, int32_t* keep, int32_t* rank,
                        int32_t* err, int32_t* granted, int T, int n_keys,
                        cudaStream_t stream) {
  const int n_blocks = (T + kPlanBlock - 1) / kPlanBlock;
  plan_hist_kernel<Key><<<n_blocks, kPlanBlock, n_keys * sizeof(int32_t),
                          stream>>>(key, hist, T, n_keys, n_blocks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  plan_prefix_kernel<<<n_keys, scan_threads(n_blocks), 0, stream>>>(
      hist, n_blocks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)(kPlanWarps + 1) * n_keys * sizeof(int32_t);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(plan_rank_kernel<Key, kSlot>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  plan_rank_kernel<Key, kSlot><<<n_blocks, kPlanBlock, smem, stream>>>(
      key, quota, cap, hist, keep, rank, err, granted, T, n_keys, n_blocks);
  return cudaGetLastError();
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
  const PairKey key{static_cast<const int32_t*>(dst),
                    static_cast<const int32_t*>(src),
                    static_cast<const int32_t*>(allowed), S};
  return (int)launch_plan<PairKey, false>(
      key, static_cast<const int32_t*>(quota), nullptr,
      static_cast<int32_t*>(hist), static_cast<int32_t*>(keep),
      static_cast<int32_t*>(rank), static_cast<int32_t*>(err),
      static_cast<int32_t*>(granted), T, S * S,
      static_cast<cudaStream_t>(stream_ptr));
}

// One source's plan: register rows ``allowed``, ``quota`` and ``capacity``
// [S].  Scratch ``hist`` holds ceil(T / 256) * S int32; ``counts`` [S]
// must be zeroed by the caller.
int crossbar_plan(const void* dst, const void* allowed, const void* quota,
                  const void* capacity, void* keep, void* slot, void* err,
                  void* counts, void* hist, int T, int S, void* stream_ptr) {
  const DstKey key{static_cast<const int32_t*>(dst),
                   static_cast<const int32_t*>(allowed), S};
  return (int)launch_plan<DstKey, true>(
      key, static_cast<const int32_t*>(quota),
      static_cast<const int32_t*>(capacity), static_cast<int32_t*>(hist),
      static_cast<int32_t*>(keep), static_cast<int32_t*>(slot),
      static_cast<int32_t*>(err), static_cast<int32_t*>(counts), T, S,
      static_cast<cudaStream_t>(stream_ptr));
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
