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
//    TPU version builds a [bT, C] one-hot and runs it through the MXU into
//    zeroed slabs.  Here every byte of the [S*C, D] slabs is written once:
//    a slab row holds the row of the granted packet that owns it, or
//    zeros.  Bound: bytes (the granted rows read once, the slabs written
//    once); at the served decode shape (64 rows of 8 KiB) launch latency,
//    and the call's host path more than both.  The design:
//    - no memset: the wrapper allocates the slabs with torch.empty, and a
//      row that no packet owns is stored as zeros without a read;
//    - below OWNER_PASS_T packets (kernel.py) a call is one launch,
//      scan_scatter_kernel: each block scans dst, keep and slot of all T
//      packets (12 bytes a packet, coalesced, from L2 after the first
//      block) into a table of the owners of its rows in shared memory;
//      slots are unique per dst, so no atomics.  The one-hot silently
//      dropped packets with slot >= C or dst outside [0, S); the scan
//      bounds-checks both.  So that few blocks scan, the grid is
//      kBlocksPerSm blocks an SM, each taking every g-th slab row (a range
//      would leave some blocks a slab's empty tail); where the slab is
//      small the rows are also cut into column chunks, so the 64 decode
//      rows run on 128 blocks instead of one SM writing 512 KiB;
//    - the scan costs blocks x 12 T bytes of L2 reads, so from OWNER_PASS_T
//      packets on the wrapper passes an int32 [S*C] scratch and a call
//      takes two launches: owner_kernel writes owner[row] = t, then
//      gather_kernel (below) copies each slab row from the packet its
//      owner entry names, believing the entry only if that packet routes
//      to the row, so the scratch needs no clearing;
//    - rows move as 16-byte vectors: scan_scatter_kernel keeps kUnroll
//      loads in flight a thread, issued before their stores, with no
//      division per vector.
//
// 3. combine     replaces kernel.py combine_call / _combine_kernel: the
//    weighted gather back to packet order, out[t] = (f32(w[t]) *
//    f32(y[dst, slot])) rounded once to y's type, zeros for dropped
//    packets.  Bound: bytes (the granted slab rows read once, out written
//    once); at decode, as scatter, launch latency and the host path.  One
//    launch of gather_kernel: a block of 128 threads a packet row (in
//    order, so many small blocks balance themselves), which looks its
//    route up once, reads the slab row only for a granted packet and
//    stores zeros for the rest, in a plain loop with few registers, so
//    that 16 blocks fit an SM and the train step's 2048 rows run in one
//    wave; few rows are cut into column chunks, rows narrower than 512
//    vectors share a block.  A null ``weights`` is
//    the unit-weight form, a plain copy: bit-equal to weight 1.0, since
//    1.0f * v == v and rounding an exact bfloat16 value returns it.
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

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kPlanBlock = 256;                 // tokens (= threads) per block
constexpr int kPlanWarps = kPlanBlock / 32;
constexpr int kScanThreads = 1024;            // most threads of the prefix pass
constexpr int kRowThreads = 256;                // threads of a scan_scatter block
constexpr int kGatherThreads = 128;             // threads of a gather block
constexpr int kUnroll = 4;                      // 16-byte loads in flight a thread
constexpr int kScanUnroll = 4;                  // packets a thread loads at once
constexpr int kBlocksPerSm = 4;                 // scan_scatter blocks an SM
constexpr int kMinBlockVecs = 256;              // 16-byte vectors a block takes at least
constexpr int kMaxBlockRows = 4096;             // rows of a block's owner table

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
                                           int C, int* row) {
  const int d = dst[t], s = slot[t];
  if (keep[t] <= 0 || d < 0 || d >= S || s < 0 || s >= C) return false;
  *row = d * C + s;
  return true;
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

// Where the owner of a slab row (scatter) or the slab row of a packet
// (combine) comes from, outside the one-pass scatter's scan.
enum class Source {
  kOwner,   // scatter: owner_kernel's map, checked back
  kRoute,   // combine: output row t reads slab row dst[t]*C + slot[t]
};

// The flat index i = r * nc + c of a thread's vectors, stepped by
// kThreads at a time without a division: one at the start of the block.
template <int kThreads>
struct RowCol {
  int r, c, step_r, step_c, nc;
  __device__ __forceinline__ explicit RowCol(int nc_) : nc(nc_) {
    r = threadIdx.x / nc;
    c = threadIdx.x - r * nc;
    step_r = kThreads / nc;
    step_c = kThreads - step_r * nc;
  }
  __device__ __forceinline__ void next() {
    r += step_r;
    c += step_c;
    if (c >= nc) { c -= nc; ++r; }
  }
};

// One-pass scatter.  Block (bx, by) owns slab rows bx, bx + g, bx + 2g, ...
// (g = gridDim.x) and vectors [c0, c0 + chunk_vecs) of each: few blocks,
// since each scans all T packets, and every g-th row, since a range would
// leave some blocks a slab's empty tail.  The scan fills a table of the
// owners of its rows in shared memory; then the rows are copied with
// kUnroll 16-byte loads in flight a thread, issued before the stores, and
// rows that no packet owns are stored as zeros without a read.
__global__ void __launch_bounds__(kRowThreads)
scan_scatter_kernel(const uint4* __restrict__ x, uint4* __restrict__ slabs,
                    const int32_t* __restrict__ dst,
                    const int32_t* __restrict__ keep,
                    const int32_t* __restrict__ slot, int T, int S, int C,
                    int row_vecs, int chunk_vecs) {
  extern __shared__ int32_t owner_of[];            // [nr]
  const int g = gridDim.x, bx = blockIdx.x;
  const int nr = (S * C - bx + g - 1) / g;
  const int c0 = blockIdx.y * chunk_vecs;
  const int nc = min(chunk_vecs, row_vecs - c0);
  for (int i = threadIdx.x; i < nr; i += kRowThreads) owner_of[i] = -1;
  __syncthreads();
  // 12 bytes a packet, coalesced, kScanUnroll loads of each in flight;
  // every block after the first reads them from L2.
  for (int base = 0; base < T; base += kRowThreads * kScanUnroll) {
    int d[kScanUnroll], k[kScanUnroll], s[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const int t = base + u * kRowThreads + threadIdx.x;
      d[u] = k[u] = s[u] = 0;
      if (t < T) { d[u] = dst[t]; k[u] = keep[t]; s[u] = slot[t]; }
    }
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      if (k[u] > 0 && d[u] >= 0 && d[u] < S && s[u] >= 0 && s[u] < C) {
        const int r = d[u] * C + s[u];
        if (r % g == bx)
          owner_of[r / g] = base + u * kRowThreads + threadIdx.x;
      }
    }
  }
  __syncthreads();

  const int n = nr * nc;
  RowCol<kRowThreads> rc(nc);
  for (int base = 0; base < n; base += kRowThreads * kUnroll) {
    uint4 v[kUnroll];
    int r[kUnroll], c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      r[u] = rc.r;
      c[u] = c0 + rc.c;
      rc.next();
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      const int t = base + u * kRowThreads + threadIdx.x < n ? owner_of[r[u]]
                                                             : -1;
      if (t >= 0) v[u] = x[(int64_t)t * row_vecs + c[u]];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (base + u * kRowThreads + threadIdx.x < n)
        slabs[(int64_t)(bx + r[u] * g) * row_vecs + c[u]] = v[u];
  }
}

// The input row that output row r copies, or -1 (zeros), and its weight.
template <Source kSource, bool kWeighted>
__device__ __forceinline__ int row_source(
    const int32_t* __restrict__ dst, const int32_t* __restrict__ keep,
    const int32_t* __restrict__ slot, const int32_t* __restrict__ owner,
    const float* __restrict__ weights, int T, int S, int C, int r,
    float* w) {
  int row;
  if constexpr (kSource == Source::kOwner) {
    // owner[] was never cleared: an entry is believed only if the packet it
    // names routes to this row (slots are unique, so a true owner was
    // written there by owner_kernel).
    const int t = owner[r];
    return t >= 0 && t < T && row_target(dst, keep, slot, t, S, C, &row) &&
                   row == r
               ? t
               : -1;
  } else {
    if constexpr (kWeighted) *w = weights[r];
    return row_target(dst, keep, slot, r, S, C, &row) ? row : -1;
  }
}

// Output rows one after another, so the scheduler balances many small
// blocks and the rows are written in order.  kOneRow: block (b, c) takes
// vectors [c * chunk_vecs, ...) of row b, looks its source up once and
// copies in a plain loop (few registers, so 16 blocks fit an SM and a
// train-shape call runs in one wave).  Otherwise block b takes block_rows
// narrow rows and each thread looks up the row of each of its kUnroll
// vectors (the lanes of a warp share rows, so the loads hit L1), issuing
// the loads before the stores.  ``Elem`` is void for a copy, else the
// element type that combine weights in float32 and rounds once.
template <Source kSource, typename Elem, bool kOneRow>
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
              const int32_t* __restrict__ dst,
              const int32_t* __restrict__ keep,
              const int32_t* __restrict__ slot,
              const int32_t* __restrict__ owner,
              const float* __restrict__ weights, int T, int S, int C,
              int n_rows, int row_vecs, int block_rows, int chunk_vecs) {
  constexpr bool kWeighted = !std::is_void<Elem>::value;
  if constexpr (kOneRow) {
    const int r = blockIdx.x;
    const int c0 = blockIdx.y * chunk_vecs;
    const int nc = min(chunk_vecs, row_vecs - c0);
    float w = 1.f;
    const int src = row_source<kSource, kWeighted>(dst, keep, slot, owner,
                                                   weights, T, S, C, r, &w);
    const uint4* ip = in + (int64_t)(src < 0 ? 0 : src) * row_vecs + c0;
    uint4* op = out + (int64_t)r * row_vecs + c0;
    for (int i = threadIdx.x; i < nc; i += kGatherThreads) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (src >= 0) {
        v = ip[i];
        if constexpr (kWeighted) {
          Elem* e = reinterpret_cast<Elem*>(&v);
#pragma unroll
          for (int j = 0; j < 16 / (int)sizeof(Elem); ++j)
            e[j] = from_f32<Elem>(w * to_f32<Elem>(e[j]));
        }
      }
      op[i] = v;
    }
  } else {
    const int row0 = blockIdx.x * block_rows;
    const int n = min(block_rows, n_rows - row0) * row_vecs;
    RowCol<kGatherThreads> rc(row_vecs);
    for (int base = 0; base < n; base += kGatherThreads * kUnroll) {
      uint4 v[kUnroll];
      int src[kUnroll], r[kUnroll], c[kUnroll];
      float w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        r[u] = rc.r;
        c[u] = rc.c;
        rc.next();
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        src[u] = -1;
        w[u] = 1.f;
        if (base + u * kGatherThreads + threadIdx.x >= n) continue;
        src[u] = row_source<kSource, kWeighted>(dst, keep, slot, owner,
                                                weights, T, S, C,
                                                row0 + r[u], &w[u]);
        if (src[u] >= 0) v[u] = in[(int64_t)src[u] * row_vecs + c[u]];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (base + u * kGatherThreads + threadIdx.x >= n) continue;
        if constexpr (kWeighted) {
          if (src[u] >= 0) {
            Elem* e = reinterpret_cast<Elem*>(&v[u]);
#pragma unroll
            for (int j = 0; j < 16 / (int)sizeof(Elem); ++j)
              e[j] = from_f32<Elem>(w[u] * to_f32<Elem>(e[j]));
          }
        }
        out[(int64_t)(row0 + r[u]) * row_vecs + c[u]] = v[u];
      }
    }
  }
}

// Pass 1 of the two-pass scatter: owner[dst*C + slot] = t for every
// granted, in-range packet.  The rest of owner[] keeps whatever it held.
__global__ void owner_kernel(const int32_t* __restrict__ dst,
                             const int32_t* __restrict__ keep,
                             const int32_t* __restrict__ slot,
                             int32_t* __restrict__ owner, int T, int S,
                             int C) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  int row;
  if (t < T && row_target(dst, keep, slot, t, S, C, &row)) owner[row] = t;
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return count[dev];
}

// Blocks wanted for a copy of ``total`` vectors: kBlocksPerSm an SM, but
// none of fewer than kMinBlockVecs vectors.
long long blocks_wanted(long long total) {
  return std::max<long long>(
      1, std::min<long long>((long long)kBlocksPerSm * sm_count(),
                             (total + kMinBlockVecs - 1) / kMinBlockVecs));
}

// The one-pass scatter over S*C rows: blocks_wanted() blocks of every g-th
// row, split along the columns where the rows are fewer than the blocks,
// and more blocks where a block's owner table would pass kMaxBlockRows.
cudaError_t launch_scan_scatter(const void* x, void* slabs,
                                const int32_t* dst, const int32_t* keep,
                                const int32_t* slot, int T, int S, int C,
                                int row_vecs, cudaStream_t stream) {
  const int n_rows = S * C;
  const long long blocks = blocks_wanted((long long)n_rows * row_vecs);
  int g = n_rows, chunk_vecs = row_vecs;
  if (blocks <= n_rows) {
    g = (int)std::max<long long>(
        blocks, (n_rows + kMaxBlockRows - 1) / kMaxBlockRows);
  } else {
    const long long chunks =
        std::min<long long>((blocks + n_rows - 1) / n_rows, row_vecs);
    chunk_vecs = (int)((row_vecs + chunks - 1) / chunks);
  }
  const dim3 grid(g, (row_vecs + chunk_vecs - 1) / chunk_vecs);
  const size_t smem = (size_t)((n_rows + g - 1) / g) * sizeof(int32_t);
  scan_scatter_kernel<<<grid, kRowThreads, smem, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(slabs), dst, keep,
      slot, T, S, C, row_vecs, chunk_vecs);
  return cudaGetLastError();
}

// A gather over n_rows output rows: rows of kGatherThreads * kUnroll
// vectors or more take a block each (split along the columns where they
// are too few for blocks_wanted()), narrower rows share one.
template <Source kSource, typename Elem>
cudaError_t launch_gather(const void* in, void* out, const int32_t* dst,
                          const int32_t* keep, const int32_t* slot,
                          const int32_t* owner, const float* weights, int T,
                          int S, int C, int n_rows, int row_vecs,
                          cudaStream_t stream) {
  constexpr int kPer = kGatherThreads * kUnroll;
  const auto* x = static_cast<const uint4*>(in);
  auto* o = static_cast<uint4*>(out);
  if (row_vecs >= kPer) {
    const long long blocks = blocks_wanted((long long)n_rows * row_vecs);
    const int chunks = (int)std::max<long long>(
        (blocks + n_rows - 1) / n_rows, (row_vecs + kPer - 1) / kPer);
    const int chunk_vecs = (row_vecs + chunks - 1) / chunks;
    const dim3 grid(n_rows, (row_vecs + chunk_vecs - 1) / chunk_vecs);
    gather_kernel<kSource, Elem, true><<<grid, kGatherThreads, 0, stream>>>(
        x, o, dst, keep, slot, owner, weights, T, S, C, n_rows, row_vecs, 1,
        chunk_vecs);
  } else {
    const int block_rows = kPer / row_vecs;
    gather_kernel<kSource, Elem, false>
        <<<(n_rows + block_rows - 1) / block_rows, kGatherThreads, 0,
           stream>>>(x, o, dst, keep, slot, owner, weights, T, S, C, n_rows,
                     row_vecs, block_rows, row_vecs);
  }
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

// Every byte of ``slabs`` [S*C, row_vecs x 16 bytes] written once, in one
// launch; with ``owner`` (int32 [S*C] scratch, any contents) in two: the
// owner map, then the rows.
int crossbar_scatter(const void* x, const void* dst, const void* keep,
                     const void* slot, void* owner, void* slabs, int T, int S,
                     int C, int row_vecs, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* d = static_cast<const int32_t*>(dst);
  const auto* k = static_cast<const int32_t*>(keep);
  const auto* sl = static_cast<const int32_t*>(slot);
  auto* own = static_cast<int32_t*>(owner);
  if (S * C == 0 || row_vecs == 0) return (int)cudaSuccess;
  if (own == nullptr)
    return (int)launch_scan_scatter(x, slabs, d, k, sl, T, S, C, row_vecs,
                                    stream);
  if (T > 0) {
    owner_kernel<<<(T + kRowThreads - 1) / kRowThreads, kRowThreads, 0,
                   stream>>>(d, k, sl, own, T, S, C);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)launch_gather<Source::kOwner, void>(
      x, slabs, d, k, sl, own, nullptr, T, S, C, S * C, row_vecs, stream);
}

// out [T, row_vecs x 16 bytes].  dtype: 0 = float32, 1 = bfloat16.
// ``weights`` is float32 [T], or null for the unit-weight form, a copy.
int crossbar_combine(const void* y, const void* dst, const void* keep,
                     const void* slot, const void* weights, void* out, int T,
                     int S, int C, int row_vecs, int dtype,
                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* d = static_cast<const int32_t*>(dst);
  const auto* k = static_cast<const int32_t*>(keep);
  const auto* sl = static_cast<const int32_t*>(slot);
  const auto* w = static_cast<const float*>(weights);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (T == 0 || row_vecs == 0) return (int)cudaSuccess;
  if (w == nullptr)
    return (int)launch_gather<Source::kRoute, void>(
        y, out, d, k, sl, nullptr, nullptr, T, S, C, T, row_vecs, stream);
  if (dtype == 0)
    return (int)launch_gather<Source::kRoute, float>(
        y, out, d, k, sl, nullptr, w, T, S, C, T, row_vecs, stream);
  return (int)launch_gather<Source::kRoute, __nv_bfloat16>(
      y, out, d, k, sl, nullptr, w, T, S, C, T, row_vecs, stream);
}

}  // extern "C"
