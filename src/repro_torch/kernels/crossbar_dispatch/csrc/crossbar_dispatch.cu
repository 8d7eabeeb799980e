// Crossbar-dispatch kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes).  The four TPU kernels' counterparts and the fabric's
// whole plan, one build:
//
// 1. plan_multi  replaces repro/kernels/crossbar_dispatch/kernel.py
//    plan_multi_call / _plan_multi_kernel.  The TPU kernel walks token
//    blocks in order and carries the [S*S] per-pair live counts in VMEM
//    scratch.  Bound: at the served shapes (T = 2 at decode, 2,048 in the
//    train step) a few hundred bytes, so launches, allocations, fills and
//    host work, not bytes; bytes from some 10^5 packets on.  The design,
//    plan_kernel: one block takes a tile of up to PLAN_BLOCK_T packets
//    (kernel.py; 8 a thread, warps in order), so a served plan is one
//    launch of one block, no memset, no copy:
//    - a warp ranks each packet among its earlier packets of the same
//      stream (__match_any_sync, __popc of the lower lanes) against its
//      running count per stream in shared memory; a scan down the warps
//      of each stream then gives every packet its rank in the tile;
//    - shared memory is (warps + 2) x n_keys ints and the register entries
//      read per stream (each stream's quota, the capacities), copied in
//      while the packets load, so the warps shrink as the streams grow
//      (n_keys = 4,096 at S = 64: 11 warps for plan_multi);
//    - every output is written whole by the kernel: granted from each
//      stream's final count in closed form (min(live, quota), or live
//      where quota is 0), so no buffer is zeroed and nothing is added
//      atomically to device memory;
//    - registers are read in place: quota through strides, so the register
//      file's [dst, src] quota passes as its transpose, and bool or int32
//      isolation masks as they are;
//    - the wrapper makes one allocation: keep, rank, err and granted are
//      parts of one int32 buffer.
//    Above PLAN_BLOCK_T packets a plan takes several blocks, still one
//    launch: each takes a ticket (so blocks start in ticket order),
//    publishes its per-stream counts with a flag, waits for the flags of
//    every earlier block (a thread a flag, all at once; a block waits only
//    on blocks that started before it) and adds their counts with loads
//    that do not wait on each other (at 2^20 packets over 16 streams block
//    127 reads 127 x 16 ints).  PLAN_BLOCK_T = 8192 won a sweep of 1,024
//    to 8,192 at 2^20 packets by 1.5x or more, where each block's fixed
//    cost and the blocks x n_keys reads of the last block weigh most; at
//    16,384 to 65,536 packets a smaller limit gains at most a few us
//    (plan_bench.py --sweep; PERF.md).
//    The block that finishes last clears the
//    ticket, the flags and the count of finished blocks, so the flags the
//    wrapper keeps for each stream (in a buffer of their own, apart from
//    the counts) are zeroed once, when they are made.
//    Integer throughout, so bit-exact.
//
// 1b. plan       replaces kernel.py plan_call / _plan_kernel: one source's
//    plan, whose [S] count vector the TPU kernel carried across token
//    blocks.  The same plan_kernel over S streams (one per dst), with
//    capacity checked per packet (ACK_TIMEOUT after GRANT_TIMEOUT),
//    slot = keep ? rank : 0, and counts [S] in closed form.  A quota or
//    capacity drop still takes up a rank: ranks count isolation-passing
//    packets, as the TPU kernel's carry did.  Bound: bytes, 16 per packet
//    (dst read, keep, slot and err written).
//
// 1c. plan_fabric: the fabric's whole DispatchPlan, what the JAX
//    package's PallasBackend.plan computes around plan_multi_call and XLA
//    fuses into its step: plan_kernel over (src, dst) streams that reads
//    the register file as stored (reset folded into isolation in the
//    kernel), then, once every granted count is known, the closed-form
//    WRR slot of arbiter.wrr_slots from g [src, dst] in shared memory, the
//    capacity verdict, keep as bytes of a torch.bool tensor, the error
//    code, and counts [S] and drops [4] in closed form (a dst's granted
//    packets take WRR slots 0 .. sum_s g - 1, so min(that, capacity) are
//    kept).  One launch where the plan fits one block; over several blocks
//    the slots need every block's counts, so finish_kernel, a second
//    launch, writes the packets there, and only there.
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
#include <climits>
#include <type_traits>

namespace {

constexpr int kRowThreads = 256;                // threads of a scan_scatter block
constexpr int kGatherThreads = 128;             // threads of a gather block
constexpr int kUnroll = 4;                      // 16-byte loads in flight a thread
constexpr int kScanUnroll = 4;                  // packets a thread loads at once
constexpr int kBlocksPerSm = 4;                 // scan_scatter blocks an SM
constexpr int kMinBlockVecs = 256;              // 16-byte vectors a block takes at least
constexpr int kMaxBlockRows = 4096;             // rows of a block's owner table

constexpr int kPlanItems = 8;                   // packets a plan thread takes
constexpr int kPlanWarpT = kPlanItems * 32;     // packets a plan warp takes
constexpr int kPlanMaxWarps = 32;
constexpr int kPlanStaticSmem = 64;             // bytes of plan_kernel's __shared__
constexpr int kPlanSmemInts = (232448 - kPlanStaticSmem) / 4;
constexpr int kFinishThreads = 256;             // threads of a finish_kernel

// A register read in place: int32 or bool (one byte) elements at
// i * s0 + j * s1, so a transposed view needs no copy.
struct Reg {
  const void* p;
  int s0, s1;
  int bytes;                                     // 4: int32, 1: bool
  __device__ __forceinline__ int at(int i, int j) const {
    const long long o = (long long)i * s0 + (long long)j * s1;
    return bytes == 1 ? (int)static_cast<const uint8_t*>(p)[o]
                      : static_cast<const int32_t*>(p)[o];
  }
};

__device__ __forceinline__ int clamp_port(int v, int S) {
  return min(max(v, 0), S - 1);
}

// Packets of a stream that pass its quota (0 = unlimited) and capacity:
// ranks 0 .. live - 1 are taken, and those below both limits are kept.
__device__ __forceinline__ int kept_of(int live, int quota, int cap) {
  return max(0, min(live, min(quota == 0 ? INT_MAX : quota, cap)));
}

// The three plans differ in what a stream is, what they read and what
// they write.  Each gives:
//   staged_ints(n_keys, S), stage(sm, n_keys): the register entries it
//     reads per stream, copied into shared memory at the start of a block
//     (q_s: each stream's quota, c_s: capacities), so that no later step
//     waits on device memory for them;
//   packet(t, &key) -> live: the packet's stream and its isolation verdict;
//   write(t, key, live, rank): a packet's outputs, given its rank among the
//     live packets of its stream;
//   total(key, live): a stream's outputs, given its live count.
// FabricPlan writes its packets after every stream's count is known
// (pre(), finish()) and its totals in plan_kernel.

// plan_multi: a stream is a (src, dst) pair; capacity is not applied.
struct MultiPlan {
  static constexpr bool kFabric = false;
  const int32_t* dst;
  const int32_t* src;
  Reg allowed;                                   // [src, dst], reset folded in
  Reg quota;                                     // [src, dst]
  int S;
  int32_t* keep;
  int32_t* rank;
  int32_t* err;
  int32_t* granted;                              // [src * S + dst]
  const int32_t* q_s;                            // staged: quota [key]
  static int staged_ints(int n_keys, int) { return n_keys; }
  __device__ __forceinline__ void stage(int32_t* sm, int n_keys) {
    for (int k = threadIdx.x; k < n_keys; k += blockDim.x) {
      const int sc = k / S;
      sm[k] = quota.at(sc, k - sc * S);
    }
    q_s = sm;
  }
  __device__ __forceinline__ bool packet(int t, int* key) const {
    const int d = dst[t], s = src[t];
    const int sc = clamp_port(s, S), dc = clamp_port(d, S);
    *key = sc * S + dc;
    return d >= 0 && d < S && s >= 0 && s < S && allowed.at(sc, dc) > 0;
  }
  __device__ __forceinline__ void write(int t, int key, bool live,
                                        int r) const {
    const int q = live ? q_s[key] : 0;
    const bool quota_ok = q == 0 || r < q;
    keep[t] = live && quota_ok;
    rank[t] = live ? r : 0;
    err[t] = !live ? 1 : (quota_ok ? 0 : 2);   // INVALID_DEST, GRANT_TIMEOUT
  }
  __device__ __forceinline__ void total(int key, int live) const {
    granted[key] = kept_of(live, q_s[key], INT_MAX);
  }
};

// plan: one source's packets; a stream is a dst; capacity applied.
struct SourcePlan {
  static constexpr bool kFabric = false;
  const int32_t* dst;
  Reg allowed, quota, cap;                       // rows [S]: at(0, d)
  int S;
  int32_t* keep;
  int32_t* slot;
  int32_t* err;
  int32_t* counts;
  const int32_t* q_s;                            // staged: quota [S]
  const int32_t* c_s;                            // staged: capacity [S]
  static int staged_ints(int n_keys, int) { return 2 * n_keys; }
  __device__ __forceinline__ void stage(int32_t* sm, int n_keys) {
    for (int k = threadIdx.x; k < n_keys; k += blockDim.x) {
      sm[k] = quota.at(0, k);
      sm[n_keys + k] = cap.at(0, k);
    }
    q_s = sm;
    c_s = sm + n_keys;
  }
  __device__ __forceinline__ bool packet(int t, int* key) const {
    const int d = dst[t];
    *key = clamp_port(d, S);
    return d >= 0 && d < S && allowed.at(0, *key) > 0;
  }
  __device__ __forceinline__ void write(int t, int key, bool live,
                                        int r) const {
    int code = 1;                                // INVALID_DEST
    if (live) {
      const int q = q_s[key];
      code = (q == 0 || r < q) ? (r < c_s[key] ? 0 : 3) : 2;
    }
    keep[t] = code == 0;
    slot[t] = code == 0 ? r : 0;
    err[t] = code;
  }
  __device__ __forceinline__ void total(int key, int live) const {
    counts[key] = kept_of(live, q_s[key], c_s[key]);
  }
};

// The fabric's whole DispatchPlan from the register file as it is stored:
// allowed [src, dst] and reset [S] bool, quota [dst, src] and capacity [S]
// int32.  A stream is a (src, dst) pair.
struct FabricPlan {
  static constexpr bool kFabric = true;
  const int32_t* dst;
  const int32_t* src;
  const uint8_t* allowed;
  const uint8_t* reset;
  const int32_t* quota;
  const int32_t* cap;
  int S;
  uint8_t* keep;                                 // torch.bool
  int32_t* slot;
  int32_t* err;
  int32_t* counts;                               // [S]
  int32_t* drops;                                // [4]
  const int32_t* q_s;                            // staged: quota [src, dst]
  const int32_t* c_s;                            // staged: capacity [S]
  static int staged_ints(int n_keys, int S) { return n_keys + S; }
  __device__ __forceinline__ void stage(int32_t* sm, int n_keys) {
    for (int k = threadIdx.x; k < n_keys; k += blockDim.x) {
      const int sc = k / S;
      sm[k] = quota[(k - sc * S) * S + sc];
    }
    for (int d = threadIdx.x; d < S; d += blockDim.x) sm[n_keys + d] = cap[d];
    q_s = sm;
    c_s = sm + n_keys;
  }
  __device__ __forceinline__ bool packet(int t, int* key) const {
    const int d = dst[t], s = src[t];
    const int sc = clamp_port(s, S), dc = clamp_port(d, S);
    *key = sc * S + dc;
    return d >= 0 && d < S && s >= 0 && s < S && allowed[*key] &&
           !reset[sc] && !reset[dc];
  }
  // INVALID_DEST, GRANT_TIMEOUT, or 0 for a packet that passes both.
  __device__ __forceinline__ int pre(int key, bool live, int r) const {
    if (!live) return 1;
    const int q = q_s[key];
    return (q == 0 || r < q) ? 0 : 2;
  }
  // The WRR slot of arbiter.wrr_slots from the granted counts g [src, dst]
  // (shared memory), the capacity verdict and the packet's outputs.
  __device__ __forceinline__ void finish(int t, int key, int code, int r,
                                         const int32_t* g) const {
    int sl = 0;
    if (code == 0) {
      const int sc = key / S, dc = key - sc * S;
      for (int s = 0; s < S; ++s) {
        const int gs = g[s * S + dc];
        sl += min(r, gs) + (s < sc && gs > r);
      }
      if (sl >= c_s[dc]) code = 3;               // ACK_TIMEOUT
    }
    keep[t] = code == 0;
    slot[t] = code == 0 ? sl : 0;
    err[t] = code;
  }
};

// Device memory of a plan taken by several blocks.  ``flags`` (ticket,
// done, status [n_blocks]) is zeroed once, when it is made, and every
// launch leaves it zeroed; ``data`` (granted [n_keys], agg [n_blocks,
// n_keys]) is written before it is read.  Two buffers, so that no call's
// data lands where a later call over more blocks looks for its flags.
struct PlanScratch {
  unsigned* ticket;
  unsigned* done;
  int* status;
  int32_t* granted;
  int32_t* agg;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" : : "l"(p), "r"(v)
               : "memory");
}

// One tile of kPlanItems * blockDim.x packets a block.  Warp w takes
// kPlanItems runs of 32 packets in order and ranks each packet among the
// warp's earlier packets of its stream (__match_any_sync, __popc of the
// lower lanes, and the warp's running count per stream in shared memory);
// a scan down the warps of each stream turns the warps' counts into
// exclusive prefixes.  With one block that is the whole plan.  With
// several, a block takes a ticket (blocks start in ticket order), publishes
// its per-stream counts, and adds those of every earlier block as they
// appear: a block waits only on blocks that started before it.  The block
// that finishes last clears the ticket, the flags and the count of
// finished blocks, so the next call finds them zero without a memset.
template <class P>
__global__ void __launch_bounds__(kPlanMaxWarps * 32)
plan_kernel(P p, PlanScratch sc, int T, int n_keys, int n_blocks) {
  extern __shared__ int32_t sh[];
  __shared__ int chunk;
  __shared__ int acc[4];                         // FabricPlan's drops
  const int W = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* cnt = sh;                             // [W, n_keys]
  int32_t* tot = sh + W * n_keys;                // [n_keys] this block's
  int32_t* ex = tot + n_keys;                    // [n_keys] earlier blocks'
  int b = 0;
  if (n_blocks > 1) {
    if (threadIdx.x == 0) chunk = (int)atomicAdd(sc.ticket, 1u);
    __syncthreads();
    b = chunk;
  }
  const int t0 = b * kPlanItems * blockDim.x + warp * kPlanWarpT + lane;

  int key[kPlanItems], rank[kPlanItems];
  unsigned live = 0;
#pragma unroll
  for (int j = 0; j < kPlanItems; ++j) {         // loads first, all in flight
    const int t = t0 + j * 32;
    key[j] = rank[j] = 0;
    if (t < T && p.packet(t, &key[j])) live |= 1u << j;
  }
  // while they are in flight: the staged registers and zeroed counts
  p.stage(ex + n_keys, n_keys);
  for (int i = threadIdx.x; i < (W + 2) * n_keys; i += blockDim.x) sh[i] = 0;
  if (threadIdx.x < 4) acc[threadIdx.x] = 0;
  __syncthreads();
  const unsigned lower_lanes = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kPlanItems; ++j) {
    if (t0 - lane + j * 32 >= T) break;          // the warp's packets are done
    const bool lv = (live >> j) & 1u;
    // dead lanes take keys no live lane holds, so they match only themselves
    const unsigned peers = __match_any_sync(
        0xffffffffu, lv ? (unsigned)key[j] : (unsigned)(n_keys + lane));
    int32_t* c = cnt + warp * n_keys + key[j];
    const int before = lv ? *c : 0;
    __syncwarp();
    if (lv && (peers & lower_lanes) == 0u) *c = before + __popc(peers);
    __syncwarp();
    rank[j] = before + __popc(peers & lower_lanes);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_keys; k += blockDim.x) {
    int run = 0;
    for (int w = 0; w < W; ++w) {
      const int v = cnt[w * n_keys + k];
      cnt[w * n_keys + k] = run;
      run += v;
    }
    tot[k] = run;
  }
  __syncthreads();

  if (n_blocks > 1) {
    for (int k = threadIdx.x; k < n_keys; k += blockDim.x)
      sc.agg[(size_t)b * n_keys + k] = tot[k];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) st_release(&sc.status[b], 1);
    // Wait until every earlier block q < b has published (a thread a
    // flag, all at once), then ex[k] = the sum of their agg[q, k], every
    // load independent of the others: rows of threads over q when the
    // streams are fewer than the threads, else a thread a stream.
    for (int q = threadIdx.x; q < b; q += blockDim.x)
      while (ld_acquire(&sc.status[q]) == 0) {}
    __syncthreads();
    if (n_keys <= (int)blockDim.x) {
      const int rows = blockDim.x / n_keys;
      const int k = threadIdx.x % n_keys, row = threadIdx.x / n_keys;
      if (row < rows) {
        int sum = 0;
#pragma unroll 8
        for (int q = row; q < b; q += rows)
          sum += __ldcg(&sc.agg[(size_t)q * n_keys + k]);
        if (sum) atomicAdd(&ex[k], sum);
      }
    } else {
      for (int k = threadIdx.x; k < n_keys; k += blockDim.x) {
        int sum = 0;
#pragma unroll 8
        for (int q = 0; q < b; ++q)
          sum += __ldcg(&sc.agg[(size_t)q * n_keys + k]);
        ex[k] = sum;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      if (atomicAdd(sc.done, 1u) == (unsigned)n_blocks - 1u) {
        for (int q = 0; q < n_blocks; ++q) sc.status[q] = 0;
        *sc.ticket = 0u;
        *sc.done = 0u;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kPlanItems; ++j)
    if ((live >> j) & 1u)
      rank[j] += ex[key[j]] + cnt[warp * n_keys + key[j]];
  const bool last = b == n_blocks - 1;           // sees every block's counts

  if constexpr (!P::kFabric) {
#pragma unroll
    for (int j = 0; j < kPlanItems; ++j) {
      const int t = t0 + j * 32;
      if (t < T) p.write(t, key[j], (live >> j) & 1u, rank[j]);
    }
    if (last)
      for (int k = threadIdx.x; k < n_keys; k += blockDim.x)
        p.total(k, ex[k] + tot[k]);
  } else {
    const int S = p.S;
    __syncthreads();                             // cnt is reused for g
    if (last) {
      // g [src, dst]: granted before capacity; then per dst the capacity
      // verdict in closed form (the WRR slots of a dst's granted packets
      // are 0 .. sum_s g - 1), and the error histogram.
      for (int k = threadIdx.x; k < n_keys; k += blockDim.x) {
        const int n_live = ex[k] + tot[k];
        const int g = kept_of(n_live, p.q_s[k], INT_MAX);
        cnt[k] = g;
        if (n_blocks > 1) sc.granted[k] = g;
        if (n_live) atomicAdd(&acc[1], n_live);
        if (n_live - g) atomicAdd(&acc[2], n_live - g);
      }
      __syncthreads();
      for (int d = threadIdx.x; d < S; d += blockDim.x) {
        int G = 0;
        for (int s = 0; s < S; ++s) G += cnt[s * S + d];
        const int c = max(0, min(G, p.c_s[d]));
        p.counts[d] = c;
        if (c) atomicAdd(&acc[0], c);
        if (G - c) atomicAdd(&acc[3], G - c);
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        p.drops[0] = acc[0];                     // OK
        p.drops[1] = T - acc[1];                 // INVALID_DEST
        p.drops[2] = acc[2];                     // GRANT_TIMEOUT
        p.drops[3] = acc[3];                     // ACK_TIMEOUT
      }
    }
#pragma unroll
    for (int j = 0; j < kPlanItems; ++j) {
      const int t = t0 + j * 32;
      if (t >= T) continue;
      const int code = p.pre(key[j], (live >> j) & 1u, rank[j]);
      if (n_blocks == 1) {
        p.finish(t, key[j], code, rank[j], cnt);
      } else {                                   // finished by finish_kernel
        p.slot[t] = rank[j];
        p.err[t] = code;
      }
    }
  }
}

// The fabric plan's packets once every block's counts are known (several
// blocks only): slot holds the stream rank and err the pre-capacity code.
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(FabricPlan p, const int32_t* __restrict__ granted, int T,
              int n_keys) {
  extern __shared__ int32_t g[];                 // [n_keys], then staged
  p.stage(g + n_keys, n_keys);
  for (int i = threadIdx.x; i < n_keys; i += blockDim.x) g[i] = granted[i];
  __syncthreads();
  const int t0 = blockIdx.x * kFinishThreads * kPlanItems + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kPlanItems; ++j) {
    const int t = t0 + j * kFinishThreads;
    if (t >= T) continue;
    int key;
    p.packet(t, &key);
    p.finish(t, key, p.err[t], p.slot[t], g);
  }
}

// Warps of a plan block, its blocks and its dynamic shared memory, for T
// packets over n_keys streams with at most block_t packets a block.  The
// warps shrink as n_keys grows, so (W + 2) * n_keys ints and the staged
// register entries fit the SM.
struct PlanGrid {
  int warps, blocks;
  size_t smem;
};

inline PlanGrid plan_grid(int T, int n_keys, int staged, int block_t) {
  PlanGrid g{0, 0, 0};
  const int w_max = std::min(
      {kPlanMaxWarps, (kPlanSmemInts - staged) / n_keys - 2,
       std::max(1, block_t / kPlanWarpT)});
  if (w_max < 1) return g;
  const int tile = w_max * kPlanWarpT;
  if (T <= tile) {
    g.blocks = 1;
    g.warps = std::max(1, std::min(w_max, (T + kPlanWarpT - 1) / kPlanWarpT));
  } else {
    g.blocks = (T + tile - 1) / tile;
    g.warps = w_max;
  }
  g.smem = ((size_t)(g.warps + 2) * n_keys + staged) * sizeof(int32_t);
  return g;
}

// One launch of plan_kernel (and, for a fabric plan over several blocks,
// one of finish_kernel).  Returns a cudaError_t, or minus the number of
// blocks, having launched nothing, when a plan over several blocks finds
// less scratch than they need: 2 + blocks flag ints and
// (1 + blocks) * n_keys data ints.
template <class P>
int launch_plan(const P& p, int T, int n_keys, int block_t, void* flags,
                long long flag_ints, void* data, long long data_ints,
                cudaStream_t stream) {
  if (n_keys < 1 || T < 0) return (int)cudaErrorInvalidValue;
  const int staged = P::staged_ints(n_keys, p.S);
  const PlanGrid g = plan_grid(T, n_keys, staged, block_t);
  if (g.blocks == 0) return (int)cudaErrorInvalidValue;
  PlanScratch sc{nullptr, nullptr, nullptr, nullptr, nullptr};
  if (g.blocks > 1) {
    if (flags == nullptr || data == nullptr || flag_ints < 2 + g.blocks ||
        data_ints < (1 + (long long)g.blocks) * n_keys)
      return -g.blocks;
    auto* f = static_cast<int32_t*>(flags);
    sc.ticket = reinterpret_cast<unsigned*>(f);
    sc.done = reinterpret_cast<unsigned*>(f + 1);
    sc.status = f + 2;
    sc.granted = static_cast<int32_t*>(data);
    sc.agg = sc.granted + n_keys;
  }
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        plan_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)g.smem);
    if (e != cudaSuccess) return (int)e;
  }
  plan_kernel<P><<<g.blocks, g.warps * 32, g.smem, stream>>>(p, sc, T, n_keys,
                                                             g.blocks);
  cudaError_t e = cudaGetLastError();
  if constexpr (P::kFabric) {
    if (e == cudaSuccess && g.blocks > 1) {
      const int per = kFinishThreads * kPlanItems;
      finish_kernel<<<(T + per - 1) / per, kFinishThreads,
                      (n_keys + staged) * sizeof(int32_t), stream>>>(
          p, sc.granted, T, n_keys);
      e = cudaGetLastError();
    }
  }
  return (int)e;
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

// Every plan entry takes the plan scratch of its stream: ``flags`` (int32,
// zeroed when it is made; every launch leaves it zeroed) and ``data``
// (int32, any contents), with their lengths; both may be null where a plan
// fits one block.  A plan over B blocks that finds fewer than 2 + B flag
// ints or (1 + B) * n_keys data ints launches nothing and returns -B.  A
// plan block takes at most ``block_t`` packets (kernel.PLAN_BLOCK_T).

// plan_multi.  ``allowed`` [S, S] [src, dst] contiguous, int32
// (``allowed_bytes`` 4) or bool (1); ``quota`` int32 [src, dst] at
// element strides (qs0, qs1), so the register file's quota [dst, src]
// passes as its transpose.  ``out`` int32 [3 T + S * S]: keep, rank and
// err [T], then granted [S, S], each written whole.
int crossbar_plan_multi(const void* dst, const void* src, const void* allowed,
                        int allowed_bytes, const void* quota, int qs0,
                        int qs1, void* out, void* flags,
                        long long flag_ints, void* data, long long data_ints,
                        int T, int S, int block_t,
                        void* stream_ptr) {
  auto* o = static_cast<int32_t*>(out);
  const MultiPlan p{static_cast<const int32_t*>(dst),
                    static_cast<const int32_t*>(src),
                    Reg{allowed, S, 1, allowed_bytes},
                    Reg{quota, qs0, qs1, 4},
                    S, o, o + T, o + 2 * (size_t)T, o + 3 * (size_t)T};
  return launch_plan(p, T, S * S, block_t, flags, flag_ints,
                     data, data_ints, static_cast<cudaStream_t>(stream_ptr));
}

// plan: one source's register rows ``allowed`` (int32 or bool,
// ``allowed_bytes``), ``quota`` and ``capacity`` (int32), contiguous [S].
// ``out`` int32 [3 T + S]: keep, slot and err [T], then counts [S].
int crossbar_plan(const void* dst, const void* allowed, int allowed_bytes,
                  const void* quota, const void* capacity, void* out,
                  void* flags, long long flag_ints, void* data,
                  long long data_ints, int T, int S,
                  int block_t, void* stream_ptr) {
  auto* o = static_cast<int32_t*>(out);
  const SourcePlan p{static_cast<const int32_t*>(dst),
                     Reg{allowed, 0, 1, allowed_bytes}, Reg{quota, 0, 1, 4},
                     Reg{capacity, 0, 1, 4}, S, o, o + T, o + 2 * (size_t)T,
                     o + 3 * (size_t)T};
  return launch_plan(p, T, S, block_t, flags, flag_ints,
                     data, data_ints, static_cast<cudaStream_t>(stream_ptr));
}

// The fabric's plan from its register file as stored, all contiguous:
// ``allowed`` bool [src, dst], ``reset`` bool [S], ``quota`` int32
// [dst, src], ``capacity`` int32 [S] (clamped to the slab depth by the
// caller).  ``out`` holds int32 slot [T], err [T], counts [S] and drops [4],
// then keep as T bytes (torch.bool).  One launch where the plan fits a
// block; else two (plan_kernel, finish_kernel).
int crossbar_plan_fabric(const void* dst, const void* src, const void* allowed,
                         const void* reset, const void* quota,
                         const void* capacity, void* out, void* flags,
                         long long flag_ints, void* data,
                         long long data_ints, int T, int S, int block_t,
                         void* stream_ptr) {
  auto* o = static_cast<int32_t*>(out);
  const FabricPlan p{static_cast<const int32_t*>(dst),
                     static_cast<const int32_t*>(src),
                     static_cast<const uint8_t*>(allowed),
                     static_cast<const uint8_t*>(reset),
                     static_cast<const int32_t*>(quota),
                     static_cast<const int32_t*>(capacity), S,
                     reinterpret_cast<uint8_t*>(o + 2 * (size_t)T + S + 4),
                     o, o + T, o + 2 * (size_t)T, o + 2 * (size_t)T + S};
  return launch_plan(p, T, S * S, block_t, flags, flag_ints,
                     data, data_ints, static_cast<cudaStream_t>(stream_ptr));
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
