// RG-LRU diagonal linear recurrence, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `rglru_call` (`_rglru_kernel`) of
// src/repro/kernels/rglru/kernel.py:  h_t = a_t * h_{t-1} + b_t over
// [B, S, L] (contiguous), h_last [B, L] float32.  Two entry points share
// one kernel template:
//
// - `rglru_fwd`: the TPU kernel's float32 contract.  a, b float32 in, h and
//   h_last float32 out, from a zero state; the caller prefolds the gated
//   input and any initial state.
// - `rglru_scan`: the model's entry (ops.py `rglru_scan_kernel`).  a float32,
//   the gated input u in its own type (bfloat16 or float32), an optional
//   initial state h0 [B, L] float32, h written in u's type, h_last float32.
//   h0 is folded into the first step as b_0 = a_0 * h0 + b_0 with two
//   roundings (__fmul_rn, __fadd_rn), as the fold-then-scan route computes
//   it, and h is the float32 carry rounded once to u's type, as
//   `h.to(u.dtype)` rounds it; so the entry equals `rglru_fwd` on the
//   folded float32 input followed by the cast, bit for bit.  Given a
//   `carries` buffer it also writes each tile's incoming float32 carry
//   ([B, ceil(S / kSteps), L], a sixteenth of h) for the backward.
// - `rglru_scan_bwd`: the gradient of `rglru_scan` (below).
//
// What bounds it: one FMA per element against 12 bytes moved for the float32
// contract (a, b read, h written) and 8 for the model's types (a float32,
// u and h bfloat16), so memory bounds it: at RecurrentGemma-9B's width
// (L = 4096) and S = 32768, 1.61 GB or 0.481 ms at 3.35 TB/s, and 1.07 GB or
// 0.320 ms.  The entry used to convert u to float32, fold h0 with a
// `torch.cat` and convert h back: 24 bytes an element in three passes.
//
// Design: a block takes 32 channels (one per lane, so a warp reads a
// 128-byte row of a) and the whole sequence, cut into tiles of kSteps steps.
// Its kWarps warps take the tiles in turn (warp w: tiles w, w + kWarps,
// ...), so each SM holds kWarps tiles of loads in flight: 32 warps x 16
// steps x 2 rows, 128 KB at L = 4096, where the HBM rate needs some 20 KB.
// A warp loads its tile into registers and, before it knows its carry,
// reduces the tile to the affine map h -> A h + B (A the product of the
// decays, B the tile's scan from a zero state).  The carry then passes
// from warp to warp through shared memory: tile k waits for tile k - 1's
// outgoing carry c_{k-1}, publishes c_k = A_k c_{k-1} + B_k (one FMA, so
// the chain costs one shared-memory hop a tile), then runs its steps
// sequentially from c_{k-1} and writes h.  Every carry is composed in the
// order of the tiles, so two calls give the same bits; within a tile the
// sum is the sequential order, and across tiles it differs from the
// sequential oracle only by the rounding of the (A, B) composition.  One
// block a channel group keeps the carry inside the SM: no workspace, no
// flags in device memory, no memset, one launch a call; B * ceil(L / 32)
// blocks of one per SM (128 at B = 1, L = 4096, on 132 SMs).  a, b and h
// stream through once (evict-first loads and stores).
//
// On the card (NVIDIA H100 80GB HBM3, 700 W; kernels/rglru/scan_bench.py,
// B = 1, S = 32768, L = 4096, device ms): `rglru_fwd` 0.576-0.589 (82-84% of
// its bound; one thread per channel walking the whole sequence took 1.59),
// the bfloat16 entry 0.407-0.416 (77-79%; with the conversions and the fold
// around the float32 kernel it took 2.27, in three kernels).  Of the tile
// shapes tried (8 to 64 steps, 8 to 32 warps), 16 steps x 32 warps was the
// fastest for bfloat16 u and close to the fastest for float32, so it is
// the one shape built.  Handing the carry on in per-lane 64-bit words
// tagged with the tile, with no flag and no fence, was slower: each lane
// spun on its own word, apart from its warp.
//
// Backward (`rglru_bwd_kernel`, no TPU kernel: XLA differentiated the jnp
// scan).  For the cotangents dh (u's type) and dh_last (float32):
//
//   g_t  = dh_t + a_{t+1} g_{t+1}     (g_{S-1} = dh_{S-1} + dh_last)
//   du_t = g_t (u's type);  da_t = g_t h_{t-1} (float32, h_{-1} = h0);
//   dh0  = a_0 g_0
//
// da needs the float32 h that the forward carried, not the bf16 h it
// wrote: the forward saves each tile's incoming carry, and the backward
// recomputes the tile's h from it with the forward's own FMAs, so its h is
// the forward's float32 h bit for bit.  g is the same scan run backward in
// time.  What bounds it: memory, 14 bytes an element for bf16 u (a, u, dh
// read; du, da written) plus the carries: at L = 4096, S = 4096 some
// 0.25 GB, 0.0714 ms at 3.35 TB/s.  A block per channel group walking the
// whole sequence (the forward's design) gives 128 blocks at L = 4096, each
// warp holding one tile of loads at a time and waiting on a chain of 256
// hand-overs: 0.122-0.124 ms on the card.  So the backward also cuts the
// sequence into chunks of kBwdChunkTiles tiles across blocks (256 steps,
// 16 chunks, 2,048 blocks at the train shape, two an SM), and runs each in
// three phases: every warp issues the loads of all its kBwdTpw tiles at once
// and reduces each tile to its map x -> A x + B of the gradient arriving
// from the right (A the product of the decays, B = a_{t0} g_{t0} from
// x = 0); warp 0 takes the chunk's incoming carry and composes it through
// the maps in the order of the tiles (one FMA a tile, as the warps'
// hand-over did), keeping each tile's incoming x; then every warp writes
// its tiles' du and da.  The carry passes from a chunk to the one before
// it through a 64-bit word in device memory, its float32 value tagged with
// the call's epoch, so the words are never cleared; the blocks are
// numbered in the chain's order, so a block waits only on blocks with a
// lower index, dispatched before it.  Every carry is the same FMA of the
// same operands in the same order as a tile-by-tile walk, so the outputs
// do not depend on the chunk size, and two calls give the same bits; no
// atomics, one launch.  On the card (H100, 700 W; flash_attention/
// bwd_bench.py): 0.094-0.096 ms of device time at the train shape, 74-76%
// of the bound (trial builds with chunks of 8 tiles: 0.094-0.095; of 32
// tiles, one block an SM: 0.117-0.120).  The epoch comes from the host
// with each launch, so a launch captured in a CUDA graph would replay one
// epoch and could read a carry of the replay before: the wrapper refuses
// to be captured.
//
// Every entry returns the `cudaError_t` of its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kSteps = 16;     // steps a tile
constexpr int kWarps = 32;     // tiles in flight a block
constexpr int kThreads = 32 * kWarps;
constexpr int kBwdWarps = 8;   // backward: warps a block
constexpr int kBwdTpw = 2;     // tiles a warp
constexpr int kBwdChunkTiles = kBwdWarps * kBwdTpw;   // tiles a block (a chunk)
constexpr int kBwdThreads = 32 * kBwdWarps;

__device__ __forceinline__ float load(const float* p) { return __ldcs(p); }

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcs(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ void store(float* p, float v) { __stcs(p, v); }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p),
         __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// grid (ceil(L / 32), B); block kThreads.  b and h in TB and TH; h0 may be
// null (a zero state); carries may be null (not saved).
template <typename TB, typename TH>
__global__ void __launch_bounds__(kThreads, 1)
rglru_kernel(const float* __restrict__ a, const TB* __restrict__ b,
             const float* __restrict__ h0, TH* __restrict__ h,
             float* __restrict__ h_last, float* __restrict__ carries, int S, int L) {
  __shared__ float carry_out[kWarps][32];   // c_k of each warp's last tile
  __shared__ int published[kWarps];         // the tile whose c_k is there
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int l = blockIdx.x * 32 + lane;
  const bool live = l < L;
  const size_t batch_rows = (size_t)blockIdx.y * S;
  const size_t state = (size_t)blockIdx.y * L + l;
  if (lane == 0) published[warp] = -1;
  __syncthreads();
  volatile int* pub = published;
  volatile float* carries_sm = &carry_out[0][0];
  const int prev = (warp + kWarps - 1) % kWarps;
  const int n_tiles = (S + kSteps - 1) / kSteps;
  if (S == 0 && warp == 0 && live) h_last[state] = h0 ? h0[state] : 0.f;

  for (int k = warp; k < n_tiles; k += kWarps) {
    const int n = min(kSteps, S - k * kSteps);
    const size_t base = (batch_rows + (size_t)k * kSteps) * L + l;
    float av[kSteps], bv[kSteps];
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      const bool in = live && t < n;
      av[t] = in ? load(a + base + (size_t)t * L) : 1.f;
      bv[t] = in ? load(b + base + (size_t)t * L) : 0.f;
    }
    if (k == 0 && h0 != nullptr && live)
      bv[0] = __fadd_rn(__fmul_rn(av[0], h0[state]), bv[0]);
    // the tile as an affine map of its incoming carry: h -> A h + B
    float A = 1.f, B = 0.f;
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      if (t < n) {
        A = __fmul_rn(A, av[t]);
        B = __fmaf_rn(av[t], B, bv[t]);
      }
    }
    float carry = 0.f;
    if (k > 0) {
      while (pub[prev] != k - 1) {
      }
      __threadfence_block();
      carry = carries_sm[prev * 32 + lane];
    }
    carries_sm[warp * 32 + lane] = __fmaf_rn(A, carry, B);
    __threadfence_block();
    __syncwarp();
    if (lane == 0) pub[warp] = k;
    if (carries != nullptr && live)
      carries[((size_t)blockIdx.y * n_tiles + k) * L + l] = carry;

    float hv = carry;
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      if (t < n) {
        hv = __fmaf_rn(av[t], hv, bv[t]);
        if (live) store(h + base + (size_t)t * L, hv);
      }
    }
    if (k == n_tiles - 1 && live) h_last[state] = hv;
  }
}

template <typename TB, typename TH>
int launch(const float* a, const TB* b, const float* h0, TH* h,
           float* h_last, float* carries, int B, int S, int L, void* stream) {
  const dim3 grid((L + 31) / 32, B);
  rglru_kernel<TB, TH><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h0, h, h_last, carries, S, L);
  return (int)cudaGetLastError();
}

// Step t + 1 of a tile, kept inside the tile's registers (t < n - 1 there
// whenever it is read).
__device__ __forceinline__ constexpr int next(int t) { return t + 1 < kSteps ? t + 1 : t; }

// A value as loaded, before its conversion to float32, so that a tile's
// loads stay in flight until the tile's turn.
template <typename T> struct Raw { using type = float; };
template <> struct Raw<__nv_bfloat16> { using type = unsigned short; };

__device__ __forceinline__ float load_raw(const float* p) { return __ldcs(p); }
__device__ __forceinline__ unsigned short load_raw(const __nv_bfloat16* p) {
  return __ldcs(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(unsigned short x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}

// One tile of the backward's inputs (a, u, dh and the forward's carry into
// the tile), loaded before the tile's turn.
template <typename T>
struct BwdTile {
  float a[kSteps];
  typename Raw<T>::type u[kSteps], g[kSteps];
  float carry;
};

template <typename T>
__device__ __forceinline__ void load_bwd_tile(BwdTile<T>& x, const float* a, const T* u,
                                              const T* dh, const float* carries, size_t base,
                                              size_t carry_at, int n, bool live, bool has_carry,
                                              int L) {
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    const bool in = live && t < n;
    x.a[t] = in ? load_raw(a + base + (size_t)t * L) : 1.f;
    x.u[t] = in ? load_raw(u + base + (size_t)t * L) : typename Raw<T>::type(0);
    x.g[t] = in ? load_raw(dh + base + (size_t)t * L) : typename Raw<T>::type(0);
  }
  x.carry = has_carry && live ? __ldcs(carries + carry_at) : 0.f;
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" : : "l"(p), "l"(v) : "memory");
}

// grid (n_chunks * B * ceil(L / 32)), block kBwdThreads.  Block i takes
// chunk n_chunks - 1 - i / (B * groups), of kBwdChunkTiles tiles, of
// channel group i % (B * groups), so a block waits only on blocks with a
// lower index.  u, dh and du in T; h0, dh_last and dh0 may be null (no
// initial state, a zero cotangent, none wanted); carries is the forward's.
// slots: [n_chunks, B * groups, 32] 64-bit words, a chunk's outgoing carry
// tagged with `epoch` (this call's).
//
// Three phases: every warp loads its kBwdTpw tiles (all loads in flight at
// once) and reduces each to its map x -> A x + B; warp 0 takes the carry
// of the chunk to the right and runs it through the chunk's maps in the
// order of the tiles (one FMA a tile, as the warps' hand-over did), keeping
// each tile's incoming gradient and publishing the chunk's outgoing carry;
// then every warp writes its tiles' du and da.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 2)
rglru_bwd_kernel(const float* __restrict__ a, const T* __restrict__ u,
                 const float* __restrict__ h0, const T* __restrict__ dh,
                 const float* __restrict__ dh_last, const float* __restrict__ carries,
                 T* __restrict__ du, float* __restrict__ da, float* __restrict__ dh0,
                 unsigned long long* __restrict__ slots, unsigned epoch, int S, int L,
                 int n_chunks) {
  constexpr int CT = kBwdChunkTiles;
  __shared__ float map_a[CT][32], map_b[CT][32], x_in[CT][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = (L + 31) / 32;
  const int lanes = gridDim.x / n_chunks;     // B * groups
  const int bg = blockIdx.x % lanes, chunk = n_chunks - 1 - (int)blockIdx.x / lanes;
  const int batch = bg / groups;
  const int l = (bg % groups) * 32 + lane;
  const bool live = l < L;
  const size_t batch_rows = (size_t)batch * S;
  const size_t state = (size_t)batch * L + l;
  const int n_tiles = (S + kSteps - 1) / kSteps;
  const int k_hi = min((chunk + 1) * CT, n_tiles);
  const int nt = k_hi - chunk * CT;

  // rank r: the r-th tile of the chunk from its end, k = k_hi - 1 - r;
  // warp w takes ranks w, w + kBwdWarps, ...
  BwdTile<T> tile[kBwdTpw];
#pragma unroll
  for (int i = 0; i < kBwdTpw; ++i) {
    const int r = warp + i * kBwdWarps, k = k_hi - 1 - r;
    if (r < nt)
      load_bwd_tile(tile[i], a, u, dh, carries, (batch_rows + (size_t)k * kSteps) * L + l,
                    ((size_t)batch * n_tiles + k) * L + l, min(kSteps, S - k * kSteps), live,
                    k > 0, L);
  }
  // each tile as a map of the gradient x arriving from the right:
  // a_{t0} g_{t0} = A x + B
#pragma unroll
  for (int i = 0; i < kBwdTpw; ++i) {
    const int r = warp + i * kBwdWarps, k = k_hi - 1 - r;
    if (r >= nt) continue;
    const int n = min(kSteps, S - k * kSteps);
    float A = 1.f, G = 0.f;
#pragma unroll
    for (int t = kSteps - 1; t >= 0; --t) {
      if (t < n) {
        A = __fmul_rn(A, tile[i].a[t]);
        G = t == n - 1 ? to_f32(tile[i].g[t])
                       : __fmaf_rn(tile[i].a[next(t)], G, to_f32(tile[i].g[t]));
      }
    }
    map_a[r][lane] = A;
    map_b[r][lane] = __fmul_rn(tile[i].a[0], G);
  }
  __syncthreads();
  if (warp == 0) {
    float x = 0.f;
    if (chunk < n_chunks - 1) {
      // the carry of the chunk to the right, from a block before this one
      const unsigned long long* slot = slots + ((size_t)(chunk + 1) * lanes + bg) * 32 + lane;
      unsigned long long w;
      do {
        w = ld_relaxed(slot);
      } while ((unsigned)(w >> 32) != epoch);
      x = __uint_as_float((unsigned)w);
    } else if (dh_last != nullptr && live) {
      x = dh_last[state];
    }
#pragma unroll
    for (int r = 0; r < CT; ++r) {
      if (r < nt) {
        x_in[r][lane] = x;
        x = __fmaf_rn(map_a[r][lane], x, map_b[r][lane]);
      }
    }
    if (chunk > 0)
      st_relaxed(slots + ((size_t)chunk * lanes + bg) * 32 + lane,
                 ((unsigned long long)epoch << 32) | __float_as_uint(x));
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kBwdTpw; ++i) {
    const int r = warp + i * kBwdWarps, k = k_hi - 1 - r;
    if (r >= nt) continue;
    const int n = min(kSteps, S - k * kSteps);
    const size_t base = (batch_rows + (size_t)k * kSteps) * L + l;
    const BwdTile<T>& c = tile[i];
    // the forward's h within the tile, from its saved carry: hp[t] = h_{t-1}
    float hp[kSteps];
    float hv = c.carry;
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      float bv = to_f32(c.u[t]);
      if (t == 0 && k == 0 && h0 != nullptr && live) {
        bv = __fadd_rn(__fmul_rn(c.a[0], h0[state]), bv);
        hp[0] = h0[state];
      } else {
        hp[t] = hv;
      }
      if (t < n) hv = __fmaf_rn(c.a[t], hv, bv);
    }
    const float x = x_in[r][lane];
    float g = x;
#pragma unroll
    for (int t = kSteps - 1; t >= 0; --t) {
      if (t < n) {
        const float gt = to_f32(c.g[t]);
        g = t == n - 1 ? __fadd_rn(gt, x) : __fmaf_rn(c.a[next(t)], g, gt);
        if (live) {
          store(du + base + (size_t)t * L, g);
          store(da + base + (size_t)t * L, __fmul_rn(g, hp[t]));
        }
      }
    }
    if (k == 0 && dh0 != nullptr && live) dh0[state] = __fmul_rn(c.a[0], g);
  }
}

template <typename T>
int launch_bwd(const float* a, const T* u, const float* h0, const T* dh, const float* dh_last,
               const float* carries, T* du, float* da, float* dh0, unsigned long long* slots,
               unsigned epoch, int B, int S, int L, void* stream) {
  const int n_tiles = (S + kSteps - 1) / kSteps;
  const int n_chunks = (n_tiles + kBwdChunkTiles - 1) / kBwdChunkTiles;
  const int blocks = n_chunks * B * ((L + 31) / 32);
  if (blocks == 0) return 0;
  rglru_bwd_kernel<T><<<blocks, kBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, u, h0, dh, dh_last, carries, du, da, dh0, slots, epoch, S, L, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Steps a tile, for the tests that cut sequences at the tile edges.
int rglru_tile_steps() { return kSteps; }

// Tiles a chunk of the backward, which sizes its carry words.
int rglru_bwd_chunk_tiles() { return kBwdChunkTiles; }

int rglru_fwd(const float* a, const float* b, float* h, float* h_last, int B,
              int S, int L, void* stream) {
  return launch<float, float>(a, b, nullptr, h, h_last, nullptr, B, S, L, stream);
}

// u and h are bfloat16 when `u_bf16` is 1, float32 when it is 0; h0 may be
// null; carries may be null (not saved).
int rglru_scan(const float* a, const void* u, const float* h0, void* h,
               float* h_last, float* carries, int B, int S, int L, int u_bf16,
               void* stream) {
  if (u_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        a, static_cast<const __nv_bfloat16*>(u), h0,
        static_cast<__nv_bfloat16*>(h), h_last, carries, B, S, L, stream);
  return launch<float, float>(a, static_cast<const float*>(u), h0,
                              static_cast<float*>(h), h_last, carries, B, S, L, stream);
}

// The gradient of `rglru_scan`: u, dh and du in u's type (`u_bf16` as
// above); a, carries and da float32; h0, dh_last and dh0 float32 or null.
// The sequence is cut into chunks of rglru_bwd_chunk_tiles() tiles, one
// block each per channel group; `slots` holds n_chunks * B * ceil(L / 32)
// * 32 64-bit words, which only words tagged with `epoch` are read from, so
// they need no clearing between calls as long as each call takes a new
// epoch.
int rglru_scan_bwd(const float* a, const void* u, const float* h0, const void* dh,
                   const float* dh_last, const float* carries, void* du, float* da,
                   float* dh0, void* slots, unsigned epoch, int B, int S, int L,
                   int u_bf16, void* stream) {
  using bf16 = __nv_bfloat16;
  auto* sl = static_cast<unsigned long long*>(slots);
  if (u_bf16)
    return launch_bwd<bf16>(a, static_cast<const bf16*>(u), h0, static_cast<const bf16*>(dh),
                            dh_last, carries, static_cast<bf16*>(du), da, dh0, sl, epoch, B, S,
                            L, stream);
  return launch_bwd<float>(a, static_cast<const float*>(u), h0, static_cast<const float*>(dh),
                           dh_last, carries, static_cast<float*>(du), da, dh0, sl, epoch, B, S,
                           L, stream);
}

}  // extern "C"
