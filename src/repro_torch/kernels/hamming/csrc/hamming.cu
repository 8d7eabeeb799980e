// Hamming(31,26) encoder and decoder and the constant multiplier, the
// paper's three computation modules (section V-B), for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/hamming/kernel.py:
// `encode_call`, `decode_call` and `mul_call`, all three through
// `_call_elementwise`, which cut an int32 word stream into (8, 1024) VMEM
// tiles and built each codeword bit by bit with shifts and masks over the
// tile (26 steps to scatter the data bits, xor-halving for parity).
//
// Words are 32-bit patterns; every kernel computes in uint32_t, so shifts
// are logical and the multiply wraps mod 2^32 by definition (the TPU
// kernel's signed int32 multiply would be undefined behaviour in C++).
//
// - Encode: the 26 data bits land at codeword positions in four contiguous
//   runs (data bit 0 -> position 3; bits 1-3 -> 5-7; bits 4-10 -> 9-15;
//   bits 11-25 -> 17-31; position p is bit p-1), so the scatter is four
//   shift-and-mask steps.  Parity bit 2^i is __popc(code & COVER[i]) & 1.
// - Decode: mask to 31 bits, form the syndrome from the five parities,
//   flip bit syndrome-1 where the syndrome is nonzero (a double-bit error
//   is miscorrected exactly as the reference miscorrects it), gather the
//   four runs back, and write the corrected flag.
// - Multiply: x * c in uint32_t.
//
// What bounds them: each reads one word and writes one (decode two), with
// a few integer operations per word, far below the card's integer rate;
// so bytes bound all three: 8 bytes a word for encode and multiply, 12 for
// decode, over 3.35 TB/s.
//
// Design: one thread per 4 words, with 16-byte loads and stores
// (neighbouring threads on neighbouring 16 bytes), and a grid sized to the
// stream: one block per 256 vectors, no loop (2^18 blocks at 2^28 words);
// the last n % 4 words go to the first threads of the grid one word each.
// The wrapper passes 16-byte aligned pointers.  Every launcher returns
// cudaGetLastError().
//
// The launch was chosen on the card (NVIDIA H100 80GB HBM3, 700 W, 2^28
// words, device ms, kernels/hamming/map_bench.py against the grid-stride
// launch it replaced): the earlier grid-stride loop over at most 8192
// blocks took 0.731 against `torch.mul`'s 0.706; the sized grid takes 0.704.
// Issuing 2 or 4 loads a thread before the stores, evict-first hints
// (__ldcs/__stcs) and a persistent grid of SMs x resident blocks were also
// tried and gained nothing over the sized grid.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__constant__ uint32_t kCover[5] = {0x55555555u, 0x66666666u, 0x78787878u,
                                   0x7F807F80u, 0x7FFF8000u};

__device__ __forceinline__ uint32_t parity(uint32_t v) { return __popc(v) & 1u; }

__device__ __forceinline__ uint32_t encode_word(uint32_t d) {
  uint32_t code = ((d & 0x1u) << 2)             // data bit 0 -> position 3
                  | (((d >> 1) & 0x7u) << 4)    // bits 1-3   -> 5-7
                  | (((d >> 4) & 0x7Fu) << 8)   // bits 4-10  -> 9-15
                  | (((d >> 11) & 0x7FFFu) << 16);  // bits 11-25 -> 17-31
#pragma unroll
  for (int i = 0; i < 5; ++i) code |= parity(code & kCover[i]) << ((1 << i) - 1);
  return code;
}

struct Decoded {
  uint32_t data, corrected;
};

__device__ __forceinline__ Decoded decode_word(uint32_t code) {
  code &= 0x7FFFFFFFu;
  uint32_t syndrome = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) syndrome |= parity(code & kCover[i]) << i;
  const uint32_t fixed = syndrome ? code ^ (1u << (syndrome - 1u)) : code;
  const uint32_t data = ((fixed >> 2) & 0x1u) | (((fixed >> 4) & 0x7u) << 1) |
                        (((fixed >> 8) & 0x7Fu) << 4) |
                        (((fixed >> 16) & 0x7FFFu) << 11);
  return {data, syndrome != 0u ? 1u : 0u};
}

struct Encode {
  __device__ uint32_t operator()(uint32_t w) const { return encode_word(w); }
};

struct Multiply {
  uint32_t c;
  __device__ uint32_t operator()(uint32_t w) const { return w * c; }
};

template <typename Op>
__device__ __forceinline__ uint4 apply4(uint4 v, const Op& f) {
  return make_uint4(f(v.x), f(v.y), f(v.z), f(v.w));
}

// One output word per input word: encode and multiply.
template <typename Op>
__global__ void __launch_bounds__(kThreads)
map_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
           long long n, Op op) {
  const long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (v < n / 4)
    reinterpret_cast<uint4*>(out)[v] =
        apply4(reinterpret_cast<const uint4*>(x)[v], op);
  const long long t = n / 4 * 4 + v;            // masked tail: n % 4 words
  if (t < n) out[t] = op(x[t]);
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ data,
              uint32_t* __restrict__ corrected, long long n) {
  const long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (v < n / 4) {
    const uint4 w = reinterpret_cast<const uint4*>(x)[v];
    const Decoded a = decode_word(w.x), b = decode_word(w.y),
                  c = decode_word(w.z), d = decode_word(w.w);
    reinterpret_cast<uint4*>(data)[v] =
        make_uint4(a.data, b.data, c.data, d.data);
    reinterpret_cast<uint4*>(corrected)[v] =
        make_uint4(a.corrected, b.corrected, c.corrected, d.corrected);
  }
  const long long t = n / 4 * 4 + v;
  if (t < n) {
    const Decoded r = decode_word(x[t]);
    data[t] = r.data;
    corrected[t] = r.corrected;
  }
}

// One block per kThreads vectors; at least one, for the tail of a stream
// shorter than one vector.
int n_blocks(long long n) {
  const long long want = (n / 4 + kThreads - 1) / kThreads;
  return (int)(want < 1 ? 1 : want);
}

}  // namespace

extern "C" {

int hamming_encode(const void* x, void* out, long long n, void* stream_ptr) {
  map_kernel<Encode><<<n_blocks(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n,
      Encode{});
  return (int)cudaGetLastError();
}

int hamming_decode(const void* x, void* data, void* corrected, long long n,
                   void* stream_ptr) {
  decode_kernel<<<n_blocks(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(data),
      static_cast<uint32_t*>(corrected), n);
  return (int)cudaGetLastError();
}

// ``constant`` is the multiplier reduced mod 2^32.
int hamming_mul(const void* x, void* out, long long n, unsigned int constant,
                void* stream_ptr) {
  map_kernel<Multiply><<<n_blocks(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n,
      Multiply{constant});
  return (int)cudaGetLastError();
}

}  // extern "C"
