// Timing harness of the plan's prefix pass (pass 2 of crossbar_dispatch.cu),
// built by prefix_bench.py and loaded by nothing else.  It includes
// crossbar_dispatch.cu for its prefix kernel and adds the design that kernel
// replaced, so that one build times them side by side:
//
//   variant 0  serial: one thread per stream walks the token blocks in
//              order, over a [block, stream] layout (coalesced across
//              streams, one dependent load per block);
//   variant 1  one block of kScanThreads threads per stream;
//   variant 2  one block per stream of scan_threads(n_blocks) threads, as
//              the library launches it.

#include "crossbar_dispatch.cu"

namespace {

__global__ void plan_prefix_serial_kernel(int32_t* __restrict__ hist,
                                          int n_blocks, int n_keys) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_keys) return;
  int32_t run = 0;
  for (int b = 0; b < n_blocks; ++b) {
    const int32_t c = hist[(size_t)b * n_keys + p];
    hist[(size_t)b * n_keys + p] = run;
    run += c;
  }
}

}  // namespace

extern "C" {

// ``reps`` prefix passes of one variant, back to back on ``stream``, in
// place over ``hist`` ([n_keys, n_blocks], or [n_blocks, n_keys] for the
// serial variant).
int prefix_bench(void* hist, int n_keys, int n_blocks, int variant, int reps,
                 void* stream_ptr) {
  int32_t* h = static_cast<int32_t*>(hist);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  for (int r = 0; r < reps; ++r) {
    if (variant == 0) {
      plan_prefix_serial_kernel<<<(n_keys + 255) / 256, 256, 0, stream>>>(
          h, n_blocks, n_keys);
    } else {
      const int threads = variant == 1 ? kScanThreads : scan_threads(n_blocks);
      plan_prefix_kernel<<<n_keys, threads, 0, stream>>>(h, n_blocks);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
