// Elementwise AND of two bitmap word streams (kernel B10 of the port).
//
// Replaces the JAX package's Pallas kernel kernels/intersect.py
// bitmap_and_tiles (body _and_kernel), which walked (rows_per_block, 128)
// tiles of both bitmaps through VMEM.  Here one thread per word: a 256-thread
// block covers two 128-lane rows, so every load and store of a warp is one
// coalesced 128-byte segment.
//
// Bound on the H100: bytes.  Two words read and one written per word of the
// bitmap; one AND each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
and_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
           uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n) out[i] = a[i] & b[i];
}

}  // namespace

// a, b, out: (n,) u32.  Returns cudaGetLastError().
extern "C" int repro_bitmap_and(const void* a, const void* b, void* out,
                                long long n, void* stream) {
  if (n == 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (n < 0 || blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  and_kernel<<<(unsigned)blocks, THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
