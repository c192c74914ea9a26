// Elementwise AND of two bitmap word streams (kernel B10 of the port).
//
// Replaces the JAX package's Pallas kernel kernels/intersect.py
// bitmap_and_tiles (body _and_kernel), which walked (rows_per_block, 128)
// tiles of both bitmaps through VMEM.  Here each thread ANDs one uint4 (4
// words) of each input, so a warp moves 512 contiguous bytes per load and
// store, and a 256-thread block covers 8 rows.  (Measured on the card: a
// grid-stride loop over a grid sized to the SMs, and 2 or 4 uint4 a
// thread, were no faster.)  The words past the last whole uint4 (n need
// not be a multiple of 4) are ANDed by block 0.  The inputs and the output
// are 16-byte aligned (the wrapper checks it).
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
  const long long n4 = n >> 2;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n4) {
    const uint4 x = reinterpret_cast<const uint4*>(a)[i];
    const uint4 y = reinterpret_cast<const uint4*>(b)[i];
    reinterpret_cast<uint4*>(out)[i] =
        make_uint4(x.x & y.x, x.y & y.y, x.z & y.z, x.w & y.w);
  }
  const long long k = (n4 << 2) + threadIdx.x;     // the words past the
  if (blockIdx.x == 0 && k < n) out[k] = a[k] & b[k];   // last whole uint4
}

}  // namespace

// a, b, out: (n,) u32, 16-byte aligned.  Returns cudaGetLastError().
extern "C" int repro_bitmap_and(const void* a, const void* b, void* out,
                                long long n, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || ((reinterpret_cast<uintptr_t>(a) |
                 reinterpret_cast<uintptr_t>(b) |
                 reinterpret_cast<uintptr_t>(out)) & 15u))
    return (int)cudaErrorInvalidValue;
  long long blocks = ((n >> 2) + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;                 // n < 4: the tail alone
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  and_kernel<<<(unsigned)blocks, THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
