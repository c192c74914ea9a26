// Alternative thread mappings of kernel B2's add form
// (acc[qslot[j], ids[j, l]] += contrib[j, l]), kept to time against the
// port's kernel (src/repro_torch/kernels/csrc/accumulate.cu) by
// tools/b2_add_order.py: the flat form with a 64-bit division a lane that
// the port's kernel replaced, a warp per entry loading uint4, and a warp
// per 128 lanes loading uint4 (the fastest where nearly every lane is
// dead).  Each computes the same function; they differ only in which
// thread issues which atomic, and so in the order the updates reach
// memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ void add_at(uint32_t* row, uint32_t col,
                                       uint32_t c, uint32_t width) {
  if (c != 0u && col < width) atomicAdd(row + col, c);
}

// one thread per (entry, lane) from a flat index: a 64-bit division a lane
__global__ void __launch_bounds__(THREADS)
flat_div64(uint32_t* acc, const uint32_t* ids, const int32_t* qslot,
           const uint32_t* contrib, long long n, long long lanes,
           long long rows, long long width) {
  const long long k = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (k >= n * lanes) return;
  const uint32_t c = contrib[k];
  if (c == 0u) return;
  const long long q = qslot[k / lanes];
  const long long col = ids[k];
  if (q < 0 || q >= rows || col >= width) return;
  atomicAdd(acc + q * width + col, c);
}

// one warp per entry, four lanes a thread as uint4: a warp-wide atomic
// spans 128 lanes (lanes % 4 == 0, 16-byte aligned rows)
__global__ void __launch_bounds__(THREADS)
warp_uint4(uint32_t* acc, const uint32_t* ids, const int32_t* qslot,
           const uint32_t* contrib, long long n, int lanes, int rows,
           uint32_t width) {
  const int lane = threadIdx.x & 31;
  const long long j = blockIdx.x * (long long)WARPS + (threadIdx.x >> 5);
  if (j >= n) return;
  const int q = qslot[j];
  if (q < 0 || q >= rows) return;
  uint32_t* row = acc + (size_t)q * width;
  const uint4* c4 = reinterpret_cast<const uint4*>(contrib + (size_t)j * lanes);
  const uint4* i4 = reinterpret_cast<const uint4*>(ids + (size_t)j * lanes);
  for (int g = lane; g < lanes / 4; g += 32) {
    const uint4 c = c4[g];
    if ((c.x | c.y | c.z | c.w) == 0u) continue;
    const uint4 d = i4[g];
    add_at(row, d.x, c.x, width);
    add_at(row, d.y, c.y, width);
    add_at(row, d.z, c.z, width);
    add_at(row, d.w, c.w, width);
  }
}

// one warp per 128 consecutive lanes of one entry: four lanes a thread
// (uint4, and 4 bytes of mask where surv is given), a warp whose lanes add
// nothing stops there, otherwise the lanes go across through shared memory
// and the warp issues its atomics on 32 consecutive lanes at a time
__global__ void __launch_bounds__(THREADS)
warp128_uint4_shared(uint32_t* acc, const uint32_t* ids, const int32_t* qslot,
                     const uint32_t* contrib, const uint8_t* surv,
                     unsigned n_warps, unsigned groups, int lanes, int rows,
                     uint32_t width) {
  __shared__ uint4 sc[WARPS][32], si[WARPS][32];
  const int wib = threadIdx.x >> 5, t = threadIdx.x & 31;
  const unsigned w = blockIdx.x * WARPS + wib;
  if (w >= n_warps) return;
  const unsigned j = w / groups;
  const int l = (int)(w - j * groups) * 128 + 4 * t;
  const size_t k = (size_t)j * lanes + l;
  uint4 c = make_uint4(0u, 0u, 0u, 0u), d = c;
  if (l < lanes) {
    const uint32_t live =
        surv ? *reinterpret_cast<const uint32_t*>(surv + k) : 0xFFFFFFFFu;
    if (live) {
      c = *reinterpret_cast<const uint4*>(contrib + k);
      c.x = (live & 0xFFu) ? c.x : 0u;
      c.y = (live & 0xFF00u) ? c.y : 0u;
      c.z = (live & 0xFF0000u) ? c.z : 0u;
      c.w = (live & 0xFF000000u) ? c.w : 0u;
    }
  }
  const bool any = (c.x | c.y | c.z | c.w) != 0u;
  if (!__ballot_sync(0xFFFFFFFFu, any)) return;
  if (any) d = *reinterpret_cast<const uint4*>(ids + k);
  const int q = qslot[j];
  if (q < 0 || q >= rows) return;
  sc[wib][t] = c;
  si[wib][t] = d;
  __syncwarp();
  uint32_t* row = acc + (size_t)q * width;
  const uint32_t* cs = reinterpret_cast<const uint32_t*>(sc[wib]);
  const uint32_t* is = reinterpret_cast<const uint32_t*>(si[wib]);
#pragma unroll
  for (int step = 0; step < 4; ++step)
    add_at(row, is[32 * step + t], cs[32 * step + t], width);
}

}  // namespace

// variant: 0 flat_div64, 1 warp_uint4, 2 warp128_uint4_shared (the only
// one that reads surv, a (n, lanes) bool mask or null).  Variants 1 and 2
// need lanes % 4 == 0 and aligned rows; the tool gives 512 lanes.
extern "C" int b2_add_variant(int variant, void* acc, const void* ids,
                              const void* qslot, const void* contrib,
                              const void* surv, long long n, long long lanes,
                              long long rows, long long width, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* A = static_cast<uint32_t*>(acc);
  auto* I = static_cast<const uint32_t*>(ids);
  auto* Q = static_cast<const int32_t*>(qslot);
  auto* C = static_cast<const uint32_t*>(contrib);
  switch (variant) {
    case 0:
      flat_div64<<<(unsigned)((n * lanes + THREADS - 1) / THREADS), THREADS, 0,
                   s>>>(A, I, Q, C, n, lanes, rows, width);
      break;
    case 1:
      warp_uint4<<<(unsigned)((n + WARPS - 1) / WARPS), THREADS, 0, s>>>(
          A, I, Q, C, n, (int)lanes, (int)rows, (uint32_t)width);
      break;
    case 2: {
      const unsigned n_warps = (unsigned)(n * ((lanes + 127) / 128));
      warp128_uint4_shared<<<(n_warps + WARPS - 1) / WARPS, THREADS, 0, s>>>(
          A, I, Q, C, static_cast<const uint8_t*>(surv), n_warps,
          (unsigned)((lanes + 127) / 128), (int)lanes, (int)rows,
          (uint32_t)width);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
