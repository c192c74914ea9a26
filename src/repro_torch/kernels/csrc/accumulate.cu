// Segmented accumulate: the scatter half of every device-resident round.
// Kernel B2 of the port (both forms) and kernel B4 (the dense window add).
//
// Replaces the JAX package's Pallas kernel kernels/accumulate.py
// _sparse_pallas (body _sparse_kernel), behind scatter_add and scatter_bits:
//   add form:   acc[qslot[j], ids[j, l]] += contrib[j, l]          (mod 2**32)
//   bits form:  bm[qslot[j], ids[j, l] >> 5] |= 1 << (ids[j, l] & 31)
//               where surv[j, l]
//
// The TPU form sorted entries by qslot and kept the owning query's row
// aliased in VMEM across consecutive grid steps, because its grid runs in
// order on one core.  Here every (entry, lane) is one thread and the update
// is one atomic: atomicAdd on unsigned int wraps mod 2**32 exactly like the
// reference's u32 add, and atomicOr sets the survivor bit.  No sort, no
// row residency.
//
// The bits form ORs into the caller's bitmap in place.  The reference ORs a
// freshly zeroed scatter into it (intersect_rounds.py round_accumulate,
// accumulate.py scatter_bits); the result is the same because the docid sets
// of one round's calls are disjoint, and in place saves a zero-fill of the
// whole (queries, words) bitmap per call (806 MB for 256 queries at GOV2's
// 25,205,179 docs).
//
// Out-of-range rows or columns are dropped, as the reference's XLA scatter
// drops them.
//
// Bound on the H100: bytes.  Each thread reads one id (4 B), one mask byte
// or contribution (1 or 4 B) and its entry's qslot, and does one
// read-modify-write of one 4-byte word in L2; there is no arithmetic to
// speak of.  Consecutive lanes of an entry hold ascending docids of one
// block, so a warp's atomics fall on few words.
//
// B4 (dense_add) replaces the JAX package's Pallas kernel
// kernels/accumulate.py _dense_pallas (body _dense_kernel):
//   acc[qslot[j], col0[j] : col0[j] + 4096] += codes[j]    where act[j]
// The TPU form sorted entries by qslot, held the query's row in VMEM across
// consecutive grid steps and relied on the grid running in order.  A GPU
// grid has neither, and two entries of one query can overlap in columns
// within one call: a dense window starts at its first docid's word rounded
// down to a 4-word phase and clamped at the end of the bitmap, so
// consecutive dense blocks of one term can share words.  Their non-zero
// codes never share a docid, but a plain read-modify-write of the shared
// columns would race; so every non-zero code is one atomicAdd (unsigned,
// wrapping mod 2**32 like the reference's u32 add) and zeros are skipped.
// One thread block per entry; each thread loads 16-byte vectors of codes.
// Bound on the H100: bytes: 16 KB of codes per active entry, its 9 B of
// indices, and one 4-byte read-modify-write per distinct touched word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
scatter_bits_kernel(uint32_t* __restrict__ bm, const uint32_t* __restrict__ ids,
                    const int32_t* __restrict__ qslot,
                    const uint8_t* __restrict__ surv, long long n_entries,
                    long long lanes, long long n_rows, long long words) {
  const long long k = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (k >= n_entries * lanes || !surv[k]) return;
  const long long q = qslot[k / lanes];
  const uint32_t id = ids[k];
  const long long word = id >> 5;
  if (q < 0 || q >= n_rows || word >= words) return;
  atomicOr(bm + q * words + word, 1u << (id & 31u));
}

__global__ void __launch_bounds__(THREADS)
scatter_add_kernel(uint32_t* __restrict__ acc, const uint32_t* __restrict__ ids,
                   const int32_t* __restrict__ qslot,
                   const uint32_t* __restrict__ contrib, long long n_entries,
                   long long lanes, long long n_rows, long long width) {
  const long long k = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (k >= n_entries * lanes) return;
  const uint32_t c = contrib[k];
  if (c == 0u) return;                      // adds nothing: skip the atomic
  const long long q = qslot[k / lanes];
  const long long col = ids[k];
  if (q < 0 || q >= n_rows || col >= width) return;
  atomicAdd(acc + q * width + col, c);
}

constexpr int WINDOW = 4096;           // dense score window: 128 words * 32

__global__ void __launch_bounds__(THREADS)
dense_add_kernel(uint32_t* __restrict__ acc, const uint4* __restrict__ codes,
                 const int32_t* __restrict__ qslot,
                 const int32_t* __restrict__ col0,
                 const uint8_t* __restrict__ act, long long n_rows,
                 long long width) {
  const long long j = blockIdx.x;
  if (!act[j]) return;
  const long long q = qslot[j];
  const long long c0 = col0[j];
  // a window outside the accumulator is a caller bug: stop the kernel with
  // an error the next synchronisation reports, never write stray memory
  if (q < 0 || q >= n_rows || c0 < 0 || c0 + WINDOW > width) __trap();
  uint32_t* row = acc + q * width + c0;
  const uint4* src = codes + j * (WINDOW / 4);
  for (int v = threadIdx.x; v < WINDOW / 4; v += THREADS) {
    const uint4 c = src[v];
    uint32_t* dst = row + 4 * v;
    if (c.x) atomicAdd(dst, c.x);
    if (c.y) atomicAdd(dst + 1, c.y);
    if (c.z) atomicAdd(dst + 2, c.z);
    if (c.w) atomicAdd(dst + 3, c.w);
  }
}

unsigned grid_for(long long n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

}  // namespace

// bm: (n_rows, words) u32, updated in place; ids: (n_entries, lanes) u32;
// qslot: (n_entries,) i32; surv: (n_entries, lanes) bool bytes.
extern "C" int repro_scatter_bits(void* bm, const void* ids, const void* qslot,
                                  const void* surv, long long n_entries,
                                  long long lanes, long long n_rows,
                                  long long words, void* stream) {
  const long long n = n_entries * lanes;
  if (n <= 0) return 0;
  if ((n + THREADS - 1) / THREADS > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  scatter_bits_kernel<<<grid_for(n), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(bm), static_cast<const uint32_t*>(ids),
      static_cast<const int32_t*>(qslot), static_cast<const uint8_t*>(surv),
      n_entries, lanes, n_rows, words);
  return (int)cudaGetLastError();
}

// acc: (n_rows, width) u32, updated in place; ids, contrib:
// (n_entries, lanes) u32; qslot: (n_entries,) i32.
extern "C" int repro_scatter_add(void* acc, const void* ids, const void* qslot,
                                 const void* contrib, long long n_entries,
                                 long long lanes, long long n_rows,
                                 long long width, void* stream) {
  const long long n = n_entries * lanes;
  if (n <= 0) return 0;
  if ((n + THREADS - 1) / THREADS > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  scatter_add_kernel<<<grid_for(n), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(acc), static_cast<const uint32_t*>(ids),
      static_cast<const int32_t*>(qslot), static_cast<const uint32_t*>(contrib),
      n_entries, lanes, n_rows, width);
  return (int)cudaGetLastError();
}

// acc: (n_rows, width) u32, updated in place; codes: (n_entries, 4096) u32,
// 16-byte aligned; qslot, col0: (n_entries,) i32; act: (n_entries,) bool
// bytes.
extern "C" int repro_dense_add(void* acc, const void* codes, const void* qslot,
                               const void* col0, const void* act,
                               long long n_entries, long long n_rows,
                               long long width, void* stream) {
  if (n_entries <= 0) return 0;
  if (n_entries > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  dense_add_kernel<<<(unsigned)n_entries, THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(acc), static_cast<const uint4*>(codes),
      static_cast<const int32_t*>(qslot), static_cast<const int32_t*>(col0),
      static_cast<const uint8_t*>(act), n_rows, width);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
