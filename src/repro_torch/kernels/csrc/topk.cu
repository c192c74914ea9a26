// Score-column unpack for the fused ranked rounds (kernel B3 of the port).
//
// Replaces the JAX package's Pallas kernel kernels/topk.py unpack_codes
// (body _unpack_kernel): the (1, 128) packed score words of the work-list
// entry's block, at arena row slots[i], become (4, 128) u8 codes; row r of
// the output takes byte r of every word, so value r*128 + l of the block
// lands at output row 4i + r, lane l (the linear order of the docid rows B1
// writes for the same entry).
//
// On the TPU each grid step DMA'd one slot's row into VMEM, chosen by a
// scalar-prefetched slot array.  Here one thread block of 128 threads
// serves one entry, one thread per lane: it loads its own slot, reads one
// word and writes four.  It stays a separate launch from B1 although it runs
// on the same slots right after it; fusing the two waits for a measurement.
//
// Bound on the H100: bytes.  Per entry it reads 512 B of score words (once
// per distinct slot) and 4 B of slot index, and writes 2 KB of codes; the
// arithmetic is one shift and one mask per code.  Every read and write of a
// warp is one coalesced 128-byte segment.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int ROWS = 4;           // four u8 codes per 32-bit word

__global__ void __launch_bounds__(LANES)
unpack_codes_kernel(const uint32_t* __restrict__ tiles,
                    const int32_t* __restrict__ slots,
                    uint32_t* __restrict__ out, long long n_tiles) {
  const long long i = blockIdx.x;
  const int lane = threadIdx.x;
  const long long slot = slots[i];
  // a slot outside the arena is a caller bug: stop the kernel with an error
  // the next synchronisation reports, never read stray memory
  if (slot < 0 || slot >= n_tiles) __trap();
  const uint32_t w = tiles[slot * LANES + lane];
  uint32_t* o = out + i * (ROWS * LANES) + lane;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) o[r * LANES] = (w >> (8 * r)) & 0xFFu;
}

}  // namespace

// tiles: (n_tiles, 128) u32 score arena; slots: (n_entries,) i32;
// out: (n_entries * 4, 128) u32.  Returns cudaGetLastError().
extern "C" int repro_unpack_codes(const void* tiles, const void* slots,
                                  void* out, long long n_entries,
                                  long long n_tiles, void* stream) {
  if (n_entries <= 0) return 0;
  if (n_entries > 0x7FFFFFFFLL || n_tiles <= 0)
    return (int)cudaErrorInvalidValue;
  unpack_codes_kernel<<<(unsigned)n_entries, LANES, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tiles), static_cast<const int32_t*>(slots),
      static_cast<uint32_t*>(out), n_tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
