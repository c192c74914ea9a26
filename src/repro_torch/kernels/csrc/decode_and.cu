// Fused block decode + candidate-bitmap probe for the device-resident AND
// rounds (kernels B1 and B5 of the port).
//
// Replaces the JAX package's Pallas kernels
//   B1  kernels/intersect_rounds.py  segmented_decode_and (body _seg_kernel)
//   B5  kernels/decode_fused.py      fused_decode_and     (body _fused_kernel)
// B5 is B1 against one shared bitmap: the same kernel with qslots == nullptr
// (every entry probes query 0) and cand_words = R * 128.
//
// Per work-list entry i (one thread block of 128 threads, thread = lane):
//   1. unpack the entry's (rows_per_block(BW), 128) packed gap tile at
//      slots[i]: lane l holds values r*128 + l for r = 0..3, packed LSB-first
//      at the static width BW (one template instance per BW bucket);
//   2. inclusive prefix sum of the 512 gaps in linear order (row r, lane l
//      -> r*128 + l), mod 2**32, plus firsts[i] -> docids;
//   3. probe each docid in the candidate bitmap of query qslots[i]: word
//      qslot*cand_words + min(d >> 5, cand_words - 1), bit d & 31;
//   4. write the docids for every lane (past ns[i] the gaps are 0, so the
//      last docid repeats, bit for bit as the reference) and the hit mask,
//      zeroed past ns[i].
//
// On the TPU the work-list indices were scalar-prefetched and BlockSpec
// index maps DMA'd the tile and the query's bitmap block into VMEM; here each
// block loads its own indices and reads the tile and the probed bitmap words
// straight from global memory (the bitmap of one query is 3 MB at GOV2 scale,
// far beyond shared memory, and each entry touches at most 512 of its words).
//
// Bound on the H100: bytes.  Per entry it reads rows_per_block(BW) * 512 B of
// tile, 16 B of indices and up to 512 probed 4-byte words, and writes 4 KB of
// docids and hits; the arithmetic is a few integer ops per value.  The design
// keeps every value in registers (4 per thread), does the 512-wide scan with
// warp shuffles plus one 16-word shared-memory exchange, and makes every tile
// read and output write one coalesced 512-byte row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int BLOCK_ROWS = 4;
constexpr int WARPS = LANES / 32;

template <int BW>
__global__ void __launch_bounds__(LANES)
decode_and_kernel(const uint32_t* __restrict__ tiles,
                  const int32_t* __restrict__ slots,
                  const int32_t* __restrict__ qslots,
                  const uint32_t* __restrict__ firsts,
                  const int32_t* __restrict__ ns,
                  const uint32_t* __restrict__ cand,
                  uint32_t* __restrict__ ids,
                  uint32_t* __restrict__ hits,
                  long long n_tiles, long long n_queries,
                  long long cand_words) {
  constexpr int RPB = (BLOCK_ROWS * BW + 31) / 32;
  constexpr uint32_t MASK = BW >= 32 ? 0xFFFFFFFFu : ((1u << BW) - 1u);
  __shared__ uint32_t warp_tot[BLOCK_ROWS][WARPS];

  const long long i = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const int wl = lane & 31;
  const long long slot = slots[i];
  const long long q = qslots ? (long long)qslots[i] : 0;
  // an index outside the arena or the batch is a caller bug: stop the kernel
  // with an error the next synchronisation reports, never read stray memory
  if (slot < 0 || slot >= n_tiles || q < 0 || q >= n_queries) __trap();

  const uint32_t* tile = tiles + slot * (RPB * LANES);
  uint32_t w[RPB];
#pragma unroll
  for (int k = 0; k < RPB; ++k) w[k] = tile[k * LANES + lane];

  uint32_t v[BLOCK_ROWS];
#pragma unroll
  for (int r = 0; r < BLOCK_ROWS; ++r) {
    // unpack row r: static bit offset r*BW within the lane's words
    const int start = r * BW;
    const int wi = start >> 5;
    const int off = start & 31;
    uint32_t x = w[wi] >> off;
    if (off + BW > 32) x |= w[wi + 1] << (32 - off);
    x &= MASK;
    // inclusive scan within the warp (mod 2**32 by unsigned wrap)
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
      if (wl >= d) x += y;
    }
    v[r] = x;
    if (wl == 31) warp_tot[r][warp] = x;
  }
  __syncthreads();

  uint32_t base = firsts[i];
  const int n = ns[i];
  const uint32_t* qcand = cand + q * cand_words;
  const unsigned long long last_word = (unsigned long long)(cand_words - 1);
#pragma unroll
  for (int r = 0; r < BLOCK_ROWS; ++r) {
    uint32_t pre = base;
    for (int k = 0; k < warp; ++k) pre += warp_tot[r][k];
#pragma unroll
    for (int k = 0; k < WARPS; ++k) base += warp_tot[r][k];
    const uint32_t d = pre + v[r];
    unsigned long long wd = d >> 5;
    if (wd > last_word) wd = last_word;
    const uint32_t word = qcand[wd];
    const uint32_t hit = (word >> (d & 31u)) & 1u;
    const long long o = (i * BLOCK_ROWS + r) * LANES + lane;
    ids[o] = d;
    hits[o] = (r * LANES + lane < n) ? hit : 0u;
  }
}

template <int BW>
void launch(const void* tiles, const void* slots, const void* qslots,
            const void* firsts, const void* ns, const void* cand, void* ids,
            void* hits, long long n_entries, long long n_tiles,
            long long n_queries, long long cand_words, cudaStream_t stream) {
  decode_and_kernel<BW><<<(unsigned)n_entries, LANES, 0, stream>>>(
      static_cast<const uint32_t*>(tiles), static_cast<const int32_t*>(slots),
      static_cast<const int32_t*>(qslots), static_cast<const uint32_t*>(firsts),
      static_cast<const int32_t*>(ns), static_cast<const uint32_t*>(cand),
      static_cast<uint32_t*>(ids), static_cast<uint32_t*>(hits), n_tiles,
      n_queries, cand_words);
}

}  // namespace

// tiles: (n_tiles * rows_per_block(bw), 128) u32; slots, ns: (n_entries,)
// i32; qslots: (n_entries,) i32 or null (B5: every entry probes query 0);
// firsts: (n_entries,) u32; cand: (n_queries * cand_words) u32;
// ids, hits: (n_entries * 4, 128) u32 outputs.  Returns cudaGetLastError().
extern "C" int repro_decode_and(const void* tiles, const void* slots,
                                const void* qslots, const void* firsts,
                                const void* ns, const void* cand, void* ids,
                                void* hits, long long n_entries, int bw,
                                long long n_tiles, long long n_queries,
                                long long cand_words, void* stream) {
  if (n_entries <= 0) return 0;
  if (n_entries > 0x7FFFFFFFLL || cand_words <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bw) {
    case 4: launch<4>(tiles, slots, qslots, firsts, ns, cand, ids, hits,
                      n_entries, n_tiles, n_queries, cand_words, s); break;
    case 8: launch<8>(tiles, slots, qslots, firsts, ns, cand, ids, hits,
                      n_entries, n_tiles, n_queries, cand_words, s); break;
    case 12: launch<12>(tiles, slots, qslots, firsts, ns, cand, ids, hits,
                        n_entries, n_tiles, n_queries, cand_words, s); break;
    case 16: launch<16>(tiles, slots, qslots, firsts, ns, cand, ids, hits,
                        n_entries, n_tiles, n_queries, cand_words, s); break;
    case 24: launch<24>(tiles, slots, qslots, firsts, ns, cand, ids, hits,
                        n_entries, n_tiles, n_queries, cand_words, s); break;
    case 32: launch<32>(tiles, slots, qslots, firsts, ns, cand, ids, hits,
                        n_entries, n_tiles, n_queries, cand_words, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
