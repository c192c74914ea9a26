// Fused block decode + candidate-bitmap probe for the device-resident AND
// rounds (kernels B1 and B5 of the port).
//
// Replaces the JAX package's Pallas kernels
//   B1  kernels/intersect_rounds.py  segmented_decode_and (body _seg_kernel)
//   B5  kernels/decode_fused.py      fused_decode_and     (body _fused_kernel)
// B5 is B1 against one shared bitmap: the same kernel with qslots == nullptr
// (every entry probes query 0) and cand_words = R * 128.
//
// Per work-list entry i:
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
// warp loads its own indices and reads the tile and the probed bitmap words
// straight from global memory (the bitmap of one query is 3 MB at GOV2 scale,
// far beyond shared memory, and each entry touches at most 512 of its words).
//
// Bound on the H100: bytes, and the latency of the chain of loads an entry
// waits on.  Per entry it reads rows_per_block(BW) * 512 B of tile, 16 B of
// indices and up to 512 probed words (each in a 32-byte sector of its own
// where the docids lie more than 8 words apart), and writes 4 KB of docids
// and hits; the arithmetic is a few integer ops per value.  So the design
// keeps many loads in flight and no barrier between them: one warp per
// entry, several entries per block; every per-entry index is loaded first;
// thread t holds lanes 4t..4t+3 of every row, so a 512-byte tile row is one
// warp-wide uint4 load; each row is a scan of 4 values in the thread and a
// 5-step shuffle scan of the thread totals, the row carry going from row to
// row (the linear order r*128 + l holds a thread's 4 lanes in a row in
// order); all 16 probe loads of a thread go out before any store, and
// ids and hits go out as uint4.  The tiles and both outputs are 16-byte
// aligned (the wrapper checks the tiles and allocates the outputs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int BLOCK_ROWS = 4;
constexpr int ENTRIES = 4;                  // entries (warps) per block
constexpr int THREADS = 32 * ENTRIES;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t part(const uint4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <int BW>
__global__ void __launch_bounds__(THREADS)
decode_and_kernel(const uint4* __restrict__ tiles,
                  const int32_t* __restrict__ slots,
                  const int32_t* __restrict__ qslots,
                  const uint32_t* __restrict__ firsts,
                  const int32_t* __restrict__ ns,
                  const uint32_t* __restrict__ cand,
                  uint4* __restrict__ ids, uint4* __restrict__ hits,
                  long long n_entries, long long n_tiles, long long n_queries,
                  long long cand_words) {
  constexpr int RPB = (BLOCK_ROWS * BW + 31) / 32;
  constexpr uint32_t MASK = BW >= 32 ? 0xFFFFFFFFu : ((1u << BW) - 1u);

  const long long i = (long long)blockIdx.x * ENTRIES + (threadIdx.x >> 5);
  if (i >= n_entries) return;               // the whole warp leaves
  const int t = threadIdx.x & 31;
  // every per-entry index first, so none waits behind the tile
  const long long slot = slots[i];
  const long long q = qslots ? (long long)qslots[i] : 0;
  uint32_t base = firsts[i];
  const int n = ns[i];
  // an index outside the arena or the batch is a caller bug: stop the kernel
  // with an error the next synchronisation reports, never read stray memory
  if (slot < 0 || slot >= n_tiles || q < 0 || q >= n_queries) __trap();

  const uint4* tile = tiles + slot * (RPB * LANES / 4);
  uint4 w[RPB];
#pragma unroll
  for (int k = 0; k < RPB; ++k) w[k] = tile[k * (LANES / 4) + t];

  uint32_t d[BLOCK_ROWS][4];
#pragma unroll
  for (int r = 0; r < BLOCK_ROWS; ++r) {
    // unpack row r of the thread's 4 lanes: static bit offset r*BW
    const int start = r * BW;
    const int wi = start >> 5;
    const int off = start & 31;
    uint32_t x[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t v = part(w[wi], c) >> off;
      if (off + BW > 32) v |= part(w[wi + 1], c) << (32 - off);
      x[c] = v & MASK;
    }
    // inclusive scan mod 2**32: the thread's 4 values, then the warp's
    // thread totals; the row's total carries into the next row
    x[1] += x[0];
    x[2] += x[1];
    x[3] += x[2];
    uint32_t s = x[3];
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const uint32_t y = __shfl_up_sync(FULL, s, k);
      if (t >= k) s += y;
    }
    const uint32_t pre = base + (s - x[3]);
#pragma unroll
    for (int c = 0; c < 4; ++c) d[r][c] = pre + x[c];
    base += __shfl_sync(FULL, s, 31);
  }

  // every probe load before any store
  const uint32_t* qcand = cand + q * cand_words;
  const unsigned long long last_word = (unsigned long long)(cand_words - 1);
  uint32_t word[BLOCK_ROWS][4];
#pragma unroll
  for (int r = 0; r < BLOCK_ROWS; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      unsigned long long wd = d[r][c] >> 5;
      if (wd > last_word) wd = last_word;
      word[r][c] = qcand[wd];
    }
#pragma unroll
  for (int r = 0; r < BLOCK_ROWS; ++r) {
    uint32_t h[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      h[c] = (r * LANES + 4 * t + c < n)
                 ? (word[r][c] >> (d[r][c] & 31u)) & 1u : 0u;
    const long long o = (i * BLOCK_ROWS + r) * (LANES / 4) + t;
    ids[o] = make_uint4(d[r][0], d[r][1], d[r][2], d[r][3]);
    hits[o] = make_uint4(h[0], h[1], h[2], h[3]);
  }
}

template <int BW>
void launch(const void* tiles, const void* slots, const void* qslots,
            const void* firsts, const void* ns, const void* cand, void* ids,
            void* hits, long long n_entries, long long n_tiles,
            long long n_queries, long long cand_words, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n_entries + ENTRIES - 1) / ENTRIES);
  decode_and_kernel<BW><<<blocks, THREADS, 0, stream>>>(
      static_cast<const uint4*>(tiles), static_cast<const int32_t*>(slots),
      static_cast<const int32_t*>(qslots), static_cast<const uint32_t*>(firsts),
      static_cast<const int32_t*>(ns), static_cast<const uint32_t*>(cand),
      static_cast<uint4*>(ids), static_cast<uint4*>(hits), n_entries, n_tiles,
      n_queries, cand_words);
}

}  // namespace

// tiles: (n_tiles * rows_per_block(bw), 128) u32, 16-byte aligned; slots,
// ns: (n_entries,) i32; qslots: (n_entries,) i32 or null (B5: every entry
// probes query 0); firsts: (n_entries,) u32; cand: (n_queries * cand_words)
// u32; ids, hits: (n_entries * 4, 128) u32 outputs, 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int repro_decode_and(const void* tiles, const void* slots,
                                const void* qslots, const void* firsts,
                                const void* ns, const void* cand, void* ids,
                                void* hits, long long n_entries, int bw,
                                long long n_tiles, long long n_queries,
                                long long cand_words, void* stream) {
  if (n_entries <= 0) return 0;
  if (n_entries > 0x7FFFFFFFLL || cand_words <= 0 ||
      ((reinterpret_cast<uintptr_t>(tiles) | reinterpret_cast<uintptr_t>(ids) |
        reinterpret_cast<uintptr_t>(hits)) & 15u))
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
