// Comparison forms of the AND round's two kernels, kept to time against the
// port's kernels (src/repro_torch/kernels/csrc/decode_and.cu, B1 and B5;
// the bits form of csrc/accumulate.cu, B2) by tools/and_round_forms.py and
// chip_smoke.py.  Each computes the same function as the port's kernel;
// the probes change one thing on purpose and say what.
//
// B1 (decode + prefix sum + probe), the form the port had before its warp
// per entry: one 128-thread block per entry, a thread a lane, the indices
// of firsts and ns loaded after a block barrier.  PROBE selects
//   0  as it is;
//   1  every probe reads one fixed word (query 0, word 0): decode, scan and
//      stores without the scattered probe loads;
//   2  no stores: the block ORs its ids and hits and writes one word only
//      where the OR is a value no input gives (never), so the loads, decode
//      and probes stay and the 4 KB of outputs an entry go.
//
// B2 bits (bm[qslot[j], id >> 5] |= 1 << (id & 31) where surv), four
// forms: one thread per (entry, lane) from a flat index with a 64-bit
// division a lane (the port's form before); one block per 256 lanes of one
// entry with one atomicOr a live lane; the same with the port's per-warp
// merge (__match_any_sync, a shared-memory OR, one atomicOr a word), a lane
// a thread; and the port's 128-lane warps with their sub-rounds in series,
// each loading its own ids.  The first two take a bool-byte mask, the last
// two also u32 hit words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int BLOCK_ROWS = 4;
constexpr int WARPS = LANES / 32;
constexpr int THREADS = 256;

template <int BW, int PROBE>
__global__ void __launch_bounds__(LANES)
b1_block(const uint32_t* __restrict__ tiles, const int32_t* __restrict__ slots,
         const int32_t* __restrict__ qslots,
         const uint32_t* __restrict__ firsts, const int32_t* __restrict__ ns,
         const uint32_t* __restrict__ cand, uint32_t* __restrict__ ids,
         uint32_t* __restrict__ hits, long long n_tiles, long long n_queries,
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
  if (slot < 0 || slot >= n_tiles || q < 0 || q >= n_queries) __trap();

  const uint32_t* tile = tiles + slot * (RPB * LANES);
  uint32_t w[RPB];
#pragma unroll
  for (int k = 0; k < RPB; ++k) w[k] = tile[k * LANES + lane];

  uint32_t v[BLOCK_ROWS];
#pragma unroll
  for (int r = 0; r < BLOCK_ROWS; ++r) {
    const int start = r * BW;
    const int wi = start >> 5;
    const int off = start & 31;
    uint32_t x = w[wi] >> off;
    if (off + BW > 32) x |= w[wi + 1] << (32 - off);
    x &= MASK;
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
  const uint32_t* qcand = PROBE == 1 ? cand : cand + q * cand_words;
  const unsigned long long last_word = (unsigned long long)(cand_words - 1);
  uint32_t acc = 0;
#pragma unroll
  for (int r = 0; r < BLOCK_ROWS; ++r) {
    uint32_t pre = base;
    for (int k = 0; k < warp; ++k) pre += warp_tot[r][k];
#pragma unroll
    for (int k = 0; k < WARPS; ++k) base += warp_tot[r][k];
    const uint32_t d = pre + v[r];
    unsigned long long wd = d >> 5;
    if (wd > last_word) wd = last_word;
    const uint32_t word = qcand[PROBE == 1 ? 0 : wd];
    const uint32_t hit = (word >> (d & 31u)) & 1u;
    const uint32_t h = (r * LANES + lane < n) ? hit : 0u;
    const long long o = (i * BLOCK_ROWS + r) * LANES + lane;
    if (PROBE == 2) {
      acc |= d ^ (h << 31);
    } else {
      ids[o] = d;
      hits[o] = h;
    }
  }
  if (PROBE == 2 && acc == 0xFFFFFFFFu && n < 0) ids[i] = acc;
}

template <int PROBE>
int b1_launch(int bw, const void* tiles, const void* slots, const void* qslots,
              const void* firsts, const void* ns, const void* cand, void* ids,
              void* hits, long long n_entries, long long n_tiles,
              long long n_queries, long long cand_words, cudaStream_t s) {
#define B1_CASE(BW)                                                         \
  case BW:                                                                  \
    b1_block<BW, PROBE><<<(unsigned)n_entries, LANES, 0, s>>>(              \
        static_cast<const uint32_t*>(tiles),                                \
        static_cast<const int32_t*>(slots),                                 \
        static_cast<const int32_t*>(qslots),                                \
        static_cast<const uint32_t*>(firsts),                               \
        static_cast<const int32_t*>(ns), static_cast<const uint32_t*>(cand), \
        static_cast<uint32_t*>(ids), static_cast<uint32_t*>(hits), n_tiles, \
        n_queries, cand_words);                                             \
    break;
  switch (bw) {
    B1_CASE(4) B1_CASE(8) B1_CASE(12) B1_CASE(16) B1_CASE(24) B1_CASE(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef B1_CASE
  return (int)cudaGetLastError();
}

// one thread per (entry, lane) from a flat index, a 64-bit division a lane
__global__ void __launch_bounds__(THREADS)
bits_flat(uint32_t* __restrict__ bm, const uint32_t* __restrict__ ids,
          const int32_t* __restrict__ qslot, const uint8_t* __restrict__ surv,
          long long n_entries, long long lanes, long long n_rows,
          long long words) {
  const long long k = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (k >= n_entries * lanes || !surv[k]) return;
  const long long q = qslot[k / lanes];
  const uint32_t id = ids[k];
  const long long word = id >> 5;
  if (q < 0 || q >= n_rows || word >= words) return;
  atomicOr(bm + q * words + word, 1u << (id & 31u));
}

// one block per THREADS consecutive lanes of one entry, one atomicOr a live
// lane (the port's order, without its per-warp merge)
__global__ void __launch_bounds__(THREADS)
bits_block(uint32_t* __restrict__ bm, const uint32_t* __restrict__ ids,
           const int32_t* __restrict__ qslot, const uint8_t* __restrict__ surv,
           unsigned chunks, int lanes, int n_rows, uint32_t words) {
  const unsigned j = blockIdx.x / chunks;
  const int l = (int)(blockIdx.x - j * chunks) * THREADS + (int)threadIdx.x;
  if (l >= lanes) return;
  const size_t k = (size_t)j * lanes + l;
  if (!surv[k]) return;
  const int q = qslot[j];
  const uint32_t id = ids[k];
  if (q < 0 || q >= n_rows || (id >> 5) >= words) return;
  atomicOr(bm + (size_t)q * words + (id >> 5), 1u << (id & 31u));
}

// a block per 256 lanes, a lane a thread, with the port's per-warp merge
template <typename M>
__global__ void __launch_bounds__(THREADS)
bits_block_merged(uint32_t* __restrict__ bm, const uint32_t* __restrict__ ids,
                  const int32_t* __restrict__ qslot,
                  const M* __restrict__ surv, unsigned chunks, int lanes,
                  int n_rows, uint32_t words) {
  __shared__ uint32_t merged[THREADS];
  const unsigned j = blockIdx.x / chunks;
  const int l = (int)(blockIdx.x - j * chunks) * THREADS + (int)threadIdx.x;
  const size_t k = (size_t)j * lanes + l;
  uint32_t word = 0xFFFFFFFFu, bit = 0u;
  int q = 0;
  if (l < lanes && surv[k] != 0) {
    q = qslot[j];
    const uint32_t id = ids[k];
    if (q >= 0 && q < n_rows && (id >> 5) < words) {
      word = id >> 5;
      bit = 1u << (id & 31u);
    }
  }
  if (!__any_sync(0xFFFFFFFFu, word != 0xFFFFFFFFu)) return;
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, word);
  const int leader = __ffs(peers) - 1;
  const int t = threadIdx.x & 31;
  merged[threadIdx.x] = 0u;
  __syncwarp();
  if (word != 0xFFFFFFFFu) atomicOr(&merged[threadIdx.x - t + leader], bit);
  __syncwarp();
  if (word != 0xFFFFFFFFu && t == leader)
    atomicOr(bm + (size_t)q * words + word, merged[threadIdx.x]);
}

// the port's form before its ids were loaded all at once: 4 lanes' mask a
// thread, a dead warp of 128 lanes stopping there, then four sub-rounds of
// 32 lanes, each loading its ids, merging per word and issuing its atomics
__device__ __forceinline__ unsigned live4(uint4 v) {
  return (v.x != 0u) | (v.y != 0u) << 1 | (v.z != 0u) << 2 | (v.w != 0u) << 3;
}

__device__ __forceinline__ unsigned live4(uint32_t bytes) {
  return ((bytes & 0xFFu) != 0u) | ((bytes & 0xFF00u) != 0u) << 1 |
         ((bytes & 0xFF0000u) != 0u) << 2 | ((bytes >> 24) != 0u) << 3;
}

template <typename M>
__global__ void __launch_bounds__(128)
bits_warp128_serial(uint32_t* __restrict__ bm,
                    const uint32_t* __restrict__ ids,
                    const int32_t* __restrict__ qslot,
                    const M* __restrict__ surv, unsigned chunks, int lanes,
                    int n_rows, uint32_t words, bool vec) {
  constexpr unsigned FULL = 0xFFFFFFFFu;
  constexpr uint32_t NO_WORD = 0xFFFFFFFFu;
  __shared__ uint32_t merged[128];
  const unsigned j = blockIdx.x / chunks;
  const int t = threadIdx.x & 31;
  const int wbase = threadIdx.x & ~31;
  const int l0 = (int)(blockIdx.x - j * chunks) * 512 + 4 * wbase;
  const size_t k0 = (size_t)j * lanes + l0;
  const int lt = l0 + 4 * t;
  unsigned live = 0u;
  if (vec) {
    if (lt < lanes) {
      if constexpr (sizeof(M) == 4)
        live = live4(*reinterpret_cast<const uint4*>(surv + k0 + 4 * t));
      else
        live = live4(*reinterpret_cast<const uint32_t*>(surv + k0 + 4 * t));
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (lt + c < lanes && surv[k0 + 4 * t + c] != 0) live |= 1u << c;
  }
  if (!__any_sync(FULL, live != 0u)) return;       // the whole warp
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    // lane 32c + t of the warp's 128: bit t % 4 of thread 8c + t / 4
    const unsigned alive = (__shfl_sync(FULL, live, 8 * c + (t >> 2))
                            >> (t & 3)) & 1u;
    uint32_t word = NO_WORD, bit = 0u;
    int q = 0;
    if (alive) {
      q = qslot[j];
      const uint32_t id = ids[k0 + 32 * c + t];
      if (q >= 0 && q < n_rows && (id >> 5) < words) {
        word = id >> 5;
        bit = 1u << (id & 31u);
      }
    }
    if (!__any_sync(FULL, word != NO_WORD)) continue;
    const unsigned peers = __match_any_sync(FULL, word);
    const int leader = __ffs(peers) - 1;
    merged[threadIdx.x] = 0u;
    __syncwarp();
    if (word != NO_WORD) atomicOr(&merged[wbase + leader], bit);
    __syncwarp();
    if (word != NO_WORD && t == leader)
      atomicOr(bm + (size_t)q * words + word, merged[threadIdx.x]);
    __syncwarp();                                  // before the next clear
  }
}

}  // namespace

// B1's block-per-entry form; probe 0, 1 or 2 as above.  Arguments as
// repro_decode_and (csrc/decode_and.cu).
extern "C" int forms_b1_block(int probe, const void* tiles, const void* slots,
                              const void* qslots, const void* firsts,
                              const void* ns, const void* cand, void* ids,
                              void* hits, long long n_entries, int bw,
                              long long n_tiles, long long n_queries,
                              long long cand_words, void* stream) {
  if (n_entries <= 0) return 0;
  if (n_entries > 0x7FFFFFFFLL || cand_words <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (probe) {
    case 0: return b1_launch<0>(bw, tiles, slots, qslots, firsts, ns, cand,
                                ids, hits, n_entries, n_tiles, n_queries,
                                cand_words, s);
    case 1: return b1_launch<1>(bw, tiles, slots, qslots, firsts, ns, cand,
                                ids, hits, n_entries, n_tiles, n_queries,
                                cand_words, s);
    case 2: return b1_launch<2>(bw, tiles, slots, qslots, firsts, ns, cand,
                                ids, hits, n_entries, n_tiles, n_queries,
                                cand_words, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// B2 bits: form 0 flat, 1 a block per 256 lanes, 2 the same merged, 3 the
// serial 128-lane form.  bm: (n_rows, words) u32 in place; ids (n_entries,
// lanes) u32; qslot (n_entries,) i32; surv (n_entries, lanes) bool bytes
// (mask_bytes 1) or, forms 2 and 3, u32 hit words (mask_bytes 4).
extern "C" int forms_bits(int form, void* bm, const void* ids,
                          const void* qslot, const void* surv,
                          long long n_entries, long long lanes,
                          long long n_rows, long long words, int mask_bytes,
                          void* stream) {
  if (mask_bytes != 1 && !(form >= 2 && mask_bytes == 4))
    return (int)cudaErrorInvalidValue;
  if (n_entries <= 0 || lanes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* b = static_cast<uint32_t*>(bm);
  const uint32_t* i = static_cast<const uint32_t*>(ids);
  const int32_t* q = static_cast<const int32_t*>(qslot);
  const uint8_t* m = static_cast<const uint8_t*>(surv);
  if (form == 0) {
    const long long blocks = (n_entries * lanes + THREADS - 1) / THREADS;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    bits_flat<<<(unsigned)blocks, THREADS, 0, s>>>(b, i, q, m, n_entries,
                                                   lanes, n_rows, words);
  } else if (form == 1 || form == 2) {
    const long long chunks = (lanes + THREADS - 1) / THREADS;
    if (n_entries * chunks > 0x7FFFFFFFLL || lanes > 0x7FFFFFFFLL ||
        n_rows > 0x7FFFFFFFLL || words > 0x7FFFFFFFLL)
      return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)(n_entries * chunks);
    if (form == 1)
      bits_block<<<blocks, THREADS, 0, s>>>(b, i, q, m, (unsigned)chunks,
                                            (int)lanes, (int)n_rows,
                                            (uint32_t)words);
    else if (mask_bytes == 1)
      bits_block_merged<uint8_t><<<blocks, THREADS, 0, s>>>(
          b, i, q, m, (unsigned)chunks, (int)lanes, (int)n_rows,
          (uint32_t)words);
    else
      bits_block_merged<uint32_t><<<blocks, THREADS, 0, s>>>(
          b, i, q, static_cast<const uint32_t*>(surv), (unsigned)chunks,
          (int)lanes, (int)n_rows, (uint32_t)words);
  } else if (form == 3) {
    const long long chunks = (lanes + 511) / 512;
    if (n_entries * chunks > 0x7FFFFFFFLL || lanes > 0x7FFFFFFFLL ||
        n_rows > 0x7FFFFFFFLL || words > 0x7FFFFFFFLL)
      return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)(n_entries * chunks);
    const bool vec = lanes % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(surv) % (4 * mask_bytes) == 0;
    if (mask_bytes == 1)
      bits_warp128_serial<uint8_t><<<blocks, 128, 0, s>>>(
          b, i, q, m, (unsigned)chunks, (int)lanes, (int)n_rows,
          (uint32_t)words, vec);
    else
      bits_warp128_serial<uint32_t><<<blocks, 128, 0, s>>>(
          b, i, q, static_cast<const uint32_t*>(surv), (unsigned)chunks,
          (int)lanes, (int)n_rows, (uint32_t)words, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
