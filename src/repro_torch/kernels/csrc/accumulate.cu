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
// order on one core.  Here the updates are atomics: atomicAdd on unsigned
// int wraps mod 2**32 exactly like the reference's u32 add, and atomicOr
// sets the survivor bits (one a word a warp, after the warp merges its
// lanes' bits).  No sort, no row residency.
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
// What bounds both forms on the H100 is sector traffic.  In a round an
// entry's docids lie tens to hundreds of docs apart, in a state array far
// larger than the 50 MB L2 (the ranked accumulator is 25.8 GB at GOV2's
// size), so nearly every non-zero contribution lands in a 32-byte sector of
// its own: the card reads that sector and writes it back, 64 B for one
// 4-byte update.  The floor is the inputs plus 64 B per distinct touched
// sector (chip_smoke.py counts both); a bitmap word holds 32 docs, so the
// bits form's survivors share sectors more often.
//
// The order in which the atomics reach memory decides how close the add
// form comes to that floor: the memory favours updates close in time that
// are close in address, and the resident threads of a launch are the
// updates in flight.  So the add form keeps one thread per (entry, lane)
// in the array's order: one block per 256 consecutive lanes of one entry,
// coalesced 4-byte loads, each warp-wide atomic on 32 consecutive lanes,
// and one unsigned atomicAdd (a RED, its result unused) per non-zero
// contribution, exact for duplicates across entries too.  Mappings that
// give a thread four lanes (one warp per entry loading uint4, a warp per
// 128 lanes handing lanes across through shared memory) widen the span of
// addresses in flight and took 18 % and 7 % longer on scattered ids on the
// H100, though the last needs a quarter of the threads where nearly every
// lane is dead (tools/b2_add_order.py, PERF.md).  Its masked entry point
// (scatter_add_masked, the ranked rounds' form) reads the survivor byte
// first and a dead lane's code and id never, which saves the plain pass
// that zeroed the dead lanes first.  The bits form reads 4 lanes' mask a
// thread, stops a warp whose 128 lanes are dead, sends its atomics on 32
// consecutive lanes at a time and merges a warp's lanes that set bits of
// one word into one atomicOr (scatter_bits_kernel); its mask is bool bytes
// or, in the fused AND round, the fused decode's u32 hit words as they are,
// which saves the plain pass that turned them into bools.

// B4 (dense_add, dense_add_packed) replaces the JAX package's Pallas kernel
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
// One kernel body, two ways to read a code: unpacked, (P, 4096) words;
// packed, the ranked path's (P, 1024) score tiles read as 4096 bytes
// (position p is byte p), times bit p & 31 of word p >> 5 of the (P, 128)
// window when gated, so no (P, 4096) array is ever made.  One block per
// entry; thread t takes positions t, t + 256, ..., so each warp-wide atomic
// covers 32 consecutive words (4 sectors) and each warp-wide load 32
// consecutive codes; the window word is a broadcast load, read before the
// codes, so a gated window reads only the code sectors its set bits name.
// Bound on the H100: bytes: per active entry its 8 B of indices and the
// codes it needs (16 KB unpacked; 4 KB packed; gated, 512 B of window and
// 32 B per non-zero window word), one act byte per entry, and one 4-byte
// read-modify-write per distinct touched word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// B2 bits.  A warp takes 128 consecutive lanes of one entry (four warps, 512
// lanes, a block): thread t first reads the mask of lanes 4t..4t+3 in one
// load (a uint4 of hit words, or 4 bool bytes) where the lane count and the
// mask's address allow it, and a warp whose 128 lanes are all dead stops
// there (the fused round's mask is 99.3 % dead: one lane a thread spent
// its time starting threads).  A live warp then loads the ids of its live
// lanes, lane 32c + t in thread t (its live bit comes by a shuffle), all
// four at once, and goes over them in four sub-rounds of 32 consecutive
// lanes, so every warp-wide atomic still covers 32 consecutive lanes, the
// order the add form's measurements favour.  Within a sub-round,
// __match_any_sync groups the live lanes by target word; where no two
// share one each lane sends its atomicOr, otherwise the group ORs its bits
// into the shared word of its first lane (shared-memory atomicOr: a group
// need not be a run of lanes) and that lane sends the group's one
// atomicOr.  Every lane of the warp stays for the collectives,
// which take the full mask; a dead lane, a lane past the entry's end and a
// target out of range carry the sentinel word NO_WORD.  A dead lane reads
// its mask and nothing else.  M is the mask's type: bool bytes, or the
// fused decode's u32 hit words (non-zero: alive), read as they are.
constexpr int BITS_THREADS = 128;
constexpr int BITS_CHUNK = 4 * BITS_THREADS;    // lanes a block
constexpr uint32_t NO_WORD = 0xFFFFFFFFu;   // above any word index < 2**31
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned live4(uint4 v) {
  return (v.x != 0u) | (v.y != 0u) << 1 | (v.z != 0u) << 2 | (v.w != 0u) << 3;
}

__device__ __forceinline__ unsigned live4(uint32_t bytes) {
  return ((bytes & 0xFFu) != 0u) | ((bytes & 0xFF00u) != 0u) << 1 |
         ((bytes & 0xFF0000u) != 0u) << 2 | ((bytes >> 24) != 0u) << 3;
}

template <typename M>
__global__ void __launch_bounds__(BITS_THREADS)
scatter_bits_kernel(uint32_t* __restrict__ bm, const uint32_t* __restrict__ ids,
                    const int32_t* __restrict__ qslot,
                    const M* __restrict__ surv, unsigned chunks, int lanes,
                    int n_rows, uint32_t words, bool vec) {
  __shared__ uint32_t merged[BITS_THREADS];
  const unsigned j = blockIdx.x / chunks;
  const int t = threadIdx.x & 31;
  const int wbase = threadIdx.x & ~31;            // the warp's first thread
  const int l0 = (int)(blockIdx.x - j * chunks) * BITS_CHUNK + 4 * wbase;
  const size_t k0 = (size_t)j * lanes + l0;       // the warp's first lane
  const int lt = l0 + 4 * t;
  unsigned live = 0u;                              // bit c: lane lt + c
  if (vec) {                                       // lanes % 4 == 0, aligned
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
  // lane 32c + t of the warp's 128 is bit t % 4 of thread 8c + t / 4; every
  // live lane's id is loaded first, four independent loads a thread
  unsigned mine = 0u;                              // bit c: lane 32c + t
#pragma unroll
  for (int c = 0; c < 4; ++c)
    mine |= ((__shfl_sync(FULL, live, 8 * c + (t >> 2)) >> (t & 3)) & 1u)
            << c;
  const int q = mine ? qslot[j] : 0;
  const bool q_ok = q >= 0 && q < n_rows;
  uint32_t id[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    id[c] = (mine >> c) & 1u ? ids[k0 + 32 * c + t] : 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t word = NO_WORD, bit = 0u;
    if ((mine >> c) & 1u && q_ok && (id[c] >> 5) < words) {
      word = id[c] >> 5;
      bit = 1u << (id[c] & 31u);
    }
    if (!__any_sync(FULL, word != NO_WORD)) continue;
    const unsigned peers = __match_any_sync(FULL, word);
    if (__all_sync(FULL, word == NO_WORD || peers == 1u << t)) {
      if (word != NO_WORD)                         // no two lanes share one
        atomicOr(bm + (size_t)q * words + word, bit);
      continue;
    }
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

// One block per THREADS consecutive lanes of one entry, so the grid walks
// the (entry, lane) array in order and each warp-wide atomic covers 32
// consecutive lanes: ascending docids, as close in the accumulator as an
// entry's docids get.  The entry index comes from the block index, one
// 32-bit division (no 64-bit division a lane).  MASKED: lane l adds
// contrib[l] only where surv[l] (a bool byte), and a dead lane reads
// nothing else.
template <bool MASKED>
__global__ void __launch_bounds__(THREADS)
scatter_add_kernel(uint32_t* __restrict__ acc, const uint32_t* __restrict__ ids,
                   const int32_t* __restrict__ qslot,
                   const uint32_t* __restrict__ contrib,
                   const uint8_t* __restrict__ surv, unsigned chunks,
                   int lanes, int n_rows, uint32_t width) {
  const unsigned j = blockIdx.x / chunks;
  const int l = (int)(blockIdx.x - j * chunks) * THREADS + (int)threadIdx.x;
  if (l >= lanes) return;
  const size_t k = (size_t)j * lanes + l;
  if (MASKED && !surv[k]) return;
  const uint32_t c = contrib[k];
  if (c == 0u) return;                      // adds nothing: skip the atomic
  const int q = qslot[j];
  const uint32_t col = ids[k];
  if (q < 0 || q >= n_rows || col >= width) return;
  atomicAdd(acc + (size_t)q * width + col, c);
}

constexpr int WINDOW = 4096;           // dense score window: 128 words * 32

enum DenseForm { UNPACKED = 0, PACKED = 1, PACKED_GATED = 2 };

// UNPACKED: codes (P, 4096) u32.  PACKED: codes (P, 1024) u32 read as 4096
// bytes; PACKED_GATED: and each code times its bit of win (P, 128) u32.
template <int FORM>
__global__ void __launch_bounds__(THREADS)
dense_add_kernel(uint32_t* __restrict__ acc, const void* __restrict__ codes,
                 const uint32_t* __restrict__ win,
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
#pragma unroll
  for (int i = 0; i < WINDOW / THREADS; ++i) {
    const int p = threadIdx.x + i * THREADS;
    // gated, the bit first: a warp's 32 positions are one window word and
    // one 32-byte sector of codes, so a word of 0 fetches no code at all
    if constexpr (FORM == PACKED_GATED)
      if (!((win[j * (WINDOW / 32) + (p >> 5)] >> (p & 31)) & 1u)) continue;
    uint32_t c;
    if constexpr (FORM == UNPACKED)
      c = static_cast<const uint32_t*>(codes)[j * WINDOW + p];
    else
      c = static_cast<const uint8_t*>(codes)[j * WINDOW + p];
    if (c != 0u) atomicAdd(row + p, c);
  }
}


}  // namespace

// bm: (n_rows, words) u32, updated in place, words < 2**31; ids:
// (n_entries, lanes) u32; qslot: (n_entries,) i32; surv: (n_entries,
// lanes), bool bytes (mask_bytes 1) or u32 hit words (mask_bytes 4).
extern "C" int repro_scatter_bits(void* bm, const void* ids, const void* qslot,
                                  const void* surv, long long n_entries,
                                  long long lanes, long long n_rows,
                                  long long words, int mask_bytes,
                                  void* stream) {
  if (n_entries <= 0 || lanes <= 0) return 0;
  const long long chunks = (lanes + BITS_CHUNK - 1) / BITS_CHUNK;
  if (lanes > 0x7FFFFFFFLL || n_rows > 0x7FFFFFFFLL || words > 0x7FFFFFFFLL ||
      n_entries * chunks > 0x7FFFFFFFLL || (mask_bytes != 1 && mask_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(n_entries * chunks);
  // one load a thread for 4 lanes' mask needs every warp's lanes to start
  // on a multiple of 4 and the mask on a 4 * mask_bytes boundary
  const bool vec = lanes % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(surv) % (4 * mask_bytes) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* b = static_cast<uint32_t*>(bm);
  const uint32_t* i = static_cast<const uint32_t*>(ids);
  const int32_t* q = static_cast<const int32_t*>(qslot);
  if (mask_bytes == 1)
    scatter_bits_kernel<uint8_t><<<blocks, BITS_THREADS, 0, s>>>(
        b, i, q, static_cast<const uint8_t*>(surv), (unsigned)chunks,
        (int)lanes, (int)n_rows, (uint32_t)words, vec);
  else
    scatter_bits_kernel<uint32_t><<<blocks, BITS_THREADS, 0, s>>>(
        b, i, q, static_cast<const uint32_t*>(surv), (unsigned)chunks,
        (int)lanes, (int)n_rows, (uint32_t)words, vec);
  return (int)cudaGetLastError();
}

// acc: (n_rows, width) u32, updated in place, width < 2**31; ids, contrib:
// (n_entries, lanes) u32; qslot: (n_entries,) i32; surv: null, or
// (n_entries, lanes) bool bytes masking contrib.  Any lane count and
// alignment.
extern "C" int repro_scatter_add(void* acc, const void* ids, const void* qslot,
                                 const void* contrib, const void* surv,
                                 long long n_entries, long long lanes,
                                 long long n_rows, long long width,
                                 void* stream) {
  if (n_entries <= 0 || lanes <= 0) return 0;
  const long long chunks = (lanes + THREADS - 1) / THREADS;
  if (lanes > 0x7FFFFFFFLL || n_rows > 0x7FFFFFFFLL || width > 0x7FFFFFFFLL ||
      n_entries * chunks > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  decltype(&scatter_add_kernel<true>) kernel =
      surv ? scatter_add_kernel<true> : scatter_add_kernel<false>;
  kernel<<<(unsigned)(n_entries * chunks), THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(acc), static_cast<const uint32_t*>(ids),
      static_cast<const int32_t*>(qslot), static_cast<const uint32_t*>(contrib),
      static_cast<const uint8_t*>(surv), (unsigned)chunks, (int)lanes,
      (int)n_rows, (uint32_t)width);
  return (int)cudaGetLastError();
}

// acc: (n_rows, width) u32, updated in place; codes: (n_entries, 4096) u32
// (form 0) or the packed (n_entries, 1024) u32 tiles (forms 1, 2); win:
// (n_entries, 128) u32, read by form 2 only (may be null otherwise); qslot,
// col0: (n_entries,) i32; act: (n_entries,) bool bytes.
extern "C" int repro_dense_add(void* acc, const void* codes, const void* win,
                               const void* qslot, const void* col0,
                               const void* act, long long n_entries,
                               long long n_rows, long long width, int form,
                               void* stream) {
  if (n_entries <= 0) return 0;
  if (n_entries > 0x7FFFFFFFLL || form < UNPACKED || form > PACKED_GATED)
    return (int)cudaErrorInvalidValue;
  decltype(&dense_add_kernel<UNPACKED>) kernel =
      form == UNPACKED ? dense_add_kernel<UNPACKED>
      : form == PACKED ? dense_add_kernel<PACKED>
                       : dense_add_kernel<PACKED_GATED>;
  kernel<<<(unsigned)n_entries, THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(acc), codes, static_cast<const uint32_t*>(win),
      static_cast<const int32_t*>(qslot), static_cast<const int32_t*>(col0),
      static_cast<const uint8_t*>(act), n_rows, width);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
