// Stream codec kernels over the wide vertical layout (kernels B6, B7a, B7b,
// B8 and B9 of the port).
//
// Replaces the JAX package's Pallas kernels
//   B7a kernels/bitpack.py      pack_frames         (body _pack_kernel)
//   B7b kernels/bitpack.py      unpack_frames       (body _unpack_kernel)
//   B9  kernels/quadmax.py      frame_or            (body _frame_or_kernel)
//   B8  kernels/scan_add.py     prefix_sum_blocks   (body _scan_kernel)
//   B6  kernels/unpack_delta.py unpack_delta_frames (body _unpack_delta_kernel)
//
// Layout: a frame is 4096 words as a (32, 128) tile, row r lane l holding
// element 4096 f + 128 r + l of the stream.  Packed at width BW a frame is
// (BW, 128) words: lane l squeezes its 32 values, LSB-first, into BW words.
// One thread block of 128 threads serves one frame (thread = lane), so every
// load and store of a warp is one coalesced 128-byte segment.  BW is a
// template argument (1..32, one switch), so every shift is a constant, as the
// TPU form closed over it at trace time; no shift is ever by 32.
//
// B6 and B8 are inclusive prefix sums, mod 2**32, in linear order.  On the
// TPU the grid ran in order and carried the running sum in SMEM from step to
// step; a CUDA grid has no order.
//
// B6 is reduce-then-scan, three launches on the caller's stream:
//   1. per frame its total, unpacked and summed in registers (no gaps
//      written);
//   2. one block of 1024 threads scans the frame totals, exclusive, in place;
//   3. per frame the scan of its 32 rows in row-major order (warp shuffles
//      within a row, a 4-word exchange across its warps), plus its carry.
//
// B8 is one grid launch (after one memset of its scratch): a single-pass
// scan with decoupled look-back (Merrill and Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", NVIDIA 2016).  A block takes its
// tile (8192 words, 64 rows) from an atomicAdd ticket, so it only ever waits
// on tiles that started before it and the look-back cannot deadlock on a
// tile that is not resident.  A warp loads 8 runs of 128 consecutive words,
// one uint4 (16 bytes) a thread per run, so every load is 512 contiguous
// bytes and no shared-memory transpose is needed: a thread scans its uint4
// serially, warp shuffles scan a run, a carry goes from run to run, and the
// 8 warp totals meet in shared memory.  The block publishes the tile's
// aggregate, and one warp sums its predecessors' published words 32 at a
// time back to the first inclusive prefix.  A status word is flag and value
// in one 64-bit store, read with one 64-bit acquire load, so no value is
// read before its flag.  The tile then publishes its inclusive prefix and
// stores its words, plus the prefix, as uint4.  The scratch (status words
// and ticket) is zeroed by a memset on the same stream before each launch.
// The frame tiling knobs of the TPU form (frames_per_block, rows_per_block)
// sized VMEM blocks and are not carried over.
//
// Bound on the H100: bytes.  B7a reads 16 KB and writes 512 BW bytes per
// frame, B7b and B6 the reverse, B9 reads 16 KB and writes 512 B, B8 reads
// and writes 512 B per row; the arithmetic is a few integer ops per value.
// B8 reads its input once and writes it once.  B6 reads its packed words
// twice (passes 1 and 3), which the fused decode keeps below the two-pass
// decode's bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int FRAME_ROWS = 32;
constexpr long long FRAME_INTS = FRAME_ROWS * LANES;
constexpr int WARPS = LANES / 32;
constexpr int SCAN_THREADS = 1024;

__host__ __device__ constexpr uint32_t mask_of(int bw) {
  return bw >= 32 ? 0xFFFFFFFFu : ((1u << bw) - 1u);
}

// the lane's BW packed words of frame f
template <int BW>
__device__ __forceinline__ void load_packed(const uint32_t* __restrict__ p,
                                            long long f, int lane,
                                            uint32_t (&w)[BW]) {
  const uint32_t* src = p + f * (BW * LANES) + lane;
#pragma unroll
  for (int k = 0; k < BW; ++k) w[k] = src[k * LANES];
}

// value r of the lane: bits [r BW, r BW + BW) of its words
template <int BW>
__device__ __forceinline__ uint32_t field(const uint32_t (&w)[BW], int r) {
  const int start = r * BW;
  const int wi = start >> 5;
  const int off = start & 31;
  uint32_t v = w[wi] >> off;
  // a field that crosses a word boundary has off > 0, and its next word
  // exists (the lane's last bit is 32 BW - 1)
  if (off + BW > 32 && wi + 1 < BW) v |= w[wi + 1] << ((32 - off) & 31);
  return v & mask_of(BW);
}

// sum of one value per thread over the 128-thread block (thread 0 gets it)
__device__ __forceinline__ uint32_t block_sum(uint32_t s, uint32_t* red) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, d);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  return red[0] + red[1] + red[2] + red[3];
}

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t x, int wl) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (wl >= d) x += y;
  }
  return x;
}

// Inclusive scan of a frame's 32 rows in row-major order, starting from
// base; thread = lane holds v[r] = element (r, lane).
__device__ __forceinline__ void scan_rows_store(uint32_t (&v)[FRAME_ROWS],
                                                uint32_t base,
                                                uint32_t* __restrict__ out) {
  __shared__ uint32_t warp_tot[FRAME_ROWS][WARPS];
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const int wl = lane & 31;
#pragma unroll
  for (int r = 0; r < FRAME_ROWS; ++r) {
    v[r] = warp_inclusive_scan(v[r], wl);
    if (wl == 31) warp_tot[r][warp] = v[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < FRAME_ROWS; ++r) {
    uint32_t pre = base;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      const uint32_t t = warp_tot[r][k];
      if (k < warp) pre += t;
      base += t;
    }
    out[r * LANES + lane] = pre + v[r];
  }
}

// ---- B7a: pack ------------------------------------------------------------ //

template <int BW>
__global__ void __launch_bounds__(LANES)
pack_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out) {
  const long long f = blockIdx.x;
  const int lane = threadIdx.x;
  const uint32_t* in = x + f * FRAME_INTS + lane;
  uint32_t* o = out + f * (BW * LANES) + lane;
  uint32_t acc = 0;
#pragma unroll
  for (int r = 0; r < FRAME_ROWS; ++r) {
    const int start = r * BW;
    const int off = start & 31;
    const uint32_t v = in[r * LANES] & mask_of(BW);
    acc |= v << off;
    if (off + BW >= 32) {
      o[(start >> 5) * LANES] = acc;
      const int rem = off + BW - 32;
      acc = rem ? v >> ((32 - off) & 31) : 0u;   // rem > 0: 0 < off < 32
    }
  }
}

// ---- B7b: unpack ---------------------------------------------------------- //

template <int BW>
__global__ void __launch_bounds__(LANES)
unpack_kernel(const uint32_t* __restrict__ packed,
              uint32_t* __restrict__ out) {
  const long long f = blockIdx.x;
  const int lane = threadIdx.x;
  uint32_t w[BW];
  load_packed<BW>(packed, f, lane, w);
  uint32_t* o = out + f * FRAME_INTS + lane;
#pragma unroll
  for (int r = 0; r < FRAME_ROWS; ++r) o[r * LANES] = field<BW>(w, r);
}

// ---- B9: per-frame, per-lane OR ------------------------------------------ //

__global__ void __launch_bounds__(LANES)
frame_or_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out) {
  const long long f = blockIdx.x;
  const int lane = threadIdx.x;
  const uint32_t* in = x + f * FRAME_INTS + lane;
  uint32_t acc = 0;
#pragma unroll
  for (int r = 0; r < FRAME_ROWS; ++r) acc |= in[r * LANES];
  out[f * LANES + lane] = acc;
}

// ---- B6 pass 2: exclusive scan of the frame totals, one block ---------- //

__global__ void __launch_bounds__(SCAN_THREADS)
exclusive_scan_kernel(uint32_t* __restrict__ t, long long n) {
  __shared__ uint32_t warp_tot[SCAN_THREADS / 32];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wl = tid & 31;
  uint32_t carry = 0;
  for (long long base = 0; base < n; base += SCAN_THREADS) {
    const long long i = base + tid;
    const uint32_t x = i < n ? t[i] : 0u;
    const uint32_t s = warp_inclusive_scan(x, wl);
    if (wl == 31) warp_tot[warp] = s;
    __syncthreads();
    if (warp == 0) warp_tot[wl] = warp_inclusive_scan(warp_tot[wl], wl);
    __syncthreads();
    if (i < n) t[i] = carry + (warp ? warp_tot[warp - 1] : 0u) + s - x;
    carry += warp_tot[SCAN_THREADS / 32 - 1];
    __syncthreads();                  // warp_tot is rewritten next chunk
  }
}

// ---- B8: single-pass prefix sum of (rows, 128) words, row-major -------- //

constexpr int SCAN_TPB = 256;                          // threads per block
constexpr int SCAN_VECS = 8;                           // uint4 per thread
constexpr int SCAN_RUN = 32 * 4;                       // words of a warp load
constexpr int SCAN_TILE = (SCAN_TPB / 32) * SCAN_VECS * SCAN_RUN;   // words
static_assert(SCAN_TILE % LANES == 0, "a B8 tile is whole rows");

// status word of a tile: (value << 32) | flag; 0 until the tile publishes
constexpr unsigned long long ST_AGGREGATE = 1;         // the tile's own sum
constexpr unsigned long long ST_INCLUSIVE = 2;         // sum of tiles 0..t

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v)
               : "memory");
}

// Sum of the tiles before `tile`, by one warp: lane l reads the status of
// tile end - l, waiting until that tile has published; the window's words
// are summed back to the nearest inclusive one, else the window moves 32
// tiles down.  Tiles below 0 count as an inclusive 0 (tile 0 publishes
// inclusive, so the walk stops there).
__device__ __forceinline__ uint32_t look_back(
    const unsigned long long* status, long long tile, int wl) {
  uint32_t prefix = 0;
  for (long long end = tile - 1;; end -= 32) {
    const long long i = end - wl;
    unsigned long long s = ST_INCLUSIVE;
    if (i >= 0) {
      do {
        s = ld_acquire(status + i);
      } while ((s & 3u) == 0);
    }
    const unsigned incl = __ballot_sync(0xFFFFFFFFu, (s & 3u) == ST_INCLUSIVE);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    uint32_t v = wl <= stop ? (uint32_t)(s >> 32) : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
    prefix += v;
    if (incl) return prefix;
  }
}

__device__ __forceinline__ uint4 add4(uint4 q, uint32_t c) {
  return make_uint4(q.x + c, q.y + c, q.z + c, q.w + c);
}

// x, out: n4 uint4 (the words in linear order); status: one word per tile;
// ticket: the next tile to hand out.  status and ticket start at 0.
__global__ void __launch_bounds__(SCAN_TPB)
lookback_scan_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                     long long n4, unsigned long long* __restrict__ status,
                     unsigned int* __restrict__ ticket) {
  __shared__ uint32_t warp_tot[SCAN_TPB / 32];
  __shared__ unsigned int s_tile;
  __shared__ uint32_t s_prefix;
  const int warp = threadIdx.x >> 5;
  const int wl = threadIdx.x & 31;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tile = s_tile;
  // the warp's run j is 32 consecutive uint4; lane wl takes the wl-th
  const long long v0 = tile * (SCAN_TILE / 4)
                       + warp * (SCAN_VECS * SCAN_RUN / 4) + wl;
  uint4 q[SCAN_VECS];
#pragma unroll
  for (int j = 0; j < SCAN_VECS; ++j) {
    const long long v = v0 + j * 32;
    q[j] = v < n4 ? x[v] : make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t carry = 0;                        // the warp's sum of runs < j
#pragma unroll
  for (int j = 0; j < SCAN_VECS; ++j) {
    q[j].y += q[j].x;
    q[j].z += q[j].y;
    q[j].w += q[j].z;
    const uint32_t s = warp_inclusive_scan(q[j].w, wl);
    q[j] = add4(q[j], carry + s - q[j].w);
    carry += __shfl_sync(0xFFFFFFFFu, s, 31);
  }
  if (wl == 31) warp_tot[warp] = carry;
  __syncthreads();
  uint32_t wpre = 0, agg = 0;
#pragma unroll
  for (int k = 0; k < SCAN_TPB / 32; ++k) {
    const uint32_t t = warp_tot[k];
    if (k < warp) wpre += t;
    agg += t;
  }
  if (warp == 0) {
    uint32_t prefix = 0;
    if (tile > 0) {
      if (wl == 0) st_release(status + tile,
                              ((unsigned long long)agg << 32) | ST_AGGREGATE);
      prefix = look_back(status, tile, wl);
    }
    if (wl == 0) {
      st_release(status + tile,
                 ((unsigned long long)(prefix + agg) << 32) | ST_INCLUSIVE);
      s_prefix = prefix;
    }
  }
  __syncthreads();
  const uint32_t add = s_prefix + wpre;
#pragma unroll
  for (int j = 0; j < SCAN_VECS; ++j) {
    const long long v = v0 + j * 32;
    if (v < n4) out[v] = add4(q[j], add);
  }
}

// ---- B6: fused unpack + prefix sum ---------------------------------------- //

template <int BW>
__global__ void __launch_bounds__(LANES)
unpack_total_kernel(const uint32_t* __restrict__ packed,
                    uint32_t* __restrict__ totals) {
  __shared__ uint32_t red[WARPS];
  const long long f = blockIdx.x;
  uint32_t w[BW];
  load_packed<BW>(packed, f, threadIdx.x, w);
  uint32_t s = 0;
#pragma unroll
  for (int r = 0; r < FRAME_ROWS; ++r) s += field<BW>(w, r);
  s = block_sum(s, red);
  if (threadIdx.x == 0) totals[f] = s;
}

template <int BW>
__global__ void __launch_bounds__(LANES)
unpack_delta_kernel(const uint32_t* __restrict__ packed,
                    const uint32_t* __restrict__ carry,
                    uint32_t* __restrict__ out) {
  const long long f = blockIdx.x;
  uint32_t w[BW];
  load_packed<BW>(packed, f, threadIdx.x, w);
  uint32_t v[FRAME_ROWS];
#pragma unroll
  for (int r = 0; r < FRAME_ROWS; ++r) v[r] = field<BW>(w, r);
  scan_rows_store(v, carry[f], out + f * FRAME_INTS);
}

template <int BW>
int launch_unpack_delta(const uint32_t* p, uint32_t* out, uint32_t* totals,
                        long long frames, cudaStream_t s) {
  unpack_total_kernel<BW><<<(unsigned)frames, LANES, 0, s>>>(p, totals);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  exclusive_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(totals, frames);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  unpack_delta_kernel<BW><<<(unsigned)frames, LANES, 0, s>>>(p, totals, out);
  return (int)cudaGetLastError();
}

}  // namespace

#define REPRO_BW_CASES(X)                                                    \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13)       \
  X(14) X(15) X(16) X(17) X(18) X(19) X(20) X(21) X(22) X(23) X(24) X(25)    \
  X(26) X(27) X(28) X(29) X(30) X(31) X(32)

static bool bad_frames(long long frames) {
  return frames <= 0 || frames > 0x7FFFFFFFLL;
}

// x: (frames * 32, 128) u32 -> out: (frames * bw, 128) u32.
// Returns cudaGetLastError().
extern "C" int repro_pack_frames(const void* x, void* out, long long frames,
                                 int bw, void* stream) {
  if (frames == 0) return 0;
  if (bad_frames(frames)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* in = static_cast<const uint32_t*>(x);
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (bw) {
#define REPRO_CASE(B) \
    case B: pack_kernel<B><<<(unsigned)frames, LANES, 0, s>>>(in, o); break;
    REPRO_BW_CASES(REPRO_CASE)
#undef REPRO_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// packed: (frames * bw, 128) u32 -> out: (frames * 32, 128) u32.
extern "C" int repro_unpack_frames(const void* packed, void* out,
                                   long long frames, int bw, void* stream) {
  if (frames == 0) return 0;
  if (bad_frames(frames)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(packed);
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (bw) {
#define REPRO_CASE(B) \
    case B: unpack_kernel<B><<<(unsigned)frames, LANES, 0, s>>>(p, o); break;
    REPRO_BW_CASES(REPRO_CASE)
#undef REPRO_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x: (frames * 32, 128) u32 -> out: (frames, 128) u32.
extern "C" int repro_frame_or(const void* x, void* out, long long frames,
                              void* stream) {
  if (frames == 0) return 0;
  if (bad_frames(frames)) return (int)cudaErrorInvalidValue;
  frame_or_kernel<<<(unsigned)frames, LANES, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

// x, out: (rows, 128) u32, 16-byte aligned; scratch: scratch_words u64,
// at least one status word per tile of SCAN_TILE words (64 rows) plus the
// ticket, zeroed here on the stream before the one grid launch.
extern "C" int repro_prefix_sum(const void* x, void* out, void* scratch,
                                long long scratch_words, long long rows,
                                void* stream) {
  if (rows == 0) return 0;
  const long long tiles = (rows * LANES + SCAN_TILE - 1) / SCAN_TILE;
  if (rows < 0 || bad_frames(tiles) || scratch_words < tiles + 1 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out))
       & 15u))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  cudaError_t err = cudaMemsetAsync(
      status, 0, (size_t)(tiles + 1) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  lookback_scan_kernel<<<(unsigned)tiles, SCAN_TPB, 0, s>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out),
      rows * (LANES / 4), status,
      reinterpret_cast<unsigned int*>(status + tiles));
  return (int)cudaGetLastError();
}

// packed: (frames * bw, 128) u32 -> out: (frames * 32, 128) u32 docids;
// totals: (frames,) u32 scratch.
extern "C" int repro_unpack_delta(const void* packed, void* out, void* totals,
                                  long long frames, int bw, void* stream) {
  if (frames == 0) return 0;
  if (bad_frames(frames)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(packed);
  uint32_t* o = static_cast<uint32_t*>(out);
  uint32_t* t = static_cast<uint32_t*>(totals);
  switch (bw) {
#define REPRO_CASE(B) \
    case B: return launch_unpack_delta<B>(p, o, t, frames, s);
    REPRO_BW_CASES(REPRO_CASE)
#undef REPRO_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
