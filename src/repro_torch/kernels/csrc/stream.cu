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
// step; a CUDA grid has no order, so both are reduce-then-scan, three
// launches on the caller's stream:
//   1. per tile (a frame, or 32 rows of B8's input) its total, summed in
//      registers (B6 unpacks and sums, writing no gaps);
//   2. one block of 1024 threads scans the tile totals, exclusive, in place;
//   3. per tile the scan of its 32 rows in row-major order (warp shuffles
//      within a row, a 4-word exchange across its warps), plus its carry.
// The frame tiling knobs of the TPU form (frames_per_block, rows_per_block)
// sized VMEM blocks and are not carried over.
//
// Bound on the H100: bytes.  B7a reads 16 KB and writes 512 BW bytes per
// frame, B7b and B6 the reverse, B9 reads 16 KB and writes 512 B, B8 reads
// and writes 512 B per row; the arithmetic is a few integer ops per value.
// B6 and B8 read their input twice (passes 1 and 3), B6 its packed words
// only, which the fused decode keeps below the two-pass decode's bytes.

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

// Inclusive scan of a tile of up to 32 rows in row-major order, starting from
// base; thread = lane holds v[r] = element (r, lane).  Writes rows < rows.
__device__ __forceinline__ void scan_rows_store(uint32_t (&v)[FRAME_ROWS],
                                                uint32_t base,
                                                uint32_t* __restrict__ out,
                                                int rows) {
  __shared__ uint32_t warp_tot[FRAME_ROWS][WARPS];
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const int wl = lane & 31;
#pragma unroll
  for (int r = 0; r < FRAME_ROWS; ++r) {
    uint32_t x = v[r];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
      if (wl >= d) x += y;
    }
    v[r] = x;
    if (wl == 31) warp_tot[r][warp] = x;
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
    if (r < rows) out[r * LANES + lane] = pre + v[r];
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

// ---- scan pass 2: exclusive scan of the tile totals, one block ----------- //

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
    uint32_t s = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, s, d);
      if (wl >= d) s += y;
    }
    if (wl == 31) warp_tot[warp] = s;
    __syncthreads();
    if (warp == 0) {
      uint32_t u = warp_tot[wl];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, u, d);
        if (wl >= d) u += y;
      }
      warp_tot[wl] = u;
    }
    __syncthreads();
    if (i < n) t[i] = carry + (warp ? warp_tot[warp - 1] : 0u) + s - x;
    carry += warp_tot[SCAN_THREADS / 32 - 1];
    __syncthreads();                  // warp_tot is rewritten next chunk
  }
}

// ---- B8: prefix sum of (rows, 128) words in row-major order -------------- //

__global__ void __launch_bounds__(LANES)
row_tile_total_kernel(const uint32_t* __restrict__ x,
                      uint32_t* __restrict__ totals, long long rows) {
  __shared__ uint32_t red[WARPS];
  const long long r0 = (long long)blockIdx.x * FRAME_ROWS;
  const long long left = rows - r0;
  const int n = left < FRAME_ROWS ? (int)left : FRAME_ROWS;
  const uint32_t* in = x + r0 * LANES + threadIdx.x;
  uint32_t s = 0;
  for (int r = 0; r < n; ++r) s += in[r * LANES];
  s = block_sum(s, red);
  if (threadIdx.x == 0) totals[blockIdx.x] = s;
}

__global__ void __launch_bounds__(LANES)
scan_add_kernel(const uint32_t* __restrict__ x,
                const uint32_t* __restrict__ carry,
                uint32_t* __restrict__ out, long long rows) {
  const long long r0 = (long long)blockIdx.x * FRAME_ROWS;
  const long long left = rows - r0;
  const int n = left < FRAME_ROWS ? (int)left : FRAME_ROWS;
  const uint32_t* in = x + r0 * LANES + threadIdx.x;
  uint32_t v[FRAME_ROWS];
#pragma unroll
  for (int r = 0; r < FRAME_ROWS; ++r) v[r] = r < n ? in[r * LANES] : 0u;
  scan_rows_store(v, carry[blockIdx.x], out + r0 * LANES, n);
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
  scan_rows_store(v, carry[f], out + f * FRAME_INTS, FRAME_ROWS);
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

// x, out: (rows, 128) u32; totals: ceil(rows / 32) u32 scratch.
extern "C" int repro_prefix_sum(const void* x, void* out, void* totals,
                                long long rows, void* stream) {
  if (rows == 0) return 0;
  const long long tiles = (rows + FRAME_ROWS - 1) / FRAME_ROWS;
  if (rows < 0 || bad_frames(tiles)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* in = static_cast<const uint32_t*>(x);
  uint32_t* t = static_cast<uint32_t*>(totals);
  row_tile_total_kernel<<<(unsigned)tiles, LANES, 0, s>>>(in, t, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  exclusive_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(t, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_add_kernel<<<(unsigned)tiles, LANES, 0, s>>>(
      in, t, static_cast<uint32_t*>(out), rows);
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
