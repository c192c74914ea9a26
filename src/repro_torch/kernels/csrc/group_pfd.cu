// Group-PFD's whole-list decode in one launch (kernel PFD of the port).
//
// No Pallas site: the JAX package decodes a Group-PFD list with jnp ops
// (core/group_pfd.py decode_jax_vec), and the port's plain version
// (kernels/pfd_decode.py decode_list_plain) is the same three phases in
// torch: per-quad widths, the unpack of the four component streams, the
// exception patch.  This kernel does all three, and the frame-offset scan
// they need, in one grid launch.
//
// Format (core/group_pfd.py): frames of 32 quadruples (128 integers).  Frame
// f has a 2-byte header, bw (6 bits) | wcode (2 bits) then n_exc (8 bits),
// here one int32 a byte.  Its quadruples are packed at bw bits in four
// vertical streams, the columns of the (W + 1, 4) data words: value c of
// quadruple k is output 4k + c, at the same bit offset in stream c.  A full
// frame is bw bits x 32 quadruples = bw words a stream, so frame f starts at
// bit 0 of data row sum_{g<f} bw_g, a row being one 16-byte uint4.  Its
// exceptions are n_exc 8-bit frame-local positions then n_exc values of w
// bits (w = 8 << min(wcode, 2)), starting at bit sum_{g<f} n_exc_g (8 + w_g)
// of the exception stream, a multiple of 8: the offsets are kept in bytes.
//
// One block of 1024 threads (32 warps) decodes a tile of 256 frames:
//   1. threads 0..255 load the tile's headers (an int2 each) and scan the
//      packed pair (exception bytes << 30 | data rows) exclusive, in shared
//      memory: one 64-bit add scans both;
//   2. the tile's own offset in the list: 0 for the first tile; for the
//      others a single-pass decoupled look-back (Merrill and Garland, as
//      kernel B8 of csrc/stream.cu does it): a block takes its tile from an
//      atomic ticket, so it only waits on tiles that started before it;
//      a status word is (pair << 2) | flag in one 64-bit store, read with
//      one 64-bit acquire load.  A list of one tile (<= 32,768 integers)
//      has no status words, no ticket and no memset;
//   3. warp w decodes frames w, w + 32, ... of the tile, lane = quadruple:
//      the lane loads the one or two uint4 rows its quadruple's bits lie in
//      (a frame is bw contiguous rows, at most 512 B, so the warp's loads
//      coalesce) and funnel-shifts its four values out; the first 32
//      exceptions' loads go out before the unpack so their latency overlaps
//      it.  The frame's 128 integers are staged in shared memory as uint4,
//      the lanes patch the frame's exceptions into the stage (32 at a time,
//      up to 255; positions at or past n, or past the frame, dropped), and
//      the warp stores the frame as coalesced uint4, the tail past n masked.
//
// The stream words are read as two words and a funnel shift, so a value may
// straddle a word; the data's slack row and the exception stream's two
// slack words keep those reads inside the tensors, and every read is also
// checked against the tensor's size, so a malformed header reads zeros, not
// past the end.  Bound on the H100: bytes (the encoded list read once, 4 B
// an integer written), and for the short lists the latency of a warp's
// chain of loads; the arithmetic is a few integer ops a value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FRAME_QUADS = 32;
constexpr int FRAME_INTS = 4 * FRAME_QUADS;
constexpr int WARPS = 32;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE_FRAMES = 256;                  // frames a block decodes
constexpr int SCAN_WARPS = TILE_FRAMES / 32;      // warps that scan headers
constexpr unsigned FULL = 0xFFFFFFFFu;

// a frame offset packed in 62 bits: data rows low, exception bytes above
constexpr int ROW_BITS = 30;
constexpr unsigned long long ROW_MASK = (1ull << ROW_BITS) - 1;

// status word of a tile: (packed offset << 2) | flag; 0 until it publishes
constexpr unsigned long long ST_AGGREGATE = 1;    // the tile's own sum
constexpr unsigned long long ST_INCLUSIVE = 2;    // sum of tiles 0..t

__host__ __device__ constexpr uint32_t mask_of(int bw) {
  return bw >= 32 ? 0xFFFFFFFFu : ((1u << bw) - 1u);
}

// exception value width of header byte 0: W_CHOICES[min(wcode, 2)]
__device__ __forceinline__ int exc_width(uint32_t c0) {
  return 8 << min(c0 >> 6, 2u);
}

// `width` (<= 32) bits at bit `bit` of the stream, LSB-first
__device__ __forceinline__ uint32_t read_bits(const uint32_t* __restrict__ e,
                                             long long bit, int width,
                                             long long words) {
  const long long wi = bit >> 5;
  const uint32_t lo = wi < words ? e[wi] : 0u;
  const uint32_t hi = wi + 1 < words ? e[wi + 1] : 0u;
  return __funnelshift_r(lo, hi, (unsigned)(bit & 31)) & mask_of(width);
}

__device__ __forceinline__ unsigned long long warp_scan64(
    unsigned long long x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

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
// tile end - l, waiting until it has published; the window's values are
// summed back to the nearest inclusive one, else the window moves 32 tiles
// down.  Tiles below 0 count as an inclusive 0.
__device__ __forceinline__ unsigned long long look_back(
    const unsigned long long* status, long long tile, int lane) {
  unsigned long long prefix = 0;
  for (long long end = tile - 1;; end -= 32) {
    const long long i = end - lane;
    unsigned long long s = ST_INCLUSIVE;
    if (i >= 0) {
      do {
        s = ld_acquire(status + i);
      } while ((s & 3u) == 0);
    }
    const unsigned incl = __ballot_sync(FULL, (s & 3u) == ST_INCLUSIVE);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    unsigned long long v = lane <= stop ? s >> 2 : 0ull;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    prefix += v;
    if (incl) return prefix;
  }
}

// control: (>= 2 nf) int32 header bytes; data: (data_rows) uint4;
// exc: (exc_words) u32; out: (n) u32; status: null for one tile, else
// gridDim.x status words then the ticket, all 0.
__global__ void __launch_bounds__(THREADS)
pfd_decode_kernel(const int2* __restrict__ control,
                  const uint4* __restrict__ data,
                  const uint32_t* __restrict__ exc, uint32_t* __restrict__ out,
                  unsigned long long* __restrict__ status, long long n,
                  long long q, long long nf, long long data_rows,
                  long long exc_words) {
  __shared__ unsigned long long s_off[TILE_FRAMES];   // exclusive, in tile
  __shared__ uint32_t s_hdr[TILE_FRAMES];
  __shared__ unsigned long long s_wtot[SCAN_WARPS];
  __shared__ unsigned long long s_prefix;
  __shared__ unsigned int s_tile;
  __shared__ uint4 s_stage[WARPS][FRAME_QUADS];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0)
    s_tile = status ? atomicAdd(reinterpret_cast<unsigned int*>(
                                    status + gridDim.x), 1u)
                    : blockIdx.x;
  __syncthreads();
  const long long f0 = (long long)s_tile * TILE_FRAMES;

  // 1. the tile's headers and their exclusive scan
  unsigned long long v = 0, incl = 0;
  if (warp < SCAN_WARPS) {
    const long long f = f0 + threadIdx.x;
    uint32_t hdr = 0;
    if (f < nf) {
      const int2 c = control[f];
      const uint32_t c0 = (uint32_t)c.x & 255u, c1 = (uint32_t)c.y & 255u;
      hdr = c0 | (c1 << 8);
      v = ((unsigned long long)(c1 * (1u + (exc_width(c0) >> 3)))
           << ROW_BITS) | (c0 & 63u);
    }
    s_hdr[threadIdx.x] = hdr;
    incl = warp_scan64(v, lane);
    if (lane == 31) s_wtot[warp] = incl;
  }
  __syncthreads();
  if (warp < SCAN_WARPS) {
    unsigned long long pre = 0, agg = 0;
#pragma unroll
    for (int k = 0; k < SCAN_WARPS; ++k) {
      const unsigned long long t = s_wtot[k];
      if (k < warp) pre += t;
      agg += t;
    }
    s_off[threadIdx.x] = pre + incl - v;
    // 2. the tile's offset in the list
    if (warp == 0) {
      unsigned long long prefix = 0;
      if (status) {
        const long long tile = s_tile;
        if (tile > 0) {
          if (lane == 0) st_release(status + tile, (agg << 2) | ST_AGGREGATE);
          prefix = look_back(status, tile, lane);
        }
        if (lane == 0)
          st_release(status + tile, ((prefix + agg) << 2) | ST_INCLUSIVE);
      }
      if (lane == 0) s_prefix = prefix;
    }
  }
  __syncthreads();

  // 3. a warp a frame: unpack, patch, store
  const unsigned long long prefix = s_prefix;
  uint32_t* stage = reinterpret_cast<uint32_t*>(s_stage[warp]);
  for (int i = warp; i < TILE_FRAMES; i += WARPS) {
    const long long f = f0 + i;
    if (f >= nf) break;
    const uint32_t hdr = s_hdr[i];
    const int bw = hdr & 63u;
    const int w = exc_width(hdr & 255u);
    const int n_exc = hdr >> 8;
    const unsigned long long off = prefix + s_off[i];
    const long long row0 = (long long)(off & ROW_MASK);
    const long long ebit = (long long)(off >> ROW_BITS) * 8;
    const long long vbit = ebit + 8LL * n_exc;           // the values
    const long long g0 = f * FRAME_INTS;
    uint32_t pos = FRAME_INTS, val = 0;
    if (lane < n_exc) {
      pos = read_bits(exc, ebit + 8LL * lane, 8, exc_words);
      val = read_bits(exc, vbit + (long long)lane * w, w, exc_words);
    }
    uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
    const int bit = lane * bw;
    const unsigned sh = bit & 31;
    if (f * FRAME_QUADS + lane < q) {
      const long long r = row0 + (bit >> 5);
      if (r < data_rows) lo = data[r];
      if ((int)sh + bw > 32 && r + 1 < data_rows) hi = data[r + 1];
    }
    const uint32_t m = mask_of(bw);
    s_stage[warp][lane] = make_uint4(__funnelshift_r(lo.x, hi.x, sh) & m,
                                     __funnelshift_r(lo.y, hi.y, sh) & m,
                                     __funnelshift_r(lo.z, hi.z, sh) & m,
                                     __funnelshift_r(lo.w, hi.w, sh) & m);
    __syncwarp();
    if (pos < FRAME_INTS && g0 + pos < n) stage[pos] = val;
    for (int j = lane + 32; j < n_exc; j += 32) {
      const uint32_t p = read_bits(exc, ebit + 8LL * j, 8, exc_words);
      const uint32_t x = read_bits(exc, vbit + (long long)j * w, w, exc_words);
      if (p < FRAME_INTS && g0 + p < n) stage[p] = x;
    }
    __syncwarp();
    const uint4 o = s_stage[warp][lane];
    const long long e = g0 + 4 * lane;
    if (e + 3 < n) {
      reinterpret_cast<uint4*>(out)[e >> 2] = o;
    } else {
      if (e < n) out[e] = o.x;
      if (e + 1 < n) out[e + 1] = o.y;
      if (e + 2 < n) out[e + 2] = o.z;
    }
    __syncwarp();                     // the stage is rewritten next frame
  }
}

}  // namespace

// control: (ctrl_len,) i32 header bytes, 8-byte aligned; data: (data_rows,
// 4) u32 with one slack row, 16-byte aligned; exceptions: (exc_words,) u32
// with two slack words; out: (n,) u32, 16-byte aligned; q = ceil(n / 4)
// quadruples; scratch: null for a list of one tile, else scratch_words
// >= tiles + 1 u64 words, zeroed here on the stream before the launch.
// Runs on `device` (the caller's current device is restored).  Returns a
// cudaError_t.
extern "C" int repro_pfd_decode(const void* control, const void* data,
                                const void* exceptions, void* out,
                                void* scratch, long long scratch_words,
                                long long n, long long q, long long ctrl_len,
                                long long data_rows, long long exc_words,
                                int device, void* stream) {
  if (n <= 0) return 0;
  const long long nf = (q + FRAME_QUADS - 1) / FRAME_QUADS;
  const long long tiles = (nf + TILE_FRAMES - 1) / TILE_FRAMES;
  if (q != (n + 3) / 4 || ctrl_len < 2 * nf || data_rows < 1 ||
      data_rows > (long long)ROW_MASK || exc_words < 2 ||
      exc_words >= (1LL << 30) || tiles > 0x7FFFFFFFLL ||
      (tiles > 1 && (scratch == nullptr || scratch_words < tiles + 1)) ||
      (reinterpret_cast<uintptr_t>(control) & 7u) ||
      ((reinterpret_cast<uintptr_t>(data) | reinterpret_cast<uintptr_t>(out))
       & 15u))
    return (int)cudaErrorInvalidValue;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return (int)err;
  if (cur != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* status =
      tiles > 1 ? static_cast<unsigned long long*>(scratch) : nullptr;
  if (status)
    err = cudaMemsetAsync(status, 0,
                          (size_t)(tiles + 1) * sizeof(unsigned long long), s);
  if (err == cudaSuccess) {
    pfd_decode_kernel<<<(unsigned)tiles, THREADS, 0, s>>>(
        static_cast<const int2*>(control), static_cast<const uint4*>(data),
        static_cast<const uint32_t*>(exceptions), static_cast<uint32_t*>(out),
        status, n, q, nf, data_rows, exc_words);
    err = cudaGetLastError();
  }
  if (cur != device) cudaSetDevice(cur);
  return (int)err;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
