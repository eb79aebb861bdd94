// The CUDA plugin of the JNI library's native backend: Spark-exact string
// casts, DECIMAL128 arithmetic and JCUDF fixed-width rows on Hopper
// (sm_90a), behind the plain C interface of sprt_plugin.h.
//
// None of these kernels replaces a Pallas kernel. They replace the XLA
// programs that native/pjrt/export_ops.py exports ahead of time for the
// JAX package's C++ PJRT backend (native/jni/pjrt_backend.cpp), each
// named above its kernel. The per-row logic is sprt_rowops.h, shared
// with the host plugin; build with --fmad=false, so that no a*b+c of the
// float parse is contracted into an FMA that the torch version does not
// do.
//
// Buffers come from a memory pool of the plugin's own (stream-ordered,
// kept reserved across frees); the live-bytes counter counts what the
// caller holds. Each launch function enqueues on the caller's stream,
// checks the launch and counts it; it never synchronises.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include "sprt_plugin.h"

using namespace sprt_rowops;

namespace {

constexpr int kThreads = 256;

std::atomic<long long> g_launches[SPRTK_FAMILIES];
std::atomic<long long> g_live{0};
std::mutex g_mu;
int g_device = 0;
cudaStream_t g_stream = nullptr;    // guarded by g_mu
cudaMemPool_t g_pool = nullptr;     // guarded by g_mu

int counted(int family) {
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) g_launches[family].fetch_add(1, std::memory_order_relaxed);
  return (int)e;
}

// warp-aggregated status: status[0] <- min(first), status[1] += count.
// Every lane of the warp reaches it (no early return, blockDim % 32 == 0).
__device__ __forceinline__ void report(uint32_t* status, uint32_t first, uint32_t count) {
  uint32_t w_first = __reduce_min_sync(0xffffffffu, first);
  uint32_t w_count = __reduce_add_sync(0xffffffffu, count);
  if ((threadIdx.x & 31) == 0) {
    if (w_first != 0xffffffffu) atomicMin(&status[0], w_first);
    if (w_count != 0) atomicAdd(&status[1], w_count);
  }
}

// --- staging through shared memory: the string tiles of (a) and (b), the
// row tiles of (d)

// cp.async: global -> shared without passing through registers, 16
// bytes (.cg, L2 only) of which `src_bytes` are read and the rest
// zero-filled, or 8 or 4 bytes
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// u / d for u < 2^14 and d <= kWinWords, with magic = ceil(2^32 / d)
// (exact: u * (magic * d - 2^32) < 2^32)
__device__ __forceinline__ int32_t div_magic(int32_t u, uint64_t magic) {
  return (int32_t)(((uint64_t)(uint32_t)u * magic) >> 32);
}

// rows of tile `tile` (of R rows) among n
__device__ __forceinline__ int32_t tile_count(int64_t n, int64_t tile, int32_t R) {
  int64_t left = n - tile * R;
  return left < R ? (int32_t)left : R;
}

// --- (a) and (b), the string casts, over string tiles staged in shared
// memory

constexpr int32_t kFloatRowsPerThread = kFloatTileRows / kThreads;
static_assert(kFloatTileRows % kThreads == 0, "a tile is whole rows of the block's threads");

// a tile's offsets (nr + 1 of them from row r0) as cp.async copies: of 16
// bytes (the last one cut to the offsets left) where the source and the
// destination are 16-byte aligned, else of 4
__device__ __forceinline__ void stage_offsets(const int32_t* offsets, int64_t r0, int32_t nr,
                                              int32_t* offs) {
  const int32_t* src = offsets + r0;
  if ((((uintptr_t)src | (uintptr_t)offs) & 15) == 0) {
    for (int32_t u = threadIdx.x; 4 * u <= nr; u += blockDim.x) {
      int32_t left = 4 * (nr + 1 - 4 * u);
      cp_async16(offs + 4 * u, src + 4 * u, left < 16 ? left : 16);
    }
  } else {
    for (int32_t i = threadIdx.x; i <= nr; i += blockDim.x) cp_async4(offs + i, src + i);
  }
}

// the chars [o0, o1) as cp.async copies of the 16-byte units from the
// aligned unit that holds the first byte to the one that holds the last
// (the first unit's bytes before o0 share its 16-byte unit, so they lie
// in the same allocation; the last unit reads only up to o1)
__device__ __forceinline__ void stage_chars(const uint8_t* chars, int32_t o0, int32_t o1,
                                            uint8_t* buf) {
  uintptr_t lo = (uintptr_t)(chars + o0) & ~(uintptr_t)15;
  uintptr_t hi = o1 > o0 ? (uintptr_t)(chars + o1) : lo;  // nothing for an empty span
  for (uintptr_t a = lo + 16 * threadIdx.x; a < hi; a += 16 * blockDim.x) {
    cp_async16(buf + (a - lo), (const void*)a, hi - a < 16 ? (int)(hi - a) : 16);
  }
}

// a tile's offsets and the span of its chars that fits a buffer of Span
// bytes (sprt_rowops.h staged_end), as one cp.async group; the span's
// ends are read from device memory
template <int32_t Span>
__device__ __forceinline__ void stage_strings(const uint8_t* chars, const int32_t* offsets,
                                              int64_t r0, int32_t nr, uint8_t* buf,
                                              int32_t* offs) {
  stage_offsets(offsets, r0, nr, offs);
  int32_t o0 = offsets[r0];
  stage_chars(chars, o0, staged_end(o0, offsets[r0 + nr], Span), buf);
  cp_async_commit();
}

// one validity byte per row t of a tile of nr rows (consecutive over a
// warp's lanes, the warp's first t a multiple of 4) at `tile_valid`:
// four rows as one 32-bit store where the four lie in the tile and
// `words` (tile_valid is 4-byte aligned), else a byte each. Every lane of
// the warp calls it.
__device__ __forceinline__ void store_valid4(uint8_t* tile_valid, int32_t t, int32_t nr,
                                             bool words, uint32_t v) {
  uint32_t w = v | (__shfl_down_sync(0xffffffffu, v, 1) << 8) |
               (__shfl_down_sync(0xffffffffu, v, 2) << 16) |
               (__shfl_down_sync(0xffffffffu, v, 3) << 24);
  if (words && (t | 3) < nr) {
    if ((t & 3) == 0) *(uint32_t*)(tile_valid + t) = w;
  } else if (t < nr) {
    tile_valid[t] = (uint8_t)v;
  }
}

// (b) string -> FLOAT64. Replaces native/pjrt/export_ops.py:160
// (cast_f64: JAX _parse_float). Bound: bytes (the chars and offsets
// read once, 8 + 1 bytes written a row); at the reference's ~12-byte
// strings the parse's dependent steps, one thread a row, take most of
// the time (staging alone runs near the byte bound). Design: a
// persistent block walks tiles of kFloatTileRows rows, four rows a
// thread (1024-row tiles timed faster than 256 or 512). Each tile's
// offsets and chars are staged in shared memory by cp.async 16-byte
// copies, the next tile's in flight while this one is parsed (two
// buffers), so a warp reads whole 16-byte units of device memory
// instead of one byte a thread. Each thread parses its rows in one
// forward pass (sprt_rowops.h parse_float) from the buffer, digit runs
// eight bytes at a time; a row that ends past the span the buffer holds
// is parsed in place, a byte at a time. The powers of ten are in shared
// memory (each row indexes them its own way); validity bytes leave four
// to a store; the first ANSI row and the invalid count are reduced per
// warp into two atomics.
__global__ void __launch_bounds__(kThreads)
    cast_float64_kernel(const uint8_t* chars, const int32_t* offsets, const uint8_t* valid,
                        int64_t n, double* out, uint8_t* out_valid, uint32_t* status) {
  __shared__ __align__(16) uint8_t stage[2][kFloatStageBytes];
  __shared__ __align__(16) int32_t offs[2][kFloatTileRows + 4];  // 16-byte aligned rows
  __shared__ FloatTables tab;
  for (int32_t i = threadIdx.x; i < (int32_t)(sizeof(FloatTables) / 8); i += blockDim.x) {
    ((uint64_t*)&tab)[i] = ((const uint64_t*)&kFloatTablesDev)[i];
  }
  uint32_t first = 0xffffffffu, count = 0;
  const int32_t R = kFloatTileRows;
  int64_t ntiles = (n + R - 1) / R;
  int64_t tile = blockIdx.x;
  if (tile < ntiles) {
    stage_strings<kFloatStageSpan>(chars, offsets, tile * R, tile_count(n, tile, R), stage[0],
                                   offs[0]);
  }
  for (int32_t k = 0; tile < ntiles; tile += gridDim.x, ++k) {
    int32_t b = k & 1;
    int64_t next = tile + gridDim.x;
    if (next < ntiles) {
      stage_strings<kFloatStageSpan>(chars, offsets, next * R, tile_count(n, next, R),
                                     stage[b ^ 1], offs[b ^ 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int32_t nr = tile_count(n, tile, R);
    const int32_t* o = offs[b];
    int32_t span_end = staged_end(o[0], o[nr], kFloatStageSpan);
    const uint8_t* staged = stage[b] + ((uintptr_t)(chars + o[0]) & 15);
    uint8_t* tile_valid = out_valid + tile * R;
    bool words = ((uintptr_t)tile_valid & 3) == 0;
    for (int32_t u = 0; u < kFloatRowsPerThread; ++u) {
      int32_t t = u * kThreads + threadIdx.x;  // the row in the tile
      int64_t r = tile * R + t;
      uint32_t vbyte = 0;
      if (t < nr) {
        bool in_valid = valid == nullptr || valid[r] != 0;
        int32_t o0 = o[t], o1 = o[t + 1], len = in_valid ? o1 - o0 : 0;
        // two inlined copies of the parse: the staged one reads shared
        // memory as such, eight bytes at a time in digit runs; the other
        // global memory a byte at a time
        FloatParse p = o1 <= span_end
                           ? parse_float<true>(staged + (o0 - o[0]), len, in_valid, tab)
                           : parse_float<false>(chars + o0, len, in_valid, tab);
        out[r] = p.value;
        vbyte = p.valid ? 1 : 0;
        if (!p.valid) ++count;
        if (p.except && first == 0xffffffffu) first = (uint32_t)r;
      }
      store_valid4(tile_valid, t, nr, words, vbyte);
    }
    __syncthreads();
  }
  report(status, first, count);
}

// (a) string -> INT8/16/32/64. Replaces native/pjrt/export_ops.py:135
// (make_cast_int: JAX _parse_integer over an [n, L] char matrix).
// Bound: bytes (the chars and offsets read once, a validity byte in,
// bits/8 + 1 bytes written a row); at store_sales' 4-5-byte strings the
// offsets and the outputs weigh more than the chars. Design: a
// persistent block walks tiles of kIntTileRows rows staged in shared
// memory by cp.async: a tile's offsets arrive one tile ahead of its
// chars, so the span of chars to copy (16-byte units) is read from
// shared memory and no thread waits on device memory to start a copy;
// the next tile's chars and the offsets of the one after are in flight
// while this tile is parsed (two char buffers, three offset arrays, one
// barrier a tile). A warp reads whole 16-byte units of device memory and
// not one byte a thread. Each thread parses its rows from the buffer in
// one forward pass (sprt_rowops.h parse_integer: a digit run past eight
// digits goes on eight bytes at a time); a row that ends past the staged
// span is parsed in place, a byte at a time. One instantiation per
// target width and strip flag (the host picks it per launch), so no row
// branches on either and each stores its own type; ANSI stays an
// argument, read only at a row's dot; whether the input has a validity
// mask is chosen once a tile. Indices inside a tile are 32-bit; validity
// bytes leave four to a store; the first row made invalid and the
// invalid count are reduced per warp into two atomics. Measured on the
// card (PERF.md): 1024-row tiles of 256 threads timed within a few
// percent of 512-4096 rows with 256-1024 threads, and a byte-at-a-time
// parse of the staged rows within 4 % of the eight-byte runs.
template <int Bits>
struct IntOf;
template <>
struct IntOf<8> {
  using T = int8_t;
};
template <>
struct IntOf<16> {
  using T = int16_t;
};
template <>
struct IntOf<32> {
  using T = int32_t;
};
template <>
struct IntOf<64> {
  using T = int64_t;
};

constexpr int kIntThreads = 256;
static_assert(kIntTileRows % kIntThreads == 0, "a tile is whole rows of the block's threads");
// dynamic shared memory: two char buffers, then three offset arrays of
// R + 1 offsets each, 16-byte aligned
constexpr int32_t kIntOffsStride = kIntTileRows + 4;
constexpr int32_t kIntSmemBytes = 2 * kIntStageBytes + 3 * 4 * kIntOffsStride;

// the rows of one staged tile of the integer cast; HasValid: the input
// has a validity mask (a uniform choice, so no row tests the pointer)
template <int Bits, bool Strip, bool HasValid>
__device__ __forceinline__ void int_tile_rows(const uint8_t* chars, const int32_t* o, int32_t nr,
                                              int32_t base, int32_t span_end,
                                              const uint8_t* staged, const uint8_t* tile_in,
                                              typename IntOf<Bits>::T* tile_out,
                                              uint8_t* tile_valid, bool words, bool ansi,
                                              int64_t r0, uint32_t& first, uint32_t& count) {
#pragma unroll 1
  for (int32_t t = threadIdx.x; t < kIntTileRows; t += kIntThreads) {  // t: the row in the tile
    uint32_t vbyte = 0;
    if (t < nr) {
      bool in_valid = !HasValid || tile_in[t] != 0;
      int32_t o0 = o[t], o1 = o[t + 1];
      IntParse p = o1 <= span_end ? parse_integer<true>(staged + (o0 - base), o1 - o0, in_valid,
                                                        Bits, ansi, Strip)
                                  : parse_integer<false>(chars + o0, o1 - o0, in_valid, Bits,
                                                         ansi, Strip);
      tile_out[t] = (typename IntOf<Bits>::T)p.value;
      vbyte = p.valid ? 1 : 0;
      if (!p.valid) {
        ++count;
        if (in_valid && first == 0xffffffffu) first = (uint32_t)(r0 + t);
      }
    }
    store_valid4(tile_valid, t, nr, words, vbyte);
  }
}

template <int Bits, bool Strip>
__global__ void __launch_bounds__(kIntThreads)
    cast_integer_kernel(const uint8_t* chars, const int32_t* offsets, const uint8_t* valid,
                        int64_t n, bool ansi, typename IntOf<Bits>::T* out, uint8_t* out_valid,
                        uint32_t* status) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int32_t R = kIntTileRows;
  int32_t* offs0 = (int32_t*)(smem + 2 * kIntStageBytes);
  uint32_t first = 0xffffffffu, count = 0;
  int64_t ntiles = (n + R - 1) / R;
  int64_t tile = blockIdx.x;
  if (tile < ntiles) {  // the first tile's offsets, then its chars and the next tile's offsets
    int32_t nr = tile_count(n, tile, R);
    stage_offsets(offsets, tile * R, nr, offs0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    stage_chars(chars, offs0[0], staged_end(offs0[0], offs0[nr], kIntStageSpan), smem);
    int64_t next = tile + gridDim.x;
    if (next < ntiles) {
      stage_offsets(offsets, next * R, tile_count(n, next, R), offs0 + kIntOffsStride);
    }
    cp_async_commit();
  }
  for (int32_t k = 0; tile < ntiles; tile += gridDim.x, ++k) {
    cp_async_wait<0>();
    __syncthreads();  // this tile's chars and the next one's offsets are in; tile k - 1 is done
    int64_t next = tile + gridDim.x;
    if (next < ntiles) {
      const int32_t* on = offs0 + ((k + 1) % 3) * kIntOffsStride;
      int32_t nn = tile_count(n, next, R);
      stage_chars(chars, on[0], staged_end(on[0], on[nn], kIntStageSpan),
                  smem + ((k + 1) & 1) * kIntStageBytes);
      int64_t after = next + gridDim.x;
      if (after < ntiles) {
        stage_offsets(offsets, after * R, tile_count(n, after, R),
                      offs0 + ((k + 2) % 3) * kIntOffsStride);
      }
      cp_async_commit();
    }
    int32_t nr = tile_count(n, tile, R);
    const int32_t* o = offs0 + (k % 3) * kIntOffsStride;
    int32_t base = o[0];
    int32_t span_end = staged_end(base, o[nr], kIntStageSpan);
    const uint8_t* staged = smem + (k & 1) * kIntStageBytes + ((uintptr_t)(chars + base) & 15);
    int64_t r0 = tile * R;
    uint8_t* tile_valid = out_valid + r0;
    bool words = ((uintptr_t)tile_valid & 3) == 0;
    if (valid != nullptr) {
      int_tile_rows<Bits, Strip, true>(chars, o, nr, base, span_end, staged, valid + r0, out + r0,
                                       tile_valid, words, ansi, r0, first, count);
    } else {
      int_tile_rows<Bits, Strip, false>(chars, o, nr, base, span_end, staged, nullptr, out + r0,
                                        tile_valid, words, ansi, r0, first, count);
    }
  }
  report(status, first, count);
}

// the instantiation of each launch: [log2(bits / 8)][strip]
const void* const kIntKernels[4][2] = {
    {(const void*)cast_integer_kernel<8, false>, (const void*)cast_integer_kernel<8, true>},
    {(const void*)cast_integer_kernel<16, false>, (const void*)cast_integer_kernel<16, true>},
    {(const void*)cast_integer_kernel<32, false>, (const void*)cast_integer_kernel<32, true>},
    {(const void*)cast_integer_kernel<64, false>, (const void*)cast_integer_kernel<64, true>}};

// (c) DECIMAL128 add / subtract / multiply at run-time scales. Replaces
// native/pjrt/export_ops.py:176-195 (JAX _add_sub_scales_any,
// _multiply_scales_any). Bound: bytes (32 bytes in, 17 or 18 out per
// row) where the launch's scales need no rescale; a division by 10^k
// (one or two steps of 64-bit long division by a precomputed
// reciprocal) or a raise adds integer work. Design: one
// instantiation per regime of the launch's scales (sprt_rowops.h
// dec_plan: the host picks it), so q1's multiply (2, 2 -> 4) compiles no
// rescale at all; a product is |a| * |b| in four 64x64 partial products
// (one when both fit 64 bits) and its digits are counted from its bit
// length against the table of 10^k, which the raising instantiations
// keep in shared memory (each row indexes it its own way). A product
// over 38 digits takes the general form out of line. The grid fills
// every SM with as many blocks as fit, one row a thread at a time.
template <bool MUL, int32_t R>
__global__ void __launch_bounds__(kThreads)
    decimal128_kernel(DecPlan p, const longlong2* __restrict__ a, const longlong2* __restrict__ b,
                      const uint8_t* __restrict__ a_valid, const uint8_t* __restrict__ b_valid,
                      int64_t n, int8_t* __restrict__ overflow, longlong2* __restrict__ out,
                      uint8_t* __restrict__ out_valid) {
  constexpr bool kShared = (R & kDecUp) != 0;
  __shared__ uint64_t p10s[kShared ? 4 * 78 : 1];
  const uint64_t* p10 = kPow10x4_dev;
  if (kShared) {
    for (int32_t i = threadIdx.x; i < 4 * 78; i += blockDim.x) p10s[i] = kPow10x4_dev[i];
    __syncthreads();
    p10 = p10s;
  }
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    longlong2 x = __ldg(a + i), y = __ldg(b + i);
    bool v = (a_valid == nullptr || __ldg(a_valid + i) != 0) &&
             (b_valid == nullptr || __ldg(b_valid + i) != 0);
    DecResult r = decimal_row<MUL, R>(p, x.x, x.y, y.x, y.y, p10);
    out[i] = make_longlong2(r.lo, r.hi);
    overflow[i] = (r.overflow && v) ? 1 : 0;
    if (out_valid != nullptr) out_valid[i] = v ? 1 : 0;
  }
}

// the instantiation of each plan: [multiply][regime]
const void* const kDecimalKernels[2][4] = {
    {(const void*)decimal128_kernel<false, 0>, (const void*)decimal128_kernel<false, kDecDown>,
     (const void*)decimal128_kernel<false, kDecUp>,
     (const void*)decimal128_kernel<false, kDecDown | kDecUp>},
    {(const void*)decimal128_kernel<true, 0>, (const void*)decimal128_kernel<true, kDecDown>,
     (const void*)decimal128_kernel<true, kDecUp>,
     (const void*)decimal128_kernel<true, kDecDown | kDecUp>}};

// --- (d) JCUDF fixed-width rows, as tile transposes through shared memory

// to rows: the tile of rows [g0, g0 + nr) assembled in `tile` (stride
// S): each data column's values at tile_offset, 4, 8 and 16-byte values
// as cp.async copies straight from the column, 1 and 2-byte values
// through registers (a warp reads 32 neighbouring values either way);
// then the validity bytes. The padding bytes were zeroed once and are
// never written.
__device__ __forceinline__ void stage_columns(const RowsWin& w, uint8_t* tile, int32_t S,
                                              int64_t g0, int32_t nr) {
  for (int32_t i = 0; i < w.ndata; ++i) {
    int32_t sz = w.size[i];
    const uint8_t* src = (const uint8_t*)w.data[i] + g0 * sz;
    if (sz == 16) {
      for (int32_t r = threadIdx.x; r < nr; r += blockDim.x) {
        uint8_t* dst = tile + tile_offset(w, S, r, i);
        cp_async8(dst, src + 16 * r);
        cp_async8(dst + 8, src + 16 * r + 8);
      }
    } else if (sz == 8) {
      for (int32_t r = threadIdx.x; r < nr; r += blockDim.x) {
        cp_async8(tile + tile_offset(w, S, r, i), src + 8 * r);
      }
    } else if (sz == 4) {
      for (int32_t r = threadIdx.x; r < nr; r += blockDim.x) {
        cp_async4(tile + tile_offset(w, S, r, i), src + 4 * r);
      }
    } else {
      for (int32_t r = threadIdx.x; r < nr; r += blockDim.x) {
        store_le(tile + tile_offset(w, S, r, i), sz, load_le(src + sz * r, sz));
      }
    }
  }
  for (int32_t b = 0; b < (w.nvalid + 7) / 8; ++b) {
    for (int32_t r = threadIdx.x; r < nr; r += blockDim.x) {
      tile[r * S + w.vrel + b] = validity_byte(w, g0 + r, b);
    }
  }
  cp_async_commit();
}

// from rows: the window bytes of rows [t0, t0 + nr) into `tile` (stride
// S): the whole row unpadded as one contiguous span of 16-byte copies,
// else 8-byte copies per row word
__device__ __forceinline__ void stage_rows(const RowsWin& w, uint8_t* tile, int32_t S,
                                           const uint8_t* rows, int64_t t0, int32_t nr,
                                           uint64_t magic) {
  const uint8_t* src = rows + t0 * w.row_size;
  if (S == w.row_size && ((uintptr_t)src & 15) == 0) {
    int32_t nbytes = nr * w.row_size;
    for (int32_t k = 16 * threadIdx.x; k < nbytes; k += 16 * blockDim.x) {
      cp_async16(tile + k, src + k, min32(16, nbytes - k));
    }
  } else {
    int32_t units = nr * w.nwords;
    for (int32_t u = threadIdx.x; u < units; u += blockDim.x) {
      int32_t r = div_magic(u, magic), j = u - r * w.nwords;
      cp_async8(tile + r * S + 8 * j, src + (int64_t)r * w.row_size + 8 * (w.w0 + j));
    }
  }
  cp_async_commit();
}

// (d) columns -> JCUDF fixed-width rows. Replaces
// native/pjrt/export_ops.py:202 (to_rows: JAX _to_rows_fixed_flat).
// Bound: bytes: each column byte and validity byte read once, each row
// byte written once. Design: a tile transpose in shared memory. A
// persistent block walks tiles of R rows with two row-major tiles: while
// it writes one out, the next one's columns are in flight as cp.async
// copies (stage_columns: one uniform loop over the columns, so the
// layout is read warp-uniformly from the parameters, and a warp's reads
// of a column are contiguous). A tile's window bytes then leave as
// 16-byte stores of one contiguous run when the window is the whole
// row, 8-byte stores per word otherwise. Indices inside a tile are
// 32-bit; a word index -> (row, word) is a multiply by a magic number.
// A window (sprt_rowops.h plan_window) carries at most kWinCols columns
// of a row; a wider schema launches once per window.
__global__ void __launch_bounds__(kThreads)
    to_rows_kernel(const __grid_constant__ RowsWin w, int64_t row0, int64_t n, int32_t R,
                   uint8_t* rows, uint64_t magic) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t S = tile_stride(w);
  int32_t tile_bytes = R * S;
  for (int32_t k = 4 * threadIdx.x; k < 2 * tile_bytes; k += 4 * blockDim.x) {
    *(uint32_t*)(smem + k) = 0;  // the padding, never written again
  }
  __syncthreads();
  int64_t ntiles = (n + R - 1) / R;
  int64_t tile = blockIdx.x;
  if (tile < ntiles) stage_columns(w, smem, S, row0 + tile * R, tile_count(n, tile, R));
  for (int32_t k = 0; tile < ntiles; tile += gridDim.x, ++k) {
    uint8_t* cur = smem + (k & 1) * tile_bytes;
    int64_t next = tile + gridDim.x;
    if (next < ntiles) {
      stage_columns(w, smem + ((k + 1) & 1) * tile_bytes, S, row0 + next * R,
                    tile_count(n, next, R));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int32_t nr = tile_count(n, tile, R);
    uint8_t* out = rows + tile * R * w.row_size + 8 * w.w0;
    if (S == w.row_size && ((uintptr_t)out & 15) == 0) {  // the whole row: one run
      int32_t nbytes = nr * S;
      for (int32_t b = 16 * threadIdx.x; b < nbytes; b += 16 * blockDim.x) {
        if (b + 16 <= nbytes) {
          *(uint4*)(out + b) = *(const uint4*)(cur + b);
        } else {
          *(uint64_t*)(out + b) = *(const uint64_t*)(cur + b);
        }
      }
    } else {
      int32_t units = nr * w.nwords;
      for (int32_t u = threadIdx.x; u < units; u += blockDim.x) {
        int32_t r = div_magic(u, magic), j = u - r * w.nwords;
        *(uint64_t*)(out + (int64_t)r * w.row_size + 8 * j) =
            *(const uint64_t*)(cur + r * S + 8 * j);
      }
    }
    __syncthreads();
  }
}

// (d) JCUDF fixed-width rows -> columns. Replaces
// native/pjrt/export_ops.py:209 (from_rows: JAX _from_rows_fixed_flat).
// Bound: bytes, as to_rows. Design: the mirror image. A persistent
// block stages a tile's rows once (the whole row: one contiguous span of
// R * row_size bytes as 16-byte cp.async copies; a window of a wide
// row: its 8-byte words), the next tile in flight while this one is
// unpacked, so the row buffer is read once and not once per column.
// Then, column by column (a block-uniform loop, so the layout is read
// warp-uniformly from the parameters), thread t writes row t's value
// and validity byte: each column's stores are contiguous.
__global__ void __launch_bounds__(kThreads)
    from_rows_kernel(const __grid_constant__ RowsWin w, const uint8_t* rows, int64_t n,
                     int32_t R, uint64_t magic) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t S = tile_stride(w);
  int32_t tile_bytes = R * S;
  int64_t ntiles = (n + R - 1) / R;
  int64_t tile = blockIdx.x;
  if (tile < ntiles) stage_rows(w, smem, S, rows, tile * R, tile_count(n, tile, R), magic);
  for (int32_t k = 0; tile < ntiles; tile += gridDim.x, ++k) {
    uint8_t* cur = smem + (k & 1) * tile_bytes;
    int64_t next = tile + gridDim.x;
    if (next < ntiles) {
      stage_rows(w, smem + ((k + 1) & 1) * tile_bytes, S, rows, next * R,
                 tile_count(n, next, R), magic);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int32_t nr = tile_count(n, tile, R);
    int64_t t0 = tile * R;
    for (int32_t i = 0; i < w.ndata; ++i) {
      for (int32_t r = threadIdx.x; r < nr; r += blockDim.x) {
        tile_unpack(w, cur + r * S, t0 + r, i);
      }
    }
    for (int32_t i = 0; i < w.nvalid; ++i) {
      for (int32_t r = threadIdx.x; r < nr; r += blockDim.x) {
        tile_unpack_valid(w, cur + r * S, t0 + r, i);
      }
    }
    __syncthreads();
  }
}

// the grid of a persistent row kernel: every SM filled with as many
// blocks of `threads` as fit, never more blocks than tiles. The SM count
// and the occupancy of each (kernel, shared bytes) are read once and kept
// (dynamic shared memory past 48 KB is allowed for the kernel first): a
// launch inside a graph capture makes no query
int persistent_blocks(const void* kernel, int32_t smem_bytes, int64_t ntiles, int* blocks,
                      int threads = kThreads) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int32_t>, int64_t> per_device;  // guarded by mu
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lk(mu);
  auto key = std::make_tuple(dev, kernel, smem_bytes);
  auto it = per_device.find(key);
  if (it == per_device.end()) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && smem_bytes > 48 * 1024) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem_bytes);
    }
    if (e != cudaSuccess) return (int)e;
    it = per_device.emplace(key, (int64_t)sms * (per_sm > 0 ? per_sm : 1)).first;
  }
  *blocks = (int)(it->second < ntiles ? it->second : ntiles);
  return 0;
}

uint64_t magic_of(int32_t d) { return ((1ull << 32) + (uint64_t)d - 1) / (uint64_t)d; }

}  // namespace

extern "C" {

int sprtk_init(int device) {
  std::lock_guard<std::mutex> lk(g_mu);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (g_stream != nullptr && g_device == device) return 0;
  cudaMemPoolProps props = {};
  props.allocType = cudaMemAllocationTypePinned;
  props.location.type = cudaMemLocationTypeDevice;
  props.location.id = device;
  cudaMemPool_t pool;
  e = cudaMemPoolCreate(&pool, &props);
  if (e != cudaSuccess) return (int)e;
  uint64_t keep = UINT64_MAX;
  e = cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold, &keep);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s;
  e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (e != cudaSuccess) return (int)e;
  g_pool = pool;
  g_stream = s;
  g_device = device;
  return 0;
}

const char* sprtk_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }

void* sprtk_stream(void) {
  std::lock_guard<std::mutex> lk(g_mu);
  return (void*)g_stream;
}

int sprtk_alloc(void** p, size_t bytes, void* stream) {
  *p = nullptr;
  if (bytes == 0) return 0;
  cudaMemPool_t pool;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    pool = g_pool;
  }
  if (pool == nullptr) return (int)cudaErrorInitializationError;
  cudaError_t e = cudaMallocFromPoolAsync(p, bytes, pool, (cudaStream_t)stream);
  if (e != cudaSuccess) {
    *p = nullptr;
    cudaGetLastError();  // an allocation failure is not sticky: clear it
    return (int)e;
  }
  g_live.fetch_add((long long)bytes);
  return 0;
}

int sprtk_free(void* p, size_t bytes, void* stream) {
  if (p == nullptr) return 0;
  g_live.fetch_sub((long long)bytes);
  return (int)cudaFreeAsync(p, (cudaStream_t)stream);
}

int sprtk_copy(void* dst, const void* src, size_t bytes, void* stream) {
  if (bytes == 0) return 0;
  return (int)cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDefault, (cudaStream_t)stream);
}

int sprtk_sync(void* stream) { return (int)cudaStreamSynchronize((cudaStream_t)stream); }

long long sprtk_live_bytes(void) { return g_live.load(); }

long long sprtk_launches(int family) {
  return family >= 0 && family < SPRTK_FAMILIES ? g_launches[family].load() : -1;
}

void sprtk_reset_launches(void) {
  for (auto& c : g_launches) c.store(0);
}

// the status words before a cast: status[0] <- 0xffffffff (no row),
// status[1] <- 0, as one 8-byte copy from a device constant: one stream
// operation (each one ahead of the kernel costs the card a few
// microseconds, PERF.md); the constant's address is read once per device
__device__ const uint32_t kStatusInit[2] = {0xffffffffu, 0u};

static int init_status(uint32_t* status, cudaStream_t s) {
  static std::mutex mu;
  static std::map<int, void*> src_of;  // guarded by mu
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  void* src = nullptr;
  {
    std::lock_guard<std::mutex> lk(mu);
    auto it = src_of.find(dev);
    if (it == src_of.end()) {
      e = cudaGetSymbolAddress(&src, kStatusInit);
      if (e != cudaSuccess) return (int)e;
      src_of.emplace(dev, src);
    } else {
      src = it->second;
    }
  }
  return (int)cudaMemcpyAsync(status, src, 8, cudaMemcpyDeviceToDevice, s);
}

int sprtk_cast_to_integer(const uint8_t* chars, const int32_t* offsets, const uint8_t* valid,
                          int64_t n, int bits, int ansi, int strip, void* out,
                          uint8_t* out_valid, uint32_t* status, void* stream) {
  int w = bits == 8 ? 0 : bits == 16 ? 1 : bits == 32 ? 2 : bits == 64 ? 3 : -1;
  if (w < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = init_status(status, s);
  if (rc != 0 || n <= 0) return rc;
  const void* kernel = kIntKernels[w][strip != 0];
  int blocks = 0;
  rc = persistent_blocks(kernel, kIntSmemBytes, (n + kIntTileRows - 1) / kIntTileRows, &blocks,
                         kIntThreads);
  if (rc != 0) return rc;
  bool a = ansi != 0;
  void* args[] = {&chars, &offsets, &valid, &n, &a, &out, &out_valid, &status};
  cudaError_t e =
      cudaLaunchKernel(kernel, dim3(blocks), dim3(kIntThreads), args, kIntSmemBytes, s);
  if (e != cudaSuccess) return (int)e;
  return counted(SPRTK_CAST_INTEGER);
}

int sprtk_cast_to_float64(const uint8_t* chars, const int32_t* offsets, const uint8_t* valid,
                          int64_t n, double* out, uint8_t* out_valid, uint32_t* status,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int rc = init_status(status, s);
  if (rc != 0 || n <= 0) return rc;
  int blocks = 0;
  rc = persistent_blocks((const void*)cast_float64_kernel, 0,
                         (n + kFloatTileRows - 1) / kFloatTileRows, &blocks);
  if (rc != 0) return rc;
  cast_float64_kernel<<<blocks, kThreads, 0, s>>>(chars, offsets, valid, n, out, out_valid,
                                                  status);
  return counted(SPRTK_CAST_FLOAT64);
}

int sprtk_decimal128(int op, const int64_t* a, const int64_t* b, const uint8_t* a_valid,
                     const uint8_t* b_valid, int64_t n, int a_scale, int b_scale, int out_scale,
                     int8_t* overflow, int64_t* out, uint8_t* out_valid, void* stream) {
  if (n <= 0) return 0;
  DecPlan p = dec_plan(op == SPRTK_DEC_MUL, op == SPRTK_DEC_SUB, a_scale, b_scale, out_scale);
  void* args[] = {&p, &a, &b, &a_valid, &b_valid, &n, &overflow, &out, &out_valid};
  int blocks = 0;
  int rc = persistent_blocks(kDecimalKernels[p.mul][p.regime], 0, (n + kThreads - 1) / kThreads,
                             &blocks);
  if (rc != 0) return rc;
  cudaError_t e = cudaLaunchKernel(kDecimalKernels[p.mul][p.regime], dim3(blocks), dim3(kThreads), args,
                                   0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return counted(SPRTK_DECIMAL128);
}

int sprtk_row_layout(SprtkRowsDesc* desc, int ncols, const int32_t* sizes) {
  return row_layout(desc, ncols, sizes) ? 0 : 1;
}

int sprtk_to_rows(const SprtkRowsDesc* desc, int64_t row0, int64_t n, uint8_t* rows,
                  void* stream) {
  if (n <= 0) return 0;
  if (((uintptr_t)rows & 7) != 0) return (int)cudaErrorMisalignedAddress;
  RowsWin win;
  for (int32_t w0 = 0; w0 < desc->row_size / 8;) {
    int32_t w1 = plan_window(*desc, w0, &win);
    int32_t R = tile_rows(tile_stride(win));
    int32_t smem = 2 * R * tile_stride(win);
    int blocks = 0;
    int rc = persistent_blocks((const void*)to_rows_kernel, smem, (n + R - 1) / R, &blocks);
    if (rc != 0) return rc;
    to_rows_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(win, row0, n, R, rows,
                                                                     magic_of(win.nwords));
    rc = counted(SPRTK_TO_ROWS);
    if (rc != 0) return rc;
    w0 = w1;
  }
  return 0;
}

int sprtk_from_rows(const SprtkRowsDesc* desc, const uint8_t* rows, int64_t n, void* stream) {
  if (n <= 0) return 0;
  if (((uintptr_t)rows & 7) != 0) return (int)cudaErrorMisalignedAddress;
  RowsWin win;
  for (int32_t w0 = 0; w0 < desc->row_size / 8;) {
    int32_t w1 = plan_window(*desc, w0, &win);
    int32_t R = tile_rows(tile_stride(win));
    int32_t smem = 2 * R * tile_stride(win);
    int blocks = 0;
    int rc = persistent_blocks((const void*)from_rows_kernel, smem, (n + R - 1) / R, &blocks);
    if (rc != 0) return rc;
    from_rows_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(win, rows, n, R,
                                                                       magic_of(win.nwords));
    rc = counted(SPRTK_FROM_ROWS);
    if (rc != 0) return rc;
    w0 = w1;
  }
  return 0;
}

// loads the module of every kernel now (CUDA loads them lazily, at a
// first launch), so that a first launch inside a graph capture finds
// it loaded
int sprtk_preload(void) {
  cudaFuncAttributes a;
  const void* kernels[] = {(const void*)cast_float64_kernel, (const void*)to_rows_kernel,
                           (const void*)from_rows_kernel};
  for (const void* k : kernels) {
    cudaError_t e = cudaFuncGetAttributes(&a, k);
    if (e != cudaSuccess) return (int)e;
  }
  for (const auto& per_width : kIntKernels) {
    for (const void* k : per_width) {
      cudaError_t e = cudaFuncGetAttributes(&a, k);
      if (e != cudaSuccess) return (int)e;
    }
  }
  for (const auto& per_op : kDecimalKernels) {
    for (const void* k : per_op) {
      cudaError_t e = cudaFuncGetAttributes(&a, k);
      if (e != cudaSuccess) return (int)e;
    }
  }
  return 0;
}

}  // extern "C"
