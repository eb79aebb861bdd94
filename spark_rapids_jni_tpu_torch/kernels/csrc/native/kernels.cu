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
#include <mutex>

#include "sprt_plugin.h"

using namespace sprt_rowops;

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // grid-stride beyond 16 blocks per SM

std::atomic<long long> g_launches[SPRTK_FAMILIES];
std::atomic<long long> g_live{0};
std::mutex g_mu;
int g_device = 0;
cudaStream_t g_stream = nullptr;    // guarded by g_mu
cudaMemPool_t g_pool = nullptr;     // guarded by g_mu

int blocks_for(int64_t items) {
  int64_t b = (items + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

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

// (a) string -> INT8/16/32/64. Replaces native/pjrt/export_ops.py:135
// (make_cast_int: JAX _parse_integer over an [n, L] char matrix).
// Bound: bytes. A row reads its 4-byte offset pair, its validity byte
// and its string, and writes bits/8 + 1 bytes; the parse is a few
// integer operations per byte. Design: one thread per row walking its
// own bytes once (neighbouring threads read neighbouring strings, so a
// warp's reads share cache lines); no char matrix, no padding, so the
// bytes read are the string bytes themselves; the first ANSI error and
// the invalid count are reduced per warp and land in two atomics.
__global__ void cast_integer_kernel(const uint8_t* chars, const int32_t* offsets,
                                    const uint8_t* valid, int64_t n, int bits, bool ansi,
                                    bool strip, void* out, uint8_t* out_valid, uint32_t* status) {
  uint32_t first = 0xffffffffu, count = 0;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    bool in_valid = valid == nullptr || valid[i] != 0;
    int32_t o0 = offsets[i];
    int32_t len = in_valid ? offsets[i + 1] - o0 : 0;
    IntParse r = parse_integer(chars + o0, len, in_valid, bits, ansi, strip);
    switch (bits) {
      case 8:
        ((int8_t*)out)[i] = (int8_t)r.value;
        break;
      case 16:
        ((int16_t*)out)[i] = (int16_t)r.value;
        break;
      case 32:
        ((int32_t*)out)[i] = (int32_t)r.value;
        break;
      default:
        ((int64_t*)out)[i] = r.value;
    }
    out_valid[i] = r.valid ? 1 : 0;
    if (!r.valid) {
      ++count;
      if (in_valid && first == 0xffffffffu) first = (uint32_t)i;
    }
  }
  report(status, first, count);
}

// (b) string -> FLOAT64. Replaces native/pjrt/export_ops.py:160
// (cast_f64: JAX _parse_float). Bound: bytes, as (a): 8 + 1 bytes out
// per row; the double arithmetic is a few operations per row, far under
// the card's float64 rate. Design: as (a); the powers of ten are small
// tables in device memory (cached), read with per-row indices.
__global__ void cast_float64_kernel(const uint8_t* chars, const int32_t* offsets,
                                    const uint8_t* valid, int64_t n, double* out,
                                    uint8_t* out_valid, uint32_t* status) {
  uint32_t first = 0xffffffffu, count = 0;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    bool in_valid = valid == nullptr || valid[i] != 0;
    int32_t o0 = offsets[i];
    int32_t len = in_valid ? offsets[i + 1] - o0 : 0;
    FloatParse r = parse_float(chars + o0, len, in_valid);
    out[i] = r.value;
    out_valid[i] = r.valid ? 1 : 0;
    if (!r.valid) ++count;
    if (r.except && first == 0xffffffffu) first = (uint32_t)i;
  }
  report(status, first, count);
}

// (c) DECIMAL128 add / subtract / multiply at run-time scales. Replaces
// native/pjrt/export_ops.py:176-195 (JAX _add_sub_scales_any,
// _multiply_scales_any). Bound: bytes at Spark's common scales (32 bytes
// in, 17 or 18 out per row), where a row is one 256-bit multiply (ten
// 64x64 partial products) and a digit count; a rescale that divides adds
// a bit-serial 256-by-128 division (some 2,000 operations), and then the
// integer operations bound it. Design: one thread per row with its two
// operands in registers as 16-byte loads; the division runs only in rows
// and ops whose scales need it, from the dividend's highest set bit.
__global__ void decimal128_kernel(int op, const longlong2* a, const longlong2* b,
                                  const uint8_t* a_valid, const uint8_t* b_valid, int64_t n,
                                  int a_scale, int b_scale, int out_scale, int8_t* overflow,
                                  longlong2* out, uint8_t* out_valid) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    longlong2 x = a[i], y = b[i];
    DecResult r = op == SPRTK_DEC_MUL
                      ? multiply(x.x, x.y, y.x, y.y, a_scale, b_scale, out_scale)
                      : add_sub(x.x, x.y, y.x, y.y, a_scale, b_scale, out_scale,
                                op == SPRTK_DEC_SUB);
    bool v = (a_valid == nullptr || a_valid[i] != 0) && (b_valid == nullptr || b_valid[i] != 0);
    out[i] = make_longlong2(r.lo, r.hi);
    overflow[i] = (r.overflow && v) ? 1 : 0;
    if (out_valid != nullptr) out_valid[i] = v ? 1 : 0;
  }
}

// (d) columns -> JCUDF fixed-width rows. Replaces
// native/pjrt/export_ops.py:202 (to_rows: JAX _to_rows_fixed_flat).
// Bound: bytes: each column byte and validity byte read once, each row
// byte written once. Design: one thread per 8-byte word of the output,
// so a warp's stores are 256 contiguous bytes; the thread assembles its
// word from the (at most eight) columns that overlap it, the layout and
// the word -> column ranges arriving by value in the parameters
// (__grid_constant__: read in place, never copied per thread).
__global__ void to_rows_kernel(const __grid_constant__ RowsDesc d, int64_t row0, int64_t n,
                               uint64_t* rows) {
  int32_t words = d.row_size / 8;
  int64_t total = n * words;
  for (int64_t k = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; k < total;
       k += (int64_t)gridDim.x * blockDim.x) {
    int64_t r = k / words;
    rows[k] = row_word(d, row0 + r, (int32_t)(k - r * words));
  }
}

// (d) JCUDF fixed-width rows -> columns. Replaces
// native/pjrt/export_ops.py:209 (from_rows: JAX _from_rows_fixed_flat).
// Bound: bytes, as to_rows. Design: one thread per (column, row), rows
// fastest, so a warp's stores into one column are contiguous; the reads
// stride by the row size and share the rows' cache lines across the
// columns of a row.
__global__ void from_rows_kernel(const __grid_constant__ RowsDesc d, const uint8_t* rows,
                                 int64_t n) {
  int64_t total = n * d.ncols;
  for (int64_t k = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; k < total;
       k += (int64_t)gridDim.x * blockDim.x) {
    int32_t c = (int32_t)(k / n);
    int64_t r = k - c * n;
    row_unpack(d, rows + r * d.row_size, r, c);
  }
}

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

static int init_status(uint32_t* status, cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(status, 0xff, 4, s);
  if (e == cudaSuccess) e = cudaMemsetAsync(status + 1, 0, 4, s);
  return (int)e;
}

int sprtk_cast_to_integer(const uint8_t* chars, const int32_t* offsets, const uint8_t* valid,
                          int64_t n, int bits, int ansi, int strip, void* out,
                          uint8_t* out_valid, uint32_t* status, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int rc = init_status(status, s);
  if (rc != 0 || n <= 0) return rc;
  cast_integer_kernel<<<blocks_for(n), kThreads, 0, s>>>(chars, offsets, valid, n, bits,
                                                         ansi != 0, strip != 0, out, out_valid,
                                                         status);
  return counted(SPRTK_CAST_INTEGER);
}

int sprtk_cast_to_float64(const uint8_t* chars, const int32_t* offsets, const uint8_t* valid,
                          int64_t n, double* out, uint8_t* out_valid, uint32_t* status,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int rc = init_status(status, s);
  if (rc != 0 || n <= 0) return rc;
  cast_float64_kernel<<<blocks_for(n), kThreads, 0, s>>>(chars, offsets, valid, n, out,
                                                         out_valid, status);
  return counted(SPRTK_CAST_FLOAT64);
}

int sprtk_decimal128(int op, const int64_t* a, const int64_t* b, const uint8_t* a_valid,
                     const uint8_t* b_valid, int64_t n, int a_scale, int b_scale, int out_scale,
                     int8_t* overflow, int64_t* out, uint8_t* out_valid, void* stream) {
  if (n <= 0) return 0;
  decimal128_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      op, (const longlong2*)a, (const longlong2*)b, a_valid, b_valid, n, a_scale, b_scale,
      out_scale, overflow, (longlong2*)out, out_valid);
  return counted(SPRTK_DECIMAL128);
}

int sprtk_row_layout(SprtkRowsDesc* desc, int ncols, const int32_t* sizes) {
  return row_layout(desc, ncols, sizes) ? 0 : 1;
}

int sprtk_to_rows(const SprtkRowsDesc* desc, int64_t row0, int64_t n, uint8_t* rows,
                  void* stream) {
  if (n <= 0) return 0;
  to_rows_kernel<<<blocks_for(n * (desc->row_size / 8)), kThreads, 0, (cudaStream_t)stream>>>(
      *desc, row0, n, (uint64_t*)rows);
  return counted(SPRTK_TO_ROWS);
}

int sprtk_from_rows(const SprtkRowsDesc* desc, const uint8_t* rows, int64_t n, void* stream) {
  if (n <= 0) return 0;
  from_rows_kernel<<<blocks_for(n * desc->ncols), kThreads, 0, (cudaStream_t)stream>>>(
      *desc, rows, n);
  return counted(SPRTK_FROM_ROWS);
}

}  // extern "C"
