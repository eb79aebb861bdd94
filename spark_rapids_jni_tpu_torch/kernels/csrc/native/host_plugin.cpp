// The host plugin of the JNI library's native backend: the C interface
// of sprt_plugin.h over host memory, each "launch" a loop over the rows
// that calls the same per-row functions (sprt_rowops.h) as the CUDA
// plugin's kernels. It exists so that the backend and its row logic are
// tested on a machine with no card; the backend uses it only when its
// caller asks for the CPU (runtime/jni_backend.init_native(device="cpu")).
// Build with -ffp-contract=off, as the CUDA plugin with --fmad=false.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "sprt_plugin.h"

using namespace sprt_rowops;

namespace {

constexpr int kOk = 0;
constexpr int kInvalidValue = 1;
constexpr int kOutOfMemory = 2;

std::atomic<long long> g_launches[SPRTK_FAMILIES];
std::atomic<long long> g_live{0};

void counted(int family) { g_launches[family].fetch_add(1, std::memory_order_relaxed); }

// the rows of one decimal launch, in the plan's op and regime R
template <bool MUL, int32_t R>
void dec_rows_in(const DecPlan& p, const int64_t* a, const int64_t* b, const uint8_t* a_valid,
                 const uint8_t* b_valid, int64_t n, int8_t* overflow, int64_t* out,
                 uint8_t* out_valid) {
  for (int64_t i = 0; i < n; ++i) {
    DecResult r = decimal_row<MUL, R>(p, a[2 * i], a[2 * i + 1], b[2 * i], b[2 * i + 1],
                                      kPow10x4_host);
    bool v = (a_valid == nullptr || a_valid[i] != 0) && (b_valid == nullptr || b_valid[i] != 0);
    out[2 * i] = r.lo;
    out[2 * i + 1] = r.hi;
    overflow[i] = (r.overflow && v) ? 1 : 0;
    if (out_valid != nullptr) out_valid[i] = v ? 1 : 0;
  }
}

template <bool MUL>
void dec_rows(const DecPlan& p, const int64_t* a, const int64_t* b, const uint8_t* a_valid,
              const uint8_t* b_valid, int64_t n, int8_t* overflow, int64_t* out,
              uint8_t* out_valid) {
  switch (p.regime) {
    case 0:
      dec_rows_in<MUL, 0>(p, a, b, a_valid, b_valid, n, overflow, out, out_valid);
      break;
    case kDecDown:
      dec_rows_in<MUL, kDecDown>(p, a, b, a_valid, b_valid, n, overflow, out, out_valid);
      break;
    case kDecUp:
      dec_rows_in<MUL, kDecUp>(p, a, b, a_valid, b_valid, n, overflow, out, out_valid);
      break;
    default:
      dec_rows_in<MUL, kDecDown | kDecUp>(p, a, b, a_valid, b_valid, n, overflow, out,
                                           out_valid);
  }
}

}  // namespace

extern "C" {

int sprtk_init(int device) { return device == 0 ? kOk : kInvalidValue; }

int sprtk_preload(void) { return kOk; }

const char* sprtk_error_string(int rc) {
  switch (rc) {
    case kOk:
      return "no error";
    case kInvalidValue:
      return "invalid argument";
    case kOutOfMemory:
      return "out of memory";
    default:
      return "unknown error";
  }
}

void* sprtk_stream(void) { return nullptr; }

int sprtk_alloc(void** p, size_t bytes, void*) {
  *p = nullptr;
  if (bytes == 0) return kOk;
  *p = std::malloc(bytes);
  if (*p == nullptr) return kOutOfMemory;
  g_live.fetch_add((long long)bytes);
  return kOk;
}

int sprtk_free(void* p, size_t bytes, void*) {
  if (p == nullptr) return kOk;
  g_live.fetch_sub((long long)bytes);
  std::free(p);
  return kOk;
}

int sprtk_copy(void* dst, const void* src, size_t bytes, void*) {
  if (bytes != 0) std::memmove(dst, src, bytes);
  return kOk;
}

int sprtk_sync(void*) { return kOk; }

long long sprtk_live_bytes(void) { return g_live.load(); }

long long sprtk_launches(int family) {
  return family >= 0 && family < SPRTK_FAMILIES ? g_launches[family].load() : -1;
}

void sprtk_reset_launches(void) {
  for (auto& c : g_launches) c.store(0);
}

// the CUDA kernels' string tiles, tile by tile: the same span of each
// tile's chars staged (sprt_rowops.h staged_end, into a buffer of the
// kernel's size), the same rows parsed from it and the others from the
// chars
int sprtk_cast_to_integer(const uint8_t* chars, const int32_t* offsets, const uint8_t* valid,
                          int64_t n, int bits, int ansi, int strip, void* out,
                          uint8_t* out_valid, uint32_t* status, void*) {
  if (bits != 8 && bits != 16 && bits != 32 && bits != 64) return kInvalidValue;
  status[0] = 0xffffffffu;
  status[1] = 0;
  if (n <= 0) return kOk;
  std::vector<uint8_t> stage(kIntStageBytes);
  for (int64_t r0 = 0; r0 < n; r0 += kIntTileRows) {
    int64_t r1 = std::min<int64_t>(r0 + kIntTileRows, n);
    int32_t base = offsets[r0], end = staged_end(base, offsets[r1], kIntStageSpan);
    if (end > base) std::memcpy(stage.data(), chars + base, (size_t)(end - base));
    for (int64_t i = r0; i < r1; ++i) {
      bool in_valid = valid == nullptr || valid[i] != 0;
      int32_t o = offsets[i], len = offsets[i + 1] - o;
      IntParse r = offsets[i + 1] <= end
                       ? parse_integer<true>(stage.data() + (o - base), len, in_valid, bits,
                                             ansi != 0, strip != 0)
                       : parse_integer<false>(chars + o, len, in_valid, bits, ansi != 0,
                                              strip != 0);
      store_le((uint8_t*)out + i * (bits / 8), bits / 8, (uint64_t)r.value);
      out_valid[i] = r.valid ? 1 : 0;
      if (!r.valid) {
        ++status[1];
        if (in_valid && status[0] == 0xffffffffu) status[0] = (uint32_t)i;
      }
    }
  }
  counted(SPRTK_CAST_INTEGER);
  return kOk;
}

// as sprtk_cast_to_integer, over the float cast's tiles
int sprtk_cast_to_float64(const uint8_t* chars, const int32_t* offsets, const uint8_t* valid,
                          int64_t n, double* out, uint8_t* out_valid, uint32_t* status, void*) {
  status[0] = 0xffffffffu;
  status[1] = 0;
  if (n <= 0) return kOk;
  std::vector<uint8_t> stage(kFloatStageBytes);
  for (int64_t r0 = 0; r0 < n; r0 += kFloatTileRows) {
    int64_t r1 = std::min<int64_t>(r0 + kFloatTileRows, n);
    int32_t base = offsets[r0], end = staged_end(base, offsets[r1], kFloatStageSpan);
    if (end > base) std::memcpy(stage.data(), chars + base, (size_t)(end - base));
    for (int64_t i = r0; i < r1; ++i) {
      bool in_valid = valid == nullptr || valid[i] != 0;
      int32_t o = offsets[i], len = in_valid ? offsets[i + 1] - o : 0;
      FloatParse r = offsets[i + 1] <= end
                         ? parse_float<true>(stage.data() + (o - base), len, in_valid, kFloatTables)
                         : parse_float<false>(chars + o, len, in_valid, kFloatTables);
      out[i] = r.value;
      out_valid[i] = r.valid ? 1 : 0;
      if (!r.valid) ++status[1];
      if (r.except && status[0] == 0xffffffffu) status[0] = (uint32_t)i;
    }
  }
  counted(SPRTK_CAST_FLOAT64);
  return kOk;
}

int sprtk_decimal128(int op, const int64_t* a, const int64_t* b, const uint8_t* a_valid,
                     const uint8_t* b_valid, int64_t n, int a_scale, int b_scale, int out_scale,
                     int8_t* overflow, int64_t* out, uint8_t* out_valid, void*) {
  if (n <= 0) return kOk;
  DecPlan p = dec_plan(op == SPRTK_DEC_MUL, op == SPRTK_DEC_SUB, a_scale, b_scale, out_scale);
  if (p.mul) {  // the instantiation the CUDA plugin launches
    dec_rows<true>(p, a, b, a_valid, b_valid, n, overflow, out, out_valid);
  } else {
    dec_rows<false>(p, a, b, a_valid, b_valid, n, overflow, out, out_valid);
  }
  counted(SPRTK_DECIMAL128);
  return kOk;
}

int sprtk_row_layout(SprtkRowsDesc* desc, int ncols, const int32_t* sizes) {
  return row_layout(desc, ncols, sizes) ? kOk : kInvalidValue;
}

// the CUDA plugin's tile transposes, tile by tile on the host: the same
// windows (plan_window), tile strides and heights (tile_stride,
// tile_rows) and byte placement (tile_offset, validity_byte,
// tile_unpack), with memcpy in place of the cp.async copies
int sprtk_to_rows(const SprtkRowsDesc* desc, int64_t row0, int64_t n, uint8_t* rows, void*) {
  if (n <= 0) return kOk;
  RowsWin w;
  for (int32_t w0 = 0; w0 < desc->row_size / 8;) {
    int32_t w1 = plan_window(*desc, w0, &w);
    int32_t S = tile_stride(w), R = tile_rows(S);
    std::vector<uint8_t> tile((size_t)R * S, 0);  // the padding stays 0
    for (int64_t t0 = 0; t0 < n; t0 += R) {
      int32_t nr = (int32_t)std::min<int64_t>(R, n - t0);
      for (int32_t i = 0; i < w.ndata; ++i) {
        const uint8_t* src = (const uint8_t*)w.data[i] + (row0 + t0) * w.size[i];
        for (int32_t r = 0; r < nr; ++r) {
          std::memcpy(tile.data() + tile_offset(w, S, r, i), src + r * w.size[i], w.size[i]);
        }
      }
      for (int32_t b = 0; b < (w.nvalid + 7) / 8; ++b) {
        for (int32_t r = 0; r < nr; ++r) {
          tile[r * S + w.vrel + b] = validity_byte(w, row0 + t0 + r, b);
        }
      }
      for (int32_t r = 0; r < nr; ++r) {
        std::memcpy(rows + (t0 + r) * w.row_size + 8 * w.w0, tile.data() + r * S, 8 * w.nwords);
      }
    }
    counted(SPRTK_TO_ROWS);
    w0 = w1;
  }
  return kOk;
}

int sprtk_from_rows(const SprtkRowsDesc* desc, const uint8_t* rows, int64_t n, void*) {
  if (n <= 0) return kOk;
  RowsWin w;
  for (int32_t w0 = 0; w0 < desc->row_size / 8;) {
    int32_t w1 = plan_window(*desc, w0, &w);
    int32_t S = tile_stride(w), R = tile_rows(S);
    std::vector<uint8_t> stage((size_t)R * S);
    for (int64_t t0 = 0; t0 < n; t0 += R) {
      int32_t nr = (int32_t)std::min<int64_t>(R, n - t0);
      for (int32_t r = 0; r < nr; ++r) {
        std::memcpy(stage.data() + r * S, rows + (t0 + r) * w.row_size + 8 * w.w0,
                    (size_t)8 * w.nwords);
      }
      for (int32_t i = 0; i < w.ndata; ++i) {
        for (int32_t r = 0; r < nr; ++r) tile_unpack(w, stage.data() + r * S, t0 + r, i);
      }
      for (int32_t i = 0; i < w.nvalid; ++i) {
        for (int32_t r = 0; r < nr; ++r) tile_unpack_valid(w, stage.data() + r * S, t0 + r, i);
      }
    }
    counted(SPRTK_FROM_ROWS);
    w0 = w1;
  }
  return kOk;
}

}  // extern "C"
