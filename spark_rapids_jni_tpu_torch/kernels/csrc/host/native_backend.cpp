// The accelerated native backend of the port's JNI library (sprt_jni):
// JNI ops served by hand-written kernels with no Python anywhere in the
// process. The port's counterpart of native/jni/pjrt_backend.cpp, with
// the same op names, arguments, handles and error contract; a kernel
// plugin (csrc/native/sprt_plugin.h) takes the place of the PJRT plugin
// and its kernels the place of the AOT-exported XLA programs.
//
// Wiring: sprt_pjrt_backend_init(plugin, exports_dir, options), the
// symbol native/jni/TestSupportJni.cpp calls, dlopens the plugin,
// resolves its C interface with dlsym, selects the device named by
// `device=i:<ordinal>` and registers the backend as the ACCELERATED one,
// which run_op (sprt_jni_common.hpp) tries before the default (Python)
// backend. exports_dir is accepted and ignored: the kernels are compiled
// into the plugin, nothing is exported. This file is compiled by the
// host compiler and never links the CUDA runtime, so the library still
// loads on a machine with no card.
//
// Column handles start at 1 << 40, disjoint from the Python registry's.
// Their buffers live where the plugin allocates them (the card, for the
// CUDA plugin) and are freed by handle.release. An op, type or handle
// outside the set returns SPRT_UNSUPPORTED before any device work, so
// run_op falls through to the default backend; so does
// decimal.divide128, and so does a row conversion of a string column. A
// device error, running out of memory included, returns 1 with the
// plugin's error text, never SPRT_UNSUPPORTED. Every op synchronises
// the plugin's stream before it returns.
#include "sprt_jni_common.hpp"

#include <dlfcn.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdlib>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <new>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

#include "../native/sprt_plugin.h"

namespace {

using sprt_rowops::RowsDesc;

// cudf type ids on the JNI wire, and the backend's own kinds
enum Kind {
  K_INT8 = 1,
  K_INT16 = 2,
  K_INT32 = 3,
  K_INT64 = 4,
  K_BOOL8 = 8,
  K_FLOAT32 = 9,
  K_FLOAT64 = 10,
  K_STRING = 23,
  K_DECIMAL32 = 25,
  K_DECIMAL64 = 26,
  K_DECIMAL128 = 27,
  K_ROWS = 100,   // packed JCUDF rows of one fixed row size
  K_TABLE = 101,  // a list of columns
};

constexpr int UNSUPPORTED = SPRT_UNSUPPORTED;
constexpr uint32_t kNoRow = 0xffffffffu;
constexpr int kMaxHandles = 8;
constexpr int64_t kMaxBatchBytes = (1LL << 31) - 1024;  // row_conversion.py
constexpr int kRowBatchAlign = 32;

// bytes of one element of a fixed-width kind; 0 for any other kind
int kind_size(int kind) {
  switch (kind) {
    case K_INT8:
    case K_BOOL8:
      return 1;
    case K_INT16:
      return 2;
    case K_INT32:
    case K_FLOAT32:
    case K_DECIMAL32:
      return 4;
    case K_INT64:
    case K_FLOAT64:
    case K_DECIMAL64:
      return 8;
    case K_DECIMAL128:
      return 16;
    default:
      return 0;
  }
}

// ---------------------------------------------------------------------------
// the plugin

struct Plugin {
  decltype(&sprtk_init) init;
  decltype(&sprtk_error_string) error_string;
  decltype(&sprtk_stream) stream;
  decltype(&sprtk_alloc) alloc;
  decltype(&sprtk_free) free;
  decltype(&sprtk_copy) copy;
  decltype(&sprtk_sync) sync;
  decltype(&sprtk_live_bytes) live_bytes;
  decltype(&sprtk_launches) launches;
  decltype(&sprtk_reset_launches) reset_launches;
  decltype(&sprtk_cast_to_integer) cast_to_integer;
  decltype(&sprtk_cast_to_float64) cast_to_float64;
  decltype(&sprtk_decimal128) decimal128;
  decltype(&sprtk_to_rows) to_rows;
  decltype(&sprtk_from_rows) from_rows;
  void* s = nullptr;  // the plugin's stream
};

template <typename F>
bool resolve(void* lib, const char* name, F* out, std::string* missing) {
  *out = reinterpret_cast<F>(dlsym(lib, name));
  if (*out == nullptr) *missing += std::string(" ") + name;
  return *out != nullptr;
}

std::unique_ptr<Plugin> open_plugin(const char* path, std::string* err) {
  void* lib = dlopen(path, RTLD_NOW | RTLD_LOCAL);
  if (lib == nullptr) {
    const char* e = dlerror();
    *err = e != nullptr ? e : "dlopen failed";
    return nullptr;
  }
  auto p = std::make_unique<Plugin>();
  std::string missing;
  resolve(lib, "sprtk_init", &p->init, &missing);
  resolve(lib, "sprtk_error_string", &p->error_string, &missing);
  resolve(lib, "sprtk_stream", &p->stream, &missing);
  resolve(lib, "sprtk_alloc", &p->alloc, &missing);
  resolve(lib, "sprtk_free", &p->free, &missing);
  resolve(lib, "sprtk_copy", &p->copy, &missing);
  resolve(lib, "sprtk_sync", &p->sync, &missing);
  resolve(lib, "sprtk_live_bytes", &p->live_bytes, &missing);
  resolve(lib, "sprtk_launches", &p->launches, &missing);
  resolve(lib, "sprtk_reset_launches", &p->reset_launches, &missing);
  resolve(lib, "sprtk_cast_to_integer", &p->cast_to_integer, &missing);
  resolve(lib, "sprtk_cast_to_float64", &p->cast_to_float64, &missing);
  resolve(lib, "sprtk_decimal128", &p->decimal128, &missing);
  resolve(lib, "sprtk_to_rows", &p->to_rows, &missing);
  resolve(lib, "sprtk_from_rows", &p->from_rows, &missing);
  if (!missing.empty()) {
    *err = std::string(path) + " is not a kernel plugin; missing:" + missing;
    return nullptr;
  }
  return p;
}

std::mutex g_plugins_mu;
std::map<std::string, std::unique_ptr<Plugin>> g_plugins;  // never unloaded
std::atomic<Plugin*> g_pl{nullptr};                         // the active plugin

// a device error, raised inside an op and returned as rc 1
struct DeviceError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

void check(const Plugin* pl, int rc) {
  if (rc != 0) throw DeviceError(pl->error_string(rc));
}

// one buffer of the plugin's, freed with the last reference to it
struct Buffer {
  const Plugin* pl = nullptr;
  void* p = nullptr;
  size_t bytes = 0;
  ~Buffer() {
    if (p != nullptr) pl->free(p, bytes, pl->s);
  }
};
using Buf = std::shared_ptr<Buffer>;

Buf alloc(const Plugin* pl, size_t bytes) {
  auto b = std::make_shared<Buffer>();
  b->pl = pl;
  b->bytes = bytes;
  check(pl, pl->alloc(&b->p, bytes, pl->s));
  return b;
}

Buf upload(const Plugin* pl, const void* src, size_t bytes) {
  Buf b = alloc(pl, bytes);
  if (bytes != 0) check(pl, pl->copy(b->p, src, bytes, pl->s));
  return b;
}

void* ptr(const Buf& b) { return b ? b->p : nullptr; }

void download(const Plugin* pl, void* dst, const void* src, size_t bytes) {
  if (bytes != 0) check(pl, pl->copy(dst, src, bytes, pl->s));
  check(pl, pl->sync(pl->s));
}

// ---------------------------------------------------------------------------
// the column store

struct NativeCol {
  const Plugin* pl = nullptr;
  int kind = 0;
  int scale = 0;  // decimals, Spark's convention
  int64_t rows = 0;
  Buf data;     // fixed-width values / string bytes / packed rows
  Buf valid;    // one byte per row; null: all valid
  Buf offsets;  // strings: rows + 1 int32
  int row_size = 0;  // K_ROWS
  std::vector<std::shared_ptr<NativeCol>> children;  // K_TABLE
};
using Col = std::shared_ptr<NativeCol>;

std::mutex g_mu;
std::map<long, Col> g_cols;
long g_next_handle = (1L << 40);  // disjoint from the Python registry's ids

long put_col(Col c) {
  std::lock_guard<std::mutex> lk(g_mu);
  long h = g_next_handle++;
  g_cols.emplace(h, std::move(c));
  return h;
}

// a column of the active plugin's, or null (not ours: fall through)
Col get_col(long h) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_cols.find(h);
  if (it == g_cols.end() || it->second->pl != g_pl.load()) return nullptr;
  return it->second;
}

void fail(SprtCallResult* r, const std::string& msg) { r->error = strdup(msg.c_str()); }

void fail_cast(SprtCallResult* r, int row, const std::string& s) {
  r->error = strdup("cast failed");
  r->error_row = row;
  r->error_str = strdup(s.c_str());
}

std::string string_at(const NativeCol& c, int64_t row) {
  int32_t off[2];
  download(c.pl, off, (const int32_t*)c.offsets->p + row, sizeof(off));
  std::string s((size_t)(off[1] - off[0]), '\0');
  download(c.pl, &s[0], (const uint8_t*)ptr(c.data) + off[0], s.size());
  return s;
}

// ---------------------------------------------------------------------------
// ops

int op_cast_to_integer(const Plugin* pl, const long* args, int n_args, SprtCallResult* r) {
  if (n_args < 4) return UNSUPPORTED;
  Col col = get_col(args[0]);
  if (col == nullptr || col->kind != K_STRING) return UNSUPPORTED;
  bool ansi = args[1] != 0;
  bool strip = args[2] != 0;
  int type_id = (int)args[3];
  int bits = 8 * kind_size(type_id);
  if (type_id != K_INT8 && type_id != K_INT16 && type_id != K_INT32 && type_id != K_INT64) {
    return UNSUPPORTED;
  }
  int64_t n = col->rows;
  auto res = std::make_shared<NativeCol>();
  res->pl = pl;
  res->kind = type_id;
  res->rows = n;
  res->data = alloc(pl, (size_t)n * (bits / 8));
  Buf valid = alloc(pl, (size_t)n);
  Buf status = alloc(pl, 8);
  check(pl, pl->cast_to_integer((const uint8_t*)ptr(col->data), (const int32_t*)ptr(col->offsets),
                                (const uint8_t*)ptr(col->valid), n, bits, ansi, strip,
                                res->data->p, (uint8_t*)valid->p, (uint32_t*)status->p, pl->s));
  uint32_t st[2];
  download(pl, st, status->p, sizeof(st));
  if (ansi && st[0] != kNoRow) {
    fail_cast(r, (int)st[0], string_at(*col, st[0]));
    return 1;
  }
  if (st[1] != 0) res->valid = valid;
  r->handles[0] = put_col(res);
  r->n_handles = 1;
  return 0;
}

int op_cast_to_float(const Plugin* pl, const long* args, int n_args, SprtCallResult* r) {
  if (n_args < 3) return UNSUPPORTED;
  Col col = get_col(args[0]);
  if (col == nullptr || col->kind != K_STRING) return UNSUPPORTED;
  bool ansi = args[1] != 0;
  if ((int)args[2] != K_FLOAT64) return UNSUPPORTED;  // FLOAT32: the default backend
  int64_t n = col->rows;
  auto res = std::make_shared<NativeCol>();
  res->pl = pl;
  res->kind = K_FLOAT64;
  res->rows = n;
  res->data = alloc(pl, (size_t)n * 8);
  Buf valid = alloc(pl, (size_t)n);
  Buf status = alloc(pl, 8);
  check(pl, pl->cast_to_float64((const uint8_t*)ptr(col->data), (const int32_t*)ptr(col->offsets),
                                (const uint8_t*)ptr(col->valid), n, (double*)res->data->p,
                                (uint8_t*)valid->p, (uint32_t*)status->p, pl->s));
  uint32_t st[2];
  download(pl, st, status->p, sizeof(st));
  if (ansi && st[0] != kNoRow) {
    fail_cast(r, (int)st[0], string_at(*col, st[0]));
    return 1;
  }
  if (st[1] != 0) res->valid = valid;
  r->handles[0] = put_col(res);
  r->n_handles = 1;
  return 0;
}

// decimal add / subtract / multiply: (a, b, result scale) -> {overflow
// BOOL8, result DECIMAL128}, both masked by the AND of the input masks
int op_decimal(const Plugin* pl, int op, const long* args, int n_args, SprtCallResult* r) {
  if (n_args < 3) return UNSUPPORTED;
  Col a = get_col(args[0]);
  Col b = get_col(args[1]);
  if (a == nullptr || b == nullptr) return UNSUPPORTED;
  if (a->kind != K_DECIMAL128 || b->kind != K_DECIMAL128) return UNSUPPORTED;
  if (a->rows != b->rows) {
    fail(r, "mismatched row counts");
    return 1;
  }
  int out_scale = (int)args[2];
  if (op == SPRTK_DEC_MUL) {
    if ((a->scale + b->scale) - out_scale > 38) {
      fail(r, "divisor too big");
      return 1;
    }
  } else {
    // the rescale divisor must fit 128 bits, as in the JAX backend
    if (std::max(a->scale, b->scale) - out_scale > 38) return UNSUPPORTED;
    if (std::abs(a->scale - b->scale) > 77) {
      fail(r,
           "The intermediate scale for calculating the result exceeds "
           "256-bit representation");
      return 1;
    }
  }
  int64_t n = a->rows;
  Buf valid = (a->valid || b->valid) ? alloc(pl, (size_t)n) : nullptr;
  auto oflow = std::make_shared<NativeCol>();
  oflow->pl = pl;
  oflow->kind = K_BOOL8;
  oflow->rows = n;
  oflow->data = alloc(pl, (size_t)n);
  oflow->valid = valid;
  auto res = std::make_shared<NativeCol>();
  res->pl = pl;
  res->kind = K_DECIMAL128;
  res->scale = out_scale;
  res->rows = n;
  res->data = alloc(pl, (size_t)n * 16);
  res->valid = valid;
  check(pl, pl->decimal128(op, (const int64_t*)ptr(a->data), (const int64_t*)ptr(b->data),
                           (const uint8_t*)ptr(a->valid), (const uint8_t*)ptr(b->valid), n,
                           a->scale, b->scale, out_scale, (int8_t*)oflow->data->p,
                           (int64_t*)res->data->p, (uint8_t*)ptr(valid), pl->s));
  check(pl, pl->sync(pl->s));
  r->handles[0] = put_col(oflow);
  r->handles[1] = put_col(res);
  r->n_handles = 2;
  return 0;
}

// a row layout and the arrays its RowsDesc points to
struct RowsPlan {
  std::vector<int32_t> start, size;
  std::vector<void*> data;
  std::vector<uint8_t*> valid;
  RowsDesc d;
};

// the layout of fixed-width columns of these kinds, any number of them;
// false for a kind the rows cannot carry here (strings: the default
// backend)
bool layout_of(const std::vector<int>& kinds, RowsPlan* p) {
  std::vector<int32_t> sizes;
  for (int k : kinds) {
    if (kind_size(k) == 0) return false;
    sizes.push_back(kind_size(k));
  }
  size_t n = sizes.size();
  p->start.assign(n, 0);
  p->size.assign(n, 0);
  p->data.assign(n, nullptr);
  p->valid.assign(n, nullptr);
  std::memset(&p->d, 0, sizeof(p->d));
  p->d.start = p->start.data();
  p->d.size = p->size.data();
  p->d.data = p->data.data();
  p->d.valid = p->valid.data();
  return sprt_rowops::row_layout(&p->d, (int32_t)n, sizes.data());
}

int op_to_rows(const Plugin* pl, bool fixed_width, const long* args, int n_args,
               SprtCallResult* r) {
  if (n_args < 1) return UNSUPPORTED;
  Col tbl = get_col(args[0]);
  if (tbl == nullptr || tbl->kind != K_TABLE) return UNSUPPORTED;
  std::vector<int> kinds;
  for (const Col& c : tbl->children) {
    if (c->pl != pl) return UNSUPPORTED;
    kinds.push_back(c->kind);
  }
  RowsPlan plan;
  if (!layout_of(kinds, &plan)) return UNSUPPORTED;
  RowsDesc& d = plan.d;
  int64_t n = tbl->children[0]->rows;
  for (const Col& c : tbl->children) {
    if (c->rows != n) {
      fail(r, "mismatched row counts");
      return 1;
    }
  }
  if (fixed_width && d.row_size > 1024) {
    fail(r, "row larger than 1KB");
    return 1;
  }
  // batches of at most kMaxBatchBytes, whole multiples of 32 rows
  int64_t per = kMaxBatchBytes / d.row_size;
  if (per >= kRowBatchAlign) per = per / kRowBatchAlign * kRowBatchAlign;
  if (per < 1) per = 1;
  int64_t n_batches = n == 0 ? 1 : (n + per - 1) / per;
  if (n_batches > kMaxHandles) return UNSUPPORTED;
  for (size_t i = 0; i < tbl->children.size(); ++i) {
    d.data[i] = ptr(tbl->children[i]->data);
    d.valid[i] = (uint8_t*)ptr(tbl->children[i]->valid);
  }
  std::vector<Col> out;
  for (int64_t row0 = 0; row0 < n || out.empty(); row0 += per) {
    int64_t nb = std::min(per, n - row0);
    auto rows = std::make_shared<NativeCol>();
    rows->pl = pl;
    rows->kind = K_ROWS;
    rows->rows = nb;
    rows->row_size = d.row_size;
    rows->data = alloc(pl, (size_t)nb * d.row_size);
    check(pl, pl->to_rows(&d, row0, nb, (uint8_t*)ptr(rows->data), pl->s));
    out.push_back(rows);
  }
  check(pl, pl->sync(pl->s));
  for (size_t i = 0; i < out.size(); ++i) r->handles[i] = put_col(out[i]);
  r->n_handles = (int)out.size();
  return 0;
}

// (rows, type ids..., cudf scales...) -> one handle per column, each
// with a validity mask, as the JAX backend returns them
int op_from_rows(const Plugin* pl, const long* args, int n_args, SprtCallResult* r) {
  if (n_args < 3) return UNSUPPORTED;
  Col rows = get_col(args[0]);
  if (rows == nullptr || rows->kind != K_ROWS) return UNSUPPORTED;
  int n_cols = (n_args - 1) / 2;
  if (n_cols > kMaxHandles) return UNSUPPORTED;
  std::vector<int> kinds;
  for (int i = 0; i < n_cols; ++i) kinds.push_back((int)args[1 + i]);
  RowsPlan plan;
  if (!layout_of(kinds, &plan)) return UNSUPPORTED;
  RowsDesc& d = plan.d;
  if (d.row_size != rows->row_size) {
    fail(r, "the rows' size differs from the schema's row size");
    return 1;
  }
  int64_t n = rows->rows;
  std::vector<Col> cols;
  for (int i = 0; i < n_cols; ++i) {
    auto c = std::make_shared<NativeCol>();
    c->pl = pl;
    c->kind = kinds[i];
    bool decimal = kinds[i] == K_DECIMAL32 || kinds[i] == K_DECIMAL64 || kinds[i] == K_DECIMAL128;
    c->scale = decimal ? -(int)args[1 + n_cols + i] : 0;
    c->rows = n;
    c->data = alloc(pl, (size_t)n * kind_size(kinds[i]));
    c->valid = alloc(pl, (size_t)n);
    d.data[i] = ptr(c->data);
    d.valid[i] = (uint8_t*)ptr(c->valid);
    cols.push_back(c);
  }
  check(pl, pl->from_rows(&d, (const uint8_t*)ptr(rows->data), n, pl->s));
  check(pl, pl->sync(pl->s));
  for (int i = 0; i < n_cols; ++i) r->handles[i] = put_col(cols[i]);
  r->n_handles = n_cols;
  return 0;
}

// --- the test.* factories and readers (TestSupportJni.cpp), as the JAX
// backend's: the columns they build live where the plugin allocates

std::vector<uint8_t> valid_bytes(const long* flags, int64_t n) {
  std::vector<uint8_t> v((size_t)n);
  for (int64_t i = 0; i < n; ++i) v[i] = flags[i] ? 1 : 0;
  return v;
}

Col new_col(const Plugin* pl, int kind, int64_t n) {
  auto c = std::make_shared<NativeCol>();
  c->pl = pl;
  c->kind = kind;
  c->rows = n;
  return c;
}

int finish_factory(const Plugin* pl, Col c, SprtCallResult* r) {
  check(pl, pl->sync(pl->s));
  r->handles[0] = put_col(std::move(c));
  r->n_handles = 1;
  return 0;
}

int op_make_string_column(const Plugin* pl, const long* args, int n_args, SprtCallResult* r) {
  if (n_args < 1 || args[0] < 0) return UNSUPPORTED;
  int64_t n = args[0];
  std::vector<uint8_t> data;
  std::vector<int32_t> offsets{0};
  std::vector<uint8_t> valid((size_t)n, 1);
  bool has_valid = false;
  int i = 1;
  for (int64_t row = 0; row < n; ++row) {
    if (i >= n_args) {
      fail(r, "string column arguments end early");
      return 1;
    }
    long ln = args[i];
    if (ln < 0) {
      has_valid = true;
      valid[row] = 0;
      offsets.push_back((int32_t)data.size());
      i += 1;
      continue;
    }
    int words = (int)((ln + 7) / 8);
    if (i + words > n_args - 1) {
      fail(r, "string column arguments end early");
      return 1;
    }
    for (int w = 0; w < words; ++w) {
      unsigned long v = (unsigned long)args[i + 1 + w];
      for (int k = 0; k < 8 && (long)w * 8 + k < ln; ++k) data.push_back((uint8_t)(v >> (8 * k)));
    }
    offsets.push_back((int32_t)data.size());
    i += 1 + words;
  }
  Col c = new_col(pl, K_STRING, n);
  c->data = upload(pl, data.data(), data.size());
  c->offsets = upload(pl, offsets.data(), offsets.size() * 4);
  if (has_valid) c->valid = upload(pl, valid.data(), valid.size());
  return finish_factory(pl, c, r);
}

int op_make_long_column(const Plugin* pl, const long* args, int n_args, SprtCallResult* r) {
  if (n_args < 1 || args[0] < 0 || n_args < 1 + args[0]) return UNSUPPORTED;
  int64_t n = args[0];
  Col c = new_col(pl, K_INT64, n);
  c->data = upload(pl, args + 1, (size_t)n * 8);
  if (n_args >= 1 + 2 * n && n > 0) c->valid = upload(pl, valid_bytes(args + 1 + n, n).data(), n);
  return finish_factory(pl, c, r);
}

int op_make_decimal_column(const Plugin* pl, const long* args, int n_args, SprtCallResult* r) {
  // n, scale, lo[n], hi[n], valid[n]?
  if (n_args < 2 || args[0] < 0 || n_args < 2 + 2 * args[0]) return UNSUPPORTED;
  int64_t n = args[0];
  std::vector<int64_t> limbs((size_t)n * 2);
  for (int64_t i = 0; i < n; ++i) {
    limbs[2 * i] = args[2 + i];
    limbs[2 * i + 1] = args[2 + n + i];
  }
  Col c = new_col(pl, K_DECIMAL128, n);
  c->scale = (int)args[1];
  c->data = upload(pl, limbs.data(), limbs.size() * 8);
  if (n_args >= 2 + 3 * n && n > 0) {
    c->valid = upload(pl, valid_bytes(args + 2 + 2 * n, n).data(), n);
  }
  return finish_factory(pl, c, r);
}

int op_make_int_column(const Plugin* pl, const long* args, int n_args, SprtCallResult* r) {
  // n, type_id (K_INT32 / K_INT8), values[n], valid[n]?
  if (n_args < 2 || args[0] < 0 || n_args < 2 + args[0]) return UNSUPPORTED;
  int64_t n = args[0];
  int kind = (int)args[1];
  if (kind != K_INT32 && kind != K_INT8) return UNSUPPORTED;
  int isz = kind_size(kind);
  std::vector<uint8_t> data((size_t)n * isz);
  for (int64_t i = 0; i < n; ++i) {
    long v = args[2 + i];
    std::memcpy(data.data() + i * isz, &v, isz);  // little-endian: the low bytes
  }
  Col c = new_col(pl, kind, n);
  c->data = upload(pl, data.data(), data.size());
  if (n_args >= 2 + 2 * n && n > 0) c->valid = upload(pl, valid_bytes(args + 2 + n, n).data(), n);
  return finish_factory(pl, c, r);
}

int op_make_table(const Plugin* pl, const long* args, int n_args, SprtCallResult* r) {
  Col t = new_col(pl, K_TABLE, 0);
  for (int i = 0; i < n_args; ++i) {
    Col c = get_col(args[i]);
    if (c == nullptr) return UNSUPPORTED;  // a mixed-registry table
    t->rows = c->rows;
    t->children.push_back(c);
  }
  if (t->children.empty()) return UNSUPPORTED;
  r->handles[0] = put_col(t);
  r->n_handles = 1;
  return 0;
}

int op_table_column(const long* args, int n_args, SprtCallResult* r) {
  if (n_args < 2) return UNSUPPORTED;
  Col t = get_col(args[0]);
  if (t == nullptr) return UNSUPPORTED;
  if (t->kind != K_TABLE || args[1] < 0 || (size_t)args[1] >= t->children.size()) {
    fail(r, "bad table column index");
    return 1;
  }
  // a fresh handle on the same (immutable) column: released on its own
  r->handles[0] = put_col(t->children[(size_t)args[1]]);
  r->n_handles = 1;
  return 0;
}

int op_row_count(const long* args, int n_args, SprtCallResult* r) {
  if (n_args < 1) return UNSUPPORTED;
  Col c = get_col(args[0]);
  if (c == nullptr) return UNSUPPORTED;
  r->handles[0] = c->rows;
  r->n_handles = 1;
  return 0;
}

// the row of a reader, or -1 (an error already set) when out of range
int64_t reader_row(const NativeCol& c, long row, SprtCallResult* r) {
  if (row < 0 || row >= c.rows) {
    fail(r, "row index out of range");
    return -1;
  }
  return row;
}

int op_is_null_at(const long* args, int n_args, SprtCallResult* r) {
  if (n_args < 2) return UNSUPPORTED;
  Col c = get_col(args[0]);
  if (c == nullptr || c->kind == K_TABLE) return UNSUPPORTED;
  int64_t row = reader_row(*c, args[1], r);
  if (row < 0) return 1;
  uint8_t v = 1;
  if (c->valid) download(c->pl, &v, (const uint8_t*)c->valid->p + row, 1);
  r->handles[0] = v ? 0 : 1;
  r->n_handles = 1;
  return 0;
}

int op_get_long_at(const long* args, int n_args, SprtCallResult* r) {
  if (n_args < 2) return UNSUPPORTED;
  Col c = get_col(args[0]);
  if (c == nullptr) return UNSUPPORTED;
  int size = kind_size(c->kind);
  bool readable = c->kind == K_INT64 || c->kind == K_INT32 || c->kind == K_INT16 ||
                  c->kind == K_INT8 || c->kind == K_BOOL8 || c->kind == K_DECIMAL128 ||
                  c->kind == K_FLOAT64;
  if (!readable) return UNSUPPORTED;
  int64_t row = reader_row(*c, args[1], r);
  if (row < 0) return 1;
  uint8_t raw[8] = {0};
  // DECIMAL128: the low limb (the tests use small values)
  download(c->pl, raw, (const uint8_t*)c->data->p + row * size, size < 8 ? size : 8);
  long v = 0;
  switch (c->kind) {
    case K_INT32: {
      int32_t x;
      std::memcpy(&x, raw, 4);
      v = x;
      break;
    }
    case K_INT16: {
      int16_t x;
      std::memcpy(&x, raw, 2);
      v = x;
      break;
    }
    case K_INT8:
      v = (long)(int8_t)raw[0];
      break;
    case K_BOOL8:
      v = raw[0] != 0;
      break;
    case K_FLOAT64: {  // the value truncated toward zero
      double d;
      std::memcpy(&d, raw, 8);
      if (!(std::fabs(d) < 9.2233720368547758e18)) {
        fail(r, "the FLOAT64 value is not a finite long");
        return 1;
      }
      v = (long)d;
      break;
    }
    default:
      std::memcpy(&v, raw, 8);
  }
  r->handles[0] = v;
  r->n_handles = 1;
  return 0;
}

int op_get_string_at(const long* args, int n_args, SprtCallResult* r) {
  if (n_args < 2) return UNSUPPORTED;
  Col c = get_col(args[0]);
  if (c == nullptr || c->kind != K_STRING) return UNSUPPORTED;
  int64_t row = reader_row(*c, args[1], r);
  if (row < 0) return 1;
  uint8_t v = 1;
  if (c->valid) download(c->pl, &v, (const uint8_t*)c->valid->p + row, 1);
  if (!v) {
    r->handles[0] = -1;
    r->n_handles = 1;
    return 0;
  }
  std::string s = string_at(*c, row);
  if (s.size() > 56) s.resize(56);
  r->handles[0] = (long)s.size();
  int n_words = (int)((s.size() + 7) / 8);
  for (int w = 0; w < n_words; ++w) {
    unsigned long v = 0;
    for (int k = 0; k < 8; ++k) {
      size_t pos = (size_t)w * 8 + k;
      if (pos < s.size()) v |= ((unsigned long)(uint8_t)s[pos]) << (8 * k);
    }
    r->handles[1 + w] = (long)v;
  }
  r->n_handles = 1 + n_words;
  return 0;
}

int op_release(const long* args, int n_args, SprtCallResult* r) {
  (void)r;
  if (n_args < 1) return UNSUPPORTED;
  Col dropped;  // freed after the lock is let go
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_cols.find(args[0]);
    if (it != g_cols.end()) {
      dropped = std::move(it->second);
      g_cols.erase(it);
    }
  }
  if (dropped != nullptr) return 0;
  // not ours: the default backend's registry, unless there is none;
  // then a double release at teardown stays a no-op
  return sprt_get_backend() != nullptr ? UNSUPPORTED : 0;
}

int dispatch(const Plugin* pl, const std::string& op, const long* args, int n_args,
             SprtCallResult* r) {
  if (op == "cast.to_integer") return op_cast_to_integer(pl, args, n_args, r);
  if (op == "cast.to_float") return op_cast_to_float(pl, args, n_args, r);
  if (op == "decimal.add128") return op_decimal(pl, SPRTK_DEC_ADD, args, n_args, r);
  if (op == "decimal.subtract128") return op_decimal(pl, SPRTK_DEC_SUB, args, n_args, r);
  if (op == "decimal.multiply128") return op_decimal(pl, SPRTK_DEC_MUL, args, n_args, r);
  if (op == "row_conversion.to_rows") return op_to_rows(pl, false, args, n_args, r);
  if (op == "row_conversion.to_rows_fixed_width") return op_to_rows(pl, true, args, n_args, r);
  if (op == "row_conversion.from_rows" || op == "row_conversion.from_rows_fixed_width") {
    return op_from_rows(pl, args, n_args, r);
  }
  if (op == "test.make_string_column") return op_make_string_column(pl, args, n_args, r);
  if (op == "test.make_long_column") return op_make_long_column(pl, args, n_args, r);
  if (op == "test.make_decimal_column") return op_make_decimal_column(pl, args, n_args, r);
  if (op == "test.make_int_column") return op_make_int_column(pl, args, n_args, r);
  if (op == "test.make_table") return op_make_table(pl, args, n_args, r);
  if (op == "test.table_column") return op_table_column(args, n_args, r);
  if (op == "test.row_count") return op_row_count(args, n_args, r);
  if (op == "test.is_null_at") return op_is_null_at(args, n_args, r);
  if (op == "test.get_long_at") return op_get_long_at(args, n_args, r);
  if (op == "test.get_string_at") return op_get_string_at(args, n_args, r);
  if (op == "handle.release") return op_release(args, n_args, r);
  return UNSUPPORTED;  // decimal.divide128, cast.to_decimal, and every other op
}

int backend_call(const char* name, const long* args, int n_args, SprtCallResult* result) {
  const Plugin* pl = g_pl.load();
  if (pl == nullptr || name == nullptr) return UNSUPPORTED;
  try {
    return dispatch(pl, std::string(name), args, n_args, result);
  } catch (const DeviceError& e) {
    fail(result, e.what());
  } catch (const std::bad_alloc&) {
    fail(result, "out of host memory");
  }
  return 1;
}

SprtBackend g_backend{backend_call};

// "device=i:3 ..." -> 3 (0 when absent)
int device_option(const char* options) {
  if (options == nullptr) return 0;
  std::istringstream ss(options);
  std::string tok;
  int device = 0;
  while (ss >> tok) {
    if (tok.rfind("device=i:", 0) == 0) device = std::atoi(tok.c_str() + 9);
  }
  return device;
}

}  // namespace

extern "C" {

// Load the kernel plugin at plugin_path, select the device of `options`
// ("device=i:<ordinal>") and register the native backend as the
// accelerated one. exports_dir is ignored. Returns 0; 1 when the plugin
// cannot be loaded (a NULL path included), 2 when its device fails.
int sprt_pjrt_backend_init(const char* plugin_path, const char* exports_dir,
                           const char* options) {
  (void)exports_dir;
  if (plugin_path == nullptr) {
    std::fprintf(stderr, "sprt_pjrt_backend_init: no kernel plugin path\n");
    return 1;
  }
  std::lock_guard<std::mutex> lk(g_plugins_mu);
  auto it = g_plugins.find(plugin_path);
  if (it == g_plugins.end()) {
    std::string err;
    std::unique_ptr<Plugin> pl = open_plugin(plugin_path, &err);
    if (pl == nullptr) {
      std::fprintf(stderr, "sprt_pjrt_backend_init: %s\n", err.c_str());
      return 1;
    }
    it = g_plugins.emplace(plugin_path, std::move(pl)).first;
  }
  Plugin* pl = it->second.get();
  int rc = pl->init(device_option(options));
  if (rc != 0) {
    std::fprintf(stderr, "sprt_pjrt_backend_init: %s\n", pl->error_string(rc));
    return 2;
  }
  pl->s = pl->stream();
  g_pl.store(pl);
  sprt_register_accel_backend(&g_backend);
  return 0;
}

// The active plugin's counters, for a caller that checks which kernels
// ran and that every buffer was freed (0 before any init).
long sprt_native_live_bytes(void) {
  const Plugin* pl = g_pl.load();
  return pl != nullptr ? (long)pl->live_bytes() : 0;
}

long sprt_native_launches(int family) {
  const Plugin* pl = g_pl.load();
  return pl != nullptr ? (long)pl->launches(family) : 0;
}

void sprt_native_reset_launches(void) {
  const Plugin* pl = g_pl.load();
  if (pl != nullptr) pl->reset_launches();
}

// What a native handle holds: info[0..7] = kind, scale, rows, row size,
// data bytes, has validity, has offsets, children. Returns 0, or -1 for
// a handle the backend does not hold.
int sprt_native_column(long handle, long* info) {
  Col c = get_col(handle);
  if (c == nullptr) return -1;
  info[0] = c->kind;
  info[1] = c->scale;
  info[2] = (long)c->rows;
  info[3] = c->row_size;
  info[4] = c->data ? (long)c->data->bytes : 0;
  info[5] = c->valid ? 1 : 0;
  info[6] = c->offsets ? 1 : 0;
  info[7] = (long)c->children.size();
  return 0;
}

// Copy one buffer of a native handle (part 0: data, 1: validity bytes,
// 2: offsets) to dst, host or device memory, and wait for the copy.
// Returns 0, -1 for an unknown handle or an absent part, or the
// plugin's error code.
int sprt_native_copy_out(long handle, int part, void* dst) {
  Col c = get_col(handle);
  if (c == nullptr) return -1;
  const Buf& b = part == 0 ? c->data : (part == 1 ? c->valid : c->offsets);
  if (part < 0 || part > 2 || (b == nullptr && part != 0)) return -1;
  if (b == nullptr) return 0;
  int rc = c->pl->copy(dst, b->p, b->bytes, c->pl->s);
  return rc != 0 ? rc : c->pl->sync(c->pl->s);
}

}  // extern "C"
