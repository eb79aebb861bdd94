// The plain C interface of a native-backend kernel plugin.
//
// Two libraries define it: the CUDA plugin (kernels.cu, nvcc, buffers in
// device memory, kernels on the card) and the host plugin
// (host_plugin.cpp, g++, buffers in host memory, the same row functions
// in loops; only tests load it). The JNI library's native backend
// (csrc/host/native_backend.cpp) dlopens one of them and resolves these
// symbols with dlsym, as native/jni/pjrt_backend.cpp resolves the PJRT
// plugin, so the JNI library itself never links the CUDA runtime.
//
// Every function that can fail returns 0 or an error code that
// sprtk_error_string names (a cudaError_t for the CUDA plugin). A
// `stream` is a cudaStream_t (NULL: the legacy default stream); the host
// plugin ignores it. Launch functions only enqueue: the caller
// synchronises before it reads a result.
#ifndef SPRT_PLUGIN_H
#define SPRT_PLUGIN_H

#include <stddef.h>
#include <stdint.h>

#include "sprt_rowops.h"

// kernel families, the index of each launch counter
#define SPRTK_CAST_INTEGER 0
#define SPRTK_CAST_FLOAT64 1
#define SPRTK_DECIMAL128 2
#define SPRTK_TO_ROWS 3
#define SPRTK_FROM_ROWS 4
#define SPRTK_FAMILIES 5

// decimal ops
#define SPRTK_DEC_ADD 0
#define SPRTK_DEC_SUB 1
#define SPRTK_DEC_MUL 2

typedef sprt_rowops::RowsDesc SprtkRowsDesc;

extern "C" {

// select the device and make the plugin's stream
int sprtk_init(int device);
// load every kernel now, not at its first launch (which may then come
// inside a CUDA graph capture)
int sprtk_preload(void);
const char* sprtk_error_string(int rc);
void* sprtk_stream(void);

// memory: the live-bytes counter counts every allocation until its free
int sprtk_alloc(void** p, size_t bytes, void* stream);
int sprtk_free(void* p, size_t bytes, void* stream);
int sprtk_copy(void* dst, const void* src, size_t bytes, void* stream);
int sprtk_sync(void* stream);
long long sprtk_live_bytes(void);

// one count per family, raised by one at each kernel launch
long long sprtk_launches(int family);
void sprtk_reset_launches(void);

// string -> INT8/16/32/64 (bits): out holds n values of bits/8 bytes,
// out_valid one byte per row; status[0] <- the first row that is
// invalid but valid on input (0xffffffff: none), status[1] <- the count
// of invalid rows. `valid` may be NULL (all valid).
int sprtk_cast_to_integer(const uint8_t* chars, const int32_t* offsets, const uint8_t* valid,
                          int64_t n, int bits, int ansi, int strip, void* out,
                          uint8_t* out_valid, uint32_t* status, void* stream);

// string -> FLOAT64; status[0] <- the first row with an ANSI error
int sprtk_cast_to_float64(const uint8_t* chars, const int32_t* offsets, const uint8_t* valid,
                          int64_t n, double* out, uint8_t* out_valid, uint32_t* status,
                          void* stream);

// DECIMAL128 add / subtract / multiply (op) of limb pairs a and b at
// Spark scales; overflow is masked by the AND of the input masks, which
// goes to out_valid when either input has one (out_valid may be NULL
// when neither has)
int sprtk_decimal128(int op, const int64_t* a, const int64_t* b, const uint8_t* a_valid,
                     const uint8_t* b_valid, int64_t n, int a_scale, int b_scale, int out_scale,
                     int8_t* overflow, int64_t* out, uint8_t* out_valid, void* stream);

// fills desc's layout for ncols columns of these byte sizes into its
// scalars and the start / size arrays it points to (the caller's, of
// ncols each; sprt_rowops::row_layout); 0, or 1 for a schema the rows
// cannot carry. Any number of columns.
int sprtk_row_layout(SprtkRowsDesc* desc, int ncols, const int32_t* sizes);

// rows [row0, row0 + n) of the desc's columns into n packed rows (rows
// 8-byte aligned); one kernel launch per window of the row
// (sprt_rowops::plan_window), one for most schemas
int sprtk_to_rows(const SprtkRowsDesc* desc, int64_t row0, int64_t n, uint8_t* rows,
                  void* stream);

// n packed rows (8-byte aligned) into the desc's column buffers and
// validity bytes; launches as sprtk_to_rows
int sprtk_from_rows(const SprtkRowsDesc* desc, const uint8_t* rows, int64_t n, void* stream);

}  // extern "C"

#endif  // SPRT_PLUGIN_H
