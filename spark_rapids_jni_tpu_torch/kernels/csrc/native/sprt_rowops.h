// Per-row logic of the native JNI backend's kernels: one string parsed,
// one DECIMAL128 pair combined, one JCUDF row packed or unpacked.
//
// nvcc compiles it into the CUDA plugin (kernels.cu), g++ into the host
// plugin (host_plugin.cpp), so both run the same code. Every function
// is SPRT_HD: __host__ __device__ under nvcc, plain inline under g++.
//
// Each function is the row-at-a-time form of a column-at-a-time
// function of the JAX package and of its torch counterpart in the port,
// named above it; values, validity and error flags are equal bit for
// bit. Strings are read as bytes between int32 offsets: no padded char
// matrix, no shape bucket, any row count.
//
// Float results depend on every double operation being rounded on its
// own: build with nvcc --fmad=false and g++ -ffp-contract=off.
#ifndef SPRT_ROWOPS_H
#define SPRT_ROWOPS_H

#include <stdint.h>

#ifdef __CUDACC__
#define SPRT_HD __host__ __device__
// a constant table: one copy in host memory, one in device memory
// (global memory, read through L1, or the constant bank for a table
// that every thread of a launch reads at the same index)
#define SPRT_TABLE(type, name, ...)                      \
  static const type name##_host[] = {__VA_ARGS__};       \
  static __device__ type name##_dev[] = {__VA_ARGS__};
#define SPRT_CTABLE(type, name, ...)                     \
  static const type name##_host[] = {__VA_ARGS__};       \
  static __constant__ type name##_dev[] = {__VA_ARGS__};
#else
#define SPRT_HD
#define SPRT_TABLE(type, name, ...) static const type name##_host[] = {__VA_ARGS__};
#define SPRT_CTABLE(type, name, ...) static const type name##_host[] = {__VA_ARGS__};
#endif

#ifdef __CUDA_ARCH__
#define SPRT_AT(name, i) (name##_dev[i])
// a loop over limbs unrolled, so that the limbs stay in registers
#define SPRT_UNROLL _Pragma("unroll")
#else
#define SPRT_AT(name, i) (name##_host[i])
#define SPRT_UNROLL
#endif

namespace sprt_rowops {

// 9, 10, 13 or 32: one range test and one bit of 0x800013 (bits 0, 1, 4
// and 23 for c - 9)
SPRT_HD inline bool is_ws(int c) {
  uint32_t k = (uint32_t)c - 9u;
  return k < 24u && ((0x800013u >> k) & 1u) != 0;
}

SPRT_HD inline bool is_digit(int c) { return c >= '0' && c <= '9'; }

SPRT_HD inline int lower(int c) { return (c >= 'A' && c <= 'Z') ? c + 32 : c; }

SPRT_HD inline int32_t min32(int32_t a, int32_t b) { return a < b ? a : b; }

SPRT_HD inline int32_t max32(int32_t a, int32_t b) { return a > b ? a : b; }

SPRT_HD inline double bits_f64(uint64_t b) {
#ifdef __CUDA_ARCH__
  return __longlong_as_double((long long)b);
#else
  double d;
  __builtin_memcpy(&d, &b, 8);
  return d;
#endif
}

// ---------------------------------------------------------------------------
// string -> FLOAT64: JAX ops/cast_string.py _parse_float; port
// ops/cast_string.py:560 _parse_float. The reference's quirks: 'nan'
// only as the whole 3-byte string, inf/infinity must end the string
// (invalid but no ANSI error otherwise), one f/F/d/D suffix after a
// nonzero value, manual exponents of at most 4 digits, 19 (+1)
// significant digits with the rest truncated into the exponent.
// Subnormal results are kept (the JAX package on the CPU flushes them).

// the parse's powers of ten, one block of 864 bytes (the CUDA kernel
// copies it into shared memory: the rows index it each their own way)
struct FloatTables {
  uint64_t hi[11];      // 10^(32q), q = 0..10 (inf past 10^308)
  uint64_t sub1[57];    // 10^k, k = 0..56, correctly rounded (the first 32
                        // are also the low factor 10^r of the two-level product)
  uint64_t subneg[20];  // 10^(k - 307), k = 0..19, correctly rounded
  uint64_t u64[20];     // 10^k, k = 0..19, as integers
};

#define SPRT_FLOAT_TABLES                                                                     \
  {                                                                                           \
    {0x3ff0000000000000ULL, 0x4693b8b5b5056e17ULL, 0x4d384f03e93ff9f5ULL,                     \
     0x53ddf67562d8b363ULL, 0x5a827748f9301d32ULL, 0x6126c2d4256ffcc3ULL,                     \
     0x67cc0e1ef1a724ebULL, 0x6e714a52dffc6799ULL, 0x75154fdd7f73bf3cULL,                     \
     0x7bba44df832b8d46ULL, 0x7ff0000000000000ULL},                                           \
        {0x3ff0000000000000ULL, 0x4024000000000000ULL, 0x4059000000000000ULL,                 \
         0x408f400000000000ULL, 0x40c3880000000000ULL, 0x40f86a0000000000ULL,                 \
         0x412e848000000000ULL, 0x416312d000000000ULL, 0x4197d78400000000ULL,                 \
         0x41cdcd6500000000ULL, 0x4202a05f20000000ULL, 0x42374876e8000000ULL,                 \
         0x426d1a94a2000000ULL, 0x42a2309ce5400000ULL, 0x42d6bcc41e900000ULL,                 \
         0x430c6bf526340000ULL, 0x4341c37937e08000ULL, 0x4376345785d8a000ULL,                 \
         0x43abc16d674ec800ULL, 0x43e158e460913d00ULL, 0x4415af1d78b58c40ULL,                 \
         0x444b1ae4d6e2ef50ULL, 0x4480f0cf064dd592ULL, 0x44b52d02c7e14af6ULL,                 \
         0x44ea784379d99db4ULL, 0x45208b2a2c280291ULL, 0x4554adf4b7320335ULL,                 \
         0x4589d971e4fe8402ULL, 0x45c027e72f1f1281ULL, 0x45f431e0fae6d721ULL,                 \
         0x46293e5939a08ceaULL, 0x465f8def8808b024ULL, 0x4693b8b5b5056e17ULL,                 \
         0x46c8a6e32246c99cULL, 0x46fed09bead87c03ULL, 0x4733426172c74d82ULL,                 \
         0x476812f9cf7920e3ULL, 0x479e17b84357691bULL, 0x47d2ced32a16a1b1ULL,                 \
         0x48078287f49c4a1dULL, 0x483d6329f1c35ca5ULL, 0x48725dfa371a19e7ULL,                 \
         0x48a6f578c4e0a061ULL, 0x48dcb2d6f618c879ULL, 0x4911efc659cf7d4cULL,                 \
         0x49466bb7f0435c9eULL, 0x497c06a5ec5433c6ULL, 0x49b18427b3b4a05cULL,                 \
         0x49e5e531a0a1c873ULL, 0x4a1b5e7e08ca3a8fULL, 0x4a511b0ec57e649aULL,                 \
         0x4a8561d276ddfdc0ULL, 0x4ababa4714957d30ULL, 0x4af0b46c6cdd6e3eULL,                 \
         0x4b24e1878814c9ceULL, 0x4b5a19e96a19fc41ULL, 0x4b905031e2503da9ULL},                \
        {0x0031fa182c40c60dULL, 0x0066789e3750f791ULL, 0x009c16c5c5253575ULL,                 \
         0x00d18e3b9b374169ULL, 0x0105f1ca820511c3ULL, 0x013b6e3d22865634ULL,                 \
         0x017124e63593f5e1ULL, 0x01a56e1fc2f8f359ULL, 0x01dac9a7b3b7302fULL,                 \
         0x0210be08d0527e1dULL, 0x0244ed8b04671da5ULL, 0x027a28edc580e50eULL,                 \
         0x02b059949b708f29ULL, 0x02e46ff9c24cb2f3ULL, 0x03198bf832dfdfb0ULL,                 \
         0x034feef63f97d79cULL, 0x0383f559e7bee6c1ULL, 0x03b8f2b061aea072ULL,                 \
         0x03ef2f5c7a1a488eULL, 0x04237d99cc506d59ULL},                                       \
    {                                                                                         \
      1ULL, 10ULL, 100ULL, 1000ULL, 10000ULL, 100000ULL, 1000000ULL, 10000000ULL,             \
          100000000ULL, 1000000000ULL, 10000000000ULL, 100000000000ULL, 1000000000000ULL,     \
          10000000000000ULL, 100000000000000ULL, 1000000000000000ULL, 10000000000000000ULL,   \
          100000000000000000ULL, 1000000000000000000ULL, 10000000000000000000ULL              \
    }                                                                                         \
  }

static const FloatTables kFloatTables = SPRT_FLOAT_TABLES;
#ifdef __CUDACC__
static __device__ const FloatTables kFloatTablesDev = SPRT_FLOAT_TABLES;
#endif

constexpr uint64_t kMaxHolding = 1844674407370955160ULL;  // (2^64 - 1 - 9) / 10
constexpr uint64_t kQuietNan = 0x7ff8000000000000ULL;
constexpr uint64_t kInf = 0x7ff0000000000000ULL;

SPRT_HD inline int32_t clz64(uint64_t x) {  // x != 0
#ifdef __CUDA_ARCH__
  return __clzll((long long)x);
#else
  return __builtin_clzll(x);
#endif
}

// the correctly rounded double of a uint64: values >= 2^63 halve with
// the dropped bit kept as a sticky bit, convert, and double
SPRT_HD inline double u64_to_f64(uint64_t bits) {
  int64_t b = (int64_t)bits;
  if (b < 0) {
    int64_t half = (int64_t)((bits >> 1) | (bits & 1));
    return (double)half * 2.0;
  }
  return (double)b;
}

// 10^a for a >= 0: the correctly rounded table up to 56, the two-level
// product 10^(32q) * 10^r above (inf past 10^308)
SPRT_HD inline double pow10_pos(int32_t a, const FloatTables& T) {
  a = min32(max32(a, 0), 341);
  if (a <= 56) return bits_f64(T.sub1[a]);
  double v = bits_f64(T.hi[a >> 5]) * bits_f64(T.sub1[a & 31]);
  return v != v ? bits_f64(kInf) : v;
}

// decimal digits of x, at most 19 (0 for 0): from the bit length, d =
// floor((bits - 1) * log10(2)) = ((bits - 1) * 1233) >> 12 exactly for
// bits <= 256, then one compare with 10^(d + 1)
SPRT_HD inline int32_t digits10_u64(uint64_t x, const FloatTables& T) {
  if (x == 0) return 0;
  int32_t d = ((63 - clz64(x)) * 1233) >> 12;
  return min32(d + 1 + (x >= T.u64[d + 1] ? 1 : 0), 19);
}

SPRT_HD inline bool word_at(const uint8_t* s, int32_t len, int32_t base, const char* w, int n) {
  for (int k = 0; k < n; ++k) {
    int32_t p = base + k;
    if (!(p < len && lower(s[p]) == w[k])) return false;
  }
  return true;
}

struct FloatParse {
  double value;  // 0.0 when invalid
  bool valid;
  bool except;  // an ANSI error at this row
};

// eight bytes from s, which need not be aligned (little-endian: s[0] is
// the lowest byte); on the card the two aligned words that hold them are
// read, so the caller guarantees 16 readable bytes from s. The words'
// address is s moved back, not rebuilt from an integer, so the compiler
// keeps s's address space (shared-memory loads for a staged string).
SPRT_HD inline uint64_t load8(const uint8_t* s) {
#ifdef __CUDA_ARCH__
  uint32_t off = (uint32_t)(uintptr_t)s & 7;
  const uint64_t* w = (const uint64_t*)(s - off);
  uint32_t sh = 8 * off;
  uint64_t lo = w[0];
  return sh == 0 ? lo : (lo >> sh) | (w[1] << (64 - sh));
#else
  uint64_t x;
  __builtin_memcpy(&x, s, 8);
  return x;
#endif
}

SPRT_HD inline int32_t ctz64(uint64_t x) {  // x != 0
#ifdef __CUDA_ARCH__
  return __ffsll((long long)x) - 1;
#else
  return __builtin_ctzll(x);
#endif
}

// the value of the k (1..8) decimal digits in the low bytes of x (x's
// lowest byte the first digit): the k digits moved up behind 8 - k '0'
// bytes, then eight digits at once (Lemire, "Number Parsing at a
// Gigabyte per Second", 2021)
SPRT_HD inline uint64_t digits8_value(uint64_t x, int32_t k) {
  if (k < 8) x = (x << (64 - 8 * k)) | (0x3030303030303030ULL >> (8 * k));
  x -= 0x3030303030303030ULL;
  x = x * 10 + (x >> 8);
  return (((x & 0x000000FF000000FFULL) * (100 + (1000000ULL << 32))) +
          (((x >> 16) & 0x000000FF000000FFULL) * (1 + (10000ULL << 32)))) >>
         32;
}

// the count (0..8) of leading decimal digits among the eight bytes of x
// (x's lowest byte first), of which only the first `left` belong to the
// string: a byte is a digit when its high nibble is 3 and its low one at
// most 9, which makes its byte of m 0
SPRT_HD inline int32_t digits_in8(uint64_t x, int32_t left) {
  uint64_t m = ((x & 0xF0F0F0F0F0F0F0F0ULL) ^ 0x3030303030303030ULL) |
               (((x & 0x0F0F0F0F0F0F0F0FULL) + 0x0606060606060606ULL) & 0xF0F0F0F0F0F0F0F0ULL);
  if (left < 8) m |= ~0ULL << (8 * left);
  return m == 0 ? 8 : ctz64(m) >> 3;
}

// the digits of one run of the mantissa from *p on: the first 19 kept
// positions accumulate into *digits18, the 20th is the extra digit, the
// rest only count (*R: kept positions so far). kWide: eight bytes are read
// at a time while the run's digits stay within the first 19 (see
// parse_float); the rest of a run goes a byte at a time.
template <bool kWide>
SPRT_HD inline void digit_run(const uint8_t* s, int32_t len, int32_t* p, int32_t* R,
                              uint64_t* digits18, int32_t* extra_d, const FloatTables& T) {
  int32_t q = *p, r = *R;
  uint64_t v = *digits18;
  if (kWide) {
    while (q < len) {
      uint64_t x = load8(s + q);
      int32_t k = digits_in8(x, len - q);
      if (k == 0 || r + k > 19) break;
      v = v * T.u64[k] + digits8_value(x, k);
      r += k;
      q += k;
      if (k < 8) {
        *p = q;
        *R = r;
        *digits18 = v;
        return;
      }
    }
  }
  for (; q < len; ++q) {
    uint32_t d = (uint32_t)s[q] - '0';
    if (d > 9) break;
    if (r < 19) {
      v = v * 10u + d;
    } else if (r == 19) {
      *extra_d = (int32_t)d;
    }
    ++r;
  }
  *p = q;
  *R = r;
  *digits18 = v;
}

// One forward pass over the bytes: whitespace, sign, a nan / inf word,
// the mantissa, the exponent, the suffix and the trailing whitespace,
// each byte read once. `s` may point at shared or global memory. The
// mantissa's zeros before any nonzero digit and before the dot are
// stripped; every other digit takes the next kept position (digit_run),
// before the dot and after it. kWide: digit runs are read eight bytes at
// a time (load8: on the card two aligned words), so 16 bytes must be
// readable from every byte of the string (the staged copy of a tile has
// that slack; the chars in place do not).
template <bool kWide>
SPRT_HD inline FloatParse parse_float(const uint8_t* s, int32_t len, bool in_valid,
                                      const FloatTables& T) {
  int32_t p = 0;
  while (p < len && is_ws(s[p])) ++p;
  bool negative = false;
  if (p < len && (s[p] == '+' || s[p] == '-')) {
    negative = s[p] == '-';
    ++p;
  }
  int32_t start = p;
  double signf = negative ? -1.0 : 1.0;
  FloatParse out = {0.0, false, false};
  int c0 = p < len ? lower(s[p]) : 0;
  if (c0 == 'n' && word_at(s, len, start, "nan", 3)) {
    bool exact = len == 3;
    out.valid = in_valid && exact;
    out.except = in_valid && !exact;
    out.value = out.valid ? bits_f64(kQuietNan) : 0.0;
    return out;
  }
  if (c0 == 'i' && word_at(s, len, start, "inf", 3)) {
    bool inf8 = word_at(s, len, start + 3, "inity", 5);
    bool inf_value = start + 3 == len || (inf8 && start + 8 == len);
    out.valid = in_valid && inf_value;
    out.value = out.valid ? signf * bits_f64(kInf) : 0.0;
    return out;
  }

  // the mantissa
  uint64_t digits18 = 0;
  int32_t nd = 0, R = 0, after_dot = 0;  // digits; kept positions; of them after the dot
  int32_t extra_d = 0;
  while (p < len && s[p] == '0') {
    ++p;
    ++nd;
  }
  digit_run<kWide>(s, len, &p, &R, &digits18, &extra_d, T);
  bool dot = p < len && s[p] == '.';
  if (dot) {
    ++p;
    int32_t before = R;
    digit_run<kWide>(s, len, &p, &R, &digits18, &extra_d, T);
    after_dot = R - before;
  }
  nd += R;
  bool take_extra = R > 19 && (uint64_t)((int64_t)kMaxHolding - extra_d) / 10u >= digits18;
  uint64_t digits = take_extra ? digits18 * 10u + (uint64_t)extra_d : digits18;
  int32_t kept = min32(R, 19) + (take_extra ? 1 : 0);
  int32_t exp_base = (R - kept) - (dot ? after_dot : 0);

  // the manual exponent: at most 4 digits
  bool bad_exp = false;
  int64_t manual_exp = 0;
  if (p < len && lower(s[p]) == 'e') {
    ++p;
    bool e_neg = false;
    if (p < len && (s[p] == '+' || s[p] == '-')) {
      e_neg = s[p] == '-';
      ++p;
    }
    int32_t eds = p;
    int64_t e_val = 0;
    while (p < eds + 4 && p < len && is_digit(s[p])) {
      e_val = e_val * 10 + (s[p] - '0');
      ++p;
    }
    bad_exp = p == eds;
    manual_exp = e_neg ? -e_val : e_val;
  }

  // trailing: one f/d suffix after a nonzero value, then whitespace only
  bool zero_digits = digits == 0;
  if (p < len && !zero_digits && (lower(s[p]) == 'f' || lower(s[p]) == 'd')) ++p;
  bool trailing_junk = false;
  for (; p < len; ++p) {
    if (!is_ws(s[p])) {
      trailing_junk = true;
      break;
    }
  }
  bool bad = nd == 0 || bad_exp || trailing_junk;
  out.valid = in_valid && len > 0 && !bad;
  out.except = in_valid && bad;
  if (!out.valid) return out;

  // the value, in float64 (each operation rounded on its own)
  int32_t exp_ten = (int32_t)(exp_base + manual_exp);
  double digitsf = u64_to_f64(digits);
  int32_t nd10 = digits10_u64(digits, T);
  int32_t shift = -307 - exp_ten;
  double value;
  if (shift > 0) {
    double num = digitsf / bits_f64(T.sub1[min32(max32(nd10 - 1 + shift, 0), 56)]);
    int32_t k = nd10 - 1;
    double scale = (k >= 0 && k < 20) ? bits_f64(T.subneg[k]) : 0.0;
    value = shift > 36 ? 0.0 : num * scale;
  } else {
    int32_t a = exp_ten < 0 ? -exp_ten : exp_ten;
    double pw = pow10_pos(a, T);
    value = exp_ten < 0 ? digitsf / pw : digitsf * pw;
  }
  if (value != value) value = bits_f64(kInf);
  if (exp_ten > 308) value = bits_f64(kInf);
  if (zero_digits) value = 0.0;
  out.value = signf * value;
  return out;
}

// The string tiles of the CUDA cast kernels: a tile of rows whose chars
// are staged in a shared-memory buffer. A tile stages the span
// [offsets[r0], staged_end) of its chars: the rest of the buffer takes
// the 16-byte alignment of the span's two ends and leaves at least 16
// bytes readable past every staged byte (the eight-byte reads of
// parse_float<true> and parse_integer<true>). A row whose bytes end by
// staged_end is parsed from the buffer, any other row from the chars
// where they lie. The host plugin stages the same spans. The float cast
// takes kFloatTileRows rows a tile and a buffer of kFloatStageBytes, the
// integer cast kIntTileRows and kIntStageBytes.
constexpr int32_t kFloatTileRows = 1024;
constexpr int32_t kFloatStageBytes = 16384;
constexpr int32_t kFloatStageSpan = kFloatStageBytes - 32;
constexpr int32_t kIntTileRows = 1024;
constexpr int32_t kIntStageBytes = 16384;
constexpr int32_t kIntStageSpan = kIntStageBytes - 32;

SPRT_HD inline int32_t staged_end(int32_t span_start, int32_t span_end, int32_t span) {
  return min32(span_end, span_start + span);
}

// ---------------------------------------------------------------------------
// string -> integer: JAX spark_rapids_jni_tpu/ops/cast_string.py
// _parse_integer; port spark_rapids_jni_tpu_torch/ops/cast_string.py:91
// _parse_integer. [ws] [+-] digits ['.' digits] [ws]; the '.' truncates
// outside ANSI and is invalid under it; whitespace only when stripping;
// leading zeros are not significant, more than 19 significant digits or
// a value past the target width are invalid.

struct IntParse {
  int64_t value;  // two's complement, in the target's range; 0 when invalid
  bool valid;
};

// 10^k for k in [0, 8], from the bits of k (no table)
SPRT_HD inline uint64_t pow10_upto8(int32_t k) {
  uint64_t p = (k & 1) ? 10u : 1u;
  p *= (k & 2) ? 100u : 1u;
  p *= (k & 4) ? 10000u : 1u;
  return (k & 8) ? 100000000u : p;
}

// One forward pass over the bytes, each read once, with one byte in hand
// (c: 0 past the end, which no rule takes): whitespace (when stripping),
// the sign, the zeros before the first significant digit, the
// significant digits, the dot and its digits (checked, not accumulated),
// the trailing whitespace. It returns on the first byte that makes the
// row invalid. The first eight significant digits accumulate a byte at a
// time in 32 bits (store_sales' quantities have one or two); the rest of
// a longer run goes on eight bytes at a time when kWide (load8: on the
// card two aligned words, so 16 bytes must be readable from every byte
// of the string: the staged copy of a tile has that slack; the chars in
// place do not, and go on a byte at a time). With 19 significant digits
// at most the magnitude stays below 10^19 < 2^64: no wrap.
template <bool kWide>
SPRT_HD inline IntParse parse_integer(const uint8_t* s, int32_t len, bool in_valid, int bits,
                                      bool ansi, bool strip) {
  IntParse out = {0, false};
  if (!in_valid || len <= 0) return out;
  int32_t p = 0;
  uint32_t c = s[0];
  if (strip) {
    while (is_ws(c)) c = ++p < len ? s[p] : 0;
  }
  bool negative = c == '-';
  if (negative || c == '+') c = ++p < len ? s[p] : 0;
  int32_t start = p;
  if (start >= len) return out;  // only whitespace and a sign
  while (c == '0') c = ++p < len ? s[p] : 0;
  uint32_t head = 0;  // the first eight significant digits
  int32_t nd = 0;     // significant digits
  for (uint32_t d = c - '0'; d <= 9 && nd < 8; d = c - '0') {
    head = head * 10u + d;
    ++nd;
    c = ++p < len ? s[p] : 0;
  }
  uint64_t mag = head;
  if (c - '0' <= 9) {  // a ninth significant digit: the rest of the run
    if (kWide) {
      while (p < len) {
        uint64_t x = load8(s + p);
        int32_t k = digits_in8(x, len - p);
        if (k == 0) break;
        nd += k;
        if (nd > 19) return out;
        mag = mag * pow10_upto8(k) + digits8_value(x, k);
        p += k;
        if (k < 8) break;
      }
    } else {
      for (; p < len; ++p) {
        uint32_t d = (uint32_t)s[p] - '0';
        if (d > 9) break;
        if (++nd > 19) return out;
        mag = mag * 10u + d;
      }
    }
    c = p < len ? s[p] : 0;
  }
  if (c == '.') {
    if (ansi) return out;
    ++p;
    if (kWide) {
      while (p < len) {
        int32_t k = digits_in8(load8(s + p), len - p);
        p += k;
        if (k < 8) break;
      }
    } else {
      while (p < len && is_digit(s[p])) ++p;
    }
    c = p < len ? s[p] : 0;
  }
  if (p < len) {
    // the rest must be whitespace, after a payload: a row whose first
    // byte past the sign is neither a digit nor the dot is invalid
    if (!strip || p == start) return out;
    while (is_ws(c)) {
      if (++p == len) break;
      c = s[p];
    }
    if (p < len) return out;
  }
  uint64_t limit = negative ? (1ull << (bits - 1)) : (1ull << (bits - 1)) - 1;
  if (mag > limit) return out;
  out.value = (int64_t)(negative ? (uint64_t)0 - mag : mag);
  out.valid = true;
  return out;
}

// ---------------------------------------------------------------------------
// DECIMAL128 arithmetic: 128-bit two's complement operands, wider
// intermediates in 256-bit two's complement, four 64-bit limbs least
// significant first (the port's utils/int256.py, the reference's
// chunked256). A product is taken as |a| * |b| (four 64x64 partial
// products), and the sign applied after; digits are counted from the
// bit length; the rescale divides by 10^k with precomputed reciprocals.

struct U256 {
  uint64_t l[4];
};

// 10^k, k = 0..77, as four limbs each (least significant first)
SPRT_TABLE(uint64_t, kPow10x4,
           0x0000000000000001ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x000000000000000aULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x0000000000000064ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x00000000000003e8ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x0000000000002710ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x00000000000186a0ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x00000000000f4240ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x0000000000989680ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x0000000005f5e100ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x000000003b9aca00ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x00000002540be400ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x000000174876e800ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x000000e8d4a51000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x000009184e72a000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x00005af3107a4000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x00038d7ea4c68000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x002386f26fc10000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x016345785d8a0000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x0de0b6b3a7640000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x8ac7230489e80000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x6bc75e2d63100000ULL, 0x0000000000000005ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x35c9adc5dea00000ULL, 0x0000000000000036ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x19e0c9bab2400000ULL, 0x000000000000021eULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x02c7e14af6800000ULL, 0x000000000000152dULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x1bcecceda1000000ULL, 0x000000000000d3c2ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x161401484a000000ULL, 0x0000000000084595ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0xdcc80cd2e4000000ULL, 0x000000000052b7d2ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x9fd0803ce8000000ULL, 0x00000000033b2e3cULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x3e25026110000000ULL, 0x00000000204fce5eULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x6d7217caa0000000ULL, 0x00000001431e0faeULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x4674edea40000000ULL, 0x0000000c9f2c9cd0ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0xc0914b2680000000ULL, 0x0000007e37be2022ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x85acef8100000000ULL, 0x000004ee2d6d415bULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x38c15b0a00000000ULL, 0x0000314dc6448d93ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x378d8e6400000000ULL, 0x0001ed09bead87c0ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x2b878fe800000000ULL, 0x0013426172c74d82ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0xb34b9f1000000000ULL, 0x00c097ce7bc90715ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x00f436a000000000ULL, 0x0785ee10d5da46d9ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x098a224000000000ULL, 0x4b3b4ca85a86c47aULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x5f65568000000000ULL, 0xf050fe938943acc4ULL, 0x0000000000000002ULL, 0x0000000000000000ULL,
           0xb9f5610000000000ULL, 0x6329f1c35ca4bfabULL, 0x000000000000001dULL, 0x0000000000000000ULL,
           0x4395ca0000000000ULL, 0xdfa371a19e6f7cb5ULL, 0x0000000000000125ULL, 0x0000000000000000ULL,
           0xa3d9e40000000000ULL, 0xbc627050305adf14ULL, 0x0000000000000b7aULL, 0x0000000000000000ULL,
           0x6682e80000000000ULL, 0x5bd86321e38cb6ceULL, 0x00000000000072cbULL, 0x0000000000000000ULL,
           0x011d100000000000ULL, 0x9673df52e37f2410ULL, 0x0000000000047bf1ULL, 0x0000000000000000ULL,
           0x0b22a00000000000ULL, 0xe086b93ce2f768a0ULL, 0x00000000002cd76fULL, 0x0000000000000000ULL,
           0x6f5a400000000000ULL, 0xc5433c60ddaa1640ULL, 0x0000000001c06a5eULL, 0x0000000000000000ULL,
           0x5986800000000000ULL, 0xb4a05bc8a8a4de84ULL, 0x00000000118427b3ULL, 0x0000000000000000ULL,
           0x7f41000000000000ULL, 0x0e4395d69670b12bULL, 0x00000000af298d05ULL, 0x0000000000000000ULL,
           0xf88a000000000000ULL, 0x8ea3da61e066ebb2ULL, 0x00000006d79f8232ULL, 0x0000000000000000ULL,
           0xb564000000000000ULL, 0x926687d2c40534fdULL, 0x000000446c3b15f9ULL, 0x0000000000000000ULL,
           0x15e8000000000000ULL, 0xb8014e3ba83411e9ULL, 0x000002ac3a4edbbfULL, 0x0000000000000000ULL,
           0xdb10000000000000ULL, 0x300d0e549208b31aULL, 0x00001aba4714957dULL, 0x0000000000000000ULL,
           0x8ea0000000000000ULL, 0xe0828f4db456ff0cULL, 0x00010b46c6cdd6e3ULL, 0x0000000000000000ULL,
           0x9240000000000000ULL, 0xc51999090b65f67dULL, 0x000a70c3c40a64e6ULL, 0x0000000000000000ULL,
           0xb680000000000000ULL, 0xb2fffa5a71fba0e7ULL, 0x006867a5a867f103ULL, 0x0000000000000000ULL,
           0x2100000000000000ULL, 0xfdffc78873d4490dULL, 0x04140c78940f6a24ULL, 0x0000000000000000ULL,
           0x4a00000000000000ULL, 0xebfdcb54864ada83ULL, 0x28c87cb5c89a2571ULL, 0x0000000000000000ULL,
           0xe400000000000000ULL, 0x37e9f14d3eec8920ULL, 0x97d4df19d6057673ULL, 0x0000000000000001ULL,
           0xe800000000000000ULL, 0x2f236d04753d5b48ULL, 0xee50b7025c36a080ULL, 0x000000000000000fULL,
           0x1000000000000000ULL, 0xd762422c946590d9ULL, 0x4f2726179a224501ULL, 0x000000000000009fULL,
           0xa000000000000000ULL, 0x69d695bdcbf7a87aULL, 0x17877cec0556b212ULL, 0x0000000000000639ULL,
           0x4000000000000000ULL, 0x2261d969f7ac94caULL, 0xeb4ae1383562f4b8ULL, 0x0000000000003e3aULL,
           0x8000000000000000ULL, 0x57d27e23acbdcfe6ULL, 0x30eccc3215dd8f31ULL, 0x0000000000026e4dULL,
           0x0000000000000000ULL, 0x6e38ed64bf6a1f01ULL, 0xe93ff9f4daa797edULL, 0x0000000000184f03ULL,
           0x0000000000000000ULL, 0x4e3945ef7a25360aULL, 0x1c7fc3908a8bef46ULL, 0x0000000000f31627ULL,
           0x0000000000000000ULL, 0x0e3cbb5ac5741c64ULL, 0x1cfda3a5697758bfULL, 0x00000000097edd87ULL,
           0x0000000000000000ULL, 0x8e5f518bb6891be8ULL, 0x21e864761ea97776ULL, 0x000000005ef4a747ULL,
           0x0000000000000000ULL, 0x8fb92f75215b1710ULL, 0x5313ec9d329eaaa1ULL, 0x00000003b58e88c7ULL,
           0x0000000000000000ULL, 0x9d3bda934d8ee6a0ULL, 0x3ec73e23fa32aa4fULL, 0x00000025179157c9ULL,
           0x0000000000000000ULL, 0x245689c107950240ULL, 0x73c86d67c5faa71cULL, 0x00000172ebad6ddcULL,
           0x0000000000000000ULL, 0x6b61618a4bd21680ULL, 0x85d4460dbbca8719ULL, 0x00000e7d34c64a9cULL,
           0x0000000000000000ULL, 0x31cdcf66f634e100ULL, 0x3a4abc8955e946feULL, 0x000090e40fbeea1dULL,
           0x0000000000000000ULL, 0xf20a1a059e10ca00ULL, 0x46eb5d5d5b1cc5edULL, 0x0005a8e89d752524ULL,
           0x0000000000000000ULL, 0x746504382ca7e400ULL, 0xc531a5a58f1fbb4bULL, 0x003899162693736aULL,
           0x0000000000000000ULL, 0x8bf22a31be8ee800ULL, 0xb3f07877973d50f2ULL, 0x0235fadd81c2822bULL,
           0x0000000000000000ULL, 0x7775a5f171951000ULL, 0x0764b4abe8652979ULL, 0x161bcca7119915b5ULL,
           0x0000000000000000ULL, 0xaa987b6e6fd2a000ULL, 0x49ef0eb713f39ebeULL, 0xdd15fe86affad912ULL)
// division by 10^k, k = 1..19 (index k - 1), by an invariant divisor
// (Moller and Granlund, "Improved division by invariant integers",
// 2011, algorithm 4): the divisor shifted left until its top bit is
// set, that shift, the reciprocal floor((2^128 - 1) / divisor) - 2^64,
// and 5 * 10^(k - 1), half of 10^k
SPRT_CTABLE(uint64_t, kDivNorm,
           0xa000000000000000ULL, 0xc800000000000000ULL, 0xfa00000000000000ULL,
           0x9c40000000000000ULL, 0xc350000000000000ULL, 0xf424000000000000ULL,
           0x9896800000000000ULL, 0xbebc200000000000ULL, 0xee6b280000000000ULL,
           0x9502f90000000000ULL, 0xba43b74000000000ULL, 0xe8d4a51000000000ULL,
           0x9184e72a00000000ULL, 0xb5e620f480000000ULL, 0xe35fa931a0000000ULL,
           0x8e1bc9bf04000000ULL, 0xb1a2bc2ec5000000ULL, 0xde0b6b3a76400000ULL,
           0x8ac7230489e80000ULL)
SPRT_CTABLE(int32_t, kDivShift,
           60, 57, 54, 50, 47, 44, 40, 37, 34, 30,
           27, 24, 20, 17, 14, 10, 7, 4, 0)
SPRT_CTABLE(uint64_t, kDivInv,
           0x9999999999999999ULL, 0x47ae147ae147ae14ULL, 0x0624dd2f1a9fbe76ULL,
           0xa36e2eb1c432ca57ULL, 0x4f8b588e368f0846ULL, 0x0c6f7a0b5ed8d36bULL,
           0xad7f29abcaf48578ULL, 0x5798ee2308c39df9ULL, 0x12e0be826d694b2eULL,
           0xb7cdfd9d7bdbab7dULL, 0x5fd7fe17964955fdULL, 0x19799812dea11197ULL,
           0xc25c268497681c26ULL, 0x6849b86a12b9b01eULL, 0x203af9ee756159b2ULL,
           0xcd2b297d889bc2b6ULL, 0x70ef54646d496892ULL, 0x2725dd1d243aba0eULL,
           0xd83c94fb6d2ac34aULL)
SPRT_CTABLE(uint64_t, kHalfPow10,
           5ULL, 50ULL, 500ULL,
           5000ULL, 50000ULL, 500000ULL,
           5000000ULL, 50000000ULL, 500000000ULL,
           5000000000ULL, 50000000000ULL, 500000000000ULL,
           5000000000000ULL, 50000000000000ULL, 500000000000000ULL,
           5000000000000000ULL, 50000000000000000ULL, 500000000000000000ULL,
           5000000000000000000ULL)
constexpr uint64_t kDec38Lo = 0x098a224000000000ULL;  // 10^38, low limb
constexpr uint64_t kDec38Hi = 0x4b3b4ca85a86c47aULL;  // 10^38, high limb

SPRT_HD inline void mul64(uint64_t a, uint64_t b, uint64_t* lo, uint64_t* hi) {
#ifdef __CUDA_ARCH__
  *lo = a * b;
  *hi = __umul64hi(a, b);
#else
  unsigned __int128 p = (unsigned __int128)a * b;
  *lo = (uint64_t)p;
  *hi = (uint64_t)(p >> 64);
#endif
}

// a + b + *carry, the carry out in *carry
SPRT_HD inline uint64_t addc(uint64_t a, uint64_t b, uint64_t* carry) {
  uint64_t s = a + b;
  uint64_t c = s < a;
  uint64_t s2 = s + *carry;
  *carry = c + (s2 < s);
  return s2;
}

SPRT_HD inline U256 from_i128(int64_t lo, int64_t hi) {
  uint64_t ext = (uint64_t)(hi >> 63);
  U256 r = {{(uint64_t)lo, (uint64_t)hi, ext, ext}};
  return r;
}

SPRT_HD inline bool is_neg(const U256& a) { return (int64_t)a.l[3] < 0; }

SPRT_HD inline U256 add(const U256& a, const U256& b) {
  U256 r;
  uint64_t carry = 0;
  SPRT_UNROLL
  for (int i = 0; i < 4; ++i) r.l[i] = addc(a.l[i], b.l[i], &carry);
  return r;
}

SPRT_HD inline U256 neg(const U256& a) {
  U256 r;
  uint64_t carry = 1;
  SPRT_UNROLL
  for (int i = 0; i < 4; ++i) r.l[i] = addc(~a.l[i], 0, &carry);
  return r;
}

SPRT_HD inline U256 abs256(const U256& a) { return is_neg(a) ? neg(a) : a; }

SPRT_HD inline bool lt_unsigned(const U256& a, const uint64_t* b) {
  SPRT_UNROLL
  for (int i = 3; i >= 0; --i) {
    if (a.l[i] != b[i]) return a.l[i] < b[i];
  }
  return false;
}

// |x| >= 10^38 for a magnitude x: Spark's DECIMAL128 overflow
SPRT_HD inline bool ge_dec38(const U256& x) {
  return (x.l[2] | x.l[3]) != 0 || x.l[1] > kDec38Hi ||
         (x.l[1] == kDec38Hi && x.l[0] >= kDec38Lo);
}

// the magnitude of a 128-bit two's complement value; true when negative
SPRT_HD inline bool mag128(int64_t lo, int64_t hi, uint64_t* m_lo, uint64_t* m_hi) {
  uint64_t l = (uint64_t)lo, h = (uint64_t)hi;
  bool n = hi < 0;
  if (n) {
    l = ~l + 1;
    h = ~h + (l == 0 ? 1 : 0);
  }
  *m_lo = l;
  *m_hi = h;
  return n;
}

// a * b of two magnitudes below 2^128 (at most 2^254, so no wrap):
// four 64x64 partial products, one when both fit in 64 bits
SPRT_HD inline U256 mul_mag128(uint64_t a_lo, uint64_t a_hi, uint64_t b_lo, uint64_t b_hi) {
  U256 r;
  mul64(a_lo, b_lo, &r.l[0], &r.l[1]);
  r.l[2] = r.l[3] = 0;
  if ((a_hi | b_hi) == 0) return r;
  uint64_t lo, hi, c = 0;
  mul64(a_lo, b_hi, &lo, &hi);
  r.l[1] = addc(r.l[1], lo, &c);
  r.l[2] = addc(r.l[2], hi, &c);
  r.l[3] += c;
  c = 0;
  mul64(a_hi, b_lo, &lo, &hi);
  r.l[1] = addc(r.l[1], lo, &c);
  r.l[2] = addc(r.l[2], hi, &c);
  r.l[3] += c;
  c = 0;
  mul64(a_hi, b_hi, &lo, &hi);
  r.l[2] = addc(r.l[2], lo, &c);
  r.l[3] += hi + c;
  return r;
}

// a * b mod 2^256
SPRT_HD inline U256 mul(const U256& a, const U256& b) {
  uint64_t r[4] = {0, 0, 0, 0};
  SPRT_UNROLL
  for (int i = 0; i < 4; ++i) {
    uint64_t carry = 0;
    SPRT_UNROLL
    for (int j = 0; j < 4 - i; ++j) {
      uint64_t lo, hi;
      mul64(a.l[i], b.l[j], &lo, &hi);
      uint64_t s = r[i + j] + lo;
      uint64_t c1 = s < lo;
      uint64_t s2 = s + carry;
      uint64_t c2 = s2 < s;
      r[i + j] = s2;
      carry = hi + c1 + c2;
    }
  }
  U256 out = {{r[0], r[1], r[2], r[3]}};
  return out;
}

// a * b mod 2^256 for a 64-bit b
SPRT_HD inline U256 mul_u64(const U256& a, uint64_t b) {
  U256 r;
  uint64_t carry = 0;
  SPRT_UNROLL
  for (int i = 0; i < 4; ++i) {
    uint64_t lo, hi;
    mul64(a.l[i], b, &lo, &hi);
    uint64_t s = lo + carry;
    r.l[i] = s;
    carry = hi + (s < lo);
  }
  return r;
}

// a * 10^k mod 2^256, k in [0, 77]; p10: kPow10x4 (its copy in shared
// memory on the card, or the table itself)
SPRT_HD inline U256 mul_pow10(const U256& a, int32_t k, const uint64_t* p10) {
  if (k == 0) return a;
  if (k <= 19) return mul_u64(a, p10[4 * k]);
  U256 p = {{p10[4 * k], p10[4 * k + 1], p10[4 * k + 2], p10[4 * k + 3]}};
  return mul(a, p);
}

// decimal digits of a magnitude (int256.py precision10): the count of i
// in [0, 76] with 10^i < |a|, -1 past 10^76. That count is the number of
// digits of |a| - 1: d = floor((bits - 1) * log10(2)) from the bit length
// (((bits - 1) * 1233) >> 12, exact up to 256 bits), then one compare
// with 10^(d + 1).
SPRT_HD inline int32_t precision10(const U256& mag, const uint64_t* p10) {
  if ((mag.l[0] | mag.l[1] | mag.l[2] | mag.l[3]) == 0) return 0;
  U256 x;
  uint64_t borrow = 1;
  SPRT_UNROLL
  for (int i = 0; i < 4; ++i) {
    x.l[i] = mag.l[i] - borrow;
    borrow = mag.l[i] < borrow ? 1 : 0;
  }
  int32_t bits = x.l[3] ? 256 - clz64(x.l[3])
                 : x.l[2] ? 192 - clz64(x.l[2])
                 : x.l[1] ? 128 - clz64(x.l[1])
                 : x.l[0] ? 64 - clz64(x.l[0])
                          : 0;
  if (bits == 0) return 0;  // |a| == 1
  int32_t d = ((bits - 1) * 1233) >> 12;
  int32_t digits = d + 1 + (lt_unsigned(x, p10 + 4 * (d + 1)) ? 0 : 1);
  return digits >= 77 ? -1 : digits;
}

// (u1:u0) / d for a normalised d (top bit set), u1 < d, with v its
// reciprocal: the quotient; the remainder in *r
SPRT_HD inline uint64_t div_preinv(uint64_t u1, uint64_t u0, uint64_t d, uint64_t v,
                                   uint64_t* r) {
  uint64_t q0, q1;
  mul64(v, u1, &q0, &q1);
  q0 += u0;
  q1 += u1 + (q0 < u0 ? 1 : 0) + 1;
  uint64_t rr = u0 - q1 * d;
  if (rr > q0) {
    q1 -= 1;
    rr += d;
  }
  if (rr >= d) {
    q1 += 1;
    rr -= d;
  }
  *r = rr;
  return q1;
}

// floor(x / 10^k) of a 256-bit x, k in [1, 19]: long division on 64-bit
// limbs of x shifted by the divisor's normalising shift; the remainder
// in *rem
SPRT_HD inline U256 div_pow10_small(const U256& x, int32_t k, uint64_t* rem) {
  int32_t s = SPRT_AT(kDivShift, k - 1);
  uint64_t d = SPRT_AT(kDivNorm, k - 1), v = SPRT_AT(kDivInv, k - 1);
  U256 q;
  uint64_t r = s ? x.l[3] >> (64 - s) : 0;
  SPRT_UNROLL
  for (int i = 3; i >= 0; --i) {
    uint64_t u = x.l[i] << s;
    if (s && i > 0) u |= x.l[i - 1] >> (64 - s);
    q.l[i] = div_preinv(r, u, d, v, &r);
  }
  *rem = r >> s;
  return q;
}

// x / 10^k rounded HALF_UP for a magnitude x, k in [0, 38] (int256.py
// divide_and_round_pow10): one step of the long division for k <= 19,
// two (by 10^19, then by 10^(k - 19)) above. Twice the remainder
// reaches 10^k exactly when the remainder reaches 5 * 10^(k - 1); past
// 10^19 that is the second remainder reaching 5 * 10^(k - 20), the
// first being below 10^19.
SPRT_HD inline U256 div_round_pow10(const U256& x, int32_t k) {
  if (k == 0) return x;
  uint64_t r;
  U256 q;
  bool up;
  if (k <= 19) {
    q = div_pow10_small(x, k, &r);
    up = r >= SPRT_AT(kHalfPow10, k - 1);
  } else {
    U256 q1 = div_pow10_small(x, 19, &r);
    q = div_pow10_small(q1, k - 19, &r);
    up = r >= SPRT_AT(kHalfPow10, k - 20);
  }
  if (up) {
    uint64_t carry = 1;
    SPRT_UNROLL
    for (int i = 0; i < 4; ++i) q.l[i] = addc(q.l[i], 0, &carry);
  }
  return q;
}

// a signed 256-bit n / 10^k rounded HALF_UP away from zero (int256.py
// divide_and_round)
SPRT_HD inline U256 div_round_signed(const U256& n, int32_t k) {
  bool n_neg = is_neg(n);
  U256 q = div_round_pow10(n_neg ? neg(n) : n, k);
  return n_neg ? neg(q) : q;
}

struct DecResult {
  int64_t lo, hi;
  bool overflow;
};

SPRT_HD inline DecResult dec_out(const U256& r, bool overflow) {
  DecResult out = {(int64_t)r.l[0], (int64_t)r.l[1], overflow};
  return out;
}

// What a launch's scales ask of every row: the rescales it may need.
// Add / subtract: the operands raised to the larger scale (ea, eb), then
// the sum lowered (delta > 0, a division) or raised (delta < 0) to the
// target. Multiply: the product rescaled by delta = a_scale + b_scale -
// product_scale (a division when positive). A product over 38 digits
// takes its first rounding whatever the scales (multiply_any).
constexpr int32_t kDecDown = 1;  // a division by 10^delta
constexpr int32_t kDecUp = 2;    // a multiplication by a power of ten

struct DecPlan {
  bool mul, is_sub;
  int32_t regime;      // kDecDown | kDecUp bits
  int32_t ea, eb;      // add / subtract: each operand's raise
  int32_t delta;       // the rescale of the sum or product
};

SPRT_HD inline DecPlan dec_plan(bool mul, bool is_sub, int32_t a_scale, int32_t b_scale,
                                int32_t out_scale) {
  DecPlan p = {mul, is_sub, 0, 0, 0, 0};
  if (mul) {
    p.delta = a_scale + b_scale - out_scale;
  } else {
    int32_t inter = max32(a_scale, b_scale);
    p.ea = inter - a_scale;
    p.eb = inter - b_scale;
    p.delta = inter - out_scale;
  }
  if (p.delta > 0) p.regime |= kDecDown;
  if (p.delta < 0 || p.ea > 0 || p.eb > 0) p.regime |= kDecUp;
  return p;
}

// add / subtract with scales given at run time: JAX ops/decimal.py
// _add_sub_scales_any; port ops/decimal.py:150 _add_sub_scales_any. The
// caller keeps max(a_scale, b_scale) - target_scale <= 38. R: the
// regime bits of the launch's plan; the code for a rescale it cannot
// need is not compiled in.
template <int32_t R>
SPRT_HD inline DecResult add_sub(const DecPlan& p, int64_t a_lo, int64_t a_hi, int64_t b_lo,
                                 int64_t b_hi, const uint64_t* p10) {
  U256 a = from_i128(a_lo, a_hi), b = from_i128(b_lo, b_hi);
  if (R & kDecUp) {
    a = mul_pow10(a, min32(p.ea, 77), p10);
    b = mul_pow10(b, min32(p.eb, 77), p10);
  }
  if (p.is_sub) b = neg(b);
  U256 s = add(a, b);
  if ((R & kDecDown) && p.delta > 0) {
    s = div_round_signed(s, min32(p.delta, 38));
  } else if ((R & kDecUp) && p.delta < 0) {
    s = mul_pow10(s, min32(-p.delta, 77), p10);
  }
  return dec_out(s, ge_dec38(abs256(s)));
}

#ifdef __CUDA_ARCH__
#define SPRT_NOINLINE __noinline__
#else
#define SPRT_NOINLINE
#endif

// the multiply of any product magnitude `mag` (sign `negative`): the
// first rounding of a product over 38 digits, then the rescale by
// delta less that rounding's digits. Kept out of line on the card: few
// rows take it.
SPRT_HD inline SPRT_NOINLINE DecResult multiply_any(U256 mag, bool negative, int32_t delta,
                                                    const uint64_t* p10) {
  int32_t first_div = max32(precision10(mag, p10) - 38, 0);
  if (first_div > 0) mag = div_round_pow10(mag, first_div);
  int32_t exponent = delta - first_div;
  bool pre_overflow = exponent < 0 && (precision10(mag, p10) - exponent) > 38;
  if (exponent < 0) {
    mag = mul_pow10(mag, min32(-exponent, 77), p10);
  } else if (exponent > 0) {
    mag = div_round_pow10(mag, min32(exponent, 38));
  }
  U256 r = negative ? neg(mag) : mag;
  bool overflow = pre_overflow || ge_dec38(abs256(r));
  if (pre_overflow) {
    U256 zero = {{0, 0, 0, 0}};
    r = zero;
  }
  return dec_out(r, overflow);
}

// multiply with Spark's SPARK-40129 double rounding: JAX ops/decimal.py
// _multiply_scales_any; port ops/decimal.py:112 _multiply_scales_any.
// The caller keeps a_scale + b_scale - product_scale <= 38. A product
// below 10^38 has at most 38 digits, so no first rounding: it is
// rescaled by delta alone, in the regime R of the launch's plan, in 128
// bits (a raise that does not overflow stays below 2^127). Any other
// product takes multiply_any.
template <int32_t R>
SPRT_HD inline DecResult multiply(const DecPlan& p, int64_t a_lo, int64_t a_hi, int64_t b_lo,
                                  int64_t b_hi, const uint64_t* p10) {
  uint64_t al, ah, bl, bh;
  bool negative = mag128(a_lo, a_hi, &al, &ah) != mag128(b_lo, b_hi, &bl, &bh);
  U256 mag = mul_mag128(al, ah, bl, bh);
  if (ge_dec38(mag)) return multiply_any(mag, negative, p.delta, p10);
  bool overflow = false;
  if ((R & kDecDown) && p.delta > 0) {
    mag = div_round_pow10(mag, min32(p.delta, 38));  // below 10^37: no overflow
  } else if ((R & kDecUp) && p.delta < 0) {
    if (precision10(mag, p10) - p.delta > 38) {
      DecResult zero = {0, 0, true};
      return zero;
    }
    mag = mul_pow10(mag, -p.delta, p10);  // at most 10^38
    overflow = ge_dec38(mag);
  }
  uint64_t lo = mag.l[0], hi = mag.l[1];
  if (negative) {
    lo = ~lo + 1;
    hi = ~hi + (lo == 0 ? 1 : 0);
  }
  DecResult out = {(int64_t)lo, (int64_t)hi, overflow};
  return out;
}

// one row of the launch's op (MUL: multiply, else add / subtract) in
// regime R
template <bool MUL, int32_t R>
SPRT_HD inline DecResult decimal_row(const DecPlan& p, int64_t a_lo, int64_t a_hi,
                                     int64_t b_lo, int64_t b_hi, const uint64_t* p10) {
  if constexpr (MUL) {
    return multiply<R>(p, a_lo, a_hi, b_lo, b_hi, p10);
  } else {
    return add_sub<R>(p, a_lo, a_hi, b_lo, b_hi, p10);
  }
}

// ---------------------------------------------------------------------------
// JCUDF fixed-width rows: port ops/row_conversion.py:66
// compute_row_layout, _fixed_section and _decode_fixed (JAX
// ops/row_conversion.py _to_rows_fixed_flat / _from_rows_fixed_flat).
// Each column aligned to its size in declared order, the validity bits
// (LSB first, 1 = valid) after the last column, the row padded with
// zeros to 8 bytes.
//
// Both directions move a tile of rows at a time through a row-major
// staging tile (shared memory on the card, a heap buffer on the host):
// the tile holds one window of each of its rows, at a stride of
// tile_stride bytes. A window is a run of 16-byte units of the row:
// every column lies inside one unit (a column is aligned to its size,
// at most 16), so no column straddles two windows. Most schemas are one
// window (the whole row); a wide one is cut into windows of at most
// kWinWords words, kWinCols data columns and kWinCols validity columns,
// which is what a kernel's parameters carry.

constexpr int kWinCols = 128;  // data columns, and validity columns, of one window
constexpr int kWinWords = 64;  // 8-byte words of one window (512 bytes of a row)
constexpr int kTileBytes = 16384;  // bytes of one staging tile (one buffer)
constexpr int kTileRowsMax = 256;

// the layout of a whole row; the caller owns the four arrays of ncols
struct RowsDesc {
  int32_t ncols;
  int32_t row_size;  // bytes, a multiple of 8
  int32_t validity_offset;
  int32_t validity_bytes;
  int32_t* start;   // byte of each column in the row
  int32_t* size;    // 1, 2, 4, 8 or 16
  void** data;      // n * size bytes each
  uint8_t** valid;  // one byte per row; to rows: NULL = all valid
};

// one window of a row: the columns whose bytes lie in it and the
// columns whose validity bits lie in it
struct RowsWin {
  int32_t row_size;  // bytes of a whole row: the rows' stride
  int32_t w0;        // the window is words [w0, w0 + nwords) of each row
  int32_t nwords;
  int32_t ndata;     // data columns i = 0..ndata-1, in row order
  int32_t nvalid;    // validity columns i = 0..nvalid-1: bit i % 8 of byte vrel + i / 8
  int32_t vrel;      // the window's byte of validity column 0
  int16_t start[kWinCols];  // window byte of data column i
  int16_t size[kWinCols];
  void* data[kWinCols];
  uint8_t* valid[kWinCols];
};

// fills the layout of `ncols` columns of byte sizes `size` into d's
// scalars and its start / size arrays; false when the schema has no
// columns or a size the format lacks
SPRT_HD inline bool row_layout(RowsDesc* d, int32_t ncols, const int32_t* size) {
  if (ncols < 1) return false;
  int32_t off = 0;
  for (int32_t i = 0; i < ncols; ++i) {
    int32_t sz = size[i];
    if (sz != 1 && sz != 2 && sz != 4 && sz != 8 && sz != 16) return false;
    off = (off + sz - 1) / sz * sz;
    d->start[i] = off;
    d->size[i] = sz;
    off += sz;
  }
  d->ncols = ncols;
  d->validity_offset = off;
  d->validity_bytes = (ncols + 7) / 8;
  d->row_size = (off + d->validity_bytes + 7) / 8 * 8;
  return true;
}

// the validity columns whose bits lie in row bytes [lo, hi): the first
// is *c0, the count is returned
SPRT_HD inline int32_t validity_cols(const RowsDesc& d, int32_t lo, int32_t hi, int32_t* c0) {
  int32_t b0 = max32(lo, d.validity_offset);
  int32_t b1 = min32(hi, d.validity_offset + d.validity_bytes);
  *c0 = 8 * (b0 - d.validity_offset);
  return b1 > b0 ? min32(8 * (b1 - b0), d.ncols - *c0) : 0;
}

// the window that starts at word w0 (even): as many whole 16-byte units
// as stay within kWinWords words, kWinCols data columns and kWinCols
// validity columns (one unit always fits: 16 data or 128 validity
// columns). Fills *win and returns the word after it.
SPRT_HD inline int32_t plan_window(const RowsDesc& d, int32_t w0, RowsWin* win) {
  int32_t words = d.row_size / 8, lo = 8 * w0;
  int32_t c = 0;
  while (c < d.ncols && d.start[c] + d.size[c] <= lo) ++c;
  int32_t w1 = w0, e = c, vc0 = 0, nv = 0;
  while (w1 < words) {
    int32_t nw1 = min32(w1 + 2, words), hi = 8 * nw1;
    int32_t e1 = e;
    while (e1 < d.ncols && d.start[e1] < hi) ++e1;
    int32_t v0;
    int32_t nv1 = validity_cols(d, lo, hi, &v0);
    if (w1 > w0 && (nw1 - w0 > kWinWords || e1 - c > kWinCols || nv1 > kWinCols)) break;
    w1 = nw1;
    e = e1;
    nv = nv1;
    vc0 = v0;
  }
  win->row_size = d.row_size;
  win->w0 = w0;
  win->nwords = w1 - w0;
  win->ndata = e - c;
  win->nvalid = nv;
  win->vrel = max32(d.validity_offset - lo, 0);
  for (int32_t i = 0; i < kWinCols; ++i) {
    bool in = i < e - c;
    win->start[i] = (int16_t)(in ? d.start[c + i] - lo : 0);
    win->size[i] = (int16_t)(in ? d.size[c + i] : 0);
    win->data[i] = in ? d.data[c + i] : nullptr;
    win->valid[i] = i < nv ? d.valid[vc0 + i] : nullptr;
  }
  return w1;
}

// the staging tile's row stride: the window's bytes, padded by 8 where
// the rows would all start in one shared-memory bank
SPRT_HD inline int32_t tile_stride(const RowsWin& w) {
  int32_t s = 8 * w.nwords;
  return s % 128 == 0 ? s + 8 : s;
}

// rows of one tile of stride S: a multiple of 32, kTileBytes at most
// where 32 rows fit in it
SPRT_HD inline int32_t tile_rows(int32_t S) {
  int32_t r = kTileBytes / max32(S, 1) / 32 * 32;
  return min32(max32(r, 32), kTileRowsMax);
}

// where data column i of tile row r lies in the tile
SPRT_HD inline int32_t tile_offset(const RowsWin& w, int32_t S, int32_t r, int32_t i) {
  return r * S + w.start[i];
}

// little-endian loads and stores of 1, 2, 4 or 8 bytes at an address
// aligned to their size
SPRT_HD inline uint64_t load_le(const uint8_t* p, int32_t nbytes) {
#ifdef __CUDA_ARCH__
  switch (nbytes) {
    case 1:
      return *p;
    case 2:
      return *(const uint16_t*)p;
    case 4:
      return *(const uint32_t*)p;
    default:
      return *(const uint64_t*)p;
  }
#else
  uint64_t v = 0;
  __builtin_memcpy(&v, p, nbytes);
  return v;
#endif
}

SPRT_HD inline void store_le(uint8_t* p, int32_t nbytes, uint64_t v) {
#ifdef __CUDA_ARCH__
  switch (nbytes) {
    case 1:
      *p = (uint8_t)v;
      break;
    case 2:
      *(uint16_t*)p = (uint16_t)v;
      break;
    case 4:
      *(uint32_t*)p = (uint32_t)v;
      break;
    default:
      *(uint64_t*)p = v;
  }
#else
  __builtin_memcpy(p, &v, nbytes);
#endif
}

// the window's validity byte b (window byte vrel + b) of row `row`:
// bit k is validity column 8b + k, 1 = valid (a NULL mask: all valid)
SPRT_HD inline uint8_t validity_byte(const RowsWin& w, int64_t row, int32_t b) {
  uint32_t byte = 0;
  for (int32_t c = 8 * b; c < min32(8 * b + 8, w.nvalid); ++c) {
    const uint8_t* v = w.valid[c];
    byte |= (uint32_t)(v == nullptr || v[row] != 0) << (c - 8 * b);
  }
  return (uint8_t)byte;
}

// data column i of the row whose staged window bytes are `row`, into
// the column at row `out_row`
SPRT_HD inline void tile_unpack(const RowsWin& w, const uint8_t* row, int64_t out_row, int32_t i) {
  int32_t sz = w.size[i];
  uint8_t* dst = (uint8_t*)w.data[i] + out_row * sz;
  const uint8_t* src = row + w.start[i];
  if (sz == 16) {
    store_le(dst, 8, load_le(src, 8));
    store_le(dst + 8, 8, load_le(src + 8, 8));
  } else {
    store_le(dst, sz, load_le(src, sz));
  }
}

// validity column i of that row
SPRT_HD inline void tile_unpack_valid(const RowsWin& w, const uint8_t* row, int64_t out_row,
                                      int32_t i) {
  w.valid[i][out_row] = (row[w.vrel + i / 8] >> (i % 8)) & 1;
}

}  // namespace sprt_rowops

#endif  // SPRT_ROWOPS_H
