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
#define SPRT_TABLE(type, name, ...)                      \
  static const type name##_host[] = {__VA_ARGS__};       \
  static __device__ type name##_dev[] = {__VA_ARGS__};
#else
#define SPRT_HD
#define SPRT_TABLE(type, name, ...) static const type name##_host[] = {__VA_ARGS__};
#endif

#ifdef __CUDA_ARCH__
#define SPRT_AT(name, i) (name##_dev[i])
#else
#define SPRT_AT(name, i) (name##_host[i])
#endif

namespace sprt_rowops {

constexpr int32_t NONE = 0x7fffffff;  // "no such position"

SPRT_HD inline bool is_ws(int c) { return c == 32 || c == 13 || c == 9 || c == 10; }

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

// the parsers' shared prologue (cast_string.py _prologue): leading
// whitespace skipped when stripping, then one optional sign
SPRT_HD inline void prologue(const uint8_t* s, int32_t len, bool strip, int32_t* start,
                             bool* negative) {
  int32_t i0 = 0;
  if (strip) {
    while (i0 < len && is_ws(s[i0])) ++i0;
  }
  bool has_sign = i0 < len && (s[i0] == '+' || s[i0] == '-');
  *negative = has_sign && s[i0] == '-';
  *start = i0 + (has_sign ? 1 : 0);
}

// ---------------------------------------------------------------------------
// string -> integer: JAX spark_rapids_jni_tpu/ops/cast_string.py
// _parse_integer; port spark_rapids_jni_tpu_torch/ops/cast_string.py:90
// _parse_integer. [ws] [+-] digits ['.' digits] [ws]; the '.' truncates
// outside ANSI and is invalid under it; whitespace only when stripping;
// overflow of the target width is invalid.

struct IntParse {
  int64_t value;  // two's complement, already narrowed; 0 when invalid
  bool valid;
};

SPRT_HD inline IntParse parse_integer(const uint8_t* s, int32_t len, bool in_valid, int bits,
                                      bool ansi, bool strip) {
  IntParse out = {0, false};
  int32_t start;
  bool negative;
  prologue(s, len, strip, &start, &negative);
  if (!(in_valid && len > 0 && start < len)) return out;
  int32_t W = NONE;  // the first whitespace after the payload starts
  if (strip) {
    for (int32_t p = start; p < len; ++p) {
      if (is_ws(s[p])) {
        W = p;
        break;
      }
    }
  }
  if (W == start) return out;
  int32_t D1 = NONE;  // the one truncation dot (outside ANSI)
  if (!ansi) {
    for (int32_t p = start; p < min32(W, len); ++p) {
      if (s[p] == '.') {
        D1 = p;
        break;
      }
    }
  }
  for (int32_t p = start; p < len; ++p) {
    int c = s[p];
    bool ok = p < W ? (is_digit(c) || p == D1) : is_ws(c);
    if (!ok) return out;
  }
  int32_t D = min32(min32(D1, W), len);
  uint64_t mag = 0;  // wraps mod 2^64 like the column form's sum
  int32_t z = NONE;  // the first significant digit
  for (int32_t p = start; p < D; ++p) {
    int d = s[p] - '0';
    if (z == NONE && d != 0) z = p;
    mag = mag * 10u + (uint64_t)d;
  }
  int32_t nd = z == NONE ? 0 : D - z;
  uint64_t limit = negative ? (1ull << (bits - 1)) : (1ull << (bits - 1)) - 1;
  if (nd > 19 || limit < mag) return out;
  uint64_t v = negative ? (uint64_t)0 - mag : mag;
  if (bits == 8) {
    out.value = (int8_t)(uint8_t)v;
  } else if (bits == 16) {
    out.value = (int16_t)(uint16_t)v;
  } else if (bits == 32) {
    out.value = (int32_t)(uint32_t)v;
  } else {
    out.value = (int64_t)v;
  }
  out.valid = true;
  return out;
}

// ---------------------------------------------------------------------------
// string -> FLOAT64: JAX ops/cast_string.py _parse_float; port
// ops/cast_string.py:540 _parse_float. The reference's quirks: 'nan'
// only as the whole 3-byte string, inf/infinity must end the string
// (invalid but no ANSI error otherwise), one f/F/d/D suffix after a
// nonzero value, manual exponents of at most 4 digits, 19 (+1)
// significant digits with the rest truncated into the exponent.
// Subnormal results are kept (the JAX package on the CPU flushes them).

// 10^(32q), q = 0..10 (inf past 10^308)
SPRT_TABLE(uint64_t, kPow10Hi, 0x3ff0000000000000ULL, 0x4693b8b5b5056e17ULL,
           0x4d384f03e93ff9f5ULL, 0x53ddf67562d8b363ULL, 0x5a827748f9301d32ULL,
           0x6126c2d4256ffcc3ULL, 0x67cc0e1ef1a724ebULL, 0x6e714a52dffc6799ULL,
           0x75154fdd7f73bf3cULL, 0x7bba44df832b8d46ULL, 0x7ff0000000000000ULL)
// 10^k, k = 0..56, correctly rounded (its first 32 entries are also the
// low factor 10^r of the two-level product)
SPRT_TABLE(uint64_t, kPow10Sub1, 0x3ff0000000000000ULL, 0x4024000000000000ULL,
           0x4059000000000000ULL, 0x408f400000000000ULL, 0x40c3880000000000ULL,
           0x40f86a0000000000ULL, 0x412e848000000000ULL, 0x416312d000000000ULL,
           0x4197d78400000000ULL, 0x41cdcd6500000000ULL, 0x4202a05f20000000ULL,
           0x42374876e8000000ULL, 0x426d1a94a2000000ULL, 0x42a2309ce5400000ULL,
           0x42d6bcc41e900000ULL, 0x430c6bf526340000ULL, 0x4341c37937e08000ULL,
           0x4376345785d8a000ULL, 0x43abc16d674ec800ULL, 0x43e158e460913d00ULL,
           0x4415af1d78b58c40ULL, 0x444b1ae4d6e2ef50ULL, 0x4480f0cf064dd592ULL,
           0x44b52d02c7e14af6ULL, 0x44ea784379d99db4ULL, 0x45208b2a2c280291ULL,
           0x4554adf4b7320335ULL, 0x4589d971e4fe8402ULL, 0x45c027e72f1f1281ULL,
           0x45f431e0fae6d721ULL, 0x46293e5939a08ceaULL, 0x465f8def8808b024ULL,
           0x4693b8b5b5056e17ULL, 0x46c8a6e32246c99cULL, 0x46fed09bead87c03ULL,
           0x4733426172c74d82ULL, 0x476812f9cf7920e3ULL, 0x479e17b84357691bULL,
           0x47d2ced32a16a1b1ULL, 0x48078287f49c4a1dULL, 0x483d6329f1c35ca5ULL,
           0x48725dfa371a19e7ULL, 0x48a6f578c4e0a061ULL, 0x48dcb2d6f618c879ULL,
           0x4911efc659cf7d4cULL, 0x49466bb7f0435c9eULL, 0x497c06a5ec5433c6ULL,
           0x49b18427b3b4a05cULL, 0x49e5e531a0a1c873ULL, 0x4a1b5e7e08ca3a8fULL,
           0x4a511b0ec57e649aULL, 0x4a8561d276ddfdc0ULL, 0x4ababa4714957d30ULL,
           0x4af0b46c6cdd6e3eULL, 0x4b24e1878814c9ceULL, 0x4b5a19e96a19fc41ULL,
           0x4b905031e2503da9ULL)
// 10^(k - 307), k = 0..19, correctly rounded
SPRT_TABLE(uint64_t, kPow10SubNeg, 0x0031fa182c40c60dULL, 0x0066789e3750f791ULL,
           0x009c16c5c5253575ULL, 0x00d18e3b9b374169ULL, 0x0105f1ca820511c3ULL,
           0x013b6e3d22865634ULL, 0x017124e63593f5e1ULL, 0x01a56e1fc2f8f359ULL,
           0x01dac9a7b3b7302fULL, 0x0210be08d0527e1dULL, 0x0244ed8b04671da5ULL,
           0x027a28edc580e50eULL, 0x02b059949b708f29ULL, 0x02e46ff9c24cb2f3ULL,
           0x03198bf832dfdfb0ULL, 0x034feef63f97d79cULL, 0x0383f559e7bee6c1ULL,
           0x03b8f2b061aea072ULL, 0x03ef2f5c7a1a488eULL, 0x04237d99cc506d59ULL)
// 10^k, k = 0..19, as integers
SPRT_TABLE(uint64_t, kPow10U64, 1ULL, 10ULL, 100ULL, 1000ULL, 10000ULL, 100000ULL, 1000000ULL,
           10000000ULL, 100000000ULL, 1000000000ULL, 10000000000ULL, 100000000000ULL,
           1000000000000ULL, 10000000000000ULL, 100000000000000ULL, 1000000000000000ULL,
           10000000000000000ULL, 100000000000000000ULL, 1000000000000000000ULL,
           10000000000000000000ULL)

constexpr uint64_t kMaxHolding = 1844674407370955160ULL;  // (2^64 - 1 - 9) / 10
constexpr uint64_t kQuietNan = 0x7ff8000000000000ULL;
constexpr uint64_t kInf = 0x7ff0000000000000ULL;

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
SPRT_HD inline double pow10_pos(int32_t a) {
  a = min32(max32(a, 0), 341);
  if (a <= 56) return bits_f64(SPRT_AT(kPow10Sub1, a));
  double v = bits_f64(SPRT_AT(kPow10Hi, a >> 5)) * bits_f64(SPRT_AT(kPow10Sub1, a & 31));
  return v != v ? bits_f64(kInf) : v;
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

SPRT_HD inline FloatParse parse_float(const uint8_t* s, int32_t len, bool in_valid) {
  int32_t start;
  bool negative;
  prologue(s, len, true, &start, &negative);

  bool is_nan = word_at(s, len, start, "nan", 3);
  bool nan_exact = is_nan && len == 3;
  bool is_inf3 = word_at(s, len, start, "inf", 3);
  bool is_inf8 = is_inf3 && word_at(s, len, start + 3, "inity", 5);
  bool inf_value = (is_inf3 && start + 3 == len) || (is_inf8 && start + 8 == len);

  // mantissa: the run of digits and at most one dot from `start`
  int32_t D1 = NONE;
  int32_t M = start;
  while (M < len && (is_digit(s[M]) || (s[M] == '.' && D1 == NONE))) {
    if (s[M] == '.') D1 = M;
    ++M;
  }
  if (M > len) M = len;
  bool has_dot = D1 < M;
  int32_t nd = 0, pre_dot = 0, first_nz = -1;
  for (int32_t p = start; p < M; ++p) {
    if (!is_digit(s[p])) continue;
    if (first_nz < 0 && s[p] != '0') first_nz = nd;
    if (p < D1) ++pre_dot;
    ++nd;
  }
  if (first_nz < 0) first_nz = nd;
  int32_t stripped = min32(has_dot ? pre_dot : nd, first_nz);
  int32_t R = nd - stripped;
  bool seen_valid_digit = nd > 0 || stripped > 0;
  int32_t kept18 = min32(R, 19);
  uint64_t digits18 = 0;
  int64_t extra_d = 0;
  for (int32_t p = start, k = 0; p < M; ++p) {
    if (!is_digit(s[p])) continue;
    if (k >= stripped && k < stripped + kept18) digits18 = digits18 * 10u + (uint64_t)(s[p] - '0');
    if (k == stripped + kept18) extra_d = s[p] - '0';
    ++k;
  }
  bool take_extra = R > 19 && (uint64_t)((int64_t)kMaxHolding - extra_d) / 10u >= digits18;
  uint64_t digits = take_extra ? digits18 * 10u + (uint64_t)extra_d : digits18;
  int32_t kept = kept18 + (take_extra ? 1 : 0);
  int32_t trunc = R - kept;
  int32_t decimal_pos = max32(pre_dot - stripped, 0);
  int32_t exp_base = trunc - (has_dot ? R - decimal_pos : 0);

  // the manual exponent at M: at most 4 digits
  bool has_e = M < len && lower(s[M]) == 'e';
  bool e_sign = has_e && M + 1 < len && (s[M + 1] == '+' || s[M + 1] == '-');
  bool e_neg = e_sign && s[M + 1] == '-';
  int32_t eds = M + 1 + (e_sign ? 1 : 0);
  int32_t ede = eds;
  while (ede < eds + 4 && ede < len && is_digit(s[ede])) ++ede;
  ede = min32(ede, len);
  int32_t e_ndig = max32(ede - eds, 0);
  int64_t e_val = 0;
  for (int32_t p = eds; p < ede; ++p) e_val = e_val * 10 + (s[p] - '0');
  int64_t manual_exp = has_e ? (e_neg ? -e_val : e_val) : 0;
  bool bad_exp = has_e && e_ndig == 0;

  // trailing: one f/d suffix after a nonzero value, then whitespace only
  int32_t T0 = has_e ? ede : M;
  bool zero_digits = digits == 0;
  bool fd = T0 < len && (lower(s[T0]) == 'f' || lower(s[T0]) == 'd') && !zero_digits;
  int32_t T1 = T0 + (fd ? 1 : 0);
  bool trailing_junk = false;
  for (int32_t p = max32(T1, 0); p < len; ++p) {
    if (!is_ws(s[p])) {
      trailing_junk = true;
      break;
    }
  }

  FloatParse out;
  bool number_path = !is_nan && !is_inf3;
  bool bad = (number_path && !seen_valid_digit) || (number_path && (bad_exp || trailing_junk));
  out.valid = in_valid && len > 0 && !bad;
  out.except = in_valid && bad;
  if (is_nan) {
    out.valid = in_valid && nan_exact;
    out.except = in_valid && !nan_exact;
  }
  if (is_inf3) {
    out.valid = in_valid && inf_value;
    out.except = false;
  }

  // the value, in float64 (each operation rounded on its own)
  int32_t exp_ten = (int32_t)(exp_base + manual_exp);
  double digitsf = u64_to_f64(digits);
  double signf = negative ? -1.0 : 1.0;
  int32_t nd10 = 0;
  for (int i = 0; i < 19; ++i) nd10 += digits >= SPRT_AT(kPow10U64, i) ? 1 : 0;
  int32_t shift = -307 - exp_ten;
  double value;
  if (shift > 0) {
    double num = digitsf / bits_f64(SPRT_AT(kPow10Sub1, min32(max32(nd10 - 1 + shift, 0), 56)));
    int32_t k = nd10 - 1;
    double scale = (k >= 0 && k < 20) ? bits_f64(SPRT_AT(kPow10SubNeg, k)) : 0.0;
    value = shift > 36 ? 0.0 : num * scale;
  } else {
    int32_t a = exp_ten < 0 ? -exp_ten : exp_ten;
    double p = pow10_pos(a);
    value = exp_ten < 0 ? digitsf / p : digitsf * p;
  }
  if (value != value) value = bits_f64(kInf);
  if (exp_ten > 308) value = bits_f64(kInf);
  if (zero_digits) value = 0.0;
  value = signf * value;
  if (inf_value) value = signf * bits_f64(kInf);
  if (is_nan && nan_exact) value = bits_f64(kQuietNan);
  out.value = out.valid ? value : 0.0;
  return out;
}

// ---------------------------------------------------------------------------
// DECIMAL128 arithmetic in 256-bit two's complement, four 64-bit limbs
// least significant first (the port's utils/int256.py, the reference's
// chunked256).

struct U256 {
  uint64_t l[4];
};

// 10^(19q), q = 0..4
SPRT_TABLE(uint64_t, kPow10Step19, 0x0000000000000001ULL, 0x0000000000000000ULL,
           0x0000000000000000ULL, 0x0000000000000000ULL, 0x8ac7230489e80000ULL,
           0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x098a224000000000ULL, 0x4b3b4ca85a86c47aULL, 0x0000000000000000ULL,
           0x0000000000000000ULL, 0x4a00000000000000ULL, 0xebfdcb54864ada83ULL,
           0x28c87cb5c89a2571ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
           0x7775a5f171951000ULL, 0x0764b4abe8652979ULL, 0x161bcca7119915b5ULL)

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

SPRT_HD inline U256 from_i128(int64_t lo, int64_t hi) {
  uint64_t ext = (uint64_t)(hi >> 63);
  U256 r = {{(uint64_t)lo, (uint64_t)hi, ext, ext}};
  return r;
}

SPRT_HD inline bool is_neg(const U256& a) { return (int64_t)a.l[3] < 0; }

SPRT_HD inline U256 add(const U256& a, const U256& b) {
  U256 r;
  uint64_t carry = 0;
  for (int i = 0; i < 4; ++i) {
    uint64_t s = a.l[i] + b.l[i];
    uint64_t c1 = s < a.l[i];
    uint64_t s2 = s + carry;
    uint64_t c2 = s2 < s;
    r.l[i] = s2;
    carry = c1 | c2;
  }
  return r;
}

SPRT_HD inline U256 neg(const U256& a) {
  U256 r = {{~a.l[0], ~a.l[1], ~a.l[2], ~a.l[3]}};
  U256 one = {{1, 0, 0, 0}};
  return add(r, one);
}

SPRT_HD inline U256 abs256(const U256& a) { return is_neg(a) ? neg(a) : a; }

SPRT_HD inline bool lt_unsigned(const U256& a, const U256& b) {
  for (int i = 3; i >= 0; --i) {
    if (a.l[i] != b.l[i]) return a.l[i] < b.l[i];
  }
  return false;
}

// a * b mod 2^256
SPRT_HD inline U256 mul(const U256& a, const U256& b) {
  uint64_t r[4] = {0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    uint64_t carry = 0;
    for (int j = 0; i + j < 4; ++j) {
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
  for (int i = 0; i < 4; ++i) {
    uint64_t lo, hi;
    mul64(a.l[i], b, &lo, &hi);
    uint64_t s = lo + carry;
    r.l[i] = s;
    carry = hi + (s < lo);
  }
  return r;
}

// 10^e for e in [0, 77]: 10^(19q) * 10^r
SPRT_HD inline U256 pow10_256(int32_t e) {
  int32_t q = e / 19, r = e % 19;
  U256 base = {{SPRT_AT(kPow10Step19, 4 * q), SPRT_AT(kPow10Step19, 4 * q + 1),
                SPRT_AT(kPow10Step19, 4 * q + 2), SPRT_AT(kPow10Step19, 4 * q + 3)}};
  return mul_u64(base, SPRT_AT(kPow10U64, r));
}

// a * 10^e mod 2^256, e in [0, 77]
SPRT_HD inline U256 scale_up(const U256& a, int32_t e) { return e == 0 ? a : mul(a, pow10_256(e)); }

// |a| >= 10^38: Spark's DECIMAL128 overflow
SPRT_HD inline bool gt_decimal38(const U256& a) {
  return !lt_unsigned(abs256(a), pow10_256(38));
}

// decimal digits of |a| (int256.py precision10): the count of i in
// [0, 76] with 10^i < |a|, -1 past 10^76
SPRT_HD inline int32_t precision10(const U256& a) {
  U256 mag = abs256(a);
  U256 p = {{1, 0, 0, 0}};
  int32_t i = 0;
  while (i < 77 && lt_unsigned(p, mag)) {
    p = mul_u64(p, 10);
    ++i;
  }
  return i >= 77 ? -1 : i;
}

// unsigned floor division of a 256-bit n by a nonzero 128-bit d (below
// 2^127): restoring division from n's highest set bit
SPRT_HD inline void divmod_u128(const U256& n, uint64_t d_lo, uint64_t d_hi, U256* q,
                                uint64_t* r_lo, uint64_t* r_hi) {
  U256 qq = {{0, 0, 0, 0}};
  uint64_t rl = 0, rh = 0;
  int top = 255;
  while (top >= 0 && ((n.l[top >> 6] >> (top & 63)) & 1) == 0) --top;
  for (int bit = top; bit >= 0; --bit) {
    uint64_t in = (n.l[bit >> 6] >> (bit & 63)) & 1;
    rh = (rh << 1) | (rl >> 63);
    rl = (rl << 1) | in;
    bool ge = rh > d_hi || (rh == d_hi && rl >= d_lo);
    if (ge) {
      uint64_t borrow = rl < d_lo;
      rl -= d_lo;
      rh = rh - d_hi - borrow;
      qq.l[bit >> 6] |= 1ull << (bit & 63);
    }
  }
  *q = qq;
  *r_lo = rl;
  *r_hi = rh;
}

// n / d rounded HALF_UP away from zero, d a positive power of ten below
// 2^127 (int256.py divide_and_round / divide_and_round_pow10)
SPRT_HD inline U256 divide_and_round(const U256& n, const U256& d) {
  bool n_neg = is_neg(n);
  U256 mag = n_neg ? neg(n) : n;
  U256 q;
  uint64_t r_lo, r_hi;
  divmod_u128(mag, d.l[0], d.l[1], &q, &r_lo, &r_hi);
  bool top = (int64_t)r_hi < 0;
  uint64_t dbl_lo = r_lo << 1, dbl_hi = (r_hi << 1) | (r_lo >> 63);
  bool inc = top || dbl_hi > d.l[1] || (dbl_hi == d.l[1] && dbl_lo >= d.l[0]);
  if (inc) {
    U256 one = {{1, 0, 0, 0}};
    q = add(q, one);
  }
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

// add / subtract with scales given at run time: JAX ops/decimal.py
// _add_sub_scales_any; port ops/decimal.py:149 _add_sub_scales_any.
// The caller keeps max(a_scale, b_scale) - target_scale <= 38.
SPRT_HD inline DecResult add_sub(int64_t a_lo, int64_t a_hi, int64_t b_lo, int64_t b_hi,
                                 int32_t a_scale, int32_t b_scale, int32_t target_scale,
                                 bool is_sub) {
  int32_t inter = max32(a_scale, b_scale);
  U256 a = scale_up(from_i128(a_lo, a_hi), min32(max32(inter - a_scale, 0), 77));
  U256 b = scale_up(from_i128(b_lo, b_hi), min32(max32(inter - b_scale, 0), 77));
  if (is_sub) b = neg(b);
  U256 s = add(a, b);
  int32_t delta = inter - target_scale;
  U256 result = s;
  if (delta > 0) {
    result = divide_and_round(s, pow10_256(min32(delta, 38)));
  } else if (delta < 0) {
    result = scale_up(s, min32(-delta, 77));
  }
  return dec_out(result, gt_decimal38(result));
}

// multiply with Spark's SPARK-40129 double rounding: JAX ops/decimal.py
// _multiply_scales_any; port ops/decimal.py:111 _multiply_scales_any.
// The caller keeps a_scale + b_scale - product_scale <= 38.
SPRT_HD inline DecResult multiply(int64_t a_lo, int64_t a_hi, int64_t b_lo, int64_t b_hi,
                                  int32_t a_scale, int32_t b_scale, int32_t product_scale) {
  U256 product = mul(from_i128(a_lo, a_hi), from_i128(b_lo, b_hi));
  int32_t first_div = max32(precision10(product) - 38, 0);
  if (first_div > 0) product = divide_and_round(product, pow10_256(first_div));
  int32_t exponent = (a_scale + b_scale - product_scale) - first_div;
  bool pre_overflow = exponent < 0 && (precision10(product) - exponent) > 38;
  U256 result;
  if (exponent < 0) {
    result = scale_up(product, min32(-exponent, 77));
  } else if (exponent > 0) {
    result = divide_and_round(product, pow10_256(min32(exponent, 38)));
  } else {
    result = product;
  }
  bool overflow = pre_overflow || gt_decimal38(result);
  if (pre_overflow) {
    U256 zero = {{0, 0, 0, 0}};
    result = zero;
  }
  return dec_out(result, overflow);
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
