// Tile functions of the kernels: the opcode table, the SSA instruction,
// the crafted f32 transcendentals and the opcode interpreter.  The program
// and operand descriptors and the per-element helpers that both kernels
// share are in program.cuh.
//
// Transcribed from the JAX package's tile functions, which Mosaic lowered
// into its Pallas kernels:
//   simplemath_tpu/ops/registry.py        (the registry arithmetic)
//   simplemath_tpu/ops/transcendental.py  (_ldexp_f32, exp_f32, log_f32,
//                                          exp2_f32, log2_f32, pow_f32,
//                                          tanh_f32, ipow_tile)
// The plain PyTorch versions are simplemath_tpu_torch/ops/transcendental.py
// and the interpreter in ops/program.py; a change here changes both sides of
// the kernel-vs-plain comparison, so keep them in step.
//
// Numerics: built without --use_fast_math (which implies flush-to-zero; the
// crafted exp/log handle subnormals on purpose) and with --fmad=false, so
// every float operation rounds once, as torch's own elementwise ops do.
// jnp.round rounds half to even: rintf, never roundf.  int32 arithmetic
// wraps as XLA's does: it is done on uint32_t, since signed overflow is
// undefined in C++.
#pragma once

#if defined(__CUDACC_RTC__)
// Compiled at run time by NVRTC (ops/codegen.py), which reads no system
// header: the fixed-width types the kernels use, as <cstdint> has them.
typedef signed char int8_t;
typedef unsigned char uint8_t;
typedef short int16_t;
typedef unsigned short uint16_t;
typedef int int32_t;
typedef unsigned int uint32_t;
typedef long long int64_t;
typedef unsigned long long uint64_t;
#else
#include <cstdint>
#include <cuda_runtime.h>
#endif

#define SM_MAX_RANK 8
#define SM_MAX_OPERANDS 16
#define SM_MAX_CONSTS 32
#define SM_MAX_INSTS 128
#define SM_MAX_REGS (SM_MAX_OPERANDS + SM_MAX_CONSTS + SM_MAX_INSTS)

// Register / operand element types.  Registers hold 32 bits: SM_F32 (a
// bf16 value too, widened), SM_I32 (a uint32 value too: the same bits), or
// SM_BOOL.  The narrow types exist in memory only: a load widens them
// (bf16 and f16 to f32, exactly; int8 and uint8 to i32), and an f32 result
// rounds to bf16 (nearest even) at the store.  An instruction whose result
// is bf16 rounds it to bf16 in the register too (SmInst::rnd), so a fused
// bf16 chain rounds where torch's and jnp's ops round, op by op.  SM_I64
// (int64 or uint64: the same bits mod 2^64) is an operand and result type
// of the 64-bit matmul kernel (matmul_wgmma_i64.cu) alone; no register
// holds it.  SM_U32 differs from SM_I32 only where a value is converted (to
// f32 by the reductions); SM_F16 is read by the reductions alone.
enum SmDtype : int32_t {
  SM_F32 = 0, SM_I32 = 1, SM_BOOL = 2, SM_BF16 = 3, SM_I8 = 4, SM_U8 = 5, SM_I64 = 6,
  SM_U32 = 7, SM_F16 = 8,
};

// Opcodes: the same names in the same order as OPCODES in ops/program.py.
enum SmOpcode : uint8_t {
  ADD_F, SUB_F, MUL_F, DIV_F, MAX_F, MIN_F,
  NEG_F, ABS_F, SQRT_F, SQUARE_F, SIGN_F,
  EXP_F, LOG_F, EXP2_F, LOG2_F, TANH_F, SIN_F, COS_F, TAN_F,
  POW_F,
  ADD_I, SUB_I, MUL_I, MAX_I, MIN_I, NEG_I, ABS_I, SQUARE_I,
  SIGN_I, IPOW_I,
  EQ_F, NE_F, LT_F, LE_F, GT_F, GE_F,
  EQ_I, NE_I, LT_I, LE_I, GT_I, GE_I,
  SELECT,
  I2F, F2I, B2F, B2I, F2B, I2B,
  LT_U, LE_U, GT_U, GE_U, MAX_U, MIN_U, SIGN_U,
  U2F, F2U, BITS,
  FDIV_I, MOD_I, FDIV_U, MOD_U,
};

// One SSA instruction: r[dst] = op(r[a], r[b], r[c]), rounded to bf16
// where ``rnd`` is set (its result is a bf16 value).
struct SmInst {
  uint8_t op, dst, a, b, c, rnd, pad1, pad2;
};

// ------------------------------------------------------------- helpers
__device__ __forceinline__ float sm_f(uint32_t u) { return __uint_as_float(u); }
__device__ __forceinline__ uint32_t sm_u(float f) { return __float_as_uint(f); }

#define SM_INF __int_as_float(0x7f800000)
#define SM_NAN __int_as_float(0x7fc00000)

__device__ __forceinline__ float sm_sign_f(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

// NaN-propagating max/min, as torch.maximum and jnp.maximum.
__device__ __forceinline__ float sm_max_f(float a, float b) {
  return (a != a || b != b) ? SM_NAN : (a > b ? a : b);
}
__device__ __forceinline__ float sm_min_f(float a, float b) {
  return (a != a || b != b) ? SM_NAN : (a < b ? a : b);
}

// f32 bits rounded to the nearest bf16 (ties to even), kept as f32 bits:
// a register's value after an instruction whose result is bf16.  A NaN
// becomes the quiet NaN torch's bf16 conversion gives (0x7fc0).
__device__ __forceinline__ uint32_t sm_bf16r(uint32_t u) {
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc00000u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
}

// Integer floor division and remainder with the values of the plain rules
// (ops/registry.py: jnp.floor_divide's and jnp.remainder's): x // 0 is -1
// for x == 0 and -2 otherwise (all ones unsigned), x % 0 is 0, INT_MIN //
// -1 wraps to INT_MIN and x % -1 is 0.
__device__ __forceinline__ uint32_t sm_fdiv_i(int32_t x, int32_t y) {
  if (y == 0) return x == 0 ? 0xffffffffu : 0xfffffffeu;
  if (y == -1) return 0u - (uint32_t)x;
  const int32_t q = x / y, r = x - q * y;
  return (uint32_t)((r != 0 && ((r < 0) != (y < 0))) ? q - 1 : q);
}
__device__ __forceinline__ uint32_t sm_mod_i(int32_t x, int32_t y) {
  if (y == 0 || y == -1) return 0u;
  const int32_t r = x % y;
  return (uint32_t)((r != 0 && ((r < 0) != (y < 0))) ? r + y : r);
}

// float -> int32 for integral-valued floats; saturating, NaN -> 0.  Lanes
// where the value is out of range are masked by the callers.
__device__ __forceinline__ int sm_f2i(float x) { return __float2int_rz(x); }

// ------------------------------------------------- crafted transcendentals
// f32 constants: the same decimal literals as transcendental.py, rounded
// to f32 once.
#define SM_LN2_HI 6.93145752e-01f
#define SM_LN2_LO 1.42860677e-06f
#define SM_LOG2E 1.44269504088896341f
#define SM_LN2 0.6931471805599453f
#define SM_INV_LN2 1.4426950408889634f
#define SM_SQRT2 1.4142135623730951f

__device__ __forceinline__ float sm_poly_exp(float x) {
  float acc = (float)(1.0 / 5040.0);
  acc = acc * x + (float)(1.0 / 720.0);
  acc = acc * x + (float)(1.0 / 120.0);
  acc = acc * x + (float)(1.0 / 24.0);
  acc = acc * x + (float)(1.0 / 6.0);
  acc = acc * x + 0.5f;
  acc = acc * x + 1.0f;
  acc = acc * x + 1.0f;
  return acc;
}

__device__ __forceinline__ float sm_poly_log(float x) {
  float acc = 0.14249323f;
  acc = acc * x + 0.15406281f;
  acc = acc * x + 0.18183572f;
  acc = acc * x + 0.22222198f;
  acc = acc * x + 0.28571429f;
  acc = acc * x + 0.40000001f;
  acc = acc * x + 0.66666667f;
  return acc;
}

__device__ __forceinline__ float sm_poly_tanh(float x) {
  float acc = (float)(21844.0 / 6081075.0);
  acc = acc * x + (float)(-1382.0 / 155925.0);
  acc = acc * x + (float)(62.0 / 2835.0);
  acc = acc * x + (float)(-17.0 / 315.0);
  acc = acc * x + (float)(2.0 / 15.0);
  acc = acc * x + (float)(-1.0 / 3.0);
  acc = acc * x + 1.0f;
  return acc;
}

// x * 2^k via a two-step exponent bitcast (subnormal results round right).
__device__ __forceinline__ float sm_ldexp(float x, int k) {
  k = max(-252, min(k, 252));
  int k1 = k >> 1;  // floor(k / 2)
  int k2 = k - k1;
  float s1 = sm_f((uint32_t)(k1 + 127) << 23);
  float s2 = sm_f((uint32_t)(k2 + 127) << 23);
  return (x * s1) * s2;
}

static __device__ float sm_exp(float x) {
  float kf = rintf(x * SM_LOG2E);
  int k = max(-1000, min(sm_f2i(kf), 1000));
  float r = (x - kf * SM_LN2_HI) - kf * SM_LN2_LO;
  float p = sm_poly_exp(r);
  float out = sm_ldexp(p, k);
  // Subnormal results: value = round(p * 2^(k+149)) * 2^-149, built as bits.
  int k149 = max(0, min(k + 149, 254));
  float scale_sub = sm_f((uint32_t)(k149 + 127) << 23);
  float out_sub = sm_f((uint32_t)__float2int_rn(p * scale_sub));
  if (k < -126) out = out_sub;
  if (x > 88.8f) out = SM_INF;
  if (x < -104.0f) out = 0.0f;
  return x != x ? x : out;
}

// x (finite, > 0) -> (e, m), x = 2^e * m, m in [sqrt(2)/2, sqrt(2)).
__device__ __forceinline__ float sm_decompose(float x, int* e_out) {
  uint32_t bits0 = sm_u(x);
  int exp_field = (bits0 >> 23) & 0xFF;
  uint32_t mant_field = bits0 & 0x007FFFFFu;
  bool is_sub = exp_field == 0 && mant_field != 0;
  float xs = is_sub ? (float)mant_field : x;
  int bias = is_sub ? 149 : 0;
  uint32_t bits = sm_u(xs);
  int e = (int)((bits >> 23) & 0xFF) - 127 - bias;
  float m = sm_f((bits & 0x007FFFFFu) | 0x3F800000u);
  if (m >= SM_SQRT2) {
    m = m * 0.5f;
    e += 1;
  }
  *e_out = e;
  return m;
}

__device__ __forceinline__ float sm_log_mantissa(float m) {
  float f = m - 1.0f;
  float s = f / (2.0f + f);
  float z = s * s;
  float t = z * sm_poly_log(z);
  float hfsq = 0.5f * f * f;
  return f - (hfsq - s * (hfsq + t));
}

__device__ __forceinline__ float sm_finish_log(float x, float res) {
  uint32_t bits = sm_u(x);
  bool is_zero = (bits & 0x7FFFFFFFu) == 0;
  bool is_pos = (int32_t)bits >= 0 && !is_zero;
  res = is_zero ? -SM_INF : (is_pos ? res : SM_NAN);
  if (x == SM_INF) res = x;
  return x != x ? x : res;
}

__device__ __forceinline__ bool sm_is_pos(float x) {
  uint32_t bits = sm_u(x);
  return (int32_t)bits >= 0 && (bits & 0x7FFFFFFFu) != 0;
}

static __device__ float sm_log(float x) {
  int e;
  float m = sm_decompose(sm_is_pos(x) ? x : 1.0f, &e);
  float ef = (float)e;
  float res = ef * SM_LN2_HI + (sm_log_mantissa(m) + ef * SM_LN2_LO);
  return sm_finish_log(x, res);
}

// 2^(t_int + t_frac), t_int integral, |t_frac| <= ~0.5.
__device__ __forceinline__ float sm_exp2_parts(float t_int, float t_frac) {
  float kf = rintf(t_frac);
  float r = (t_frac - kf) * SM_LN2;
  float p = sm_poly_exp(r);
  int k = sm_f2i(t_int + kf);
  float t = t_int + t_frac;
  float out = sm_ldexp(p, k);
  if (t > 128.5f) out = SM_INF;
  if (t < -150.5f) out = 0.0f;
  return out;
}

static __device__ float sm_exp2(float x) {
  float kf = rintf(x);
  float out = sm_exp2_parts(kf, x - kf);
  return x != x ? x : out;
}

static __device__ float sm_log2(float x) {
  int e;
  float m = sm_decompose(sm_is_pos(x) ? x : 1.0f, &e);
  float res = (float)e + sm_log_mantissa(m) * SM_INV_LN2;
  return sm_finish_log(x, res);
}

static __device__ float sm_pow(float x, float y) {
  float ax = fabsf(x);
  int e;
  float m = sm_decompose(ax > 0.f ? ax : 1.0f, &e);
  float ef = (float)e;
  float frac = sm_log_mantissa(m) * SM_INV_LN2;
  float t1 = y * ef;
  float t2 = y * frac;
  float t1_int = rintf(t1);
  t2 = t2 + (t1 - t1_int);
  float r = sm_exp2_parts(t1_int, t2);
  if (fabsf(y) == SM_INF) r = ax == 1.f ? 1.f : (((ax > 1.f) == (y > 0.f)) ? SM_INF : 0.f);

  float y_int = rintf(y);
  bool y_is_int = y == y_int;
  bool y_is_odd = y_is_int && fabsf(fmodf(y_int, 2.0f)) == 1.0f;
  bool neg = x < 0.f;
  float out = (neg && y_is_odd ? -1.0f : 1.0f) * r;
  if (neg && !y_is_int) out = SM_NAN;
  if (x == 0.f)
    out = y > 0.f ? (y_is_odd ? sm_sign_f(x) * 0.0f : 0.0f) : (y < 0.f ? SM_INF : 1.0f);
  if (ax == SM_INF)
    out = y > 0.f ? ((neg && y_is_odd) ? -SM_INF : SM_INF) : (y < 0.f ? 0.0f : 1.0f);
  if (y == 0.f) out = 1.0f;
  if (x == 1.0f) out = 1.0f;
  if (x != x && y != 0.f) out = x;
  if (y != y && x != 1.f) out = y;
  return out;
}

static __device__ float sm_tanh(float x) {
  float ax = fabsf(x);
  float small = x * sm_poly_tanh(x * x);
  float big = 1.0f - 2.0f / (sm_exp(2.0f * fminf(ax, 44.0f)) + 1.0f);
  float out = ax <= 0.5f ? small : sm_sign_f(x) * big;
  return x != x ? x : out;
}

// Integer pow by square-and-multiply, wrapping; negative exponents give 0
// except for bases 1 and -1.
static __device__ uint32_t sm_ipow(uint32_t base, uint32_t exponent) {
  int32_t eb = (int32_t)exponent;
  uint32_t e = eb < 0 ? 0u - exponent : exponent;
  uint32_t result = 1u, b = base;
  for (int i = 0; i < 31; ++i) {
    if (e & 1u) result *= b;
    b *= b;
    e >>= 1;
  }
  if (eb >= 0) return result;
  int32_t ib = (int32_t)base;
  if (ib == 1) return 1u;
  if (ib == -1) return (exponent & 1u) ? 0xFFFFFFFFu : 1u;
  return 0u;
}

// --------------------------------------------------------- the interpreter
__device__ __forceinline__ uint32_t sm_exec(uint8_t op, uint32_t a, uint32_t b,
                                            uint32_t c) {
  const float fa = sm_f(a), fb = sm_f(b);
  const int32_t ia = (int32_t)a, ib = (int32_t)b;
  switch (op) {
    case ADD_F: return sm_u(fa + fb);
    case SUB_F: return sm_u(fa - fb);
    case MUL_F: return sm_u(fa * fb);
    case DIV_F: return sm_u(fa / fb);
    case MAX_F: return sm_u(sm_max_f(fa, fb));
    case MIN_F: return sm_u(sm_min_f(fa, fb));
    case NEG_F: return sm_u(-fa);
    case ABS_F: return sm_u(fabsf(fa));
    case SQRT_F: return sm_u(sqrtf(fa));
    case SQUARE_F: return sm_u(fa * fa);
    case SIGN_F: return sm_u(sm_sign_f(fa));
    case EXP_F: return sm_u(sm_exp(fa));
    case LOG_F: return sm_u(sm_log(fa));
    case EXP2_F: return sm_u(sm_exp2(fa));
    case LOG2_F: return sm_u(sm_log2(fa));
    case TANH_F: return sm_u(sm_tanh(fa));
    case SIN_F: return sm_u(sinf(fa));
    case COS_F: return sm_u(cosf(fa));
    case TAN_F: return sm_u(tanf(fa));
    case POW_F: return sm_u(sm_pow(fa, fb));
    case ADD_I: return a + b;
    case SUB_I: return a - b;
    case MUL_I: return a * b;
    case MAX_I: return ia > ib ? a : b;
    case MIN_I: return ia < ib ? a : b;
    case NEG_I: return 0u - a;
    case ABS_I: return ia < 0 ? 0u - a : a;
    case SQUARE_I: return a * a;
    case SIGN_I: return ia > 0 ? 1u : (ia < 0 ? 0xFFFFFFFFu : 0u);
    case IPOW_I: return sm_ipow(a, b);
    case EQ_F: return fa == fb;
    case NE_F: return fa != fb;
    case LT_F: return fa < fb;
    case LE_F: return fa <= fb;
    case GT_F: return fa > fb;
    case GE_F: return fa >= fb;
    case EQ_I: return ia == ib;
    case NE_I: return ia != ib;
    case LT_I: return ia < ib;
    case LE_I: return ia <= ib;
    case GT_I: return ia > ib;
    case GE_I: return ia >= ib;
    case SELECT: return a ? b : c;
    case I2F: return sm_u((float)ia);
    case F2I: return (uint32_t)__float2int_rz(fa);
    case B2F: return sm_u(a ? 1.0f : 0.0f);
    case B2I: return a;
    case F2B: return fa != 0.0f;
    case I2B: return a != 0u;
    case LT_U: return a < b;
    case LE_U: return a <= b;
    case GT_U: return a > b;
    case GE_U: return a >= b;
    case MAX_U: return a > b ? a : b;
    case MIN_U: return a < b ? a : b;
    case SIGN_U: return a != 0u;
    case U2F: return sm_u((float)a);
    case F2U: return __float2uint_rz(fa);
    case BITS: return a;
    case FDIV_I: return sm_fdiv_i(ia, ib);
    case MOD_I: return sm_mod_i(ia, ib);
    case FDIV_U: return b == 0u ? 0xffffffffu : a / b;
    case MOD_U: return b == 0u ? 0u : a % b;
  }
  return 0u;
}
