// The program and operand descriptors, and the helpers that the elementwise
// kernel (elementwise.cu), the map-reduce kernel (reduction.cu) and the
// matmul kernels' epilogues (matmul.cuh) share: load the operands of one
// element, run the opcode program over them, store a result; and the same
// on four elements at a time, each register a uint4, so that an instruction
// is fetched and dispatched once for four elements.  One copy, so all of
// them evaluate an expression bit for bit alike.
#pragma once

#include "tiles.cuh"

// One operand: the address of its first element and its signed element
// strides over the expression's dims (0 = broadcast).  ``scalar`` marks a
// one-element operand on the flat path.
struct SmOperand {
  const void* ptr;
  int64_t strides[SM_MAX_RANK];
  int32_t dtype;
  int32_t scalar;
};

// Registers [0, n_ops) are the operands, [n_ops, n_ops + n_consts) the
// constants, then one per instruction.  With iterations > 1 the program
// runs that many times with register ``carry`` replaced by the result.
// ``n``, ``shape`` and ``rank`` are the expression's; ``out_dtype`` is the
// type of the program's result.
struct SmParams {
  int64_t n;
  int64_t shape[SM_MAX_RANK];
  int32_t rank, n_ops, n_consts, n_insts;
  int32_t out_dtype, result, iterations, carry;
  int32_t vec, pad;
  uint32_t consts[SM_MAX_CONSTS];
  SmInst insts[SM_MAX_INSTS];
  SmOperand ops[SM_MAX_OPERANDS];
};

// f16 bits widened to f32 bits, exactly (subnormals, infinities and NaNs
// included).
__device__ __forceinline__ uint32_t sm_h2f(uint32_t h) {
  const uint32_t sign = (h & 0x8000u) << 16, e = (h >> 10) & 0x1fu, m = h & 0x3ffu;
  if (e == 0x1fu) return sign | 0x7f800000u | (m << 13);
  if (e != 0u) return sign | ((e + 112u) << 23) | (m << 13);
  if (m == 0u) return sign;
  return sign | sm_u((float)m * 5.9604644775390625e-8f);  // m * 2^-24, exact
}

__device__ __forceinline__ uint32_t sm_load(const void* ptr, int64_t i, int32_t dtype) {
  if (dtype <= SM_I32 || dtype == SM_U32) return static_cast<const uint32_t*>(ptr)[i];
  if (dtype == SM_BOOL) return static_cast<const uint8_t*>(ptr)[i] != 0;
  if (dtype == SM_BF16) return (uint32_t)static_cast<const uint16_t*>(ptr)[i] << 16;
  if (dtype == SM_F16) return sm_h2f(static_cast<const uint16_t*>(ptr)[i]);
  if (dtype == SM_I8) return (uint32_t)(int32_t)static_cast<const int8_t*>(ptr)[i];
  return static_cast<const uint8_t*>(ptr)[i];  // SM_U8
}

// f32 bits rounded to bf16, nearest even (sm_bf16r); a NaN becomes 0x7fc0.
__device__ __forceinline__ uint16_t sm_f2bf(uint32_t u) { return (uint16_t)(sm_bf16r(u) >> 16); }

// ----------------------------------------------------- quads in memory
// A quad is four consecutive elements of an operand, evaluated on the four
// lanes of a uint4 (sm_exec4).  A 4-byte type reads a quad with one 16-byte
// load; a 2-byte type (bf16, f16) with one 8-byte load, widened in
// registers to the f32 bits sm_load gives element by element, so the lanes
// hold the same bits on either path.

__host__ __device__ __forceinline__ bool sm_narrow(int32_t dtype) {
  return dtype == SM_BF16 || dtype == SM_F16;
}

// Four 2-byte elements (element 0 in the low half of h.x) as f32 bits:
// bf16 by a shift, f16 by sm_h2f, exactly.
__device__ __forceinline__ uint4 sm_widen4(uint2 h, int32_t dtype) {
  if (dtype == SM_BF16)
    return make_uint4(h.x << 16, h.x & 0xffff0000u, h.y << 16, h.y & 0xffff0000u);
  return make_uint4(sm_h2f(h.x & 0xffffu), sm_h2f(h.x >> 16), sm_h2f(h.y & 0xffffu),
                    sm_h2f(h.y >> 16));
}

// Quad ``q`` of a 2-byte operand (8-byte aligned): one streaming 8-byte load.
__device__ __forceinline__ uint4 sm_load_quad2(const void* ptr, int64_t q, int32_t dtype) {
  return sm_widen4(__ldcs(static_cast<const uint2*>(ptr) + q), dtype);
}

// sm_bf16r on each lane: the rounding step of an instruction whose result
// is bf16.
__device__ __forceinline__ uint4 sm_bf16r4(uint4 v) {
  return make_uint4(sm_bf16r(v.x), sm_bf16r(v.y), sm_bf16r(v.z), sm_bf16r(v.w));
}

// Four f32 lanes rounded to bf16 (sm_f2bf, as sm_store rounds one) and
// packed, element 0 in the low half.
__device__ __forceinline__ uint2 sm_pack_bf16x4(uint4 v) {
  return make_uint2((uint32_t)sm_f2bf(v.x) | (uint32_t)sm_f2bf(v.y) << 16,
                    (uint32_t)sm_f2bf(v.z) | (uint32_t)sm_f2bf(v.w) << 16);
}

// Quad ``q`` of a result: four 4-byte values with one 16-byte store, or a
// bf16 quad packed into one 8-byte store.
__device__ __forceinline__ void sm_store_quad(void* out, int64_t q, int32_t dtype, uint4 v) {
  if (dtype == SM_BF16)
    static_cast<uint2*>(out)[q] = sm_pack_bf16x4(v);
  else
    static_cast<uint4*>(out)[q] = v;
}

__device__ __forceinline__ void sm_store(void* out, int64_t i, int32_t dtype, uint32_t v) {
  if (dtype == SM_BOOL)
    static_cast<uint8_t*>(out)[i] = v != 0;
  else if (dtype == SM_BF16)
    static_cast<uint16_t*>(out)[i] = sm_f2bf(v);
  else
    static_cast<uint32_t*>(out)[i] = v;
}

__device__ __forceinline__ uint32_t sm_run(const SmParams& p, uint32_t* r) {
  for (int it = 0; it < p.iterations; ++it) {
    for (int k = 0; k < p.n_insts; ++k) {
      const SmInst in = p.insts[k];
      const uint32_t v = sm_exec(in.op, r[in.a], r[in.b], r[in.c]);
      r[in.dst] = in.rnd ? sm_bf16r(v) : v;
    }
    if (p.carry >= 0) r[p.carry] = r[p.result];
  }
  return r[p.result];
}

__device__ __forceinline__ void sm_load_consts(const SmParams& p, uint32_t* r) {
  for (int j = 0; j < p.n_consts; ++j) r[p.n_ops + j] = p.consts[j];
}

// ------------------------------------------------ four elements at a time
// Every opcode of SmOpcode (tiles.cuh), in its order: the list behind each
// switch that turns a run-time opcode into a compile-time one.
#define SM_FOR_EACH_OPCODE(X)                                                           \
  X(ADD_F) X(SUB_F) X(MUL_F) X(DIV_F) X(MAX_F) X(MIN_F)                                 \
  X(NEG_F) X(ABS_F) X(SQRT_F) X(SQUARE_F) X(SIGN_F)                                     \
  X(EXP_F) X(LOG_F) X(EXP2_F) X(LOG2_F) X(TANH_F) X(SIN_F) X(COS_F) X(TAN_F)            \
  X(POW_F)                                                                              \
  X(ADD_I) X(SUB_I) X(MUL_I) X(MAX_I) X(MIN_I) X(NEG_I) X(ABS_I) X(SQUARE_I)            \
  X(SIGN_I) X(IPOW_I)                                                                   \
  X(EQ_F) X(NE_F) X(LT_F) X(LE_F) X(GT_F) X(GE_F)                                       \
  X(EQ_I) X(NE_I) X(LT_I) X(LE_I) X(GT_I) X(GE_I)                                       \
  X(SELECT)                                                                             \
  X(I2F) X(F2I) X(B2F) X(B2I) X(F2B) X(I2B)                                             \
  X(LT_U) X(LE_U) X(GT_U) X(GE_U) X(MAX_U) X(MIN_U) X(SIGN_U)                           \
  X(U2F) X(F2U) X(BITS)                                                                 \
  X(FDIV_I) X(MOD_I) X(FDIV_U) X(MOD_U)

__device__ __forceinline__ uint4 sm_splat(uint32_t v) { return make_uint4(v, v, v, v); }

// One instruction on the four elements of a register.  With a constant
// ``op`` sm_exec's switch folds to that opcode's body.
__device__ __forceinline__ uint4 sm_exec_lanes(uint8_t op, uint4 a, uint4 b, uint4 c) {
  return make_uint4(sm_exec(op, a.x, b.x, c.x), sm_exec(op, a.y, b.y, c.y),
                    sm_exec(op, a.z, b.z, c.z), sm_exec(op, a.w, b.w, c.w));
}

// One instruction on four elements behind one dispatch.  Inside a case the
// opcode is a constant, so the values are sm_exec's, bit for bit, and an
// opcode missing from the list is still right (the default dispatches per
// element).
__device__ __forceinline__ uint4 sm_exec4(uint8_t op, uint4 a, uint4 b, uint4 c) {
#define SM_CASE4(OP) \
  case OP:           \
    return sm_exec_lanes(OP, a, b, c);
  switch (op) { SM_FOR_EACH_OPCODE(SM_CASE4) }
#undef SM_CASE4
  return sm_exec_lanes(op, a, b, c);
}

// sm_load_consts and sm_run on registers of four elements.
__device__ __forceinline__ void sm_load_consts4(const SmParams& p, uint4* r) {
  for (int j = 0; j < p.n_consts; ++j) r[p.n_ops + j] = sm_splat(p.consts[j]);
}

__device__ __forceinline__ uint4 sm_run4(const SmParams& p, uint4* r) {
  for (int it = 0; it < p.iterations; ++it) {
    for (int k = 0; k < p.n_insts; ++k) {
      const SmInst in = p.insts[k];
      const uint4 a = r[in.a], b = r[in.b], c = r[in.c];
      const uint4 v = sm_exec4(in.op, a, b, c);
      r[in.dst] = in.rnd ? sm_bf16r4(v) : v;
    }
    if (p.carry >= 0) r[p.carry] = r[p.result];
  }
  return r[p.result];
}

// Operand registers of flat element ``i``: every operand is contiguous and
// full-size or a single element.
__device__ __forceinline__ void sm_load_flat(const SmParams& p, uint32_t* r, int64_t i) {
  for (int o = 0; o < p.n_ops; ++o)
    r[o] = sm_load(p.ops[o].ptr, p.ops[o].scalar ? 0 : i, p.ops[o].dtype);
}

// Operand registers of element ``i`` (row-major over p.shape), each
// operand read through its own signed strides.
__device__ __forceinline__ void sm_load_strided(const SmParams& p, uint32_t* r, int64_t i) {
  int64_t coord[SM_MAX_RANK];
  int64_t rem = i;
  for (int d = p.rank - 1; d >= 0; --d) {
    coord[d] = rem % p.shape[d];
    rem /= p.shape[d];
  }
  for (int o = 0; o < p.n_ops; ++o) {
    int64_t off = 0;
    for (int d = 0; d < p.rank; ++d) off += coord[d] * p.ops[o].strides[d];
    r[o] = sm_load(p.ops[o].ptr, off, p.ops[o].dtype);
  }
}
