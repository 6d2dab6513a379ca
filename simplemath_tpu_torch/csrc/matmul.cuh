// What the two matmul sources (matmul.cu: the CUDA-core kernel for f32,
// mixed and integer operands; matmul_wgmma.cu: the tensor-core kernel for
// bf16 @ bf16) share: the parameter block of one product and the epilogue
// of one output element.  One copy, so both give an epilogue's values bit
// for bit alike from the same accumulator.
#pragma once

#include "program.cuh"

// One matrix operand: its first element and its signed element strides
// over (batch, row, column) of the product it enters: A is (b, m, k), B is
// (b, k, n).  ``inner_fast`` says the operand is staged with its
// contraction dimension as the fast one (the CUDA-core kernel: neighbouring
// threads walk k; the tensor-core kernel: the K-major shared-memory layout,
// else the MN-major one).  ``vec16`` (tensor-core kernel only) says the
// fast dimension has stride 1, every other stride is a multiple of 8
// elements and the base is 16-byte aligned, so a tile is copied 16 bytes at
// a time; otherwise it is read element by element through the strides.
struct MmOperand {
  const void* ptr;
  int64_t strides[3];
  int32_t dtype;
  int32_t inner_fast;
  int32_t vec16;
  int32_t pad;
};

// ``p`` is the epilogue over shape (B, M, N): operand 0 is the accumulator
// (never loaded), operands 1.. are the extras with their strides over
// (b, m, n); p.out_dtype is the type of the program's result.  Without an
// epilogue the accumulator itself is stored.  ``out_dtype`` is the stored
// type: the result's own, or SM_BF16 for an f32 result.
struct MmParams {
  SmParams p;
  MmOperand a, b;
  int64_t B, M, N, K;
  int32_t int_acc;
  int32_t epilogue;
  int32_t out_dtype;
  int32_t pad;
};

// The epilogue's value at output element (bz, m, n) whose accumulator is
// ``acc``; ``r`` is the interpreter's register file with the constants
// already loaded (sm_load_consts).
__device__ __forceinline__ uint32_t mm_epilogue_at(const SmParams& p, uint32_t* r, int64_t bz,
                                                   int64_t m, int64_t n, uint32_t acc) {
  r[0] = acc;
  for (int o = 1; o < p.n_ops; ++o) {
    const SmOperand& x = p.ops[o];
    r[o] = sm_load(x.ptr, bz * x.strides[0] + m * x.strides[1] + n * x.strides[2], x.dtype);
  }
  return sm_run(p, r);
}

// One instruction on four elements behind one dispatch.  Inside a case the
// opcode is a constant, so sm_exec's own switch folds to that opcode's
// body: the values are sm_exec's, bit for bit, and an opcode missing from
// the list is still right (the default dispatches per element).
#define MM_CASE4(OP)                                                                       \
  case OP:                                                                                 \
    return make_uint4(sm_exec(OP, a.x, b.x, c.x), sm_exec(OP, a.y, b.y, c.y),              \
                      sm_exec(OP, a.z, b.z, c.z), sm_exec(OP, a.w, b.w, c.w));
__device__ __forceinline__ uint4 mm_exec4(uint8_t op, uint4 a, uint4 b, uint4 c) {
  switch (op) {
    MM_CASE4(ADD_F) MM_CASE4(SUB_F) MM_CASE4(MUL_F) MM_CASE4(DIV_F) MM_CASE4(MAX_F)
    MM_CASE4(MIN_F) MM_CASE4(NEG_F) MM_CASE4(ABS_F) MM_CASE4(SQRT_F) MM_CASE4(SQUARE_F)
    MM_CASE4(SIGN_F) MM_CASE4(EXP_F) MM_CASE4(LOG_F) MM_CASE4(EXP2_F) MM_CASE4(LOG2_F)
    MM_CASE4(TANH_F) MM_CASE4(SIN_F) MM_CASE4(COS_F) MM_CASE4(TAN_F) MM_CASE4(POW_F)
    MM_CASE4(ADD_I) MM_CASE4(SUB_I) MM_CASE4(MUL_I) MM_CASE4(MAX_I) MM_CASE4(MIN_I)
    MM_CASE4(NEG_I) MM_CASE4(ABS_I) MM_CASE4(SQUARE_I) MM_CASE4(SIGN_I) MM_CASE4(IPOW_I)
    MM_CASE4(EQ_F) MM_CASE4(NE_F) MM_CASE4(LT_F) MM_CASE4(LE_F) MM_CASE4(GT_F) MM_CASE4(GE_F)
    MM_CASE4(EQ_I) MM_CASE4(NE_I) MM_CASE4(LT_I) MM_CASE4(LE_I) MM_CASE4(GT_I) MM_CASE4(GE_I)
    MM_CASE4(SELECT) MM_CASE4(I2F) MM_CASE4(F2I) MM_CASE4(B2F) MM_CASE4(B2I) MM_CASE4(F2B)
    MM_CASE4(I2B)
  }
  return make_uint4(sm_exec(op, a.x, b.x, c.x), sm_exec(op, a.y, b.y, c.y),
                    sm_exec(op, a.z, b.z, c.z), sm_exec(op, a.w, b.w, c.w));
}
#undef MM_CASE4

// The epilogue's values at four adjacent columns (m, n .. n + 3) at once,
// of which the first ``count`` exist: each register holds the four
// elements' values, so one fetch and one dispatch of an instruction serve
// four elements.  ``r`` has the constants loaded by mm_load_consts4; a
// column that does not exist computes on zeros and its result is dropped
// by the caller.
__device__ __forceinline__ void mm_load_consts4(const SmParams& p, uint4* r) {
  for (int j = 0; j < p.n_consts; ++j) {
    const uint32_t c = p.consts[j];
    r[p.n_ops + j] = make_uint4(c, c, c, c);
  }
}

__device__ __forceinline__ uint4 mm_epilogue4_at(const SmParams& p, uint4* r, int64_t bz, int64_t m,
                                                 int64_t n, uint4 acc, int count) {
  r[0] = acc;
  for (int o = 1; o < p.n_ops; ++o) {
    const SmOperand& x = p.ops[o];
    const int64_t step = x.strides[2];
    const int64_t at = bz * x.strides[0] + m * x.strides[1] + n * step;
    uint4 v;
    v.x = sm_load(x.ptr, at, x.dtype);
    v.y = count > 1 ? sm_load(x.ptr, at + step, x.dtype) : 0u;
    v.z = count > 2 ? sm_load(x.ptr, at + 2 * step, x.dtype) : 0u;
    v.w = count > 3 ? sm_load(x.ptr, at + 3 * step, x.dtype) : 0u;
    r[o] = v;
  }
  for (int it = 0; it < p.iterations; ++it) {
    for (int k = 0; k < p.n_insts; ++k) {
      const SmInst in = p.insts[k];
      const uint4 a = r[in.a], b = r[in.b], c = r[in.c];
      r[in.dst] = mm_exec4(in.op, a, b, c);
    }
    if (p.carry >= 0) r[p.carry] = r[p.result];
  }
  return r[p.result];
}
