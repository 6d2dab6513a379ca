// What the matmul sources (matmul.cu: the CUDA-core kernel for f32, mixed
// and int32 operands; matmul_wgmma.cu and matmul_wgmma_s8.cu: the
// tensor-core kernels for bf16 @ bf16 and for int8/uint8 pairs;
// matmul_wgmma_i64.cu, which reads the parameter block alone: the 64-bit
// product on the int8 tensor cores) share: the parameter block of one
// product and the epilogue of one output element, or of four.  One copy, so all give an epilogue's values bit for bit alike
// from the same accumulator.
#pragma once

#include "program.cuh"

// One matrix operand: its first element and its signed element strides
// over (batch, row, column) of the product it enters: A is (b, m, k), B is
// (b, k, n).  ``inner_fast`` says the operand is staged with its
// contraction dimension as the fast one (the CUDA-core and bf16 kernels:
// the K-major shared-memory layout, else the MN-major one; the int8 kernel:
// copied as it is, else transposed on the way in).  ``vec16`` says the fast
// dimension has stride 1, every other stride is a multiple of 16 bytes and
// the base is 16-byte aligned, so a tile is read 16 bytes at a time;
// otherwise it is read element by element through the strides.
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

// The epilogue's values at four adjacent columns (m, n .. n + 3) at once,
// of which the first ``count`` exist: each register holds the four
// elements' values, so one fetch and one dispatch of an instruction serve
// four elements.  ``r`` has the constants loaded by sm_load_consts4; a
// column that does not exist computes on zeros and its result is dropped
// by the caller.
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
  return sm_run4(p, r);
}
