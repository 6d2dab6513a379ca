// What the matmul sources (matmul.cu: the CUDA-core kernel for f32, mixed
// and int32 operands; matmul_wgmma.cu and matmul_wgmma_s8.cu: the
// tensor-core kernels for bf16 @ bf16 and for int8/uint8 pairs;
// matmul_wgmma_i64.cu, which reads the parameter block alone: the 64-bit
// product on the int8 tensor cores) and the kernels generated per epilogue
// (ops/codegen.py, kind "matmul") share: the parameter block of one product
// and the epilogue of four output elements.  The kernels take the epilogue
// as a type (MmInterp here, the interpreter; MmGenerated in a generated
// source), with one interface, so that every epilogue runs in the same
// store and gives the same bits from the same accumulator.
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

// Operand ``x`` of the epilogue at four adjacent columns (m, n .. n + 3),
// of which the first ``count`` exist (the others read as zero), in the
// register type (sm_load widens ``dtype``).
__device__ __forceinline__ uint4 mm_load4(const SmOperand& x, int64_t bz, int64_t m, int64_t n,
                                          int count, int32_t dtype) {
  const int64_t step = x.strides[2];
  const int64_t at = bz * x.strides[0] + m * x.strides[1] + n * step;
  uint4 v;
  v.x = sm_load(x.ptr, at, dtype);
  v.y = count > 1 ? sm_load(x.ptr, at + step, dtype) : 0u;
  v.z = count > 2 ? sm_load(x.ptr, at + 2 * step, dtype) : 0u;
  v.w = count > 3 ? sm_load(x.ptr, at + 3 * step, dtype) : 0u;
  return v;
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
  for (int o = 1; o < p.n_ops; ++o) r[o] = mm_load4(p.ops[o], bz, m, n, count, p.ops[o].dtype);
  return sm_run4(p, r);
}

// An epilogue as the stores of the matmul kernels call it.  ``kGenerated``
// is false for the interpreter, whose kernels also store bare products
// (MmParams::epilogue 0) and store the parameter block's ``out_dtype``;
// a generated epilogue always runs and stores ``kOut``.  Constructed once
// a thread, at the block's batch ``bz``; ``columns(n, count)`` before the
// rows of a group of four columns, ``row(m)`` before each row of it, then
// ``(m, n, acc, count)``: the four values from the four accumulators.

#if !defined(__CUDACC_RTC__)  // a generated kernel brings its own epilogue
// Out of line: one copy of the interpreter for every instantiation of a
// kernel, whose store may be unrolled.
static __device__ __noinline__ uint4 mm_interp4(const SmParams& p, uint4* r, int64_t bz, int64_t m,
                                                int64_t n, uint4 acc, int count) {
  return mm_epilogue4_at(p, r, bz, m, n, acc, count);
}

// MmInterp: the interpreter, the reference (matmul.interpret).  Its
// register file (uint4 r[SM_MAX_REGS]) lives in local memory, the
// constants loaded once, and every instruction is fetched and dispatched
// at run time (sm_run4).
struct MmInterp {
  static constexpr bool kGenerated = false;
  static constexpr int32_t kOut = -1;
  const SmParams& p;
  const int64_t bz;
  uint4 r[SM_MAX_REGS];
  __device__ __forceinline__ MmInterp(const MmParams& q, int64_t bz_) : p(q.p), bz(bz_) {
    sm_load_consts4(p, r);
  }
  __device__ __forceinline__ void columns(int64_t, int) {}
  __device__ __forceinline__ void row(int64_t) {}
  __device__ __forceinline__ uint4 operator()(int64_t m, int64_t n, uint4 acc, int count) {
    return mm_interp4(p, r, bz, m, n, acc, count);
  }
};
#endif  // !__CUDACC_RTC__
