// The entry point of the CUDA-core matmul kernel (matmul_fma.cuh: what it
// computes, the TPU kernels it replaces, its design): float32, mixed
// float32/bfloat16 and int32 products, and every integer product whose
// result is int64 or uint64.  The kernels whose operands are both copied 16
// bytes at a time are built here, the others in matmul_elem.cu.

#include "matmul_fma.cuh"

// The product of q->a and q->b, through the epilogue when q->epilogue, into
// the contiguous (B, M, N) ``out``.  B <= 65535 and M <= 65535 * 128.  The
// 64-bit product takes MN-major tiles read element by element alone.
extern "C" int sm_mm_launch(const MmParams* q, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q->int_acc == kI64 &&
      (q->a.inner_fast || q->b.inner_fast || q->a.vec16 || q->b.vec16 || q->epilogue))
    return (int)cudaErrorInvalidValue;
  if (!q->a.vec16 || !q->b.vec16) return mm_launch_elem(*q, out, s);
  switch (q->int_acc) {
    case kF32: return mm_launch_layouts<kF32, false>(*q, out, s);
    case kI32: return mm_launch_layouts<kI32, false>(*q, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int sm_mm_params_size() { return (int)sizeof(MmParams); }
