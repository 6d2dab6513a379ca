// The CUDA-core matmul kernels with an operand read element by element
// (ELEM, matmul_fma.cuh): a view, the narrow operand of a mixed pair.  Apart
// from matmul.cu's copy-only kernels because nvcc takes about as long for
// each half, and builds them side by side.

#include "matmul_fma.cuh"

int mm_launch_elem(const MmParams& q, void* out, cudaStream_t s) {
  switch (q.int_acc) {
    case kF32: return mm_launch_layouts<kF32, true>(q, out, s);
    case kI32: return mm_launch_layouts<kI32, true>(q, out, s);
  }
  return (int)cudaErrorInvalidValue;
}
