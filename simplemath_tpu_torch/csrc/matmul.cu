// The entry point of the CUDA-core matmul kernel (matmul_fma.cuh: what it
// computes, the TPU kernels it replaces, its design): float32, mixed
// float32/bfloat16 and int32 products.  The kernels whose operands are both
// copied 16 bytes at a time are built here, the others in matmul_elem.cu;
// and the launcher of the kernels generated per epilogue, of every variant.

#include "matmul_fma.cuh"

// The product of q->a and q->b, through the epilogue when q->epilogue, into
// the contiguous (B, M, N) ``out``.  B <= 65535 and M <= 65535 * 128.
extern "C" int sm_mm_launch(const MmParams* q, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q->int_acc != kF32 && q->int_acc != kI32) return (int)cudaErrorInvalidValue;
  if (!q->a.vec16 || !q->b.vec16) return mm_launch_elem(*q, out, s);
  switch (q->int_acc) {
    case kF32: return mm_launch_layouts<kF32, false>(*q, out, s);
    case kI32: return mm_launch_layouts<kI32, false>(*q, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

// A kernel generated for an epilogue (ops/codegen.py, kind "matmul", over
// matmul_wgmma.cuh, matmul_wgmma_s8.cuh or matmul_fma.cuh; nvrtc.cu loads
// it), launched as the compiled kernel of its variant is: the tensor-core
// kernels' 128 x 256 tiles and ring (``tensor_core``), or the CUDA-core
// kernel's 128 x 128 tiles and ring.
extern "C" int sm_mm_launch_kernel(const void* kernel, const MmParams* q, void* out, int tensor_core,
                                   void* stream) {
  const int bn = tensor_core ? sm_wgmma::kBN : kBN;
  const int smem = tensor_core ? sm_wgmma::kSmemBytes : kSmemBytes;
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((unsigned)((q->N + bn - 1) / bn), (unsigned)((q->M + kBM - 1) / kBM),
                  (unsigned)q->B);
  void* args[] = {const_cast<MmParams*>(q), &out};
  rc = cudaLaunchKernel(kernel, grid, dim3(kThreads), args, (size_t)smem,
                        static_cast<cudaStream_t>(stream));
  return (int)(rc != cudaSuccess ? rc : cudaGetLastError());
}

extern "C" int sm_mm_params_size() { return (int)sizeof(MmParams); }
