// The tensor-core matmul kernel for Hopper (sm_90a): bfloat16 @ bfloat16.
//
// Replaces, for bfloat16 operands, the JAX package's two Pallas matmul
// kernels in simplemath_tpu/ops/matmul.py (_build_matmul :134, body
// _matmul_kernel :49; _build_bmm :209, body _bmm_kernel :85), which feed
// bfloat16 tiles to the TPU's matrix unit with a float32 accumulator.  It
// computes what the CUDA-core kernel of matmul.cu computes,
// out[b] = epilogue(A[b] @ B[b], extras...), with the same parameter block
// and the same epilogue; only the order and the rounding of the float32 sum
// differ (a bf16 x bf16 product is exact in float32 on both routes).
//
// What bounds it on an H100: operations, at the tensor cores' bf16 rate
// (989 TFLOP/s: 17 us for 2048^3, whose 25 MB take 7.5 us at 3.35 TB/s).
// The CUDA cores reach a fifteenth of that rate at best, so the product
// goes to wgmma.mma_async (m64n256k16, f32 += bf16 x bf16), which reads
// both operands from shared memory through matrix descriptors and keeps the
// accumulator in registers: 128 floats a thread.  Below that bound sits a
// second one, the traffic from L2 into the SMs: every block reads its A
// rows and B columns for itself, so the tile is as large as the registers
// allow (128 x 256: 192 MB of tile reads for 2048^3, where 128 x 128 tiles
// read 256 MB and spent all their time on it).
//
// The design.  A block of 256 threads (two warpgroups) owns a 128 x 256
// output tile; each warpgroup owns 64 of its rows.  K is walked in steps of
// 64 through a ring of kStages stages in dynamic shared memory, each stage
// an A tile (128 x 64, 16 KB) and a B tile (64 x 256, 32 KB) in the
// 128-byte swizzled layout wgmma reads.  All threads copy a tile
// kStages - 2 steps ahead of the one being multiplied, and the multiplies
// of one step stay in flight while the next step's are issued
// (wait_group 1), so the tensor cores do not wait for the copies.  One
// warpgroup sums each output element over ascending k: no split-K, no
// atomics, the bits repeat from launch to launch.
//
// Operands arrive through signed element strides, so each has a staging
// order and a staging path, chosen by the wrapper (ops/matmul.py::staging):
//   order: K-major (the contraction dimension is the 128-byte row of the
//     shared tile; a row-major A, a transposed-view B) or MN-major (the
//     m or n dimension is; a row-major B, a transposed-view A).  wgmma
//     reads either through the transpose bits of the instruction, which are
//     immediates: the kernel is instantiated for the four combinations.
//   path: 16-byte cp.async copies (vec16: stride 1 along the row, every
//     other stride a multiple of 8 elements, base 16-byte aligned; the
//     source size of a copy zero-fills what lies past the matrix edge), or
//     element by element through the strides (a negative or wider step
//     along the row, odd strides, unaligned slices) with ordinary
//     shared-memory stores.
// Both paths fill the same layout, zero past the edge, so one consumer
// serves both and a view and its contiguous clone give the same bits.
// cp.async was taken rather than TMA: a tensor map has to be encoded on the
// host for every launch and refuses exactly the strides the element path
// exists for, so it would be a third path, not a replacement.
//
// After the K loop one block of 8 warps is all an SM runs, so nothing hides
// an instruction's latency and the store is written to do little per
// element.  Each accumulator register's (row, column) is known at compile
// time (a thread holds pairs of adjacent columns); a warp lays its 16 x 256
// results out in the ring, free by then, and they leave as whole rows, 16
// bytes a lane (element by element where the output's rows do not start on
// 16 bytes).  With an epilogue, it runs on those rows, four adjacent
// columns a lane at a time, so that the extras are read along their rows:
// on the launch's path a kernel generated for the program (ops/codegen.py,
// kind "matmul": this kernel's body, mm_wgmma_body in matmul_wgmma.cuh,
// with the epilogue's instructions compiled in, built by NVRTC), as the TPU
// kernel compiles one kernel per epilogue; the kernels built here run the
// interpreter (matmul.cuh's MmInterp), the reference.
//
// Built with --fmad=false like the other sources (the epilogue rounds once
// per operation).  Launch: on the caller's stream; allocates nothing;
// returns the first CUDA error so the wrapper can raise.

#include "matmul_wgmma.cuh"

template <bool A_KMAJOR, bool B_KMAJOR>
__global__ void __launch_bounds__(kThreads, 1)
    mm_wgmma_kernel(const __grid_constant__ MmParams q, void* __restrict__ out) {
  mm_wgmma_body<A_KMAJOR, B_KMAJOR, MmInterp>(q, out);
}

namespace {

template <bool A_KMAJOR, bool B_KMAJOR>
int launch(const MmParams* q, void* out, dim3 grid, cudaStream_t s) {
  // More than 48 KB of dynamic shared memory has to be asked for; the
  // attribute belongs to the function on the current device.
  cudaError_t rc = cudaFuncSetAttribute(mm_wgmma_kernel<A_KMAJOR, B_KMAJOR>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (rc != cudaSuccess) return (int)rc;
  mm_wgmma_kernel<A_KMAJOR, B_KMAJOR><<<grid, kThreads, kSmemBytes, s>>>(*q, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 @ bf16 product of q->a and q->b, through the epilogue when
// q->epilogue, into the contiguous (B, M, N) ``out``.  B <= 65535 and
// M <= 65535 * 128.  Each operand's inner_fast picks its staging order.
extern "C" int sm_mm_wgmma_launch(const MmParams* q, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q->a.dtype != SM_BF16 || q->b.dtype != SM_BF16 || q->int_acc) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((q->N + kBN - 1) / kBN), (unsigned)((q->M + kBM - 1) / kBM),
                  (unsigned)q->B);
  if (q->a.inner_fast)
    return q->b.inner_fast ? launch<true, true>(q, out, grid, s) : launch<true, false>(q, out, grid, s);
  return q->b.inner_fast ? launch<false, true>(q, out, grid, s) : launch<false, false>(q, out, grid, s);
}
