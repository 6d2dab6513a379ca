// The tensor-core matmul kernel for Hopper (sm_90a): int8/uint8 @ int8/uint8.
//
// Replaces, for 1-byte integer operands, the JAX package's two Pallas matmul
// kernels in simplemath_tpu/ops/matmul.py (_build_matmul :134, _build_bmm
// :209, with int8_matmul :457 and its dequantizing epilogue _dequant_epi
// :451 on top), which feed int8 tiles to the TPU's matrix unit with an int32
// accumulator.  It computes what the CUDA-core kernel of matmul.cu computes
// for these types, out[b] = epilogue(A[b] @ B[b], extras...), with the same
// parameter block, the same epilogue and the same store (the bf16 kernel's),
// and the same bits: the accumulator is int32 and wraps mod 2^32 (wgmma
// without .satfinite), and uint8 is read as unsigned (the instruction has
// all four signed/unsigned pairs: four instantiations).  With an epilogue,
// the launch runs this kernel's body (matmul_wgmma_s8.cuh) generated with
// the epilogue compiled in (ops/codegen.py, kind "matmul"); the kernels
// built here run the interpreter, the reference.
//
// What bounds it on an H100: operations, at the tensor cores' int8 rate
// (1979 TOP/s: 8.7 us for 2048^3, whose 24 MB take 7.2 us at 3.35 TB/s).
// The CUDA cores' 32-bit multiply-adds are two hundred times slower, so the
// product goes to wgmma.mma_async (m64n256k32, s32 += {s8,u8} x {s8,u8}).
// Everything around the instruction is the bf16 kernel's (wgmma.cuh): a
// block of two warpgroups owns a 128 x 256 tile, K is walked in steps of 128
// (a 128-byte tile row) through a ring of four 48 KB stages filled two steps
// ahead, one step's multiplies stay in flight while the next is issued, one
// warpgroup sums each element in ascending k (the bits repeat), and the
// tile is stored as whole rows through the ring.
//
// The hard part.  The 8-bit wgmma has no transpose bits: both operands must
// be K-major in shared memory (k along the 128-byte row).  So each operand
// has one tile layout and three ways into it, chosen by the wrapper
// (ops/matmul.py::staging) from its strides:
//   - k contiguous in memory (a row-major A; a transposed-view B, the usual
//     layout of a quantized weight): 16-byte cp.async copies, as for bf16;
//   - m or n contiguous (a row-major B; a transposed-view A): the tile is
//     transposed byte-wise on the way in.  A thread reads 16 bytes along mn
//     of four consecutive k rows, transposes each 4 x 4 block of bytes in
//     registers (prmt), and stores sixteen 4-byte words, each four
//     consecutive k of one mn.  Lanes: 8 along mn (128 contiguous bytes of a
//     source row: whole lines) by 4 along k.  The words of one mn are 128
//     bytes apart from the next mn's, so stored in order the 8 lanes along
//     mn would hit one bank; lane nn therefore stores its word j ^ nn at
//     instruction j, which puts the 8 lanes on 8 different rows of the
//     swizzle's atom and so on 8 different 16-byte columns.  The
//     permutation costs no data movement between registers: its low bits
//     are folded into the prmt selectors, which are computed once, and its
//     high bit swaps the halves of each loaded 16 bytes;
//   - anything else (a base off 16 bytes, odd strides, a negative step along
//     the contiguous dimension): byte by byte through the strides.
// All three fill the same layout, zero past the edge, so one consumer
// serves them and a view gives its contiguous clone's bits (integers are
// exact anyway).  A transposed operand's 16-byte loads are issued one step
// of the K loop before their words are permuted and stored, so that the
// permuting does not wait for them (at 4096^3 0.255 -> 0.211 ms; H100,
// 700 W).  At 2048^3 the copied-only product spends 9.6 of its 21 us in the
// K loop (the bound is 8.7) and the rest in the store of 16 MB of int32; a
// transposed B adds 12 us of permuting to the K loop.
//
// Built with --fmad=false like the other sources (the epilogue rounds once
// per operation).  Launch: on the caller's stream; allocates nothing;
// returns the first CUDA error so the wrapper can raise.

#include "matmul_wgmma_s8.cuh"

template <bool A_SIGNED, bool B_SIGNED>
__global__ void __launch_bounds__(kThreads, 1)
    mm_wgmma_s8_kernel(const __grid_constant__ MmParams q, void* __restrict__ out) {
  mm_wgmma_s8_body<A_SIGNED, B_SIGNED, kWayAny, kWayAny, MmInterp>(q, out);
}

namespace {

template <bool A_SIGNED, bool B_SIGNED>
int launch(const MmParams* q, void* out, dim3 grid, cudaStream_t s) {
  // More than 48 KB of dynamic shared memory has to be asked for; the
  // attribute belongs to the function on the current device.
  cudaError_t rc = cudaFuncSetAttribute(mm_wgmma_s8_kernel<A_SIGNED, B_SIGNED>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (rc != cudaSuccess) return (int)rc;
  mm_wgmma_s8_kernel<A_SIGNED, B_SIGNED><<<grid, kThreads, kSmemBytes, s>>>(*q, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The int8/uint8 product of q->a and q->b, through the epilogue when
// q->epilogue, into the contiguous (B, M, N) ``out``.  B <= 65535 and
// M <= 65535 * 128.  Each operand's vec16 and inner_fast pick its way into
// the tile, its dtype the instruction.
extern "C" int sm_mm_wgmma_s8_launch(const MmParams* q, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool a_signed = q->a.dtype == SM_I8, b_signed = q->b.dtype == SM_I8;
  if (!(a_signed || q->a.dtype == SM_U8) || !(b_signed || q->b.dtype == SM_U8) || !q->int_acc)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((q->N + kBN - 1) / kBN), (unsigned)((q->M + kBM - 1) / kBM),
                  (unsigned)q->B);
  if (a_signed)
    return b_signed ? launch<true, true>(q, out, grid, s) : launch<true, false>(q, out, grid, s);
  return b_signed ? launch<false, true>(q, out, grid, s) : launch<false, false>(q, out, grid, s);
}
