// The CUDA-core matmul kernel for Hopper (sm_90a): float32, mixed
// float32/bfloat16 and integer operands of which one is int32.  bfloat16 @
// bfloat16 takes the tensor-core kernel of matmul_wgmma.cu and int8/uint8
// pairs that of matmul_wgmma_s8.cu instead; the wrapper routes by the
// operands' types alone, never by shape, stride or size.
//
// Replaces the JAX package's two Pallas matmul kernels, both in
// simplemath_tpu/ops/matmul.py:
//   mm_kernel, one batch  <- _build_matmul (:134, body _matmul_kernel :49)
//   mm_kernel, batch grid <- _build_bmm    (:209, body _bmm_kernel :85)
// with the fused epilogue of ops/fusion.py::materialize_matmul and the
// dequantizing epilogue of int8_matmul (_dequant_epi, :451) on top.
//
// What it computes: out[b] = epilogue(A[b] @ B[b], extras...) for
// (B, M, K) @ (B, K, N); rank 2 is B = 1.  The accumulator is f32 for f32
// and bf16 operands (each read by its own type and widened at the load, so
// a bf16 factor enters exactly and only the sum rounds) and int32 for int8,
// uint8 and int32 operands (kept in uint32_t: it wraps mod 2^32, exactly).
// The epilogue is the elementwise kernel's opcode program (program.cuh) run
// once per output element with register 0 holding the accumulator and the
// other operand registers the extras, so it gives the values ew_strided
// would give on the stored product, without storing it.  The result is cast
// to the output type at the store (f32 -> bf16 rounds to nearest even).
//
// How the TPU kernel's parts translate.  Its sequential K grid dimension
// with a VMEM accumulator becomes a K loop inside the block with the
// accumulator in registers: a block of 256 threads owns a 128 x 128 output
// tile, each thread an 8 x 8 register tile (two 4-wide groups 64 apart in
// each direction, so its shared-memory reads are conflict-free 16-byte
// loads), and walks K in steps of 16 through shared-memory tiles of A and
// B.  The next tiles are fetched into registers while the current ones are
// multiplied.  No split-K and no atomics: every output element is summed
// by one thread in ascending k, so two launches give the same bits.  The
// TPU wrapper's zero padding to block multiples is gone: A, B and every
// extra are read in place through signed element strides (row, column,
// batch; 0 broadcasts an extra; a transposed or negative-step view costs
// no copy) and the ragged edge is masked at the load and at the store.
//
// What bounds it on an H100: operations.  2048^3 is 17.2 GFLOP over 48 MB,
// so even at the f32 rate of the CUDA cores (67 TFLOP/s: 0.256 ms) the
// bytes (14 us at 3.35 TB/s) are far from the limit.  This kernel does
// exact f32 multiply-adds on the CUDA cores for every float signature it
// takes, and 32-bit integer multiply-adds for the integer types.  For f32
// operands that is the arithmetic "default" precision promises (a
// tensor-core route would truncate them), and a product with an int32
// operand has no tensor-core instruction.  The int8 and uint8 loads stay
// for the pairs with one int32 operand; a pair of 1-byte operands runs on
// the int8 tensor cores (matmul_wgmma_s8.cu), which this kernel's
// multiply-adds are two hundred times slower than.
//
// Built with --fmad=false like the other sources, so the epilogue rounds
// once per operation; the inner product therefore asks for its fused
// multiply-add by name (__fmaf_rn).
//
// Launch: on the caller's stream; allocates nothing; returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include "matmul.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kThreads = 256;
constexpr int kPad = 4;    // keeps the transposing tile stores off one bank
constexpr int kSlots = 8;  // kBM * kBK / kThreads elements per thread per tile

template <bool INT>
__device__ __forceinline__ uint32_t mm_fma(uint32_t a, uint32_t b, uint32_t c) {
  if (INT) return c + a * b;
  return sm_u(__fmaf_rn(sm_f(a), sm_f(b), sm_f(c)));
}

// Row (m or n) and contraction index, inside a tile, of load slot ``i`` of
// thread ``tid``: neighbouring threads walk the operand's fast dimension.
__device__ __forceinline__ void mm_slot(int tid, int i, int inner_fast, int* row, int* k) {
  if (inner_fast) {
    *k = tid & (kBK - 1);
    *row = (tid >> 4) + 16 * i;
  } else {
    *row = tid & (kBM - 1);
    *k = (tid >> 7) + 2 * i;
  }
}

// This thread's elements of the A tile (rows m0.., columns k0..) or the B
// tile (rows k0.., columns n0..) into ``regs``; zero outside the matrix.
__device__ __forceinline__ void mm_fetch(const MmOperand& x, bool is_a, int64_t base,
                                         int64_t row0, int64_t rows, int64_t k0, int64_t K,
                                         int tid, uint32_t* regs) {
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    int row, k;
    mm_slot(tid, i, x.inner_fast, &row, &k);
    const int64_t gr = row0 + row, gk = k0 + k;
    const int64_t off = is_a ? base + gr * x.strides[1] + gk * x.strides[2]
                             : base + gk * x.strides[1] + gr * x.strides[2];
    regs[i] = (gr < rows && gk < K) ? sm_load(x.ptr, off, x.dtype) : 0u;
  }
}

// ``regs`` into the shared tile, stored as tile[k][row].
__device__ __forceinline__ void mm_stage(uint32_t (*tile)[kBM + kPad], int inner_fast, int tid,
                                         const uint32_t* regs) {
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    int row, k;
    mm_slot(tid, i, inner_fast, &row, &k);
    tile[k][row] = regs[i];
  }
}

// Row of the output tile that register row ``i`` (0..7) of thread row
// ``t`` (0..15) holds: two groups of 4, 64 apart.
__device__ __forceinline__ int mm_row(int t, int i) {
  return (i < 4) ? t * 4 + i : 64 + t * 4 + (i - 4);
}

}  // namespace

template <bool INT>
__global__ void __launch_bounds__(kThreads, 2) mm_kernel(const MmParams q, void* __restrict__ out) {
  static_assert(kBM == kBN, "A and B tiles share the slot map");
  __shared__ __align__(16) uint32_t As[kBK][kBM + kPad];
  __shared__ __align__(16) uint32_t Bs[kBK][kBN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int64_t bz = blockIdx.z;
  const int64_t m0 = (int64_t)blockIdx.y * kBM, n0 = (int64_t)blockIdx.x * kBN;
  const int64_t base_a = bz * q.a.strides[0], base_b = bz * q.b.strides[0];

  uint32_t acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0u;  // 0.0f and 0 alike

  uint32_t ra[kSlots], rb[kSlots];
  mm_fetch(q.a, true, base_a, m0, q.M, 0, q.K, tid, ra);
  mm_fetch(q.b, false, base_b, n0, q.N, 0, q.K, tid, rb);
  for (int64_t k0 = 0; k0 < q.K; k0 += kBK) {
    mm_stage(As, q.a.inner_fast, tid, ra);
    mm_stage(Bs, q.b.inner_fast, tid, rb);
    __syncthreads();
    if (k0 + kBK < q.K) {
      mm_fetch(q.a, true, base_a, m0, q.M, k0 + kBK, q.K, tid, ra);
      mm_fetch(q.b, false, base_b, n0, q.N, k0 + kBK, q.K, tid, rb);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const uint4 a0 = *reinterpret_cast<const uint4*>(&As[kk][ty * 4]);
      const uint4 a1 = *reinterpret_cast<const uint4*>(&As[kk][64 + ty * 4]);
      const uint4 b0 = *reinterpret_cast<const uint4*>(&Bs[kk][tx * 4]);
      const uint4 b1 = *reinterpret_cast<const uint4*>(&Bs[kk][64 + tx * 4]);
      const uint32_t a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const uint32_t b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = mm_fma<INT>(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int64_t out_base = bz * q.M * q.N;
  if (!q.epilogue) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t m = m0 + mm_row(ty, i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t n = n0 + mm_row(tx, j);
        if (m < q.M && n < q.N) sm_store(out, out_base + m * q.N + n, q.out_dtype, acc[i][j]);
      }
    }
    return;
  }

  // The epilogue walks the 64 results in a loop that is not unrolled, over
  // a copy it may index at run time: the interpreter and its register file
  // (local memory) exist once, and the accumulator tile above stays in
  // registers through the K loop.
  uint32_t res[64];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) res[i * 8 + j] = acc[i][j];
  const SmParams& p = q.p;
  uint32_t r[SM_MAX_REGS];
  sm_load_consts(p, r);
#pragma unroll 1
  for (int e = 0; e < 64; ++e) {
    const int64_t m = m0 + mm_row(ty, e >> 3), n = n0 + mm_row(tx, e & 7);
    if (m >= q.M || n >= q.N) continue;
    sm_store(out, out_base + m * q.N + n, q.out_dtype, mm_epilogue_at(p, r, bz, m, n, res[e]));
  }
}

// The product of q->a and q->b, through the epilogue when q->epilogue, into
// the contiguous (B, M, N) ``out``.  B <= 65535 and M <= 65535 * 128.
extern "C" int sm_mm_launch(const MmParams* q, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((q->N + kBN - 1) / kBN), (unsigned)((q->M + kBM - 1) / kBM),
                  (unsigned)q->B);
  if (q->int_acc)
    mm_kernel<true><<<grid, kThreads, 0, s>>>(*q, out);
  else
    mm_kernel<false><<<grid, kThreads, 0, s>>>(*q, out);
  return (int)cudaGetLastError();
}

extern "C" int sm_mm_params_size() { return (int)sizeof(MmParams); }
