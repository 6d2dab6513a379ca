// The tensor-core matmul kernel for Hopper (sm_90a): bfloat16 @ bfloat16.
//
// Replaces, for bfloat16 operands, the JAX package's two Pallas matmul
// kernels in simplemath_tpu/ops/matmul.py (_build_matmul :134, body
// _matmul_kernel :49; _build_bmm :209, body _bmm_kernel :85), which feed
// bfloat16 tiles to the TPU's matrix unit with a float32 accumulator.  It
// computes what the CUDA-core kernel of matmul.cu computes,
// out[b] = epilogue(A[b] @ B[b], extras...), with the same parameter block,
// the same epilogue interpreter and the same store; only the order and the
// rounding of the float32 sum differ (a bf16 x bf16 product is exact in
// float32 on both routes).
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
// 16 bytes).  With an epilogue the interpreter runs on those rows, four
// adjacent columns a lane at a time, so that the extras are read along
// their rows and each instruction is fetched and dispatched once for four
// elements.
//
// Built with --fmad=false like the other sources (the epilogue rounds once
// per operation).  Launch: on the caller's stream; allocates nothing;
// returns the first CUDA error so the wrapper can raise.

#include "wgmma.cuh"

using namespace sm_wgmma;

namespace {

constexpr int kBK = kRowBytes / 2;  // k of one step: a 128-byte tile row of bf16

// Keeps the compiler from moving accumulator registers across the
// asynchronous multiplies.
__device__ __forceinline__ void fence_accumulator(float* d) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, f32) += A (64 x 16) * B (16 x 256), both bf16 in shared
// memory; TA / TB = 1 for an MN-major operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TA), "n"(TB));
}

}  // namespace

template <bool A_KMAJOR, bool B_KMAJOR>
__global__ void __launch_bounds__(kThreads, 1)
    mm_wgmma_kernel(const __grid_constant__ MmParams q, void* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  // The swizzle is a function of the address: tiles start on 1024 bytes.
  const uint32_t skew = (kAtomBytes - (smem_u32(smem_raw) & (kAtomBytes - 1))) & (kAtomBytes - 1);
  uint8_t* const ring_ptr = smem_raw + skew;
  const uint32_t ring = smem_u32(ring_ptr);

  const int tid = threadIdx.x;
  const int half = tid >> 7;  // this thread's warpgroup: rows 64 * half ..
  const int64_t bz = blockIdx.z;
  const int64_t m0 = (int64_t)blockIdx.y * kBM, n0 = (int64_t)blockIdx.x * kBN;
  const int64_t base_a = bz * q.a.strides[0], base_b = bz * q.b.strides[0];
  const int n_steps = (int)((q.K + kBK - 1) / kBK);
  // cp.async's writes are seen by wgmma once their group has been waited
  // for; ordinary stores need the proxy fence on top.
  const bool stores = !(q.a.vec16 && q.b.vec16);

  // B is (b, k, n): its mn stride is its last.
  ChunkPlan<uint16_t> plan_a =
      plan_chunks<A_KMAJOR, kBM, uint16_t>(q.a, base_a, q.a.strides[1], q.a.strides[2], m0, q.M, tid);
  ChunkPlan<uint16_t> plan_b =
      plan_chunks<B_KMAJOR, kBN, uint16_t>(q.b, base_b, q.b.strides[2], q.b.strides[1], n0, q.N, tid);
  // Steps are staged in ascending order, each once.
  auto stage = [&](int step) {
    const uint32_t off = (uint32_t)(step % kStages) * kStageBytes;
    const int64_t k0 = (int64_t)step * kBK;
    if (q.a.vec16)
      copy_chunks<A_KMAJOR, kBM, uint16_t>(plan_a, q.a.ptr, ring + off, q.K - k0);
    else
      copy_elements<A_KMAJOR, kBM, uint16_t>(q.a, base_a, q.a.strides[1], q.a.strides[2], m0, q.M, k0, q.K,
                                   ring_ptr + off, tid);
    if (q.b.vec16)
      copy_chunks<B_KMAJOR, kBN, uint16_t>(plan_b, q.b.ptr, ring + off + kTileBytesA, q.K - k0);
    else
      copy_elements<B_KMAJOR, kBN, uint16_t>(q.b, base_b, q.b.strides[2], q.b.strides[1], n0, q.N, k0, q.K,
                                   ring_ptr + off + kTileBytesA, tid);
  };

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;

  // One cp.async group per step, empty past the end, so that "all but the
  // newest kStages - 3 groups have landed" always means "this step is in".
#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (s < n_steps) stage(s);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStages - 3>();
    if (stores) fence_async_proxy();
    // Every thread's part of this step's tiles is in, and every warpgroup
    // has finished the multiplies of step - 2, whose stage is refilled below.
    __syncthreads();
    const uint32_t a_tile = ring + (uint32_t)(step % kStages) * kStageBytes;
    const uint32_t b_tile = a_tile + kTileBytesA;
    fence_accumulator(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      wgmma_m64n256k16<!A_KMAJOR, !B_KMAJOR>(
          acc, tile_desc<A_KMAJOR>(a_tile + step_offset<A_KMAJOR>(half, ks)),
          tile_desc<B_KMAJOR>(b_tile + step_offset<B_KMAJOR>(0, ks)));
    }
    wgmma_commit();
    fence_accumulator(acc);
    if (step + kStages - 2 < n_steps) stage(step + kStages - 2);
    cp_async_commit();
    wgmma_wait<1>();  // the multiplies of step - 1 are done; this step's run on
  }
  wgmma_wait<0>();
  fence_accumulator(acc);

  store_tile(q, out, acc, ring_ptr, tid, bz, m0, n0);
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
