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

#include "matmul.cuh"

namespace {

constexpr int kBM = 128, kBN = 256, kBK = 64;
constexpr int kThreads = 256;
constexpr int kAcc = kBN / 2;  // accumulator registers of a thread
constexpr int kStages = 4;  // 5 to 7 were no faster at 128 x 128 tiles
constexpr int kTileBytesA = kBM * kBK * 2, kTileBytesB = kBN * kBK * 2;
constexpr int kStageBytes = kTileBytesA + kTileBytesB;
constexpr int kAtomBytes = 1024;  // 8 rows of 128 bytes: the swizzle's period
constexpr int kSmemBytes = kStages * kStageBytes + kAtomBytes;  // + alignment slack
static_assert(kStages >= 3, "the ring keeps two steps in the multiplier");
static_assert(kSmemBytes <= 232448, "a block has 227 KB of shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset, inside a ROWS x 64 (K-major) or 64 x ROWS (MN-major) bf16
// tile, of element (mn, k).  Both are the canonical 128-byte-swizzle
// layouts of wgmma: rows of 128 bytes in atoms of 8 rows, the 16-byte chunk
// c of row r stored at chunk c ^ (r & 7).
//   K-major:  row = mn, 64 k to a row; atoms follow each other over mn.
//   MN-major: row = k, 64 mn to a row; atom (mn / 64, k / 8) sits at
//             (mn / 64) * 8 + k / 8.
template <bool KMAJOR>
__device__ __forceinline__ uint32_t tile_offset(int mn, int k) {
  if (KMAJOR) return mn * 128 + ((((k >> 3) ^ (mn & 7)) << 4) | ((k & 7) << 1));
  return ((mn >> 6) * 8 + (k >> 3)) * kAtomBytes + (k & 7) * 128 +
         (((((mn & 63) >> 3) ^ (k & 7)) << 4) | ((mn & 7) << 1));
}

// The shared-memory matrix descriptor of a tile (or of a part of it that
// starts at ``addr``): 128-byte swizzle, 1024 bytes from one atom to the
// next along the strided direction (8 rows of mn for K-major, 8 rows of k
// for MN-major), and for MN-major 8 KB from one block of 64 mn to the next
// (the leading offset is not used for a swizzled K-major operand).
template <bool KMAJOR>
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  const uint64_t lbo = KMAJOR ? 1 : (8 * kAtomBytes) >> 4;
  const uint64_t sbo = kAtomBytes >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (lbo << 16) | (sbo << 32) | (1ull << 62);
}

// Bytes from a tile's start to what one k16 step ``ks`` (0..3) reads of the
// rows from 64 * ``half`` on.
template <bool KMAJOR>
__device__ __forceinline__ uint32_t step_offset(int half, int ks) {
  // K-major: 64 rows of 128 bytes down, 16 k = 32 bytes along the row.
  // MN-major: the next block of 64 mn, two atoms of 8 k down.
  return KMAJOR ? half * 64 * 128 + ks * 32 : half * 8 * kAtomBytes + ks * 2 * kAtomBytes;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's ordinary shared-memory stores before later reads by
// wgmma (the async proxy).
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
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

// A thread's part in staging one operand 16 bytes at a time.  A tile of
// ROWS x 64 is ROWS * 8 chunks of 8 elements, ROWS / 32 to a thread;
// neighbouring threads take neighbouring chunks of one row of the source.
// K-major: the thread's chunks sit at one k, 32 rows of mn apart; MN-major:
// at one mn, 2048 / ROWS rows of k apart (a multiple of 8, so the swizzle's
// row bits do not change).  Either way they are a fixed step apart in the
// source and in the tile, and the source moves on by 64 k from one step to
// the next, so the addresses are worked out once, before the K loop.
struct ChunkPlan {
  const uint16_t* src;  // the thread's first chunk of the coming step
  int64_t per_chunk;    // elements from one of its chunks to the next
  int64_t per_step;     // elements from one step to the next
  uint32_t dst;         // bytes from a tile's start to its first chunk
  int32_t k;            // k, inside a tile, of its first chunk
  // K-major: bit i says the row of chunk i lies inside the matrix;
  // MN-major: the bytes (0..16) of each chunk that lie inside it along mn.
  int32_t inside;
};

template <bool KMAJOR, int ROWS>
__device__ __forceinline__ ChunkPlan plan_chunks(const MmOperand& x, int64_t base, int64_t s_mn,
                                                 int64_t s_k, int64_t mn0, int64_t MN, int tid) {
  constexpr int kPerRow = ROWS / 8;  // chunks along mn (MN-major)
  ChunkPlan c;
  const int mn = KMAJOR ? tid >> 3 : (tid % kPerRow) << 3;
  c.k = KMAJOR ? (tid & 7) << 3 : tid / kPerRow;
  c.src = static_cast<const uint16_t*>(x.ptr) + base + (mn0 + mn) * s_mn + c.k * s_k;
  c.per_chunk = KMAJOR ? 32 * s_mn : (kThreads / kPerRow) * s_k;
  c.per_step = kBK * s_k;
  c.dst = tile_offset<KMAJOR>(mn, c.k);
  c.inside = 0;
  if (KMAJOR) {
#pragma unroll
    for (int i = 0; i < ROWS / 32; ++i) c.inside |= (mn0 + mn + 32 * i < MN) << i;
  } else {
    const int64_t left = MN - (mn0 + mn);
    c.inside = left >= 8 ? 16 : (left > 0 ? (int)left * 2 : 0);
  }
  return c;
}

// Issues the thread's copies of one step into the tile at ``tile`` and
// moves the plan on to the next step; ``k_left`` is K minus the step's
// first k.  The source size of a copy zero-fills what lies past the edge;
// a copy of no bytes is given ``safe``, an address it may name.
template <bool KMAJOR, int ROWS>
__device__ __forceinline__ void copy_chunks(ChunkPlan& c, const void* safe, uint32_t tile,
                                            int64_t k_left) {
  constexpr int kRowsOfK = kThreads / (ROWS / 8);  // MN-major: k from chunk to chunk
  const int64_t along = k_left - c.k;  // K-major: elements left in the row
  const int row_bytes = along >= 8 ? 16 : (along > 0 ? (int)along * 2 : 0);
#pragma unroll
  for (int i = 0; i < ROWS / 32; ++i) {
    const int bytes = KMAJOR ? ((c.inside >> i) & 1 ? row_bytes : 0)
                             : (c.k + kRowsOfK * i < k_left ? c.inside : 0);
    cp_async16(tile + c.dst + i * (KMAJOR ? 32 * 128 : kRowsOfK / 8 * kAtomBytes),
               bytes ? static_cast<const void*>(c.src + i * c.per_chunk) : safe, bytes);
  }
  c.src += c.per_step;
}

// One operand's ROWS x 64 tile (mn from mn0, k from k0), element by element
// through its strides ``s_mn`` and ``s_k``, into the shared tile at
// ``tile``; zero outside the matrix.
template <bool KMAJOR, int ROWS>
__device__ __forceinline__ void copy_elements(const MmOperand& x, int64_t base, int64_t s_mn,
                                              int64_t s_k, int64_t mn0, int64_t MN, int64_t k0,
                                              int64_t K, uint8_t* tile, int tid) {
  const uint16_t* src = static_cast<const uint16_t*>(x.ptr);
#pragma unroll 4
  for (int i = 0; i < ROWS * kBK / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int mn = KMAJOR ? e >> 6 : e % ROWS;
    const int k = KMAJOR ? e & 63 : e / ROWS;
    const int64_t gmn = mn0 + mn, gk = k0 + k;
    const uint16_t v = (gmn < MN && gk < K) ? src[base + gmn * s_mn + gk * s_k] : (uint16_t)0;
    *reinterpret_cast<uint16_t*>(tile + tile_offset<KMAJOR>(mn, k)) = v;
  }
}

// Two f32 values (as bits) rounded to bf16, nearest even, ``lo`` in the low
// half: one instruction.  A NaN becomes the canonical NaN.
__device__ __forceinline__ uint32_t pack_bf16(uint32_t lo, uint32_t hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(sm_f(hi)), "f"(sm_f(lo)));
  return d;
}

// Two adjacent f32 values at ``at`` (aligned to the pair) as bf16 (ESIZE
// 2) or as they are (ESIZE 4); one value in the stored type of ``esize``
// bytes (2: bf16; 1: bool; 4: the register's bits).
template <int ESIZE>
__device__ __forceinline__ void write_pair(void* at, uint32_t v0, uint32_t v1) {
  if (ESIZE == 2)
    *static_cast<uint32_t*>(at) = pack_bf16(v0, v1);
  else
    *static_cast<uint2*>(at) = make_uint2(v0, v1);
}
__device__ __forceinline__ void write_one(void* at, int esize, uint32_t v) {
  if (esize == 2)
    *static_cast<uint16_t*>(at) = (uint16_t)pack_bf16(v, 0u);
  else if (esize == 1)
    *static_cast<uint8_t*>(at) = v != 0;
  else
    *static_cast<uint32_t*>(at) = v;
}

// A warp lays its 16 x 256 results out in shared memory, then writes whole
// rows of the output, 16 bytes a lane.  The pitch's padding spreads the 8
// rows one store instruction touches over the banks.
template <int ESIZE>
struct Rows {
  static constexpr int kPitch = kBN * ESIZE + (ESIZE == 4 ? 32 : 16);
  static constexpr int kWarpBytes = 16 * (kBN * 4 + 32);  // the largest ESIZE's

  // Where pair ``e`` of this lane's accumulator goes (see the kernel).
  static __device__ __forceinline__ uint8_t* at(uint8_t* mine, int lane, int e) {
    return mine + ((lane >> 2) + 8 * (e & 1)) * kPitch + (8 * (e >> 1) + (lane & 3) * 2) * ESIZE;
  }

  // The accumulator itself (``wide`` output without an epilogue).
  static __device__ __forceinline__ void stash(uint8_t* mine, int lane, const float* acc) {
#pragma unroll
    for (int e = 0; e < kAcc / 2; ++e)
      write_pair<ESIZE>(at(mine, lane, e), sm_u(acc[2 * e]), sm_u(acc[2 * e + 1]));
  }

};

// A warp's rows, ``PITCH`` bytes apart at ``mine``, to ``dst`` (the output
// at the warp's first row and the tile's first column): ``rows`` of them,
// ``row_bytes`` apart, the first ``bytes`` of each (a multiple of 16), of at
// most ROW_BYTES; whole rows, 16 bytes a lane.
template <int ROW_BYTES, int PITCH>
__device__ __forceinline__ void flush_rows(const uint8_t* mine, int lane, uint8_t* dst,
                                           int64_t row_bytes, int rows, int64_t bytes) {
  for (int rr = 0; rr < rows; ++rr, dst += row_bytes) {
#pragma unroll
    for (int c = lane * 16; c < ROW_BYTES; c += 32 * 16)
      if (c < bytes)
        *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<const uint4*>(mine + rr * PITCH + c);
  }
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
  ChunkPlan plan_a =
      plan_chunks<A_KMAJOR, kBM>(q.a, base_a, q.a.strides[1], q.a.strides[2], m0, q.M, tid);
  ChunkPlan plan_b =
      plan_chunks<B_KMAJOR, kBN>(q.b, base_b, q.b.strides[2], q.b.strides[1], n0, q.N, tid);
  // Steps are staged in ascending order, each once.
  auto stage = [&](int step) {
    const uint32_t off = (uint32_t)(step % kStages) * kStageBytes;
    const int64_t k0 = (int64_t)step * kBK;
    if (q.a.vec16)
      copy_chunks<A_KMAJOR, kBM>(plan_a, q.a.ptr, ring + off, q.K - k0);
    else
      copy_elements<A_KMAJOR, kBM>(q.a, base_a, q.a.strides[1], q.a.strides[2], m0, q.M, k0, q.K,
                                   ring_ptr + off, tid);
    if (q.b.vec16)
      copy_chunks<B_KMAJOR, kBN>(plan_b, q.b.ptr, ring + off + kTileBytesA, q.K - k0);
    else
      copy_elements<B_KMAJOR, kBN>(q.b, base_b, q.b.strides[2], q.b.strides[1], n0, q.N, k0, q.K,
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

  // Accumulator register 4 * j + 2 * h + c of a thread is the element at
  // row 16 * warp + lane / 4 + 8 * h, column 8 * j + 2 * (lane % 4) + c of
  // the tile (warps 0-3 are the first warpgroup): pair e = 2 * j + h is two
  // adjacent columns.  With one block of 8 warps on an SM every instruction
  // here is paid in full (nothing else runs meanwhile), so the store does
  // as little per element as it can: where the output's rows start on 16
  // bytes (``wide``) a warp lays its 16 x 256 results out in the ring, which
  // is free by now, and writes whole rows; otherwise the pairs go out one by
  // one.
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = m0 + warp * 16 + (lane >> 2);
  const int64_t col0 = n0 + (lane & 3) * 2;
  const int esize = q.out_dtype == SM_BF16 ? 2 : (q.out_dtype == SM_BOOL ? 1 : 4);
  const bool wide = (q.N * esize) % 16 == 0;
  uint8_t* const out_bytes = static_cast<uint8_t*>(out) + bz * q.M * q.N * esize;
  uint8_t* const mine = ring_ptr + warp * Rows<4>::kWarpBytes;
  static_assert(8 * Rows<4>::kWarpBytes <= kStages * kStageBytes, "the results fit in the ring");
  __syncthreads();  // both warpgroups have read their last tiles

  const int64_t first = m0 + warp * 16;  // the warp's first row
  const int rows = first >= q.M ? 0 : (int)(q.M - first < 16 ? q.M - first : 16);
  const int64_t row_bytes = q.N * esize;
  uint8_t* const dst = out_bytes + first * row_bytes + n0 * esize;
  const int64_t bytes = row_bytes - n0 * esize;  // of an output row, from this tile on

  if (!q.epilogue) {
    if (wide) {
      // f32 or bf16: no bounds here, the rows are cut when they are written.
      if (esize == 2) {
        Rows<2>::stash(mine, lane, acc);
        __syncwarp();
        flush_rows<kBN * 2, Rows<2>::kPitch>(mine, lane, dst, row_bytes, rows, bytes);
      } else {
        Rows<4>::stash(mine, lane, acc);
        __syncwarp();
        flush_rows<kBN * 4, Rows<4>::kPitch>(mine, lane, dst, row_bytes, rows, bytes);
      }
      return;
    }
#pragma unroll
    for (int e = 0; e < kAcc / 2; ++e) {
      const int64_t m = row0 + 8 * (e & 1), n = col0 + 8 * (e >> 1);
      if (m < q.M && n < q.N) {
        uint8_t* at = out_bytes + (m * q.N + n) * esize;
        write_one(at, esize, sm_u(acc[2 * e]));
        if (n + 1 < q.N) write_one(at + esize, esize, sm_u(acc[2 * e + 1]));
      }
    }
    return;
  }

  // The epilogue.  The accumulators go to the warp's rows as f32; then a
  // lane takes four adjacent columns of a row at a time (two such groups a
  // row) through the interpreter, whose registers hold four elements each,
  // and puts the results back at the row's start in the stored type (never
  // past what the warp has already read), or straight to the output where
  // its rows do not start on 16 bytes.  Each instruction is dispatched once
  // for the four elements (mm_exec4): dispatching per element cost 0.03 ms
  // more at 2048^3 (H100, 700 W).  The register file in shared memory instead of local
  // memory, and eight elements a pass instead of four, were tried and were
  // no faster.
  Rows<4>::stash(mine, lane, acc);
  __syncwarp();
  const SmParams& p = q.p;
  uint4 r[SM_MAX_REGS];
  mm_load_consts4(p, r);
#pragma unroll 1
  for (int pass = 0; pass < 2 * rows; ++pass) {
    const int rr = pass >> 1;
    const int c = 4 * (lane + 32 * (pass & 1));  // the group's first column in the tile
    const int64_t m = first + rr, n = n0 + c;
    const int count = n < q.N ? (int)(q.N - n < 4 ? q.N - n : 4) : 0;
    uint8_t* const row = mine + rr * Rows<4>::kPitch;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (count)
      v = mm_epilogue4_at(p, r, bz, m, n, *reinterpret_cast<const uint4*>(row + c * 4), count);
    __syncwarp();  // every lane has read its accumulators of this half row
    if (wide) {  // then count is 0 or 4; what lies past N is not written out
      if (esize == 4)
        *reinterpret_cast<uint4*>(row + c * 4) = v;
      else if (esize == 2)
        *reinterpret_cast<uint2*>(row + c * 2) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
      else
        *reinterpret_cast<uint32_t*>(row + c) =
            (v.x != 0) | ((v.y != 0) << 8) | ((v.z != 0) << 16) | ((uint32_t)(v.w != 0) << 24);
    } else {
      uint8_t* at = out_bytes + (m * q.N + n) * esize;
      const uint32_t vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < count) write_one(at + i * esize, esize, vs[i]);
    }
  }
  if (!wide) return;
  __syncwarp();
  if (esize == 4)
    flush_rows<kBN * 4, Rows<4>::kPitch>(mine, lane, dst, row_bytes, rows, bytes);
  else if (esize == 2)
    flush_rows<kBN * 2, Rows<4>::kPitch>(mine, lane, dst, row_bytes, rows, bytes);
  else
    flush_rows<kBN, Rows<4>::kPitch>(mine, lane, dst, row_bytes, rows, bytes);
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
