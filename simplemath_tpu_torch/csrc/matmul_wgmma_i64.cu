// The 64-bit integer matmul kernel for Hopper (sm_90a), on the int8 tensor
// cores: every product whose result is int64 or uint64.
//
// Replaces what the JAX package leaves to XLA, jnp.dot / jnp.matmul in int64
// (simplemath_tpu/ops/engine.py:495, :557; no Pallas kernel), which the port
// first ran as 64-bit multiply-adds on the CUDA cores (matmul.cu's imad_i64,
// 3.39 ms at 2048^3 on an H100).  It computes out[b] = A[b] @ B[b] for
// (B, M, K) @ (B, K, N), wrapping mod 2^64, for int64 and uint64 operands and
// int8, uint8 and int32 ones beside them (sign- or zero-extended to 64 bits
// first): the CPU's int64 product, bit for bit.  No epilogue.
//
// The arithmetic.  Write a = sum_i a_i 2^(8i) with a_i the unsigned bytes of
// a's 64 bits ("limbs"), b likewise.  Then
//   a * b mod 2^64 = sum over s = 0..7 of D_s 2^(8s) mod 2^64,
//   D_s = sum_{i + j = s} a_i b_j        (the diagonal s: s + 1 products),
// 36 u8 x u8 products in all.  Summed over k, each diagonal is a u8 GEMM,
// which wgmma.mma_async u8.u8 -> s32 computes; without .satfinite the s32
// sum wraps mod 2^32.  For s >= 4 only D_s mod 2^(64 - 8s) reaches the
// result, so the wrap loses nothing.  For s <= 3 the sum must stay exact:
// read as unsigned it is below (s + 1) * 255^2 * k, under 2^32 while k <=
// 16,512, so a block takes at most kFoldK = 16,384 of K and parts of a longer
// K are added into the 64-bit result (integer atomics: exact and
// order-free, so the bits repeat).  ops/matmul.py::int64_limbs_plain repeats
// this arithmetic on the CPU.
//
// What bounds it on an H100: operations, 36 limb products at the int8
// tensor cores' 1979 TOP/s: 0.3125 ms for 2048^3, whose 96 MB take 0.029 ms
// at 3.35 TB/s.  (The CUDA cores' 64-bit multiply-add, three 32-bit IMADs,
// bounds the old route at 1.54 ms.)
//
// The design.  (Times: tools/time_torch_i64.py at 2048^3 on an H100 SXM at
// 700 W, the product kernel alone.)
//   - Registers decide the tile: eight diagonals' s32 sums over T outputs
//     take 8 T registers, of the SM's 64 K.  A block of two warpgroups owns a
//     64 x 64 output tile, a warpgroup its 64 x 32 half with all 8 diagonals:
//     128 accumulator registers a thread, diagonal d in columns 32 (7 - d) ..
//     of a 64 x 256 accumulator.  B's planes of the half are stacked from 7
//     down to 0 (32 rows each), so A's plane i times the stack from its
//     block i on (planes 7 - i .. 0) is one wgmma of m64n(32 (8 - i))k32 into
//     the diagonals 7 .. i, registers 0 .. 16 (8 - i): 8 instructions a k32
//     take all 36 limb products, every one on the same first register, and
//     both warpgroups run the same instructions on their own rows of B.
//     (Four warpgroups owning two diagonals of m64n64 each: 454 us, 528 when
//     ptxas serialized the multiplies on a branch it took for divergent;
//     the registers of diagonals i .. 7 at the top of the accumulator
//     instead of the bottom: 411 us, serialized "for insufficient register
//     resources"; this layout: 363 us.)
//   - A split pass reads each operand once through its signed strides
//     (views, negative steps, rank 3, the narrow types) and writes its 8 byte
//     planes into scratch the wrapper allocates, already in the layout a
//     step has in shared memory: per 64 rows and k32 an image of 16 KB (8
//     planes x 64 rows x 32 bytes, K-major with the 32-byte swizzle; zero
//     past the matrix), so that a stage is two bulk copies (cp.async.bulk,
//     the copy engine) and no consumer thread computes an address.  One byte
//     a limb: as large as the int64 operand, rows padded to 64, K to 64.
//     (16-byte cp.async copies by every thread: 784 us against 450 for bulk
//     copies into a ring of one-step stages.)  Two split kernels, so that
//     both read and write whole lines: an operand whose k is the faster
//     dimension goes a warp to 512 k of a row (split_span_kernel), any
//     other a block to 64 rows x 64 k, through shared memory
//     (split_tile_kernel).  At 2048^3 they take 28 and 22 us.
//   - A ring of kStages stages of kGroup = 2 steps (64 KB), each with a
//     "full" mbarrier the copies count down and an "empty" one the consumer
//     warps arrive on; a producer warp refills a stage as soon as it is
//     released, and one stage's products stay in flight while the next is
//     issued.  (One step a stage, refilled by one thread after a
//     __syncthreads: 450 us; two steps: 408.)  A k32 reads A's planes twice
//     and B's rows 36 times from shared memory: 104 KB for 4.7 M limb
//     multiply-adds, under its 128 bytes a clock at the tensor cores' rate.
//     The L2 gives 32 KB a step, 2.1 GB at 2048^3.
//   - The fold: after the K loop a thread adds its 8 diagonals of each of
//     its 16 outputs, (uint64)D_d << 8d, in registers and stores them; a block
//     that takes a part of K adds them into the output instead (cleared by
//     the launch first).  Small products fill the card by splitting K over
//     blocks the same way (512^3: 64 tiles, two parts of K).
//
// Launch: the split passes and the product on the caller's stream, no
// allocation, the first CUDA error returned so the wrapper can raise.

#include "wgmma.cuh"

namespace {

using sm_wgmma::smem_u32;
using sm_wgmma::wgmma_commit;
using sm_wgmma::wgmma_fence;
using sm_wgmma::wgmma_wait;

constexpr int kLimbs = 8;
constexpr int kStepK = 32;                          // k of a step: one k32 of each plane
constexpr int kTile = 64;                           // the block's output tile: kTile x kTile
constexpr int kThreads = 288;                       // two warpgroups, a half of the columns each,
                                                    // and a warp that issues the copies
constexpr int kAcc = kLimbs * 16;                   // accumulator registers of a thread
constexpr int kPlaneBytesA = kTile * kStepK;        // A's plane in a step: 64 rows of 32 bytes
constexpr int kPlaneBytesB = kTile / 2 * kStepK;    // B's plane of a warpgroup: 32 rows
constexpr int kHalfBytesB = kLimbs * kPlaneBytesB;  // a warpgroup's B: 256 rows
constexpr int kImageBytes = kLimbs * kPlaneBytesA;  // an operand's 64 rows in a step: 16 KB
constexpr int kGroup = 2;                           // steps a stage holds
constexpr int kStageBytes = 2 * kGroup * kImageBytes;
constexpr int kStages = 3;
constexpr int kAlign = 1024;
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + kAlign;  // + barriers, slack
constexpr int64_t kFoldK = 16384;  // k a block may sum: diagonal 3 stays below 2^32
static_assert(kStages >= 3, "the ring keeps a stage in the multiplier and one in flight");
static_assert(kSmemBytes <= 232448, "a block has 227 KB of shared memory");
static_assert(kFoldK % (kGroup * kStepK) == 0, "a part of K is whole stages");
static_assert(kGroup == 2, "split_tile_kernel writes a stage's two images");

// ------------------------------------------------------------ the limbs
// Byte offset, inside an image, of k32 byte ``kk`` of plane p of row r (0 ..
// 63): A's planes are tiles of 64 rows, B's of 32 (a warpgroup's half of the
// columns, its planes stacked from 7 down to 0; B's image is its two
// halves), every tile rows of 32 bytes with the 32-byte swizzle (address bit
// 4 ^= bit 7) on 256-byte boundaries.
__host__ __device__ constexpr uint32_t image_at(bool is_b, int r, int p, int kk) {
  const int t = is_b ? r & 31 : r;
  return (uint32_t)((is_b ? (r >> 5) * kHalfBytesB + (7 - p) * kPlaneBytesB : p * kPlaneBytesA) +
                    t * 32 + ((((kk >> 4) ^ (t >> 2)) & 1) << 4) + (kk & 15));
}

struct SplitParams {
  const void* ptr;          // the operand's first element
  int64_t s_b, s_row, s_k;  // its signed element strides over (batch, row, k)
  int64_t B, R, K, steps;   // batches, rows (M for A, N for B), k, k32 steps
  int32_t is_b;             // the image layout: B's (else A's)
  uint8_t* images;          // (B, ceil(R / 64), steps) images of kImageBytes
};

// An element as the 64 bits of its value: int8 and int32 sign-extended,
// uint8 zero-extended, int64 and uint64 as they are.
__device__ __forceinline__ uint64_t widen(int8_t v) { return (uint64_t)(int64_t)v; }
__device__ __forceinline__ uint64_t widen(uint8_t v) { return (uint64_t)v; }
__device__ __forceinline__ uint64_t widen(int32_t v) { return (uint64_t)(int64_t)v; }
__device__ __forceinline__ uint64_t widen(uint64_t v) { return v; }

// An operand whose k is the faster dimension: a warp takes 512 consecutive k
// of one row (rows padded to 64, zero past R and K), lane l the k = 32 i + l,
// so each load of the warp is 32 neighbouring elements and each plane's byte
// of them goes out as 32 neighbouring bytes.
template <typename E>
__global__ void __launch_bounds__(256) split_span_kernel(const __grid_constant__ SplitParams q) {
  const int64_t warp = ((int64_t)blockIdx.x * 256 + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t spans = (q.steps + 15) / 16, rows = (q.R + 63) / 64 * 64;
  if (warp >= q.B * rows * spans) return;
  const int64_t span = warp % spans, rest = warp / spans, row = rest % rows, bz = rest / rows;
  const E* const src = static_cast<const E*>(q.ptr) + bz * q.s_b + row * q.s_row;
  uint8_t* const image = q.images + ((bz * (rows / 64) + row / 64) * q.steps) * kImageBytes;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int64_t step = span * 16 + i, k = step * kStepK + lane;
    if (step >= q.steps) break;  // the warp stops together
    const uint64_t v = row < q.R && k < q.K ? widen(src[k * q.s_k]) : 0;
    uint8_t* const at = image + step * kImageBytes;
#pragma unroll
    for (int p = 0; p < kLimbs; ++p)
      at[image_at(q.is_b, (int)(row % 64), p, lane)] = (uint8_t)(v >> (8 * p));
  }
}

// Four words' bytes transposed: y[p] holds byte p of x[0], x[1], x[2], x[3].
__device__ __forceinline__ void transpose4(const uint32_t* x, uint32_t* y) {
  const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140), t1 = __byte_perm(x[0], x[1], 0x7362);
  const uint32_t t2 = __byte_perm(x[2], x[3], 0x5140), t3 = __byte_perm(x[2], x[3], 0x7362);
  y[0] = __byte_perm(t0, t2, 0x5410);
  y[1] = __byte_perm(t0, t2, 0x7632);
  y[2] = __byte_perm(t1, t3, 0x5410);
  y[3] = __byte_perm(t1, t3, 0x7632);
}

// Any other operand (a row-major B: n is the faster dimension): a block
// takes 64 rows x 64 k, the two images of a row tile's two steps (K is
// padded to whole stages of kGroup = 2 steps).  Thread t
// reads the 16 k from 16 (t / 64) of row t % 64 (each load of a warp is 32
// neighbouring rows), transposes their bytes into 16 bytes of each plane,
// and lays them out in shared memory as the images hold them; then the
// block writes the images out, 16 bytes a thread and pass.
template <typename E>
__global__ void __launch_bounds__(256) split_tile_kernel(const __grid_constant__ SplitParams q) {
  __shared__ __align__(16) uint8_t images[2 * kImageBytes];
  const int t = threadIdx.x, r = t % 64, kq = t / 64;
  const int64_t k_tiles = q.steps / 2, row_tiles = (q.R + 63) / 64;
  const int64_t kt = blockIdx.x % k_tiles, rest = blockIdx.x / k_tiles;
  const int64_t rt = rest % row_tiles, bz = rest / row_tiles, row = rt * 64 + r;
  const int64_t k0 = kt * 64 + 16 * kq;
  const E* const src = static_cast<const E*>(q.ptr) + bz * q.s_b + row * q.s_row;
  uint32_t lo[16], hi[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint64_t v = row < q.R && k0 + i < q.K ? widen(src[(k0 + i) * q.s_k]) : 0;
    lo[i] = (uint32_t)v, hi[i] = (uint32_t)(v >> 32);
  }
  uint32_t w[kLimbs][4];  // w[p][c]: plane p's bytes of k0 + 4c .. k0 + 4c + 3
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t y[4], z[4];
    transpose4(lo + 4 * c, y);
    transpose4(hi + 4 * c, z);
#pragma unroll
    for (int p = 0; p < 4; ++p) w[p][c] = y[p], w[4 + p][c] = z[p];
  }
  uint8_t* const mine = images + (kq >> 1) * kImageBytes;
#pragma unroll
  for (int p = 0; p < kLimbs; ++p)
    *reinterpret_cast<uint4*>(mine + image_at(q.is_b, r, p, 16 * (kq & 1))) =
        make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
  __syncthreads();
  uint8_t* const dst = q.images + ((bz * row_tiles + rt) * q.steps + 2 * kt) * kImageBytes;
  for (int i = t * 16; i < 2 * kImageBytes; i += 256 * 16)
    *reinterpret_cast<uint4*>(dst + i) = *reinterpret_cast<const uint4*>(images + i);
}

template <typename E>
int split(const SplitParams& q, cudaStream_t s) {
  const bool along_k = (q.s_k < 0 ? -q.s_k : q.s_k) <= (q.s_row < 0 ? -q.s_row : q.s_row);
  const int64_t row_tiles = (q.R + 63) / 64;
  const int64_t blocks = along_k ? (q.B * row_tiles * 64 * ((q.steps + 15) / 16) + 7) / 8
                                 : q.B * row_tiles * (q.steps / 2);
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  if (along_k)
    split_span_kernel<E><<<(unsigned)blocks, 256, 0, s>>>(q);
  else
    split_tile_kernel<E><<<(unsigned)blocks, 256, 0, s>>>(q);
  return (int)cudaGetLastError();
}

// The images of one operand: x's strides are over (b, m, k) for A and (b, k,
// n) for B; ``row`` is the dim that is not contracted (1 for A, 2 for B).
int split_operand(const MmOperand& x, int row, int64_t B, int64_t R, int64_t K, int64_t steps,
                  uint8_t* images, cudaStream_t s) {
  SplitParams q;
  q.ptr = x.ptr;
  q.s_b = x.strides[0], q.s_row = x.strides[row], q.s_k = x.strides[3 - row];
  q.B = B, q.R = R, q.K = K, q.steps = steps, q.is_b = row == 2, q.images = images;
  switch (x.dtype) {
    case SM_I8: return split<int8_t>(q, s);
    case SM_U8: return split<uint8_t>(q, s);
    case SM_I32: return split<int32_t>(q, s);
    case SM_I64: return split<uint64_t>(q, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ----------------------------------------------------------- the product
struct ProductParams {
  const uint8_t* a_images;  // (B, m_tiles, steps) images
  const uint8_t* b_images;  // (B, n_tiles, steps) images
  uint64_t* out;            // (B, M, N)
  int64_t M, N;
  int64_t steps;            // k32 steps of K
  int64_t part_steps;       // steps of one block's part of K
  int32_t m_tiles, n_tiles; // blockIdx.x = m tile * n_tiles + n tile
  int32_t add;              // parts of K add into the cleared output
};

// d[0 .. 16 (8 - I)) (64 x 32 (8 - I), s32) += A (64 x 32) * B (32 x 32 (8 -
// I)) (d = A * B when !scale_d): unsigned bytes, both K-major in shared
// memory with the 32-byte swizzle; wraps (no .satfinite).  The
// accumulator's columns 32 c .. 32 c + 31 are diagonal 7 - c, and B's
// planes are stacked from 7 down to 0, so the product of A's plane I with
// the stack from its block I on (B's planes 7 - I .. 0) lands on the
// diagonals 7 .. I: registers 0 .. 16 (8 - I) of a thread, the same first
// register for every width.
template <int I>
__device__ __forceinline__ void wgmma_limb(uint32_t* d, uint64_t desc_a, uint64_t desc_b, int scale_d);

#define SM_D4(i) "+r"(d[i]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3])
#define SM_D16(i) SM_D4(i), SM_D4((i) + 4), SM_D4((i) + 8), SM_D4((i) + 12)
#define SM_C0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define SM_C1 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define SM_C2 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define SM_C3 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define SM_C4 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define SM_C5 "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define SM_C6 "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
#define SM_C7 "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define SM_R1 SM_C0
#define SM_R2 SM_R1 ", " SM_C1
#define SM_R3 SM_R2 ", " SM_C2
#define SM_R4 SM_R3 ", " SM_C3
#define SM_R5 SM_R4 ", " SM_C4
#define SM_R6 SM_R5 ", " SM_C5
#define SM_R7 SM_R6 ", " SM_C6
#define SM_R8 SM_R7 ", " SM_C7
#define SM_WGMMA_LIMB(I, N, REGS, A, B, P, ...)                                              \
  template <>                                                                               \
  __device__ __forceinline__ void wgmma_limb<I>(uint32_t* d, uint64_t desc_a, uint64_t desc_b, \
                                                int scale_d) {                              \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                             \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.u8.u8 {" REGS "}, " A ", " B \
                 ", p;\n}\n"                                                                \
                 : __VA_ARGS__                                                              \
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d));                                 \
  }
SM_WGMMA_LIMB(0, 256, SM_R8, "%128", "%129", "%130", SM_D16(0), SM_D16(16), SM_D16(32), SM_D16(48), SM_D16(64), SM_D16(80), SM_D16(96), SM_D16(112))
SM_WGMMA_LIMB(1, 224, SM_R7, "%112", "%113", "%114", SM_D16(0), SM_D16(16), SM_D16(32), SM_D16(48), SM_D16(64), SM_D16(80), SM_D16(96))
SM_WGMMA_LIMB(2, 192, SM_R6, "%96", "%97", "%98", SM_D16(0), SM_D16(16), SM_D16(32), SM_D16(48), SM_D16(64), SM_D16(80))
SM_WGMMA_LIMB(3, 160, SM_R5, "%80", "%81", "%82", SM_D16(0), SM_D16(16), SM_D16(32), SM_D16(48), SM_D16(64))
SM_WGMMA_LIMB(4, 128, SM_R4, "%64", "%65", "%66", SM_D16(0), SM_D16(16), SM_D16(32), SM_D16(48))
SM_WGMMA_LIMB(5, 96, SM_R3, "%48", "%49", "%50", SM_D16(0), SM_D16(16), SM_D16(32))
SM_WGMMA_LIMB(6, 64, SM_R2, "%32", "%33", "%34", SM_D16(0), SM_D16(16))
SM_WGMMA_LIMB(7, 32, SM_R1, "%16", "%17", "%18", SM_D16(0))
#undef SM_WGMMA_LIMB
#undef SM_R1
#undef SM_R2
#undef SM_R3
#undef SM_R4
#undef SM_R5
#undef SM_R6
#undef SM_R7
#undef SM_R8
#undef SM_C0
#undef SM_C1
#undef SM_C2
#undef SM_C3
#undef SM_C4
#undef SM_C5
#undef SM_C6
#undef SM_C7
#undef SM_D16
#undef SM_D4

// Keeps the compiler from moving accumulator registers across the
// asynchronous multiplies.
__device__ __forceinline__ void fence_accumulator(uint32_t* d) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The shared-memory matrix descriptor of a K-major tile with the 32-byte
// swizzle: rows of 32 bytes (one k32 of one plane), 256 bytes from one group
// of 8 rows to the next; the leading offset is not used.
__device__ __forceinline__ uint64_t desc32(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(256 >> 4) << 32) |
         (3ull << 62);
}

// The products of one step (one k32 of each plane) for a warpgroup: A's plane
// I times B's planes 7 - I .. 0, for I = 0..7.  ``first``: the block's first
// step, whose first product (plane 0, every diagonal) overwrites what the
// registers held.
template <int I = 0>
__device__ __forceinline__ void multiply(uint32_t (&acc)[kAcc], uint32_t a_image, uint32_t b_stack,
                                         bool first) {
  wgmma_limb<I>(acc, desc32(a_image + I * kPlaneBytesA), desc32(b_stack + I * kPlaneBytesB),
                !(first && I == 0));
  if constexpr (I < 7) multiply<I + 1>(acc, a_image, b_stack, first);
}

// The mbarrier of a stage: armed for the bytes of its two copies, which the
// copy engine counts down as they land.
__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// ``bytes`` from global ``src`` to shared ``dst`` by the copy engine, counted
// on ``bar``.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

}  // namespace

__global__ void __launch_bounds__(kThreads, 1)
    mm_wgmma_i64_kernel(const __grid_constant__ ProductParams q) {
  extern __shared__ uint8_t smem_raw[];
  // The swizzle is a function of the address: images start on 256 bytes.
  const uint32_t skew = (kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1);
  const uint32_t ring = smem_u32(smem_raw) + skew;
  const uint32_t full = ring + kStages * kStageBytes, empty = full + kStages * 8;

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffff, tid >> 7, 0);  // known uniform across the warp
  const int64_t mt = blockIdx.x / q.n_tiles, nt = blockIdx.x % q.n_tiles;
  const int64_t bz = blockIdx.z;
  const int64_t step0 = (int64_t)blockIdx.y * q.part_steps;
  const int64_t n_groups = (q.steps - step0 < q.part_steps ? q.steps - step0 : q.part_steps) / kGroup;
  const uint8_t* const a_src = q.a_images + ((bz * q.m_tiles + mt) * q.steps + step0) * kImageBytes;
  const uint8_t* const b_src = q.b_images + ((bz * q.n_tiles + nt) * q.steps + step0) * kImageBytes;
  // The producer warp fills the ring: group g (kGroup steps) into stage g %
  // kStages, once the consumers have released what it held.
  uint32_t acc[kAcc];  // not cleared: the block's first products overwrite it
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + s * 8, 1);
      bar_init(empty + s * 8, kThreads / 32 - 1);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg == 2) {  // the producer warp
    if (tid == 256) {
      for (int64_t g = 0; g < n_groups; ++g) {
        const uint32_t slot = (uint32_t)(g % kStages);
        if (g >= kStages) bar_wait(empty + slot * 8, (uint32_t)(g / kStages - 1) & 1);
        const uint32_t at = ring + slot * kStageBytes, bar = full + slot * 8;
        bar_expect(bar, kStageBytes);
        bulk_copy(at, a_src + g * kGroup * kImageBytes, kGroup * kImageBytes, bar);
        bulk_copy(at + kGroup * kImageBytes, b_src + g * kGroup * kImageBytes, kGroup * kImageBytes,
                  bar);
      }
    }
    return;
  }
  for (int64_t g = 0; g < n_groups; ++g) {
    const uint32_t slot = (uint32_t)(g % kStages);
    bar_wait(full + slot * 8, (uint32_t)(g / kStages) & 1);
    const uint32_t a_image = ring + slot * kStageBytes;
    fence_accumulator(acc);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      multiply(acc, a_image + u * kImageBytes, a_image + (kGroup + u) * kImageBytes + wg * kHalfBytesB,
               g == 0 && u == 0);
    wgmma_commit();
    fence_accumulator(acc);
    wgmma_wait<1>();  // group g - 1's products are done; group g's run on
    // This warp is done with group g - 1's stage.
    if (g >= 1 && (tid & 31) == 0) bar_arrive(empty + (uint32_t)((g - 1) % kStages) * 8);
  }
  wgmma_wait<0>();
  fence_accumulator(acc);

  // The fold.  Register 16 (7 - d) + 4 j + 2 h + e of a thread is diagonal d
  // of the element at row 16 * warp + lane / 4 + 8 h, column 8 j + 2 (lane %
  // 4) + e of the warpgroup's 64 x 32 half of the tile.
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  uint64_t* const out = q.out + bz * q.M * q.N;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = mt * kTile + 16 * warp + (lane >> 2) + 8 * h;
      const int64_t n = nt * kTile + 32 * wg + 8 * j + 2 * (lane & 3);
      uint64_t v[2] = {0, 0};
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int d = 0; d < 8; ++d) v[e] += (uint64_t)acc[16 * (7 - d) + 4 * j + 2 * h + e] << (8 * d);
      if (m >= q.M || n >= q.N) continue;
      uint64_t* const at = out + m * q.N + n;
      const bool both = n + 1 < q.N;
      if (q.add) {
        atomicAdd(reinterpret_cast<unsigned long long*>(at), (unsigned long long)v[0]);
        if (both) atomicAdd(reinterpret_cast<unsigned long long*>(at + 1), (unsigned long long)v[1]);
      } else if (both && (reinterpret_cast<uintptr_t>(at) & 15) == 0) {
        *reinterpret_cast<ulonglong2*>(at) = make_ulonglong2(v[0], v[1]);
      } else {
        at[0] = v[0];
        if (both) at[1] = v[1];
      }
    }
  }
}

namespace {

int sm_count() {
  static int count = 0;
  if (!count) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

int64_t tiles_of(int64_t rows) { return (rows + kTile - 1) / kTile; }
int64_t steps_of(int64_t K) { return (K + kGroup * kStepK - 1) / (kGroup * kStepK) * kGroup; }

}  // namespace

// Bytes of scratch the 64-bit product of (B, M, K) @ (B, K, N) needs: the
// images of A, then those of B.
extern "C" long long sm_mm_wgmma_i64_scratch(long long B, long long M, long long N, long long K) {
  return (long long)(B * (tiles_of(M) + tiles_of(N)) * steps_of(K) * kImageBytes);
}

// The 64-bit product of q->a and q->b into the contiguous (B, M, N) int64
// ``out``, through ``scratch`` (sm_mm_wgmma_i64_scratch bytes, 16-byte
// aligned).  B <= 65535.
extern "C" int sm_mm_wgmma_i64_launch(const MmParams* q, void* out, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto takes = [](int32_t d) { return d == SM_I8 || d == SM_U8 || d == SM_I32 || d == SM_I64; };
  if (!takes(q->a.dtype) || !takes(q->b.dtype) || q->epilogue || q->int_acc != 2 ||
      (reinterpret_cast<uintptr_t>(scratch) & 15))
    return (int)cudaErrorInvalidValue;
  const int64_t steps = steps_of(q->K), m_tiles = tiles_of(q->M), n_tiles = tiles_of(q->N);
  uint8_t* const a_images = static_cast<uint8_t*>(scratch);
  uint8_t* const b_images = a_images + q->B * m_tiles * steps * kImageBytes;
  int rc = split_operand(q->a, 1, q->B, q->M, q->K, steps, a_images, s);
  if (rc == 0) rc = split_operand(q->b, 2, q->B, q->N, q->K, steps, b_images, s);
  if (rc != 0) return rc;

  // Parts of K: at most kFoldK each, and halved while fewer than half the
  // SMs would have a block and a part keeps at least 8 steps.
  const int64_t tiles = m_tiles * n_tiles * q->B;
  int64_t part = steps < kFoldK / kStepK ? steps : kFoldK / kStepK;
  int64_t parts = (steps + part - 1) / part;
  while (2 * tiles * parts <= sm_count() && part >= 16) {
    part = (part / 2 + kGroup - 1) / kGroup * kGroup;
    parts = (steps + part - 1) / part;
  }
  if (m_tiles * n_tiles > 0x7FFFFFFF || parts > 65535) return (int)cudaErrorInvalidValue;
  ProductParams p;
  p.a_images = a_images, p.b_images = b_images, p.out = static_cast<uint64_t*>(out);
  p.M = q->M, p.N = q->N, p.steps = steps, p.part_steps = part;
  p.m_tiles = (int32_t)m_tiles, p.n_tiles = (int32_t)n_tiles, p.add = parts > 1;
  if (p.add) {
    const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)(q->B * q->M * q->N) * 8, s);
    if (e != cudaSuccess) return (int)e;
  }
  const cudaError_t e = cudaFuncSetAttribute(mm_wgmma_i64_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(m_tiles * n_tiles), (unsigned)parts, (unsigned)q->B);
  mm_wgmma_i64_kernel<<<grid, kThreads, kSmemBytes, s>>>(p);
  return (int)cudaGetLastError();
}
