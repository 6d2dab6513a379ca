// The int8 tensor-core matmul kernel's body (matmul_wgmma_s8.cu has the
// design and the launcher), templated on its epilogue E (matmul.cuh), so
// that nvcc builds it with the interpreter and NVRTC with a generated
// epilogue (ops/codegen.py, kind "matmul").  Device code alone.
#pragma once

#include "wgmma.cuh"

using namespace sm_wgmma;

namespace {

constexpr int kBK = kRowBytes;  // k of one step: a 128-byte tile row of bytes

// Keeps the compiler from moving accumulator registers across the
// asynchronous multiplies.
__device__ __forceinline__ void fence_accumulator(uint32_t* d) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define SM_D4(i) "+r"(d[i]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3])
#define SM_D16(i) SM_D4(i), SM_D4((i) + 4), SM_D4((i) + 8), SM_D4((i) + 12)
#define SM_D128                                                                  \
  SM_D16(0), SM_D16(16), SM_D16(32), SM_D16(48), SM_D16(64), SM_D16(80), SM_D16(96), \
      SM_D16(112)

// d (64 x 256, s32) = A (64 x 32) * B (32 x 256) (+ d when ``scale_d``),
// both 1-byte integers, K-major in shared memory; wraps (no .satfinite).
#define SM_WGMMA_S8(NAME, ATYPE, BTYPE)                                                   \
  __device__ __forceinline__ void NAME(uint32_t* d, uint64_t desc_a, uint64_t desc_b, int scale_d) {   \
    asm volatile(                                                                         \
        "{\n"                                                                             \
        ".reg .pred p;\n"                                                                 \
        "setp.ne.b32 p, %130, 0;\n"                                                       \
        "wgmma.mma_async.sync.aligned.m64n256k32.s32." ATYPE "." BTYPE " "                \
        SM_ACC_LIST                                                                       \
        "%128, %129, p;\n"                                                                \
        "}\n"                                                                             \
        : SM_D128                                                                         \
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));                                              \
  }
#define SM_ACC_LIST \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
SM_WGMMA_S8(wgmma_s8s8, "s8", "s8")
SM_WGMMA_S8(wgmma_s8u8, "s8", "u8")
SM_WGMMA_S8(wgmma_u8s8, "u8", "s8")
SM_WGMMA_S8(wgmma_u8u8, "u8", "u8")
#undef SM_ACC_LIST
#undef SM_WGMMA_S8
#undef SM_D128
#undef SM_D16
#undef SM_D4

template <bool A_SIGNED, bool B_SIGNED>
__device__ __forceinline__ void wgmma_m64n256k32(uint32_t* d, uint64_t desc_a, uint64_t desc_b, int scale_d) {
  if (A_SIGNED)
    B_SIGNED ? wgmma_s8s8(d, desc_a, desc_b, scale_d) : wgmma_s8u8(d, desc_a, desc_b, scale_d);
  else
    B_SIGNED ? wgmma_u8s8(d, desc_a, desc_b, scale_d) : wgmma_u8u8(d, desc_a, desc_b, scale_d);
}

// ------------------------------------------------- the transposing stage
// A thread's part in staging an operand whose mn is contiguous in memory:
// warp w takes the 16 k rows from 16 * w, lane (kq = lane / 8, nn = lane %
// 8) the four rows from 4 * kq of them, and of each the 16 bytes of mn from
// 16 * nn of every block of 128 mn (one block for A, two for B).  The plan
// lives in a ChunkPlan: ``src`` the first of its rows in the coming step,
// ``per_chunk`` the bytes from one k row to the next, ``dst`` the lane's
// part of its words' offsets in the tile, ``inside`` the bytes (0..16) of
// its 16 that lie inside the matrix along mn, a byte for each block.
template <int ROWS>
__device__ __forceinline__ ChunkPlan<uint8_t> plan_transpose(const MmOperand& x, int64_t base, int64_t s_k,
                                                    int64_t mn0, int64_t MN, int tid) {
  const int lane = tid & 31, kc = tid >> 5;
  const int kq = lane >> 3, nn = lane & 7;
  ChunkPlan<uint8_t> c;
  c.k = 16 * kc + 4 * kq;
  c.src = static_cast<const uint8_t*>(x.ptr) + base + (mn0 + 16 * nn) + c.k * s_k;
  c.per_chunk = s_k;
  c.per_step = kBK * s_k;
  // Word j of the lane is four k of mn = 16 * nn + j: row mn of the tile,
  // chunk kc ^ (mn & 7), bytes 4 * kq on.  The lane stores word j ^ nn at
  // instruction j; the bits of j are put in by XOR (transpose_tile).
  c.dst = (nn << 11) | (nn << 7) | ((kc ^ nn) << 4) | (kq << 2);
  c.inside = 0;
#pragma unroll
  for (int u = 0; u < ROWS / 128; ++u) {
    const int64_t left = MN - (mn0 + 128 * u + 16 * nn);
    c.inside |= (left >= 16 ? 16 : (left > 0 ? (int)left : 0)) << (8 * u);
  }
  return c;
}

// 16 bytes at ``src`` (16-byte aligned), of which the first ``valid`` lie
// inside the matrix; the rest read as zero and are not touched.
__device__ __forceinline__ uint4 load16_inside(const uint8_t* src, int valid) {
  if (valid == 16) return *reinterpret_cast<const uint4*>(src);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < valid; ++i) w[i >> 2] |= (uint32_t)src[i] << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t selector) {
  return __byte_perm(a, b, selector);
}

// The loads of one step's ROWS x 128 tile of an mn-contiguous operand into
// ``held`` (zero outside the matrix); moves the plan on to the next step.
// ``k_left`` is K minus the step's first k.
template <int ROWS>
__device__ __forceinline__ void transpose_load(ChunkPlan<uint8_t>& c, int64_t k_left,
                                               uint4 (&held)[ROWS / 128][4]) {
  const int64_t rows_left = k_left - c.k;  // of the lane's four k rows, those inside K
#pragma unroll
  for (int u = 0; u < ROWS / 128; ++u) {
    const int valid = (c.inside >> (8 * u)) & 0xFF;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      held[u][i] = make_uint4(0u, 0u, 0u, 0u);
      if (i < rows_left && valid) held[u][i] = load16_inside(c.src + 128 * u + i * c.per_chunk, valid);
    }
  }
  c.src += c.per_step;
}

// What transpose_load read, transposed into the K-major tile at ``tile``.
template <int ROWS>
__device__ __forceinline__ void transpose_store(const ChunkPlan<uint8_t>& c,
                                                const uint4 (&held)[ROWS / 128][4], uint8_t* tile) {
  const int nn = threadIdx.x & 7;
  // Word j ^ nn instead of word j.  Bits 0 and 1 of nn pick another byte of
  // each loaded word: they go into the selectors of the first prmt stage
  // (pair p of a 4 x 4 block: bytes 2 * (p ^ r1) + (r0, 1 ^ r0) of two
  // rows, interleaved).  Bit 2 swaps neighbouring words of a load.
  const uint32_t r0 = nn & 1, r1 = (nn >> 1) & 1;
  const bool r2 = nn & 4;
  uint32_t sel[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint32_t x0 = 2 * (p ^ r1) + r0, x1 = 2 * (p ^ r1) + (1 ^ r0);
    sel[p] = x0 | ((4 + x0) << 4) | (x1 << 8) | ((4 + x1) << 12);
  }
#pragma unroll
  for (int u = 0; u < ROWS / 128; ++u) {
    uint32_t w[4][4];  // [k row][word of 4 mn]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 v = held[u][i];
      w[i][0] = r2 ? v.y : v.x;
      w[i][1] = r2 ? v.x : v.y;
      w[i][2] = r2 ? v.w : v.z;
      w[i][3] = r2 ? v.z : v.w;
    }
    uint8_t* const block = tile + (u << 14);  // 128 rows of 128 bytes
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint32_t lo = prmt(w[0][g], w[1][g], sel[p]);  // k 0, 1 of two mn
        const uint32_t hi = prmt(w[2][g], w[3][g], sel[p]);  // k 2, 3 of the same
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = 4 * g + 2 * p + t;
          const uint32_t cj = (j << 7) | ((j & 7) << 4);
          *reinterpret_cast<uint32_t*>(block + (c.dst ^ cj)) = prmt(lo, hi, t ? 0x7632 : 0x5410);
        }
      }
    }
  }
}

}  // namespace

// How an operand comes into its tile: 16-byte copies, transposed on the
// way in, or byte by byte (ops/matmul.py::staging), as MmOperand says;
// kWayAny: read from the parameter block at run time.
enum S8Way { kWayCopy = 0, kWayTranspose = 1, kWayBytes = 2, kWayAny = 3 };

__device__ __forceinline__ int s8_way(const MmOperand& x) {
  return x.vec16 ? (x.inner_fast ? kWayCopy : kWayTranspose) : kWayBytes;
}

// WAY_A, WAY_B: each operand's way in, fixed in a kernel generated for
// an epilogue (its signature's layout), so that it holds neither the
// registers nor the code of the other ways: with the dequantizing
// epilogue, 198 registers and no stack, against 250 and 16 bytes of stack
// with all three ways in (ptxas of CUDA 12.9, sm_90a).
template <bool A_SIGNED, bool B_SIGNED, int WAY_A, int WAY_B, typename E>
__device__ __forceinline__ void mm_wgmma_s8_body(const MmParams& q, void* __restrict__ out) {
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
  // How each operand comes in: copied (cp.async), transposed, or byte by byte.
  const int way_a = WAY_A == kWayAny ? s8_way(q.a) : WAY_A;
  const int way_b = WAY_B == kWayAny ? s8_way(q.b) : WAY_B;
  const bool copy_a = way_a == kWayCopy, copy_b = way_b == kWayCopy;
  // cp.async's writes are seen by wgmma once their group has been waited
  // for; ordinary stores need the proxy fence on top.
  const bool stores = !(copy_a && copy_b);

  // B is (b, k, n): its mn stride is its last.
  ChunkPlan<uint8_t> plan_a, plan_b;
  if (copy_a)
    plan_a = plan_chunks<true, kBM, uint8_t>(q.a, base_a, q.a.strides[1], q.a.strides[2], m0, q.M, tid);
  else
    plan_a = plan_transpose<kBM>(q.a, base_a, q.a.strides[2], m0, q.M, tid);
  if (copy_b)
    plan_b = plan_chunks<true, kBN, uint8_t>(q.b, base_b, q.b.strides[2], q.b.strides[1], n0, q.N, tid);
  else
    plan_b = plan_transpose<kBN>(q.b, base_b, q.b.strides[1], n0, q.N, tid);
  // A transposed operand's loads run one step ahead of its stores: what
  // ``held_*`` holds was asked for a whole step of the K loop earlier.
  const bool turn_a = way_a == kWayTranspose, turn_b = way_b == kWayTranspose;
  uint4 held_a[kBM / 128][4], held_b[kBN / 128][4];
  if (turn_a) transpose_load<kBM>(plan_a, q.K, held_a);
  if (turn_b) transpose_load<kBN>(plan_b, q.K, held_b);
  // Steps are staged in ascending order, each once.
  auto stage = [&](int step) {
    const uint32_t off = (uint32_t)(step % kStages) * kStageBytes;
    const int64_t k0 = (int64_t)step * kBK;
    const bool more = step + 1 < n_steps;
    if (copy_a) {
      copy_chunks<true, kBM, uint8_t>(plan_a, q.a.ptr, ring + off, q.K - k0);
    } else if (turn_a) {
      transpose_store<kBM>(plan_a, held_a, ring_ptr + off);
      if (more) transpose_load<kBM>(plan_a, q.K - k0 - kBK, held_a);
    } else if (q.a.inner_fast) {
      copy_elements<true, kBM, uint8_t, true>(q.a, base_a, q.a.strides[1], q.a.strides[2], m0, q.M,
                                              k0, q.K, ring_ptr + off, tid);
    } else {
      copy_elements<true, kBM, uint8_t, false>(q.a, base_a, q.a.strides[1], q.a.strides[2], m0, q.M,
                                               k0, q.K, ring_ptr + off, tid);
    }
    if (copy_b) {
      copy_chunks<true, kBN, uint8_t>(plan_b, q.b.ptr, ring + off + kTileBytesA, q.K - k0);
    } else if (turn_b) {
      transpose_store<kBN>(plan_b, held_b, ring_ptr + off + kTileBytesA);
      if (more) transpose_load<kBN>(plan_b, q.K - k0 - kBK, held_b);
    } else if (q.b.inner_fast) {
      copy_elements<true, kBN, uint8_t, true>(q.b, base_b, q.b.strides[2], q.b.strides[1], n0, q.N,
                                              k0, q.K, ring_ptr + off + kTileBytesA, tid);
    } else {
      copy_elements<true, kBN, uint8_t, false>(q.b, base_b, q.b.strides[2], q.b.strides[1], n0, q.N,
                                               k0, q.K, ring_ptr + off + kTileBytesA, tid);
    }
  };

  // Not cleared: the first multiply of the first step overwrites it
  // (scale-d 0).  Zeros written here made ptxas wait for every wgmma before
  // it issued the next ("serialized ... defining accumulator registers").
  uint32_t acc[kAcc];

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
    for (int ks = 0; ks < kBK / 32; ++ks) {
      wgmma_m64n256k32<A_SIGNED, B_SIGNED>(acc, tile_desc<true>(a_tile + step_offset<true>(half, ks)),
                                           tile_desc<true>(b_tile + step_offset<true>(0, ks)),
                                           (step | ks) != 0);
    }
    wgmma_commit();
    fence_accumulator(acc);
    if (step + kStages - 2 < n_steps) stage(step + kStages - 2);
    cp_async_commit();
    wgmma_wait<1>();  // the multiplies of step - 1 are done; this step's run on
  }
  wgmma_wait<0>();
  fence_accumulator(acc);

  store_tile<E>(q, out, acc, ring_ptr, tid, bz, m0, n0);
}
