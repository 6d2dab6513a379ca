// The CUDA-core matmul kernel for Hopper (sm_90a): float32, mixed
// float32/bfloat16 and integer operands of which one is int32, and every
// integer product whose result is int64 or uint64.  bfloat16 @ bfloat16
// takes the tensor-core kernel of matmul_wgmma.cu and int8/uint8 pairs that
// of matmul_wgmma_s8.cu instead; the wrapper routes by the operands' types
// alone, never by shape, stride or size.
//
// Replaces the JAX package's two Pallas matmul kernels, both in
// simplemath_tpu/ops/matmul.py:
//   mm_kernel, one batch  <- _build_matmul (:134, body _matmul_kernel :49)
//   mm_kernel, batch grid <- _build_bmm    (:209, body _bmm_kernel :85)
// with the fused epilogue of ops/fusion.py::materialize_matmul on top, and
// the 64-bit integer products the JAX package leaves to jnp.dot /
// jnp.matmul (simplemath_tpu/ops/engine.py).
//
// What it computes: out[b] = epilogue(A[b] @ B[b], extras...) for
// (B, M, K) @ (B, K, N); rank 2 is B = 1.  Three accumulators:
//   f32 (float32 and bfloat16 operands, each read by its own type and
//       widened at the load, so a bf16 factor enters exactly and only the
//       sum rounds): every output element is one thread's chain of
//       __fmaf_rn from 0 in ascending k, the k padded to a multiple of 16
//       with zeros;
//   i32 (int8, uint8, int32 operands): uint32_t, wrapping mod 2^32;
//   i64 (any of those and int64/uint64, sign- or zero-extended at the
//       load): uint64_t, wrapping mod 2^64 as XLA's int64 dot does.  It
//       takes no epilogue (the wrapper refuses one).
// Integer sums are exact in any order.  The epilogue is the elementwise
// kernel's opcode program (program.cuh) with register 0 holding the
// accumulator and the other operand registers the extras, run on four
// adjacent columns per dispatch (mm_epilogue4_at), so it gives the values
// ew_strided would give on the stored product, without storing it.  The
// result is cast to the output type at the store (f32 -> bf16 rounds to
// nearest even).
//
// How the TPU kernel's parts translate.  Its sequential K grid dimension
// with a VMEM accumulator becomes a K loop inside the block with the
// accumulator in registers: a block of 256 threads owns a 128 x 128 output
// tile, each thread an 8 x 8 register tile (rows 4t..4t+3 and 64+4t..,
// columns likewise), and walks K through a ring of kStages shared-memory
// stages of 128 bytes of k for A and for B (32 k of 4-byte values, 16 of
// 8-byte ones).  The TPU wrapper's zero padding is gone: A, B and every
// extra are read in place through signed element strides (a transposed or
// negative-step view costs no copy), and the ragged edge is zero-filled at
// the load and masked at the store.  No split-K and no atomics: two
// launches give the same bits.
//
// What bounds it on an H100: operations.  2048^3 is 17.2 GFLOP over 48 MB,
// so at the f32 rate of the CUDA cores (67 TFLOP/s: 0.256 ms) the bytes
// (14 us at 3.35 TB/s) are far from the limit; a product with an int32 or
// a 64-bit operand has no tensor-core instruction, and f32 operands on the
// tensor cores would be truncated, which "default" precision does not
// allow.  So the design keeps the multiply-adds fed:
//   - tiles reach shared memory by 16-byte cp.async copies, kStages - 1
//     steps ahead, with no register in between (the copy path: an operand
//     whose fast dimension has stride 1, other strides multiples of 4
//     elements and a 16-byte-aligned base, ops/matmul.py::staging); any
//     other operand (a view, a bf16 operand of a mixed pair, an int8 one
//     beside an int32 one, every operand of the 64-bit product) is read
//     element by element through its strides into the same layout, so a
//     view and its contiguous clone give the same bits.  Those loads are
//     kStages - 1 steps ahead too: issued into registers before a step's
//     multiply-adds and stored after them, with the operand type's dispatch
//     taken once per stage.  Only the kernels built for such an operand
//     (ELEM) hold those registers and that code.  (f32 2048^3 with both
//     operands copied: 0.475 ms, against 0.493 when one kernel held both
//     paths and stored each element as soon as it was loaded; an operand 4
//     bytes off: 0.560 against 0.731.  H100 SXM, 700 W.);
//   - a tile is K-major (rows of mn, 128 bytes of k each) or MN-major (rows
//     of k), whichever its operand's copy lands as (four instantiations,
//     each with and without ELEM).
//     The inner loop reads 16 bytes at a time either way: MN-major, the
//     four adjacent rows of a thread at one k; K-major, four k of one row,
//     the row's 16-byte chunk q stored at q ^ ((row / 4) % 8).  Bank
//     arithmetic: a warp is 8 threads along N by 4 along M.  An A read is
//     4 distinct 16-byte addresses (the 8 threads of a row of the warp
//     broadcast): MN-major they are adjacent (64 bytes), K-major rows 4t..
//     of 4 consecutive t put their chunks at 4 distinct positions of the
//     128-byte row (the swizzle), so 4 x 4 banks; a B read is 8 addresses,
//     MN-major 128 adjacent bytes, K-major 8 distinct chunk positions.  One
//     shared-memory wavefront a read, none repeated;
//   - one block an SM with a ring of four stages (128 KB), so that a thread
//     may hold its 64 accumulators and two fragments in up to 255 registers
//     without spilling; when both tiles are K-major a fragment is two k
//     deep, else four.  One __syncthreads a step.  (Two blocks an SM, three
//     stages each, cap a thread at 128 registers: ptxas spilled 368-488
//     bytes and f32 2048^3 took 0.508-0.511 ms against 0.4956 for this
//     layout; with fragments two k deep throughout, 0.507.  H100 SXM,
//     700 W.)
//   - the epilogue dispatches once per four columns, and a row of four
//     results goes out as one 16-byte (f32, int32) or 8-byte (bf16) store
//     where the output's rows allow it.
//
// Built with --fmad=false like the other sources, so the epilogue rounds
// once per operation; the inner product asks for its fused multiply-add by
// name (__fmaf_rn).
//
// Launch: on the caller's stream; allocates nothing; returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#pragma once

#include "wgmma.cuh"  // MmParams, and the cp.async helpers of the tensor-core kernels

namespace {

using sm_wgmma::cp_async16;
using sm_wgmma::cp_async_commit;
using sm_wgmma::cp_async_wait;
using sm_wgmma::smem_u32;

enum MmKind { kF32 = 0, kI32 = 1, kI64 = 2 };  // MmParams::int_acc

constexpr int kBM = 128, kBN = 128;
constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kTileBytes = 128 * 128;  // 128 mn x 128 bytes of k
constexpr int kSmemBytes = kStages * 2 * kTileBytes;
static_assert(kStages >= 3, "copies run two steps ahead");
static_assert(kSmemBytes + 1024 <= 233472, "the ring fits an SM's shared memory");

template <int KIND>
struct Kind {
  using T = uint32_t;  // an element in shared memory and an accumulator: f32 bits or int32
};
template <>
struct Kind<kI64> {
  using T = uint64_t;
};

template <int KIND>
__device__ __forceinline__ typename Kind<KIND>::T mm_madd(typename Kind<KIND>::T a,
                                                          typename Kind<KIND>::T b,
                                                          typename Kind<KIND>::T c) {
  if constexpr (KIND == kF32)
    return sm_u(__fmaf_rn(sm_f(a), sm_f(b), sm_f(c)));
  else
    return c + a * b;
}

// Row (or column) of the block tile that register row ``i`` (0..7) of
// thread row ``t`` (0..15) holds: 4t..4t+3, then 64+4t..64+4t+3.
__device__ __forceinline__ int mm_row(int t, int i) { return (i & 4) * 16 + 4 * t + (i & 3); }

// Offset in elements, inside a tile of T, of element (mn, k).
template <bool KMAJOR, typename T>
__device__ __forceinline__ int tile_at(int mn, int k) {
  constexpr int kChunk = 16 / sizeof(T), kBK = 128 / sizeof(T);
  if (KMAJOR) return mn * kBK + (((k / kChunk) ^ ((mn >> 2) & 7)) * kChunk) + (k % kChunk);
  return k * 128 + mn;
}

// Two or four adjacent elements from shared memory, in one load.
__device__ __forceinline__ void lds(const uint32_t* p, uint32_t (&v)[4]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void lds(const uint32_t* p, uint32_t (&v)[2]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  v[0] = x.x, v[1] = x.y;
}
__device__ __forceinline__ void lds(const uint64_t* p, uint64_t (&v)[4]) {
  const ulonglong2 x = *reinterpret_cast<const ulonglong2*>(p);
  const ulonglong2 y = *reinterpret_cast<const ulonglong2*>(p + 2);
  v[0] = x.x, v[1] = x.y, v[2] = y.x, v[3] = y.y;
}

// The thread's fragment of one tile: f[i][kk] is element (mm_row(t, i),
// k + kk), for KG consecutive k (k a multiple of KG).
template <bool KMAJOR, int KG, typename T>
__device__ __forceinline__ void load_frag(const T* tile, int t, int k, T (&f)[8][KG]) {
  if constexpr (KMAJOR) {
#pragma unroll
    for (int i = 0; i < 8; ++i) lds(tile + tile_at<true, T>(mm_row(t, i), k), f[i]);
  } else {
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) {
      T v[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lds(tile + (k + kk) * 128 + 64 * h + 4 * t, v);
#pragma unroll
        for (int i = 0; i < 4; ++i) f[4 * h + i][kk] = v[i];
      }
    }
  }
}

// Fills the tile at ``tile`` with the step's 128 mn x 128 bytes of k (k
// from k0) of operand A (IS_A; mn = m) or B (mn = n), when the operand is
// copied 16 bytes at a time (MmOperand::vec16): cp.async copies, whose
// source size zero-fills what lies past the edge.  Everything it needs is
// read from the parameter block, which is in constant memory, so that no
// register holds it across the K loop.
template <bool IS_A, bool KMAJOR, typename T>
__device__ __forceinline__ void copy(const MmParams& q, T* tile, int64_t k0, int tid) {
  constexpr int kChunk = 16 / sizeof(T);
  const MmOperand& x = IS_A ? q.a : q.b;
  const int64_t s_mn = x.strides[IS_A ? 1 : 2], s_k = x.strides[IS_A ? 2 : 1];
  const int64_t mn0 = (int64_t)(IS_A ? blockIdx.y : blockIdx.x) * 128;
  const int64_t MN = IS_A ? q.M : q.N;
  const T* const src = static_cast<const T*>(x.ptr) + (int64_t)blockIdx.z * x.strides[0];
  const uint32_t dst = smem_u32(tile);
#pragma unroll
  for (int i = 0; i < kTileBytes / 16 / kThreads; ++i) {
    const int c = tid + i * kThreads;
    int mn, k;
    if (KMAJOR) {  // 8 chunks of k to a row of mn
      mn = c >> 3, k = (c & 7) * kChunk;
    } else {  // 128 / kChunk chunks of mn to a row of k
      mn = (c % (128 / kChunk)) * kChunk, k = c / (128 / kChunk);
    }
    const int64_t gmn = mn0 + mn, gk = k0 + k;
    const int64_t left = KMAJOR ? q.K - gk : MN - gmn;
    const bool inside = KMAJOR ? gmn < MN : gk < q.K;
    const int bytes = inside && left > 0 ? (left < kChunk ? (int)left : kChunk) * (int)sizeof(T) : 0;
    const T* from = bytes ? src + gmn * s_mn + gk * s_k : src;
    cp_async16(dst + tile_at<KMAJOR, T>(mn, k) * (int)sizeof(T), from, bytes);
  }
}

// The element path, for an operand that is not copied: kEach<T> elements a
// thread and stage, read through the signed strides and widened to T
// (fetch), then stored into the tile's layout (put).  The threads walk the
// operand's faster dimension (along k, else along mn), so a warp's loads
// are adjacent in memory; element i of a thread is element 0 moved i *
// kThreads / 128 (along k: kThreads / kBK) rows along the other dimension,
// so its offset is one add from the last.
template <typename T>
constexpr int kEach = 128 * (128 / (int)sizeof(T)) / kThreads;

struct Walk {
  int64_t off, step;  // offset of element 0, and from one element to the next
  int64_t room;       // elements 0 .. room - 1 lie inside the matrix (when ok)
  int mn, k, dmn, dk; // tile coordinates of element 0 and the step between
  bool ok;            // element 0's fixed coordinate lies inside the matrix
};

template <bool IS_A, typename T>
__device__ __forceinline__ Walk walk(const MmParams& q, int64_t k0, int tid) {
  constexpr int kBK = 128 / sizeof(T);
  const MmOperand& x = IS_A ? q.a : q.b;
  const int64_t s_mn = x.strides[IS_A ? 1 : 2], s_k = x.strides[IS_A ? 2 : 1];
  const int64_t mn0 = (int64_t)(IS_A ? blockIdx.y : blockIdx.x) * 128;
  const int64_t MN = IS_A ? q.M : q.N;
  const bool along_k = (s_k < 0 ? -s_k : s_k) <= (s_mn < 0 ? -s_mn : s_mn);
  Walk w;
  if (along_k) {
    w.mn = tid / kBK, w.k = tid % kBK, w.dmn = kThreads / kBK, w.dk = 0;
    w.ok = k0 + w.k < q.K;
    w.room = (MN - mn0 - w.mn + w.dmn - 1) / w.dmn;
    w.step = w.dmn * s_mn;
  } else {
    w.mn = tid % 128, w.k = tid / 128, w.dmn = 0, w.dk = kThreads / 128;
    w.ok = mn0 + w.mn < MN;
    w.room = (q.K - k0 - w.k + w.dk - 1) / w.dk;
    w.step = w.dk * s_k;
  }
  w.off = (int64_t)blockIdx.z * x.strides[0] + (mn0 + w.mn) * s_mn + (k0 + w.k) * s_k;
  return w;
}

template <typename T, typename E, typename F>
__device__ __forceinline__ void gather(const Walk& w, const void* ptr, F widen, T (&v)[kEach<T>]) {
  const E* const p = static_cast<const E*>(ptr);
#pragma unroll
  for (int i = 0; i < kEach<T>; ++i)
    v[i] = w.ok && i < w.room ? widen(p[w.off + i * w.step]) : T(0);
}

// An int32 value as T: itself, or sign-extended to 64 bits.
template <typename T>
__device__ __forceinline__ T from_i32(uint32_t u) {
  if constexpr (sizeof(T) == 8)
    return (T)(int64_t)(int32_t)u;
  else
    return (T)u;
}

// The loads, with the operand type's dispatch out of the loop, over the
// types that reach each accumulator (ops/matmul.py::accumulator): float32
// and bfloat16; int32, int8 and uint8; those and int64/uint64.
template <bool IS_A, int KIND, typename T>
__device__ __forceinline__ void fetch(const MmParams& q, const Walk& w, T (&v)[kEach<T>]) {
  const MmOperand& x = IS_A ? q.a : q.b;
  const auto as_is = [](auto e) { return (T)e; };
  const auto as_i32 = [](auto e) { return from_i32<T>((uint32_t)(int32_t)e); };
  if (KIND == kF32 && x.dtype == SM_F32) {
    gather<T, uint32_t>(w, x.ptr, as_is, v);
  } else if (KIND == kF32) {  // SM_BF16
    gather<T, uint16_t>(w, x.ptr, [](uint16_t e) { return (T)((uint32_t)e << 16); }, v);
  } else if (x.dtype == SM_I32) {
    gather<T, uint32_t>(w, x.ptr, as_i32, v);
  } else if (x.dtype == SM_I8) {
    gather<T, int8_t>(w, x.ptr, as_i32, v);
  } else if (KIND == kI32 || x.dtype == SM_U8) {
    gather<T, uint8_t>(w, x.ptr, as_is, v);
  } else {  // SM_I64 (int64 and uint64), into the 64-bit accumulator's tiles alone
    gather<T, uint64_t>(w, x.ptr, as_is, v);
  }
}

template <bool KMAJOR, typename T>
__device__ __forceinline__ void put(const Walk& w, T* tile, const T (&v)[kEach<T>]) {
#pragma unroll
  for (int i = 0; i < kEach<T>; ++i)
    tile[tile_at<KMAJOR, T>(w.mn + i * w.dmn, w.k + i * w.dk)] = v[i];
}

// One stage of one operand, copied or element by element.
template <bool IS_A, bool KMAJOR, int KIND, typename T>
__device__ __forceinline__ void stage(const MmParams& q, T* tile, int64_t k0, int tid) {
  if ((IS_A ? q.a : q.b).vec16) {
    copy<IS_A, KMAJOR>(q, tile, k0, tid);
  } else {
    const Walk w = walk<IS_A, T>(q, k0, tid);
    T v[kEach<T>];
    fetch<IS_A, KIND>(q, w, v);
    put<KMAJOR>(w, tile, v);
  }
}

// The multiply-adds of k0 .. k0 + kBK of one stage.  A float32 product
// takes 16 k at a time and stops where the parent kernel's steps of 16
// stopped, so that its padded multiply-adds (0 * 0 + acc, which turns a
// -0.0 sum into +0.0) are the same ones.
template <int KIND, bool AK, bool BK, typename T>
__device__ __forceinline__ void multiply(const T* At, const T* Bt, int tx, int ty, int64_t k_left,
                                         T (&acc)[8][8]) {
  constexpr int kBK = 128 / sizeof(T);
  constexpr int KG = (AK && BK) || sizeof(T) == 8 ? 2 : 4;
#pragma unroll
  for (int k = 0; k < kBK; k += KG) {
    if (k == 16 && k_left <= 16) break;
    T a[8][KG], b[8][KG];
    load_frag<AK, KG>(At, ty, k, a);
    load_frag<BK, KG>(Bt, tx, k, b);
#pragma unroll
    for (int kk = 0; kk < KG; ++kk)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = mm_madd<KIND>(a[i][kk], b[j][kk], acc[i][j]);
  }
}

// The epilogue of four adjacent columns, out of line: one copy of the
// interpreter for every instantiation of the kernel.
__device__ __noinline__ uint4 epilogue4(const SmParams& p, uint4* r, int64_t bz, int64_t m,
                                        int64_t n, uint4 acc, int count) {
  return mm_epilogue4_at(p, r, bz, m, n, acc, count);
}

// Four results (m, n .. n + count - 1) into the output, whose rows of N
// elements start at ``row``: one 16- or 8-byte store where the row allows
// it, element by element otherwise.
__device__ __forceinline__ void store4(void* out, int64_t row, int64_t n, int count, int32_t dtype,
                                       bool whole, uint4 v) {
  if (whole && count == 4 && dtype != SM_BOOL) {
    if (dtype == SM_BF16) {
      const uint32_t lo = sm_f2bf(v.x) | ((uint32_t)sm_f2bf(v.y) << 16);
      const uint32_t hi = sm_f2bf(v.z) | ((uint32_t)sm_f2bf(v.w) << 16);
      *reinterpret_cast<uint2*>(static_cast<uint16_t*>(out) + row + n) = make_uint2(lo, hi);
    } else {
      *reinterpret_cast<uint4*>(static_cast<uint32_t*>(out) + row + n) = v;
    }
    return;
  }
  const uint32_t vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < count) sm_store(out, row + n + c, dtype, vs[c]);
}

// The block's results of one thread (rows m.., columns n.. as mm_row
// lays them out), through the epilogue when there is one, four columns a
// step.  Unrolled, so the accumulators stay in registers.
__device__ __forceinline__ void store_tile(const MmParams& q, void* out, const uint32_t (&acc)[8][8],
                                           int64_t out_base, int64_t m, int64_t n, int64_t bz) {
  const bool whole = q.N % 4 == 0;  // rows start on 16 (4-byte) or 8 (bf16) bytes
  uint4 r[SM_MAX_REGS];
  if (q.epilogue) sm_load_consts4(q.p, r);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t mi = m + (i & 4) * 16 + (i & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t nh = n + 64 * h;
      if (mi >= q.M || nh >= q.N) continue;
      const int count = q.N - nh < 4 ? (int)(q.N - nh) : 4;
      uint4 v = make_uint4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      if (q.epilogue) v = epilogue4(q.p, r, bz, mi, nh, v, count);
      store4(out, out_base + mi * q.N, nh, count, q.out_dtype, whole, v);
    }
  }
}

}  // namespace

// ELEM: an operand takes the element path.  Its loads for a stage go out
// before the multiply-adds of the stage kStages - 1 steps earlier, and are
// stored after them, so that they are in flight while those run; a kernel
// whose operands are both copied holds no register for them.
template <int KIND, bool AK, bool BK, bool ELEM>
__global__ void __launch_bounds__(kThreads, 1)
    mm_kernel(const __grid_constant__ MmParams q, void* __restrict__ out) {
  using T = typename Kind<KIND>::T;
  constexpr int kBK = 128 / sizeof(T);
  constexpr int kTileElems = kTileBytes / sizeof(T);
  extern __shared__ __align__(128) uint8_t mm_smem[];
  T* const ring = reinterpret_cast<T*>(mm_smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = ((warp & 1) << 3) | (lane & 7), ty = ((warp >> 1) << 2) | (lane >> 3);
  const int64_t bz = blockIdx.z;
  const int64_t m0 = (int64_t)blockIdx.y * kBM, n0 = (int64_t)blockIdx.x * kBN;
  const int64_t steps = (q.K + kBK - 1) / kBK;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      stage<true, AK, KIND>(q, ring + 2 * s * kTileElems, (int64_t)s * kBK, tid);
      stage<false, BK, KIND>(q, ring + (2 * s + 1) * kTileElems, (int64_t)s * kBK, tid);
    }
    cp_async_commit();
  }

  T acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;  // 0.0f and 0 alike

  for (int64_t t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of step t have landed
    __syncthreads();  // everyone's copies and stores have, and step t - 1's tiles are free
    const int64_t next = t + kStages - 1;
    T* const An = ring + 2 * (int)(next % kStages) * kTileElems;
    T* const Bn = An + kTileElems;
    const T* const At = ring + 2 * (int)(t % kStages) * kTileElems;
    const T* const Bt = At + kTileElems;
    if constexpr (ELEM) {
      const bool ea = next < steps && !q.a.vec16, eb = next < steps && !q.b.vec16;
      Walk wa, wb;
      T va[kEach<T>], vb[kEach<T>];
      if (ea) {
        wa = walk<true, T>(q, next * kBK, tid);
        fetch<true, KIND>(q, wa, va);
      } else if (next < steps) {
        copy<true, AK>(q, An, next * kBK, tid);
      }
      if (eb) {
        wb = walk<false, T>(q, next * kBK, tid);
        fetch<false, KIND>(q, wb, vb);
      } else if (next < steps) {
        copy<false, BK>(q, Bn, next * kBK, tid);
      }
      cp_async_commit();
      multiply<KIND, AK, BK>(At, Bt, tx, ty, q.K - t * kBK, acc);
      if (ea) put<AK>(wa, An, va);
      if (eb) put<BK>(wb, Bn, vb);
    } else {
      if (next < steps) {
        copy<true, AK>(q, An, next * kBK, tid);
        copy<false, BK>(q, Bn, next * kBK, tid);
      }
      cp_async_commit();
      multiply<KIND, AK, BK>(At, Bt, tx, ty, q.K - t * kBK, acc);
    }
  }

  const int64_t out_base = bz * q.M * q.N;
  if constexpr (KIND == kI64) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t m = m0 + mm_row(ty, i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t n = n0 + mm_row(tx, j);
        if (m < q.M && n < q.N) static_cast<uint64_t*>(out)[out_base + m * q.N + n] = acc[i][j];
      }
    }
  } else {
    store_tile(q, out, acc, out_base, m0 + 4 * ty, n0 + 4 * tx, bz);
  }
}

namespace {

template <int KIND, bool AK, bool BK, bool ELEM>
int mm_launch(const MmParams& q, void* out, cudaStream_t s) {
  static bool sized = false;  // the ring is above the 48 KB a launch gets unasked
  if (!sized) {
    const cudaError_t rc = cudaFuncSetAttribute(mm_kernel<KIND, AK, BK, ELEM>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                kSmemBytes);
    if (rc != cudaSuccess) return (int)rc;
    sized = true;
  }
  const dim3 grid((unsigned)((q.N + kBN - 1) / kBN), (unsigned)((q.M + kBM - 1) / kBM),
                  (unsigned)q.B);
  mm_kernel<KIND, AK, BK, ELEM><<<grid, kThreads, kSmemBytes, s>>>(q, out);
  return (int)cudaGetLastError();
}

template <int KIND, bool ELEM>
int mm_launch_layouts(const MmParams& q, void* out, cudaStream_t s) {
  if (q.a.inner_fast)
    return q.b.inner_fast ? mm_launch<KIND, true, true, ELEM>(q, out, s)
                          : mm_launch<KIND, true, false, ELEM>(q, out, s);
  return q.b.inner_fast ? mm_launch<KIND, false, true, ELEM>(q, out, s)
                        : mm_launch<KIND, false, false, ELEM>(q, out, s);
}

}  // namespace

// The kernels with an operand on the element path (ELEM) for q's
// accumulator and layouts; matmul_elem.cu compiles them, apart from the
// others (matmul.cu), so that nvcc builds the two halves side by side.
int mm_launch_elem(const MmParams& q, void* out, cudaStream_t s);
