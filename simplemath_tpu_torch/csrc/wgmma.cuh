// What the tensor-core matmul sources (matmul_wgmma.cu: bf16 @ bf16;
// matmul_wgmma_s8.cu: int8/uint8 @ int8/uint8; matmul_wgmma_i64.cu takes
// the swizzled layout, the descriptors and the asynchronous copies and
// fences alone) share: the block tile and
// the ring of shared-memory stages, the 128-byte-swizzled tile layouts and
// their descriptors, the two ways a tile is filled (16-byte cp.async copies
// and element by element through the strides), and the store of a tile's
// accumulators, bare or through an epilogue (matmul.cuh).  Each source adds its own
// wgmma instruction and its K loop.  T is the operands' element type, ESIZE
// its size in bytes: a tile row is 128 bytes of the contraction dimension (K-major), so
// one step of the K loop covers 128 / ESIZE of k.
#pragma once

#include "matmul.cuh"

namespace sm_wgmma {

constexpr int kBM = 128, kBN = 256;
constexpr int kRowBytes = 128;  // of k, in a K-major tile row
constexpr int kThreads = 256;
constexpr int kAcc = kBN / 2;  // accumulator registers of a thread
constexpr int kStages = 4;  // 5 to 7 were no faster at 128 x 128 tiles
constexpr int kTileBytesA = kBM * kRowBytes, kTileBytesB = kBN * kRowBytes;
constexpr int kStageBytes = kTileBytesA + kTileBytesB;
constexpr int kAtomBytes = 1024;  // 8 rows of 128 bytes: the swizzle's period
constexpr int kSmemBytes = kStages * kStageBytes + kAtomBytes;  // + alignment slack
static_assert(kStages >= 3, "the ring keeps two steps in the multiplier");
static_assert(kSmemBytes <= 232448, "a block has 227 KB of shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset, inside a tile, of element (mn, k).  Both are the canonical
// 128-byte-swizzle layouts of wgmma: rows of 128 bytes in atoms of 8 rows,
// the 16-byte chunk c of row r stored at chunk c ^ (r & 7).
//   K-major:  row = mn, 128 / ESIZE k to a row; atoms follow each other
//             over mn.
//   MN-major (2-byte elements only; the 8-bit wgmma reads K-major alone):
//             row = k, 64 mn to a row; atom (mn / 64, k / 8) sits at
//             (mn / 64) * 8 + k / 8.
template <bool KMAJOR, int ESIZE>
__device__ __forceinline__ uint32_t tile_offset(int mn, int k) {
  static_assert(KMAJOR || ESIZE == 2, "an MN-major tile holds 2-byte elements");
  constexpr int kChunk = 16 / ESIZE;  // elements of a 16-byte chunk
  constexpr int kLogChunk = ESIZE == 1 ? 4 : 3;
  if (KMAJOR)
    return mn * 128 + ((((k >> kLogChunk) ^ (mn & 7)) << 4) | ((k & (kChunk - 1)) * ESIZE));
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

// Bytes from a tile's start to what one wgmma of the step (``ks``, 0..3: 32
// bytes of k) reads of the rows from 64 * ``half`` on.
template <bool KMAJOR>
__device__ __forceinline__ uint32_t step_offset(int half, int ks) {
  // K-major: 64 rows of 128 bytes down, 32 bytes along the row.
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

// A thread's part in staging one operand 16 bytes at a time.  A tile of
// ROWS x 128 bytes is ROWS * 8 chunks, ROWS / 32 to a thread; neighbouring
// threads take neighbouring chunks of one row of the source.  K-major: the
// thread's chunks sit at one k, 32 rows of mn apart; MN-major: at one mn,
// 2048 / ROWS rows of k apart (a multiple of 8, so the swizzle's row bits
// do not change).  Either way they are a fixed step apart in the source and
// in the tile, and the source moves on by one tile row of k from one step
// to the next, so the addresses are worked out once, before the K loop.
// (The int8 kernel's transposing stage keeps its own plan in the same
// struct: see matmul_wgmma_s8.cu.)  T is the operands' element type.
template <typename T>
struct ChunkPlan {
  const T* src;        // the thread's first chunk of the coming step
  int64_t per_chunk;   // elements from one of its chunks to the next
  int64_t per_step;    // elements from one step to the next
  uint32_t dst;        // bytes from a tile's start to its first chunk
  int32_t k;           // k, inside a tile, of its first chunk
  // K-major: bit i says the row of chunk i lies inside the matrix;
  // MN-major: the bytes (0..16) of each chunk that lie inside it along mn.
  int32_t inside;
};

template <bool KMAJOR, int ROWS, typename T>
__device__ __forceinline__ ChunkPlan<T> plan_chunks(const MmOperand& x, int64_t base, int64_t s_mn,
                                                    int64_t s_k, int64_t mn0, int64_t MN, int tid) {
  constexpr int ESIZE = sizeof(T);
  constexpr int kChunk = 16 / ESIZE;       // elements of a chunk
  constexpr int kPerRow = ROWS / kChunk;   // chunks along mn (MN-major)
  ChunkPlan<T> c;
  const int mn = KMAJOR ? tid >> 3 : (tid % kPerRow) * kChunk;
  c.k = KMAJOR ? (tid & 7) * kChunk : tid / kPerRow;
  c.src = static_cast<const T*>(x.ptr) + base + (mn0 + mn) * s_mn + c.k * s_k;
  c.per_chunk = KMAJOR ? 32 * s_mn : (kThreads / kPerRow) * s_k;
  c.per_step = (kRowBytes / ESIZE) * s_k;
  c.dst = tile_offset<KMAJOR, ESIZE>(mn, c.k);
  c.inside = 0;
  if (KMAJOR) {
#pragma unroll
    for (int i = 0; i < ROWS / 32; ++i) c.inside |= (mn0 + mn + 32 * i < MN) << i;
  } else {
    const int64_t left = MN - (mn0 + mn);
    c.inside = left >= kChunk ? 16 : (left > 0 ? (int)left * ESIZE : 0);
  }
  return c;
}

// Issues the thread's copies of one step into the tile at ``tile`` and
// moves the plan on to the next step; ``k_left`` is K minus the step's
// first k.  The source size of a copy zero-fills what lies past the edge;
// a copy of no bytes is given ``safe``, an address it may name.
template <bool KMAJOR, int ROWS, typename T>
__device__ __forceinline__ void copy_chunks(ChunkPlan<T>& c, const void* safe, uint32_t tile,
                                            int64_t k_left) {
  constexpr int ESIZE = sizeof(T);
  constexpr int kChunk = 16 / ESIZE;
  constexpr int kRowsOfK = kThreads / (ROWS / kChunk);  // MN-major: k from chunk to chunk
  const int64_t along = k_left - c.k;  // K-major: elements left in the row
  const int row_bytes = along >= kChunk ? 16 : (along > 0 ? (int)along * ESIZE : 0);
#pragma unroll
  for (int i = 0; i < ROWS / 32; ++i) {
    const int bytes = KMAJOR ? ((c.inside >> i) & 1 ? row_bytes : 0)
                             : (c.k + kRowsOfK * i < k_left ? c.inside : 0);
    cp_async16(tile + c.dst + i * (KMAJOR ? 32 * 128 : kRowsOfK / 8 * kAtomBytes),
               bytes ? static_cast<const void*>(c.src + i * c.per_chunk) : safe, bytes);
  }
  c.src += c.per_step;
}

// One operand's ROWS x (128 / sizeof(T)) tile (mn from mn0, k from k0), element
// by element through its strides ``s_mn`` and ``s_k``, into the shared tile
// at ``tile``; zero outside the matrix.  KMAJOR is the tile's layout;
// ALONG_K says that neighbouring threads take neighbouring k (else
// neighbouring mn): the operand's faster dimension.
template <bool KMAJOR, int ROWS, typename T, bool ALONG_K = KMAJOR>
__device__ __forceinline__ void copy_elements(const MmOperand& x, int64_t base, int64_t s_mn,
                                              int64_t s_k, int64_t mn0, int64_t MN, int64_t k0,
                                              int64_t K, uint8_t* tile, int tid) {
  constexpr int ESIZE = sizeof(T);
  constexpr int kBK = kRowBytes / ESIZE;  // a power of two
  constexpr int kLogBK = ESIZE == 1 ? 7 : 6;
  static_assert(1 << kLogBK == kBK, "a tile row is 128 bytes");
  const T* src = static_cast<const T*>(x.ptr);
#pragma unroll 4
  for (int i = 0; i < ROWS * kBK / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int mn = ALONG_K ? e >> kLogBK : e % ROWS;
    const int k = ALONG_K ? e & (kBK - 1) : e / ROWS;
    const int64_t gmn = mn0 + mn, gk = k0 + k;
    const T v = (gmn < MN && gk < K) ? src[base + gmn * s_mn + gk * s_k] : (T)0;
    *reinterpret_cast<T*>(tile + tile_offset<KMAJOR, ESIZE>(mn, k)) = v;
  }
}

// An accumulator register's bits: f32 for float operands, int32 (kept in
// uint32_t, so that it wraps) for integer ones.
__device__ __forceinline__ uint32_t acc_bits(float v) { return sm_u(v); }
__device__ __forceinline__ uint32_t acc_bits(uint32_t v) { return v; }

// Two f32 values (as bits) rounded to bf16, nearest even, ``lo`` in the low
// half: one instruction.  A NaN becomes the canonical NaN.
__device__ __forceinline__ uint32_t pack_bf16(uint32_t lo, uint32_t hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(sm_f(hi)), "f"(sm_f(lo)));
  return d;
}

// Two adjacent 4-byte values at ``at`` (aligned to the pair) as bf16 (OUT
// 2) or as they are (OUT 4); one value in the stored type of ``esize``
// bytes (2: bf16; 1: bool; 4: the register's bits).
template <int OUT>
__device__ __forceinline__ void write_pair(void* at, uint32_t v0, uint32_t v1) {
  if (OUT == 2)
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
template <int OUT>
struct Rows {
  static constexpr int kPitch = kBN * OUT + (OUT == 4 ? 32 : 16);
  static constexpr int kWarpBytes = 16 * (kBN * 4 + 32);  // the largest OUT's

  // Where pair ``e`` of this lane's accumulator goes (see store_tile).
  static __device__ __forceinline__ uint8_t* at(uint8_t* mine, int lane, int e) {
    return mine + ((lane >> 2) + 8 * (e & 1)) * kPitch + (8 * (e >> 1) + (lane & 3) * 2) * OUT;
  }

  // The accumulator itself (``wide`` output without an epilogue).
  template <typename ACC>
  static __device__ __forceinline__ void stash(uint8_t* mine, int lane, const ACC* acc) {
#pragma unroll
    for (int e = 0; e < kAcc / 2; ++e)
      write_pair<OUT>(at(mine, lane, e), acc_bits(acc[2 * e]), acc_bits(acc[2 * e + 1]));
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

// The store of a block's 128 x 256 tile, after its last multiply has been
// waited for, through the epilogue E (matmul.cuh: MmInterp, or a generated
// MmGenerated).  Accumulator register 4 * j + 2 * h + c of a thread is the
// element at row 16 * warp + lane / 4 + 8 * h, column 8 * j + 2 * (lane % 4)
// + c of the tile (warps 0-3 are the first warpgroup): pair e = 2 * j + h is
// two adjacent columns.  With one block of 8 warps on an SM every
// instruction here is paid in full (nothing else runs meanwhile), so the
// store does as little per element as it can: where the output's rows start
// on 16 bytes (``wide``) a warp lays its 16 x 256 results out in the ring
// at ``ring_ptr``, which is free by now, and writes whole rows; otherwise
// the pairs go out one by one.
template <typename E, typename ACC>
__device__ __forceinline__ void store_tile(const MmParams& q, void* out, const ACC* acc,
                                           uint8_t* ring_ptr, int tid, int64_t bz, int64_t m0,
                                           int64_t n0) {
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = m0 + warp * 16 + (lane >> 2);
  const int64_t col0 = n0 + (lane & 3) * 2;
  const int32_t out_dtype = E::kGenerated ? E::kOut : q.out_dtype;
  const int esize = out_dtype == SM_BF16 ? 2 : (out_dtype == SM_BOOL ? 1 : 4);
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

  if (!E::kGenerated && !q.epilogue) {
    if (wide) {
      // 4-byte or bf16: no bounds here, the rows are cut when they are written.
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
        write_one(at, esize, acc_bits(acc[2 * e]));
        if (n + 1 < q.N) write_one(at + esize, esize, acc_bits(acc[2 * e + 1]));
      }
    }
    return;
  }

  // The epilogue.  The accumulators go to the warp's rows as they are; then
  // a lane takes four adjacent columns of a row at a time (two such groups
  // a row: the first group of every row, then the second) through the
  // epilogue, whose registers hold four elements each, and puts the results
  // back at the row's start in the stored type (never past what the warp
  // has already read: group 0's results cover the row's first 64 columns'
  // bytes, group 1's the next 64, all read in group 0), or straight to the
  // output where its rows do not start on 16 bytes.  Each instruction is
  // dispatched once for the four elements: with the interpreter (sm_exec4)
  // dispatching per element cost 0.03 ms more at 2048^3 (H100, 700 W), and
  // its register file in shared memory instead of local memory, and eight
  // elements a pass instead of four, were no faster.  A generated epilogue
  // has its registers in registers and its opcodes compiled in; it reads an
  // extra that is the same for every row once a group, and one that is the
  // same along the row once a row.
  Rows<4>::stash(mine, lane, acc);
  __syncwarp();
  E epi(q, bz);
#pragma unroll 1
  for (int group = 0; group < 2; ++group) {
    const int c = 4 * (lane + 32 * group);  // the group's first column in the tile
    const int64_t n = n0 + c;
    const int count = n < q.N ? (int)(q.N - n < 4 ? q.N - n : 4) : 0;
    if (count) epi.columns(n, count);
#pragma unroll 1
    for (int rr = 0; rr < rows; ++rr) {
      const int64_t m = first + rr;
      uint8_t* const row = mine + rr * Rows<4>::kPitch;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (count) {
        epi.row(m);
        v = epi(m, n, *reinterpret_cast<const uint4*>(row + c * 4), count);
      }
      __syncwarp();  // every lane has read its accumulators of this group
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

}  // namespace sm_wgmma
