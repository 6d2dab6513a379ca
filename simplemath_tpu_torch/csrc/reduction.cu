// The map-reduce kernel for Hopper (sm_90a).
//
// Replaces the JAX package's six Pallas reduction kernels, all in
// simplemath_tpu/ops/reduction.py:
//   rd_full <- _build_reduce_1d (:79)       full sum/max/min of flat data
//              _build_reduce_2d (:127)      the same over 2-D row blocks
//              _build_dot1d (:210)          1-D dot: f32, or i32 exact mod 2^32
//              _build_map_reduce_1d (:275)  reduce of a fused expression
//              _build_map_reduce_2d (:333)  the same with (1|R, 1|C) operands
//   rd_axis <- _build_reduce_axis (:482)    axis-0/1 sum/max/min of a mapped
//                                           2-D expression
//
// What it computes: the opcode program of the elementwise kernel
// (tiles.cuh, program.cuh) evaluated per element in registers, each result
// cast to the accumulator and combined at once, so the mapped expression
// never goes to device memory.  The identity program is a plain reduction,
// a*b (with its casts) the dot, any fused expression a map-reduce.  Every
// operand is read in place through (pointer, signed strides): stride 0
// reads broadcast rows, columns and scalars, negative strides read
// negative-step views.  Ragged sizes need no index operand: the loop
// bounds mask them.
//
// Accumulator: f32 whatever the input float type; each mapped value is
// cast to f32 first, as the TPU kernels do (reduction.py:300, :357).  The
// int32 dot accumulates in uint32_t, wrapping mod 2^32 (signed overflow is
// undefined in C++).  Identities 0, -inf, +inf; max/min propagate NaN as
// jnp.max does (sm_max_f/sm_min_f, never fmaxf/fminf, which drop it).
//
// Deterministic: no atomics.  Each block combines its threads in a fixed
// tree and writes one partial to a workspace the wrapper allocates; a
// second launch combines the partials in index order.  Threads walk the
// elements in quads of 4 consecutive elements, the same quads whether they
// are read with one 16-byte load or four scalar ones, so the order of
// every combine, and the grid, depend on the shape alone.
//
// What bounds it on an H100: device-memory bandwidth.  The bench shapes
// stream 256 MB once (Array.sum of 64M f32, the dot of two 32M vectors,
// the fused squared distance of two 32M vectors, the (8192, 8192) axis
// reductions), about 80 us at 3.35 TB/s, with one combine per element;
// the interpreter's dispatch (its register file in local memory, a switch
// per instruction) is the overhead on top.  Warp-shuffle trees, TMA and
// code generated per expression are later work; this kernel is the
// simple correct one.
//
// Launch: on the caller's stream; allocates nothing; returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include "program.cuh"

enum RdOp : int32_t { RD_SUM = 0, RD_MAX = 1, RD_MIN = 2, RD_SUM_I32 = 3 };

// ``p`` is the program over the mapped expression's shape (rank 2 for
// rd_axis).  ``blocks``: rd_full's partial blocks; rd_axis's row segments
// (axis 0) or row blocks (axis 1).  ``seg_rows``: rows per segment.
struct RdParams {
  SmParams p;
  int32_t op;
  int32_t strided;
  int64_t blocks;
  int64_t seg_rows;
  int32_t axis;
  int32_t pad;
};

namespace {

constexpr int kThreads = 256;

template <int OP>
__device__ __forceinline__ uint32_t rd_identity() {
  return OP == RD_MAX ? 0xff800000u : (OP == RD_MIN ? 0x7f800000u : 0u);
}

template <int OP>
__device__ __forceinline__ uint32_t rd_combine(uint32_t a, uint32_t b) {
  if (OP == RD_SUM_I32) return a + b;
  const float x = sm_f(a), y = sm_f(b);
  if (OP == RD_SUM) return sm_u(x + y);
  if (OP == RD_MAX) return sm_u(sm_max_f(x, y));
  return sm_u(sm_min_f(x, y));
}

// The program's result as an accumulator value.
template <int OP>
__device__ __forceinline__ uint32_t rd_value(int32_t dtype, uint32_t v) {
  if (OP == RD_SUM_I32) return v;
  if (dtype == SM_I32) return sm_u((float)(int32_t)v);
  if (dtype == SM_BOOL) return sm_u(v ? 1.0f : 0.0f);
  return v;
}

// The block's values combined in a fixed tree; every thread gets it.
template <int OP>
__device__ __forceinline__ uint32_t rd_block(uint32_t v) {
  __shared__ uint32_t s[kThreads];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) s[threadIdx.x] = rd_combine<OP>(s[threadIdx.x], s[threadIdx.x + w]);
    __syncthreads();
  }
  const uint32_t out = s[0];
  __syncthreads();
  return out;
}

template <int OP>
__device__ __forceinline__ uint32_t rd_at(const SmParams& p, uint32_t* r) {
  return rd_value<OP>(p.out_dtype, sm_run(p, r));
}

// Loads of element (i, j) of a 2-D expression.
__device__ __forceinline__ void rd_load_2d(const SmParams& p, uint32_t* r, int64_t i, int64_t j) {
  for (int o = 0; o < p.n_ops; ++o)
    r[o] = sm_load(p.ops[o].ptr, i * p.ops[o].strides[0] + j * p.ops[o].strides[1],
                   p.ops[o].dtype);
}

}  // namespace

// Pass 1 of rd_full: block b's partial over its quads.  Flat operands
// (contiguous full-size or single-element) are read with 16-byte loads
// when p.vec; strided ones through their strides, rank <= 8.
template <int OP>
__global__ void __launch_bounds__(kThreads) rd_full_partial(const RdParams q,
                                                            uint32_t* __restrict__ partial) {
  const SmParams& p = q.p;
  uint32_t r[SM_MAX_REGS];
  sm_load_consts(p, r);
  uint32_t acc = rd_identity<OP>();
  const int64_t n = p.n;
  const int64_t quads = (n + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if (p.n_insts == 0 && p.result < p.n_ops && !q.strided) {
    // The identity program (a plain reduction of one flat operand): the
    // operand is combined straight from memory, past the interpreter.
    // The same quads in the same order, so the same bits.
    const SmOperand& x = p.ops[p.result];
    for (int64_t qd = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; qd < quads; qd += stride) {
      const int64_t i0 = qd * 4;
      if (p.vec && i0 + 4 <= n) {
        const uint4 v = static_cast<const uint4*>(x.ptr)[qd];
        acc = rd_combine<OP>(acc, rd_value<OP>(x.dtype, v.x));
        acc = rd_combine<OP>(acc, rd_value<OP>(x.dtype, v.y));
        acc = rd_combine<OP>(acc, rd_value<OP>(x.dtype, v.z));
        acc = rd_combine<OP>(acc, rd_value<OP>(x.dtype, v.w));
      } else {
        const int64_t i1 = i0 + 4 < n ? i0 + 4 : n;
        for (int64_t i = i0; i < i1; ++i)
          acc = rd_combine<OP>(acc, rd_value<OP>(x.dtype, sm_load(x.ptr, x.scalar ? 0 : i, x.dtype)));
      }
    }
  } else {
    for (int64_t qd = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; qd < quads; qd += stride) {
      const int64_t i0 = qd * 4;
      if (p.vec && i0 + 4 <= n) {
        uint4 lanes[SM_MAX_OPERANDS];
        for (int o = 0; o < p.n_ops; ++o)
          if (!p.ops[o].scalar) lanes[o] = static_cast<const uint4*>(p.ops[o].ptr)[qd];
        for (int e = 0; e < 4; ++e) {
          for (int o = 0; o < p.n_ops; ++o) {
            if (p.ops[o].scalar) {
              r[o] = sm_load(p.ops[o].ptr, 0, p.ops[o].dtype);
            } else {
              const uint4 v = lanes[o];
              r[o] = e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
            }
          }
          acc = rd_combine<OP>(acc, rd_at<OP>(p, r));
        }
      } else {
        const int64_t i1 = i0 + 4 < n ? i0 + 4 : n;
        for (int64_t i = i0; i < i1; ++i) {
          if (q.strided)
            sm_load_strided(p, r, i);
          else
            sm_load_flat(p, r, i);
          acc = rd_combine<OP>(acc, rd_at<OP>(p, r));
        }
      }
    }
  }
  acc = rd_block<OP>(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

// Pass 2 of rd_full: one block combines the partials in index order.
template <int OP>
__global__ void __launch_bounds__(kThreads) rd_full_finish(const uint32_t* __restrict__ partial,
                                                           int64_t blocks,
                                                           uint32_t* __restrict__ out) {
  uint32_t acc = rd_identity<OP>();
  for (int64_t b = threadIdx.x; b < blocks; b += blockDim.x) acc = rd_combine<OP>(acc, partial[b]);
  acc = rd_block<OP>(acc);
  if (threadIdx.x == 0) out[0] = acc;
}

// rd_axis, axis 0, pass 1: thread j walks column j over one segment of
// seg_rows rows (blockIdx.y); neighbouring threads read neighbouring
// columns.
template <int OP>
__global__ void __launch_bounds__(kThreads) rd_cols_partial(const RdParams q,
                                                            uint32_t* __restrict__ partial) {
  const SmParams& p = q.p;
  const int64_t rows = p.shape[0], cols = p.shape[1];
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  uint32_t r[SM_MAX_REGS];
  sm_load_consts(p, r);
  const int64_t i0 = (int64_t)blockIdx.y * q.seg_rows;
  const int64_t i1 = i0 + q.seg_rows < rows ? i0 + q.seg_rows : rows;
  uint32_t acc = rd_identity<OP>();
  for (int64_t i = i0; i < i1; ++i) {
    rd_load_2d(p, r, i, j);
    acc = rd_combine<OP>(acc, rd_at<OP>(p, r));
  }
  partial[(int64_t)blockIdx.y * cols + j] = acc;
}

// rd_axis, axis 0, pass 2: column j's segments combined in order.
template <int OP>
__global__ void __launch_bounds__(kThreads) rd_cols_finish(const uint32_t* __restrict__ partial,
                                                           int64_t segs, int64_t cols,
                                                           uint32_t* __restrict__ out) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  uint32_t acc = rd_identity<OP>();
  for (int64_t s = 0; s < segs; ++s) acc = rd_combine<OP>(acc, partial[s * cols + j]);
  out[j] = acc;
}

// rd_axis, axis 1: a block per row; its threads walk the row's columns and
// combine in the block's tree.
template <int OP>
__global__ void __launch_bounds__(kThreads) rd_rows(const RdParams q, uint32_t* __restrict__ out) {
  const SmParams& p = q.p;
  const int64_t rows = p.shape[0], cols = p.shape[1];
  uint32_t r[SM_MAX_REGS];
  sm_load_consts(p, r);
  for (int64_t i = blockIdx.x; i < rows; i += gridDim.x) {
    uint32_t acc = rd_identity<OP>();
    for (int64_t j = threadIdx.x; j < cols; j += blockDim.x) {
      rd_load_2d(p, r, i, j);
      acc = rd_combine<OP>(acc, rd_at<OP>(p, r));
    }
    acc = rd_block<OP>(acc);
    if (threadIdx.x == 0) out[i] = acc;
  }
}

namespace {

template <int OP>
int rd_full_launch(const RdParams& q, uint32_t* partial, uint32_t* out, cudaStream_t s) {
  rd_full_partial<OP><<<(unsigned)q.blocks, kThreads, 0, s>>>(q, partial);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rd_full_finish<OP><<<1, kThreads, 0, s>>>(partial, q.blocks, out);
  return (int)cudaGetLastError();
}

template <int OP>
int rd_axis_launch(const RdParams& q, uint32_t* partial, uint32_t* out, cudaStream_t s) {
  if (q.axis == 1) {
    rd_rows<OP><<<(unsigned)q.blocks, kThreads, 0, s>>>(q, out);
    return (int)cudaGetLastError();
  }
  const int64_t cols = q.p.shape[1];
  const unsigned col_blocks = (unsigned)((cols + kThreads - 1) / kThreads);
  rd_cols_partial<OP><<<dim3(col_blocks, (unsigned)q.blocks), kThreads, 0, s>>>(q, partial);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rd_cols_finish<OP><<<col_blocks, kThreads, 0, s>>>(partial, q.blocks, cols, out);
  return (int)cudaGetLastError();
}

}  // namespace

// rd_full: the program over operands of rank <= 8 reduced to out[0] (f32
// bits, or i32 bits for RD_SUM_I32); ``partial`` holds q->blocks values.
extern "C" int sm_rd_full_launch(const RdParams* q, void* partial, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* w = static_cast<uint32_t*>(partial);
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (q->op) {
    case RD_SUM: return rd_full_launch<RD_SUM>(*q, w, o, s);
    case RD_MAX: return rd_full_launch<RD_MAX>(*q, w, o, s);
    case RD_MIN: return rd_full_launch<RD_MIN>(*q, w, o, s);
    case RD_SUM_I32: return rd_full_launch<RD_SUM_I32>(*q, w, o, s);
  }
  return (int)cudaErrorInvalidValue;
}

// rd_axis: the program over a (rows, cols) expression reduced along
// q->axis into out (cols or rows f32 values); ``partial`` holds
// q->blocks * cols values for axis 0 and is unused for axis 1.
extern "C" int sm_rd_axis_launch(const RdParams* q, void* partial, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* w = static_cast<uint32_t*>(partial);
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (q->op) {
    case RD_SUM: return rd_axis_launch<RD_SUM>(*q, w, o, s);
    case RD_MAX: return rd_axis_launch<RD_MAX>(*q, w, o, s);
    case RD_MIN: return rd_axis_launch<RD_MIN>(*q, w, o, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int sm_rd_params_size() { return (int)sizeof(RdParams); }
