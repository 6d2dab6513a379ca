// The map-reduce kernel for Hopper (sm_90a): its entry points, rd_full and
// rd_axis, and their second passes.  reduction.cuh says which TPU kernels
// they replace, what they compute, what bounds them on an H100 and what the
// design does about it; the first passes are reduction_full.cu,
// reduction_cols.cu and reduction_rows.cu.

#include "reduction.cuh"

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

// rd_axis, axis 0, pass 2: column j's segments combined in order.
template <int OP>
__global__ void __launch_bounds__(kThreads) rd_cols_finish(const uint32_t* __restrict__ partial,
                                                           int64_t segs, int64_t cols,
                                                           uint32_t* __restrict__ out) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  const int64_t width = (cols + 3) / 4 * 4;
  uint32_t acc = rd_identity<OP>();
  for (int64_t s = 0; s < segs; ++s) acc = rd_combine<OP>(acc, partial[s * width + j]);
  out[j] = acc;
}

namespace {

template <int OP>
int full_finish(const RdParams& q, uint32_t* partial, uint32_t* out, cudaStream_t s) {
  rd_full_finish<OP><<<1, kThreads, 0, s>>>(partial, q.blocks, out);
  return (int)cudaGetLastError();
}

template <int OP>
int cols_finish(const RdParams& q, uint32_t* partial, uint32_t* out, cudaStream_t s) {
  const int64_t cols = q.p.shape[1];
  rd_cols_finish<OP><<<(unsigned)((cols + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      partial, q.blocks, cols, out);
  return (int)cudaGetLastError();
}

}  // namespace

// rd_full: the program over operands of rank <= 8 reduced to out[0] (f32
// bits, or i32 bits for RD_SUM_I32); ``partial`` holds q->blocks values.
extern "C" int sm_rd_full_launch(const RdParams* q, void* partial, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* w = static_cast<uint32_t*>(partial);
  uint32_t* o = static_cast<uint32_t*>(out);
  const int rc = rd_full_partial_launch(*q, w, s);
  if (rc != 0) return rc;
  switch (q->op) {
    case RD_SUM: return full_finish<RD_SUM>(*q, w, o, s);
    case RD_MAX: return full_finish<RD_MAX>(*q, w, o, s);
    case RD_MIN: return full_finish<RD_MIN>(*q, w, o, s);
    case RD_SUM_I32: return full_finish<RD_SUM_I32>(*q, w, o, s);
  }
  return (int)cudaErrorInvalidValue;
}

// rd_axis: the program over a (rows, cols) expression reduced along
// q->axis into out (cols or rows f32 values).  For axis 0 ``partial``
// holds q->blocks rows of cols rounded up to a multiple of 4, 16-byte
// aligned; for axis 1 it is unused.
extern "C" int sm_rd_axis_launch(const RdParams* q, void* partial, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* w = static_cast<uint32_t*>(partial);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (q->axis == 1) return rd_rows_launch(*q, o, s);
  const int rc = rd_cols_partial_launch(*q, w, s);
  if (rc != 0) return rc;
  switch (q->op) {
    case RD_SUM: return cols_finish<RD_SUM>(*q, w, o, s);
    case RD_MAX: return cols_finish<RD_MAX>(*q, w, o, s);
    case RD_MIN: return cols_finish<RD_MIN>(*q, w, o, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int sm_rd_params_size() { return (int)sizeof(RdParams); }
