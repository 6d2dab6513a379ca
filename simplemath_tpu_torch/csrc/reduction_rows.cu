// The map-reduce kernel, rd_axis along axis 1: the kernels of the row walk
// (reduction.cuh says what they compute and why they are shaped so).

#include "reduction.cuh"

namespace {

template <int OP>
int launch(const RdParams& q, uint32_t* out, cudaStream_t s) {
  const unsigned grid = (unsigned)q.blocks;
  RD_LAUNCH_PATH(rd_rows, OP, q, grid, s, out);
}

}  // namespace

int rd_rows_launch(const RdParams& q, uint32_t* out, cudaStream_t s) {
  switch (q.op) {
    case RD_SUM: return launch<RD_SUM>(q, out, s);
    case RD_MAX: return launch<RD_MAX>(q, out, s);
    case RD_MIN: return launch<RD_MIN>(q, out, s);
    case RD_SUM_I32: return launch<RD_SUM_I32>(q, out, s);  // rows of the int32 dot under vmap
  }
  return (int)cudaErrorInvalidValue;
}
