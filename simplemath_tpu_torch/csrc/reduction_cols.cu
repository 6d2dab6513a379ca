// The map-reduce kernel, first pass of rd_axis along axis 0: the kernels of
// the column walk (reduction.cuh says what they compute and why they are
// shaped so).

#include "reduction.cuh"

namespace {

template <int OP>
int launch(const RdParams& q, uint32_t* partial, cudaStream_t s) {
  const int64_t quads = (q.p.shape[1] + 3) / 4;
  const dim3 grid((unsigned)((quads + 31) / 32), (unsigned)q.blocks);
  RD_LAUNCH_PATH(rd_cols_partial, OP, q, grid, s, partial);
}

}  // namespace

int rd_cols_partial_launch(const RdParams& q, uint32_t* partial, cudaStream_t s) {
  switch (q.op) {
    case RD_SUM: return launch<RD_SUM>(q, partial, s);
    case RD_MAX: return launch<RD_MAX>(q, partial, s);
    case RD_MIN: return launch<RD_MIN>(q, partial, s);
  }
  return (int)cudaErrorInvalidValue;
}
