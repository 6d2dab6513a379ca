// The map-reduce kernel, first pass of rd_full: the kernels of the flat walk
// (reduction.cuh says what they compute and why they are shaped so).

#include "reduction.cuh"

namespace {

template <int OP>
int launch(const RdParams& q, uint32_t* partial, cudaStream_t s) {
  const unsigned grid = (unsigned)q.blocks;
  RD_LAUNCH_PATH(rd_full_partial, OP, q, grid, s, partial);
}

}  // namespace

int rd_full_partial_launch(const RdParams& q, uint32_t* partial, cudaStream_t s) {
  switch (q.op) {
    case RD_SUM: return launch<RD_SUM>(q, partial, s);
    case RD_MAX: return launch<RD_MAX>(q, partial, s);
    case RD_MIN: return launch<RD_MIN>(q, partial, s);
    case RD_SUM_I32: return launch<RD_SUM_I32>(q, partial, s);
  }
  return (int)cudaErrorInvalidValue;
}
