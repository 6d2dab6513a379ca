// The generic elementwise kernel for Hopper (sm_90a).
//
// Replaces the JAX package's two Pallas elementwise kernels:
//   ew_flat    <- simplemath_tpu/ops/elementwise.py::_build_call_1d
//   ew_strided <- simplemath_tpu/ops/elementwise.py::_build_call
//                 (and ops/viewkernel.py, whose BlockSpec view plans the
//                 signed strides here replace, "cannot express" cases too)
// both sharing the body of ::_loop_kernel_body.
//
// What it computes: an expression program chosen at run time (an SSA
// opcode list, tiles.cuh), evaluated per element in registers.  Every
// operand is loaded once; with iterations = L the program runs L times
// with the carry register replaced by the last result, and the result is
// stored once, so the carry never goes back to device memory between
// iterations (the TPU kernel's in-kernel fori_loop carry).
//
// What bounds it on an H100: the 1M-float add moves 12 MB and does one
// add per element, so it is bound by device-memory bandwidth; ew_flat
// reads and writes 16 bytes per thread where the data is aligned.  The
// iterated pow/exp recurrence does ~L * 100 flops per element on 16 MB,
// so it is bound by arithmetic, and the interpreter's dispatch on each
// instruction is its overhead.  Generating code per expression, larger
// per-thread work and TMA are later work; this kernel is the simple
// correct one.
//
// Launch: on the caller's stream; allocates nothing; returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include "program.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

// One element of the flat path.
__device__ __forceinline__ void sm_flat_one(const SmParams& p, uint32_t* r,
                                            void* out, int64_t i) {
  sm_load_flat(p, r, i);
  sm_store(out, i, p.out_dtype, sm_run(p, r));
}

}  // namespace

// Counterpart of _build_call_1d: every operand is contiguous and full-size
// or a single element; a grid-stride loop, 16-byte loads and stores when
// p.vec (all full operands and the output 4-byte and 16-byte aligned).
__global__ void __launch_bounds__(kThreads) ew_flat(const SmParams p, void* __restrict__ out) {
  uint32_t r[SM_MAX_REGS];
  sm_load_consts(p, r);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t done = 0;
  if (p.vec) {
    const int64_t n4 = p.n / 4;
    for (int64_t q = tid; q < n4; q += stride) {
      uint4 lanes[SM_MAX_OPERANDS];
      for (int o = 0; o < p.n_ops; ++o)
        if (!p.ops[o].scalar) lanes[o] = static_cast<const uint4*>(p.ops[o].ptr)[q];
      uint32_t res[4];
      for (int e = 0; e < 4; ++e) {
        for (int o = 0; o < p.n_ops; ++o) {
          if (p.ops[o].scalar) {
            r[o] = sm_load(p.ops[o].ptr, 0, p.ops[o].dtype);
          } else {
            const uint4 v = lanes[o];
            r[o] = e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
          }
        }
        res[e] = sm_run(p, r);
      }
      static_cast<uint4*>(out)[q] = make_uint4(res[0], res[1], res[2], res[3]);
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < p.n; i += stride) sm_flat_one(p, r, out, i);
}

// Counterpart of _build_call: contiguous output of rank <= 8; each operand
// read in place through its own signed strides (0 = broadcast, negative =
// a negative-step view).
__global__ void __launch_bounds__(kThreads) ew_strided(const SmParams p, void* __restrict__ out) {
  uint32_t r[SM_MAX_REGS];
  sm_load_consts(p, r);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < p.n; i += stride) {
    sm_load_strided(p, r, i);
    sm_store(out, i, p.out_dtype, sm_run(p, r));
  }
}

extern "C" int sm_ew_launch(const SmParams* p, void* out, int strided, void* stream) {
  const int64_t work = (!strided && p->vec) ? (p->n + 3) / 4 : p->n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (strided)
    ew_strided<<<(unsigned)blocks, kThreads, 0, s>>>(*p, out);
  else
    ew_flat<<<(unsigned)blocks, kThreads, 0, s>>>(*p, out);
  return (int)cudaGetLastError();
}

extern "C" int sm_ew_params_size() { return (int)sizeof(SmParams); }
