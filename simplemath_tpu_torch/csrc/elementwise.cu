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
// add per element, so it is bound by bytes (device memory, or the L2 when
// the same arrays are added again); the iterated pow/exp recurrence does
// ~L * 100 flops per element on 16 MB, so it is bound by arithmetic.  Either
// way an interpreter's own work per element is the overhead, so no launch
// of the main path interprets its program:
//   - a program of one instruction (every eager unary and binary op) runs
//     ew_flat here: where the data allows whole quads (p.vec: every
//     full-size operand and the output 4 bytes wide at a 16-byte boundary,
//     or 2 bytes wide at an 8-byte one; elementwise.flat_path decides) its
//     opcode is chosen once per thread and the loop body is that opcode's
//     code on the four lanes of a uint4 (flat_single), each operand read at
//     its own width (one 16-byte load of a 4-byte type, or one 8-byte load
//     of a bf16 one widened to f32 bits in registers, sm_load_quad2),
//     scalars and constants splatted once before the loop, a bf16 result
//     quad rounded and packed into one 8-byte store (sm_store_quad); a
//     launch with a 2-byte operand or result runs a kernel of its own
//     (ew_flat<true>), so that one of 4-byte types alone runs code with no
//     width to choose, and one whose operands are all bf16 takes eight
//     elements a thread; the n % 4 tail and unaligned operands go element
//     by element;
//   - any other flat program runs a kernel generated for it and compiled at
//     run time (ops/codegen.py, kind "flat"; sm_ew_launch_flat_kernel): the
//     same quads, loads and stores, its registers local variables and
//     every instruction sm_exec with its opcode a literal;
//   - a thread issues the loads of all its operands before any
//     arithmetic (operands are read once, so the loads are streaming
//     ones), and the grid is the blocks the card runs at once, which
//     stride over the quads.  Several f32 quads per operand in flight per
//     thread were tried and were no faster: 1, 2, 4, 8 of them took 4.3,
//     4.6, 4.7, 5.0 us for the 1M-float add in a hot L2 (torch.add 3.4; H100
//     at 700 W) and 73, 74, 74, 79 us for 16M floats.
// Inside a case the opcode is a constant, so sm_exec folds to its body and
// the bits are the per-element interpreter's.
//
// ew_strided's compiled kernel interprets per element: it decodes the
// element's index rank-deep and runs the program over a register file in
// local memory, an instruction a dispatch.  It is the reference
// (elementwise.interpret): every launch of the main path runs the kernel
// generated for its program (ops/codegen.py, kind "strided"), launched here
// with ew_strided's geometry and parameter block (sm_ew_launch_kernel).
// Its registers are local variables, every instruction is sm_exec with its
// opcode a constant, and the rank is a constant.
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

// Quad ``q`` of a full-size operand on the quad path: one streaming 16-byte
// load of a 4-byte type, or, in the kernel for 2-byte operands (NARROW),
// one 8-byte load of a bf16 one widened.  The elementwise kernel's 2-byte
// type is bf16 (f16 is the reductions').
template <bool NARROW>
__device__ __forceinline__ uint4 flat_load(const void* ptr, int32_t dtype, int64_t q) {
  if (NARROW && dtype == SM_BF16) return sm_load_quad2(ptr, q, SM_BF16);
  return __ldcs(static_cast<const uint4*>(ptr) + q);
}

// A source register of a one-instruction program on the quad path: a
// full-size operand (``ptr``, read at the width of ``dtype``), or a scalar
// operand or a constant (``splat``).
struct FlatSource {
  const void* ptr;
  int32_t dtype;
  uint4 splat;
};

__device__ __forceinline__ FlatSource flat_source(const SmParams& p, int reg) {
  FlatSource s;
  s.ptr = nullptr;
  s.dtype = SM_F32;
  if (reg >= p.n_ops) {
    s.splat = sm_splat(p.consts[reg - p.n_ops]);
  } else if (p.ops[reg].scalar) {
    s.splat = sm_splat(sm_load(p.ops[reg].ptr, 0, p.ops[reg].dtype));
  } else {
    s.ptr = p.ops[reg].ptr;
    s.dtype = p.ops[reg].dtype;
    s.splat = sm_splat(0u);
  }
  return s;
}

template <bool NARROW>
__device__ __forceinline__ uint4 flat_read(const FlatSource& s, int64_t q) {
  return s.ptr ? flat_load<NARROW>(s.ptr, s.dtype, q) : s.splat;
}

// The quad path of a program of one instruction, the opcode a constant, for
// quads q0 .. n4 - 1.  An operand the opcode does not read is never loaded
// (its load is dead code).  An instruction that rounds to bf16 is the
// program's result and its quad is stored as bf16, whose packing rounds the
// same way (sm_bf16r is idempotent), so the loop needs no rounding step of
// its own.
template <SmOpcode OP, bool NARROW>
__device__ __forceinline__ void flat_single(const SmParams& p, void* __restrict__ out,
                                            int64_t q0, int64_t n4) {
  const SmInst in = p.insts[0];
  const FlatSource a = flat_source(p, in.a), b = flat_source(p, in.b), c = flat_source(p, in.c);
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t q = q0 + (int64_t)blockIdx.x * kThreads + threadIdx.x; q < n4; q += stride) {
    const uint4 va = flat_read<NARROW>(a, q), vb = flat_read<NARROW>(b, q),
                vc = flat_read<NARROW>(c, q);
    const uint4 v = sm_exec_lanes(OP, va, vb, vc);
    if (NARROW)
      sm_store_quad(out, q, p.out_dtype, v);
    else
      static_cast<uint4*>(out)[q] = v;
  }
}

// A program of one instruction whose result is the program's (every eager
// unary and binary op): flat_single takes it, its opcode chosen once.  One
// that rounds has a bf16 result, so it comes to the kernel for 2-byte
// operands (NARROW), whose store rounds.
template <bool NARROW>
__host__ __device__ __forceinline__ bool flat_is_single(const SmParams& p) {
  return p.n_insts == 1 && p.iterations == 1 && (NARROW || !p.insts[0].rnd) &&
         p.result == p.n_ops + p.n_consts && p.insts[0].dst == p.result;
}

// A one-instruction program whose full-size operands and result are all
// bf16 at a 16-byte boundary takes eight elements a thread (flat_single8):
// two quads of each source from one 16-byte load, one 16-byte store of
// eight results.  The 16M bf16 add took 0.0401 ms so against 0.0449 a quad
// at a time, the 1M one 0.00625 against 0.00630 (H100, 700 W).
__device__ __forceinline__ void flat_read8(const FlatSource& s, int64_t o, uint4& lo, uint4& hi) {
  if (!s.ptr) {
    lo = hi = s.splat;
    return;
  }
  const uint4 h = __ldcs(static_cast<const uint4*>(s.ptr) + o);
  lo = sm_widen4(make_uint2(h.x, h.y), SM_BF16);
  hi = sm_widen4(make_uint2(h.z, h.w), SM_BF16);
}

template <SmOpcode OP>
__device__ __forceinline__ void flat_single8(const SmParams& p, void* __restrict__ out,
                                             int64_t n8) {
  const SmInst in = p.insts[0];
  const FlatSource a = flat_source(p, in.a), b = flat_source(p, in.b), c = flat_source(p, in.c);
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t o = (int64_t)blockIdx.x * kThreads + threadIdx.x; o < n8; o += stride) {
    uint4 alo, ahi, blo, bhi, clo, chi;
    flat_read8(a, o, alo, ahi);
    flat_read8(b, o, blo, bhi);
    flat_read8(c, o, clo, chi);
    const uint4 lo = sm_exec_lanes(OP, alo, blo, clo), hi = sm_exec_lanes(OP, ahi, bhi, chi);
    const uint2 plo = sm_pack_bf16x4(lo), phi = sm_pack_bf16x4(hi);
    static_cast<uint4*>(out)[o] = make_uint4(plo.x, plo.y, phi.x, phi.y);
  }
}

}  // namespace

// Counterpart of _build_call_1d for a program of one instruction (every
// eager unary and binary op): every operand is contiguous and full-size or
// a single element.  With p.vec (every full operand and the output a 4-byte
// type at a 16-byte boundary or a 2-byte type at an 8-byte one) whole quads
// go through flat_single (whole octs first where ``octs``), and the last
// n % 4 elements through the per-element interpreter; without it every
// element does.  Any other program runs the kernel generated for it
// (sm_ew_launch_flat_kernel).  Two kernels, so that a launch of 4-byte
// types alone runs code with no width to choose: NARROW where a full
// operand or the result is 2 bytes wide (the launcher decides,
// flat_narrow).
template <bool NARROW>
__global__ void __launch_bounds__(kThreads) ew_flat(const __grid_constant__ SmParams p,
                                                    void* __restrict__ out, int octs) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (p.vec) {
    // The launcher takes only flat_is_single programs here.  The opcode is
    // chosen once, and is a constant inside flat_single (and flat_single8,
    // which takes the whole octs and leaves flat_single the quads after
    // them).
    const int64_t n4 = p.n / 4;
    const int64_t q0 = NARROW && octs ? p.n / 8 * 2 : 0;
#define SM_CASE_FLAT(OP)                                   \
  case OP:                                                 \
    if constexpr (NARROW) {                                \
      if (q0) flat_single8<OP>(p, out, q0 / 2);            \
    }                                                      \
    flat_single<OP, NARROW>(p, out, q0, n4);               \
    break;
    switch (p.insts[0].op) { SM_FOR_EACH_OPCODE(SM_CASE_FLAT) }
#undef SM_CASE_FLAT
    done = n4 * 4;
    if (tid >= p.n - done) return;
  }
  uint32_t r[SM_MAX_REGS];
  sm_load_consts(p, r);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = done + tid; i < p.n; i += stride) sm_flat_one(p, r, out, i);
}

// Counterpart of _build_call: contiguous output of rank <= 8; each operand
// read in place through its own signed strides (0 = broadcast, negative =
// a negative-step view).
__global__ void __launch_bounds__(kThreads) ew_strided(const __grid_constant__ SmParams p,
                                                       void* __restrict__ out) {
  uint32_t r[SM_MAX_REGS];
  sm_load_consts(p, r);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < p.n; i += stride) {
    sm_load_strided(p, r, i);
    sm_store(out, i, p.out_dtype, sm_run(p, r));
  }
}

namespace {

// The blocks of ew_flat<NARROW> that the card runs at once: its quad path
// launches no more and strides over the rest.  Asked once.
template <bool NARROW>
cudaError_t flat_resident_blocks(int64_t* resident) {
  static int64_t blocks = 0;
  if (blocks == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t rc = cudaGetDevice(&device);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ew_flat<NARROW>, kThreads, 0);
    if (rc != cudaSuccess) return rc;
    if (sms < 1 || per_sm < 1) return cudaErrorLaunchOutOfResources;
    blocks = (int64_t)sms * per_sm;
  }
  *resident = blocks;
  return cudaSuccess;
}

// Whether a launch on ew_flat's quad path has a 2-byte full operand or
// result (ew_flat<true>), and whether all of them are, at a 16-byte
// boundary, in a program of one instruction (``octs``).
bool flat_narrow(const SmParams& p, const void* out, int* octs) {
  bool narrow = p.out_dtype == SM_BF16, all = narrow && (uintptr_t)out % 16 == 0;
  for (int o = 0; o < p.n_ops; ++o)
    if (!p.ops[o].scalar) {
      const bool o_narrow = p.ops[o].dtype == SM_BF16;
      narrow = narrow || o_narrow;
      all = all && o_narrow && (uintptr_t)p.ops[o].ptr % 16 == 0;
    }
  *octs = all && flat_is_single<true>(p);
  return narrow;
}

}  // namespace

extern "C" int sm_ew_launch(const SmParams* p, void* out, int strided, void* stream) {
  int64_t blocks = (p->n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  int octs = 0;
  const bool narrow = !strided && p->vec && flat_narrow(*p, out, &octs);
  if (!strided && p->vec) {
    if (!(narrow ? flat_is_single<true>(*p) : flat_is_single<false>(*p)))
      return (int)cudaErrorInvalidValue;  // a longer program runs its generated kernel
    // One quad (or oct) a thread a pass; the blocks stride over the rest.
    int64_t resident = 0;
    const cudaError_t rc =
        narrow ? flat_resident_blocks<true>(&resident) : flat_resident_blocks<false>(&resident);
    if (rc != cudaSuccess) return (int)rc;
    blocks = (p->n / (octs ? 8 : 4) + kThreads - 1) / kThreads;
    if (blocks > resident) blocks = resident;
  }
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (strided)
    ew_strided<<<(unsigned)blocks, kThreads, 0, s>>>(*p, out);
  else if (narrow)
    ew_flat<true><<<(unsigned)blocks, kThreads, 0, s>>>(*p, out, octs);
  else
    ew_flat<false><<<(unsigned)blocks, kThreads, 0, s>>>(*p, out, 0);
  return (int)cudaGetLastError();
}

// A generated kernel of ew_strided's route "generated" (nvrtc.cu loads it),
// launched with ew_strided's geometry and parameter block.
extern "C" int sm_ew_launch_kernel(const void* kernel, const SmParams* p, void* out, void* stream) {
  int64_t blocks = (p->n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  void* args[] = {const_cast<SmParams*>(p), &out};
  const cudaError_t rc = cudaLaunchKernel(kernel, dim3((unsigned)blocks), dim3(kThreads), args, 0,
                                          static_cast<cudaStream_t>(stream));
  return (int)(rc != cudaSuccess ? rc : cudaGetLastError());
}

// ew_flat's generated kernel for a program of more than one instruction
// (ops/codegen.py, kind "flat"), with ew_flat's geometry: with p->vec one
// quad a thread a pass, at most the ``resident`` blocks the card runs at
// once, which stride over the rest; else an element a thread a pass.
extern "C" int sm_ew_launch_flat_kernel(const void* kernel, const SmParams* p, void* out,
                                        long long resident, void* stream) {
  int64_t blocks = (p->n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (p->vec) {
    blocks = (p->n / 4 + kThreads - 1) / kThreads;
    if (blocks > resident) blocks = resident;
  }
  if (blocks < 1) blocks = 1;
  void* args[] = {const_cast<SmParams*>(p), &out};
  const cudaError_t rc = cudaLaunchKernel(kernel, dim3((unsigned)blocks), dim3(kThreads), args, 0,
                                          static_cast<cudaStream_t>(stream));
  return (int)(rc != cudaSuccess ? rc : cudaGetLastError());
}

extern "C" int sm_ew_params_size() { return (int)sizeof(SmParams); }
