// The map-reduce kernel for Hopper (sm_90a): what its sources share.
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
// (tiles.cuh, program.cuh) evaluated in registers, each result cast to the
// accumulator and combined at once, so the mapped expression never goes to
// device memory.  The identity program is a plain reduction, a*b (with its
// casts) the dot, any fused expression a map-reduce.  Every operand is read
// in place through (pointer, signed strides): stride 0 reads broadcast
// rows, columns and scalars, negative strides read negative-step views.
// Ragged sizes need no index operand: the loop bounds mask them.
//
// Accumulator: f32 whatever the input float type; each mapped value is
// cast to f32 first, as the TPU kernels do (reduction.py:300, :357).  The
// int32 dot accumulates in uint32_t, wrapping mod 2^32 (signed overflow is
// undefined in C++), in rd_full and, for the rows of a dot under vmap, in
// rd_axis along axis 1.  Identities 0, -inf, +inf; max/min propagate NaN as
// jnp.max does (sm_max_f/sm_min_f, never fmaxf/fminf, which drop it).
//
// What bounds it on an H100: device-memory bandwidth.  The bench shapes
// stream 256 MB once (Array.sum of 64M f32, the dot of two 32M vectors,
// the fused squared distance of two 32M vectors, the (8192, 8192) axis
// reductions), about 80 us at 3.35 TB/s, with one combine per element.  So
// the design spends as few instructions per element as the program allows,
// and keeps several quad loads a thread in flight:
//   - the unit of work is a quad, 4 consecutive elements (of a row, for
//     rd_axis), read with one 16-byte load per operand of a 4-byte type, or
//     one 8-byte load of a 2-byte type (bf16, f16) widened in registers to
//     the f32 bits its element-by-element load gives (sm_load_quad2), and
//     evaluated on the four lanes of a uint4 at once;
//   - the wrapper (ops/reduction.py::path) decides how a launch evaluates a
//     quad, and each way is a kernel of its own, with its own registers:
//       direct  the identity program: the operand is the value;
//       single  a sum of one instruction whose result is the program's
//               (the dot, an eager op fused into a sum): the opcode is
//               chosen once per thread and is a constant in the loop, the
//               sources are operands, splatted scalars or splatted
//               constants, and there is no register file; an instruction
//               whose result is bf16 rounds each lane (sm_bf16r4), as the
//               interpreter does;
//       generated  any other program, and any program whose operands do
//               not allow quad loads (strided, negative-step, unaligned,
//               1-byte types): an evaluator generated for the program, the
//               reduction and the walk, compiled at run time
//               (ops/codegen.py, kind "reduce"; sm_rd_launch_kernel), with
//               the interface of RdLanes4 below and handed to the same
//               walks: its registers uint4 local variables, every
//               instruction sm_exec on each lane with its opcode a literal,
//               each operand read at the constant width of its type,
//               scalars and constants splatted once; rd_full also walks the
//               rows of a 2-D expression with (1, C), (R, 1) operands so, a
//               quad at a time; gathered operands are read element by
//               element into quads;
//       lanes4, element  the interpreter on uint4 registers (RdLanes4), one
//               dispatch per instruction for four elements, on quads loaded
//               whole or gathered: reduction.interpret alone launches it,
//               the reference the generated evaluators are held to;
//     each operand is read at the width of its own type (in the hoisted
//     loop and the interpreter a uniform branch in the loaders, a 2-byte
//     quad behind a call), so programs that mix f32 and bf16 take the same
//     loops;
//   - the direct loop asks for four quads a thread before it combines
//     them, the hoisted loop for two (their loads are in flight together);
//   - rd_axis, axis 0: a block is 32 column quads by 8 row lanes; a warp
//     reads 512 contiguous bytes of a row, the 8 warps 8 different rows,
//     and the row lanes are combined through shared memory; (1, C)
//     operands are loaded once before the row loop;
//   - rd_axis, axis 1: a block a row (a warp a row where a row has at most
//     32 quads), quad loads along the row;
//   - a block's threads are combined by warp shuffles and one stage of
//     shared memory.
//
// Deterministic: no atomics.  A thread owns the same quads on every path
// and combines them in the same order (ascending, lane by lane); a warp
// combines by a butterfly of shuffles, a block its warps in index order,
// and a second launch combines the blocks' partials in index order.  The
// grid and every order depend on the shape alone, so two launches give the
// same bits, an unaligned view gives the bits of its contiguous clone, and
// the identity's direct path the bits of the same reduction through the
// interpreter.  A quad's lanes hold the same bits whether it was loaded
// whole or gathered, so a 2-byte operand's quad path gives the element
// path's bits too.
//
// Launch: on the caller's stream; allocates nothing; returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// Sources: reduction.cu (the entry points and the second passes),
// reduction_full.cu, reduction_cols.cu and reduction_rows.cu (the kernels of
// one walk each, over this header), so that nvcc builds them side by side:
// in one file they took it 48 s.
#pragma once

#include "program.cuh"

enum RdOp : int32_t { RD_SUM = 0, RD_MAX = 1, RD_MIN = 2, RD_SUM_I32 = 3 };
// How a launch evaluates a quad (ops/reduction.py::path decides).
// RD_DIRECT2 is the direct loop over a 2-byte operand, its width a constant:
// the launcher takes it for path RD_DIRECT by the operand's type.
enum RdPath : int32_t {
  RD_DIRECT = 0, RD_SINGLE = 1, RD_LANES4 = 2, RD_ELEMENT = 3, RD_DIRECT2 = 4
};
// How rd_full reaches its operands: as flat data (contiguous full-size
// operands and single elements); through their strides over p.shape, rank
// <= 8 (the element path only); or, for a (rows, cols) expression whose
// operands are full-size, (1, C) rows, (R, 1) columns or single elements
// with rows aligned to whole quads, a quad at a time along the rows (the
// generated evaluators and the interpreter only).
enum RdReach : int32_t { RD_FLAT = 0, RD_STRIDED = 1, RD_ROWS = 2 };

// ``p`` is the program over the mapped expression's shape (rank 2 for
// rd_axis).  ``blocks``: rd_full's partial blocks; rd_axis's row segments
// (axis 0) or blocks (axis 1).  ``seg_rows``: rows per segment (axis 0), or
// the rows a block takes at once (axis 1: 8, a warp each, or 1).
// ``strided``: how rd_full reaches its operands (RdReach).
struct RdParams {
  SmParams p;
  int32_t op;
  int32_t strided;
  int64_t blocks;
  int64_t seg_rows;
  int32_t axis;
  int32_t path;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <int OP>
__device__ __forceinline__ uint4 rd_combine4(uint4 a, uint4 b) {
  return make_uint4(rd_combine<OP>(a.x, b.x), rd_combine<OP>(a.y, b.y),
                    rd_combine<OP>(a.z, b.z), rd_combine<OP>(a.w, b.w));
}

// The first ``nvalid`` lanes of a quad combined into ``acc`` in lane order.
template <int OP>
__device__ __forceinline__ uint32_t rd_fold(uint32_t acc, uint4 v, int nvalid) {
  acc = rd_combine<OP>(acc, v.x);
  if (nvalid > 1) acc = rd_combine<OP>(acc, v.y);
  if (nvalid > 2) acc = rd_combine<OP>(acc, v.z);
  if (nvalid > 3) acc = rd_combine<OP>(acc, v.w);
  return acc;
}

__device__ __forceinline__ uint32_t rd_i2f(uint32_t v) { return sm_u((float)(int32_t)v); }
__device__ __forceinline__ uint32_t rd_u2f(uint32_t v) { return sm_u((float)v); }
__device__ __forceinline__ uint32_t rd_b2f(uint32_t v) { return sm_u(v ? 1.0f : 0.0f); }

// A quad of program results of type ``dtype`` as accumulator values (a
// bf16 or f16 result is already f32 bits in its register).
template <int OP>
__device__ __forceinline__ uint4 rd_value4(int32_t dtype, uint4 v) {
  if (OP == RD_SUM_I32) return v;
  if (dtype == SM_I32) return make_uint4(rd_i2f(v.x), rd_i2f(v.y), rd_i2f(v.z), rd_i2f(v.w));
  if (dtype == SM_U32) return make_uint4(rd_u2f(v.x), rd_u2f(v.y), rd_u2f(v.z), rd_u2f(v.w));
  if (dtype == SM_BOOL) return make_uint4(rd_b2f(v.x), rd_b2f(v.y), rd_b2f(v.z), rd_b2f(v.w));
  return v;
}

// The register type an opcode writes, or -1 where it is its operands'
// (SELECT, BITS): what lets rd_value4's branch fold in the hoisted loop.
__host__ __device__ constexpr int32_t rd_result_dtype(SmOpcode op) {
  if (op <= POW_F || op == I2F || op == B2F || op == U2F) return SM_F32;
  if ((op >= ADD_I && op <= IPOW_I) || op == F2I || op == B2I || op == FDIV_I || op == MOD_I)
    return SM_I32;
  if (op == MAX_U || op == MIN_U || op == SIGN_U || op == F2U || op == FDIV_U || op == MOD_U)
    return SM_U32;
  if (op == SELECT || op == BITS) return -1;
  return SM_BOOL;
}

// The opcodes the hoisted loop is built for (HOISTED in ops/reduction.py):
// not the crafted transcendentals, the trigonometric functions and the
// integer power, which cost tens to hundreds of operations an element
// whoever dispatches them, and whose inlined bodies took nvcc 50 s (98 s
// for these kernels with them, 48 s without); not the unsigned, bit-copy
// and integer-division opcodes (LT_U on), which a reduction rarely ends
// in, so that nvcc builds no loop for them; for the int32 sum the integer
// ones.
template <int OP>
__host__ __device__ constexpr bool rd_single_takes(SmOpcode op) {
  if ((op >= EXP_F && op <= POW_F) || op == IPOW_I || op >= LT_U) return false;
  return OP == RD_SUM || (OP == RD_SUM_I32 && (rd_result_dtype(op) == SM_I32 || op == SELECT));
}

// A warp's values combined by a butterfly of shuffles; lane 0's result is
// the one that is used.
template <int OP>
__device__ __forceinline__ uint32_t rd_warp(uint32_t v) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) v = rd_combine<OP>(v, __shfl_xor_sync(0xffffffffu, v, w));
  return v;
}

// The block's values combined: each warp's, then the warps' in index
// order; every thread gets the result.
template <int OP>
__device__ __forceinline__ uint32_t rd_block(uint32_t v) {
  __shared__ uint32_t s[kWarps];
  v = rd_warp<OP>(v);
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t out = s[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) out = rd_combine<OP>(out, s[w]);
  __syncthreads();
  return out;
}

// ------------------------------------------------------------- sources
// Where a quad's position is (i, jq): row i (0 for flat data) and quad jq
// of that row, elements 4 * jq .. 4 * jq + 3, the first ``nvalid`` of them
// inside the data.

// A source register of the direct and the hoisted loops, whose operands
// all allow quad loads: an operand of type ``dtype`` read through its row
// stride ``rs`` and a column stride ``cs`` of 1 (a full operand or a (1, C)
// row) or 0 (an (R, 1) column), or, with ``ptr`` null, the same ``splat``
// for every quad (a constant, a one-element operand, or a row the walk has
// loaded once).
struct RdSource {
  const void* ptr;
  int64_t rs, cs;
  int32_t dtype;
  uint4 splat;
};

template <bool FLAT>
__device__ __forceinline__ RdSource rd_source(const SmParams& p, int reg) {
  RdSource s;
  s.ptr = nullptr;
  s.rs = 0;
  s.cs = 0;
  s.dtype = SM_F32;
  s.splat = sm_splat(0u);
  if (reg >= p.n_ops) {
    s.splat = sm_splat(p.consts[reg - p.n_ops]);
  } else if (p.ops[reg].scalar) {
    s.splat = sm_splat(sm_load(p.ops[reg].ptr, 0, p.ops[reg].dtype));
  } else {
    s.ptr = p.ops[reg].ptr;
    s.dtype = p.ops[reg].dtype;
    s.rs = FLAT ? 0 : p.ops[reg].strides[0];
    s.cs = FLAT ? 1 : p.ops[reg].strides[1];
  }
  return s;
}

// Quad jq of the row that starts ``off`` elements into ``ptr``: one load of
// the whole quad (16 bytes of a 4-byte type; 8 bytes of a 2-byte type,
// NARROW, widened by sm_load_quad2), or, for the ragged last quad, its
// valid elements one by one.
template <bool NARROW>
__device__ __forceinline__ uint4 rd_load_quad(const void* ptr, int64_t off, int64_t jq, int nvalid,
                                              int32_t dtype) {
  uint4 v = sm_splat(0u);
  if (NARROW) {
    if (nvalid == 4) return sm_load_quad2(static_cast<const uint16_t*>(ptr) + off, jq, dtype);
    const int64_t e = off + jq * 4;
    v.x = sm_load(ptr, e, dtype);
    if (nvalid > 1) v.y = sm_load(ptr, e + 1, dtype);
    if (nvalid > 2) v.z = sm_load(ptr, e + 2, dtype);
    return v;
  }
  const uint32_t* row = static_cast<const uint32_t*>(ptr) + off;
  if (nvalid == 4) return reinterpret_cast<const uint4*>(row)[jq];
  const uint32_t* e = row + jq * 4;
  v.x = e[0];
  if (nvalid > 1) v.y = e[1];
  if (nvalid > 2) v.z = e[2];
  return v;
}

// The quad (or, for a column, cs = 0, the row's element) of a 2-byte
// operand where its type is known at run time only (the hoisted and the
// lanes4 loops), behind a call: those loops read each source in the loop
// of each opcode, and one copy of the widening serves them all (inlined,
// it took ptxas 54 s for the axis-0 kernel of the hoisted loop, against
// 4 s).
__device__ __noinline__ uint4 rd_read_narrow(const void* ptr, int64_t off, int64_t cs, int64_t jq,
                                             int nvalid, int32_t dtype) {
  if (cs == 0) return sm_splat(sm_load(ptr, off, dtype));
  return rd_load_quad<true>(ptr, off, jq, nvalid, dtype);
}

// A source's quad at (i, jq).  W is the width of its type in bytes where
// the loop knows it (4, or 2 for the direct loop over a 2-byte operand), or
// 0: a uniform branch on the type, a 2-byte one read by rd_read_narrow.
template <int W>
__device__ __forceinline__ uint4 rd_read(const RdSource& s, int64_t i, int64_t jq, int nvalid) {
  if (!s.ptr) return s.splat;
  const int64_t off = i * s.rs;
  if (W == 0 && sm_narrow(s.dtype)) return rd_read_narrow(s.ptr, off, s.cs, jq, nvalid, s.dtype);
  if (W == 2) {
    if (s.cs == 0) return sm_splat(sm_load(s.ptr, off, s.dtype));
    return rd_load_quad<true>(s.ptr, off, jq, nvalid, s.dtype);
  }
  if (s.cs == 0) return sm_splat(static_cast<const uint32_t*>(s.ptr)[off]);
  return rd_load_quad<false>(s.ptr, off, jq, nvalid, s.dtype);
}

// For a thread that keeps quad column jq (axis 0): a (1, C) row is loaded
// now, once, not again for every row.
__device__ __forceinline__ void rd_keep_column(RdSource& s, int64_t jq, int nvalid) {
  if (s.ptr && s.rs == 0) {
    s.splat = rd_read<0>(s, 0, jq, nvalid);
    s.ptr = nullptr;
  }
}

// --------------------------------------------------------- evaluators
// An evaluator gives the quad at (i, jq) as four accumulator values.  With
// ``kBatch`` > 1 the walks ask for that many whole quads before they
// combine them (rd_batch), so that their loads are in flight together.
template <class E>
__device__ __forceinline__ void rd_batch(const E& eval, const int64_t* i, const int64_t* jq,
                                         int nvalid, uint4* out) {
#pragma unroll
  for (int u = 0; u < E::kBatch; ++u) out[u] = eval(i[u], jq[u], nvalid);
}

// The identity program, over a 4-byte operand or (NARROW) a 2-byte one, the
// width a constant, its widening inline.  Four quads a thread at a time
// either way: eight 8-byte quads (as many bytes in flight as four 16-byte
// ones) took 47 registers a thread, so fewer blocks ran at once, and 0.0708
// ms for the 64M bf16 sum against four's 0.0525 (H100, 700 W).
template <int OP, bool FLAT, bool NARROW>
struct RdDirect {
  static constexpr int kBatch = 4;
  RdSource x;
  int32_t dtype;
  __device__ __forceinline__ explicit RdDirect(const RdParams& q)
      : x(rd_source<FLAT>(q.p, q.p.result)), dtype(q.p.out_dtype) {}
  __device__ __forceinline__ void keep_column(int64_t jq, int nvalid) {
    rd_keep_column(x, jq, nvalid);
  }
  __device__ __forceinline__ uint4 operator()(int64_t i, int64_t jq, int nvalid) const {
    return rd_value4<OP>(dtype, rd_read<NARROW ? 2 : 4>(x, i, jq, nvalid));
  }
};

// One instruction, its opcode a constant: sm_exec folds to that opcode's
// body, so the values are the interpreter's bit for bit, and a source the
// opcode does not read is never loaded (its load is dead code).
template <int OP, SmOpcode OPC, bool FLAT>
struct RdSingle {
  static constexpr int kBatch = 2;  // 64M x * 1.0: 0.0947 ms; with 4, 0.0988; the dot alike
  RdSource a, b, c;
  int32_t dtype;
  bool rnd;
  __device__ __forceinline__ explicit RdSingle(const RdParams& q)
      : a(rd_source<FLAT>(q.p, q.p.insts[0].a)),
        b(rd_source<FLAT>(q.p, q.p.insts[0].b)),
        c(rd_source<FLAT>(q.p, q.p.insts[0].c)),
        dtype(rd_result_dtype(OPC) >= 0 ? rd_result_dtype(OPC) : q.p.out_dtype),
        rnd(q.p.insts[0].rnd != 0) {}
  __device__ __forceinline__ void keep_column(int64_t jq, int nvalid) {
    rd_keep_column(a, jq, nvalid);
    rd_keep_column(b, jq, nvalid);
    rd_keep_column(c, jq, nvalid);
  }
  __device__ __forceinline__ uint4 operator()(int64_t i, int64_t jq, int nvalid) const {
    const uint4 va = rd_read<0>(a, i, jq, nvalid), vb = rd_read<0>(b, i, jq, nvalid),
                vc = rd_read<0>(c, i, jq, nvalid);
    const uint4 v = sm_exec_lanes(OPC, va, vb, vc);
    return rd_value4<OP>(dtype, rnd ? sm_bf16r4(v) : v);
  }
};

// The interpreter on uint4 registers, behind a call: one copy of its switch
// for all the kernels of a source file.  (Inlined it was 3 % faster and
// took nvcc 20 s more.  On registers of a pair of quads, one dispatch for
// eight elements, the fused distance took 0.264 ms for 0.279, but the
// thresholded axis sums 0.338 and 0.351 for 0.296 and 0.283: the register
// file of 5.6 KB a thread and 80 registers cost more than the dispatch
// saved.  Reading only the sources an opcode uses changed nothing.)
__device__ __noinline__ uint4 rd_run4(const SmParams& p, uint4* r) { return sm_run4(p, r); }

// A quad of operand ``x`` gathered element by element: any of the operand
// types, any signed strides, through (row stride, column stride), the
// offset advanced by the column stride.
// ``dtype`` is the operand's (a constant in a generated evaluator).
template <bool FLAT>
__device__ __forceinline__ uint4 rd_gather_as(const SmOperand& x, int32_t dtype, int64_t i,
                                              int64_t jq, int nvalid) {
  const int64_t rs = FLAT ? 0 : x.strides[0];
  const int64_t cs = FLAT ? 1 : x.strides[1];
  int64_t off = i * rs + jq * 4 * cs;
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e < nvalid) v[e] = sm_load(x.ptr, off, dtype);
    off += cs;
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

template <bool FLAT>
__device__ __forceinline__ uint4 rd_gather(const SmOperand& x, int64_t i, int64_t jq,
                                           int nvalid) {
  return rd_gather_as<FLAT>(x, x.dtype, i, jq, nvalid);
}

// The same for rd_full's operands that are read through their strides over
// p.shape (rank <= 8): the coordinates of element 4 * jq, advanced like an
// odometer.
__device__ __noinline__ uint4 rd_gather_strided(const SmParams& p, const SmOperand& x,
                                                int64_t jq, int nvalid) {
  int64_t coord[SM_MAX_RANK];
  int64_t rem = jq * 4, off = 0;
  for (int d = p.rank - 1; d >= 0; --d) {
    coord[d] = rem % p.shape[d];
    rem /= p.shape[d];
    off += coord[d] * x.strides[d];
  }
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e < nvalid) {
      v[e] = sm_load(x.ptr, off, x.dtype);
      for (int d = p.rank - 1; d >= 0; --d) {
        off += x.strides[d];
        if (++coord[d] < p.shape[d]) break;
        off -= coord[d] * x.strides[d];
        coord[d] = 0;
      }
    }
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// Any program, a quad at a time: the interpreter, which only
// reduction.interpret launches (the reference of the generated evaluators,
// ops/codegen.py, which have its interface).  Register ``o`` of operand o
// is set once where it is the same for every quad of the thread (bit o of
// ``kept``): one-element operands here, (1, C) rows in keep_column.  The
// others are loaded four at a time before they go to the register file
// (local memory), so that their loads are in flight together.
template <int OP, bool FLAT>
struct RdLanes4 {
  static constexpr int kBatch = 1;
  const RdParams& q;
  uint4* r;
  uint32_t kept;
  __device__ __forceinline__ RdLanes4(const RdParams& q_, uint4* r_) : q(q_), r(r_), kept(0u) {
    const SmParams& p = q.p;
    sm_load_consts4(p, r);
    for (int o = 0; o < p.n_ops; ++o)
      if (p.ops[o].scalar) {
        r[o] = sm_splat(sm_load(p.ops[o].ptr, 0, p.ops[o].dtype));
        kept |= 1u << o;
      }
  }
  __device__ __forceinline__ uint4 load(int o, int64_t i, int64_t jq, int nvalid) const {
    const SmOperand& x = q.p.ops[o];
    if (q.path == RD_ELEMENT) {
      if (FLAT && q.strided == RD_STRIDED) return rd_gather_strided(q.p, x, jq, nvalid);
      return rd_gather<FLAT>(x, i, jq, nvalid);
    }
    const int64_t off = FLAT ? 0 : i * x.strides[0];
    if (sm_narrow(x.dtype))
      return rd_read_narrow(x.ptr, off, FLAT ? 1 : x.strides[1], jq, nvalid, x.dtype);
    const uint32_t* row = static_cast<const uint32_t*>(x.ptr) + off;
    if (!FLAT && x.strides[1] == 0) return sm_splat(row[0]);
    return rd_load_quad<false>(row, 0, jq, nvalid, x.dtype);
  }
  __device__ __forceinline__ void keep_column(int64_t jq, int nvalid) {
    const SmParams& p = q.p;
    for (int o = 0; o < p.n_ops; ++o)
      if (!(kept >> o & 1u) && p.ops[o].strides[0] == 0) {
        r[o] = load(o, 0, jq, nvalid);
        kept |= 1u << o;
      }
  }
  __device__ __forceinline__ uint4 operator()(int64_t i, int64_t jq, int nvalid) const {
    const SmParams& p = q.p;
    if (p.n_insts == 0 && p.result < p.n_ops) {
      // The identity program (of operands on the element path): nothing to
      // interpret, and no trip through the register file.
      const int o = p.result;
      return rd_value4<OP>(p.out_dtype, (kept >> o & 1u) ? r[o] : load(o, i, jq, nvalid));
    }
    for (int o0 = 0; o0 < p.n_ops; o0 += 4) {
      uint4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (o0 + j < p.n_ops && !(kept >> (o0 + j) & 1u)) v[j] = load(o0 + j, i, jq, nvalid);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (o0 + j < p.n_ops && !(kept >> (o0 + j) & 1u)) r[o0 + j] = v[j];
    }
    return rd_value4<OP>(p.out_dtype, rd_run4(p, r));
  }
};

// -------------------------------------------------------------- walks
// A walk gives each thread its quads, the same on every path, and combines
// what the evaluator makes of them in a fixed order.

// rd_full, pass 1: thread t of the grid owns quads t, t + T, t + 2T, ...
// and folds them in ascending order, lane by lane; the block's partial
// goes to partial[blockIdx.x].
template <int OP>
struct RdFullWalk {
  const RdParams& q;
  uint32_t* partial;
  template <class E>
  __device__ __forceinline__ void operator()(E& eval) const {
    const int64_t n = q.p.n;
    const int64_t quads = (n + 3) / 4, whole = n / 4;
    const int64_t stride = (int64_t)gridDim.x * kThreads;
    uint32_t acc = rd_identity<OP>();
    int64_t qd = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    constexpr int B = E::kBatch;
    if constexpr (B > 1) {
      for (; qd + (B - 1) * stride < whole; qd += B * stride) {
        int64_t i[B], jq[B];
        uint4 v[B];
#pragma unroll
        for (int u = 0; u < B; ++u) i[u] = 0, jq[u] = qd + u * stride;
        rd_batch(eval, i, jq, 4, v);
#pragma unroll
        for (int u = 0; u < B; ++u) acc = rd_fold<OP>(acc, v[u], 4);
      }
    }
    for (; qd < quads; qd += stride) {
      const int nvalid = qd < whole ? 4 : (int)(n - qd * 4);
      acc = rd_fold<OP>(acc, eval(0, qd, nvalid), nvalid);
    }
    acc = rd_block<OP>(acc);
    if (threadIdx.x == 0) partial[blockIdx.x] = acc;
  }
  // The same over a (rows, cols) expression (RD_ROWS): the quads are those
  // of the rows, row after row, the last one of a row ragged where cols is
  // no multiple of 4; a thread steps from quad to quad without dividing.
  template <class E>
  __device__ __forceinline__ void rows(E& eval) const {
    const int64_t cols = q.p.shape[1];
    const int64_t cquads = (cols + 3) / 4, quads = q.p.shape[0] * cquads;
    const int64_t stride = (int64_t)gridDim.x * kThreads;
    const int64_t di = stride / cquads, dj = stride % cquads;
    uint32_t acc = rd_identity<OP>();
    int64_t qd = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    int64_t i = qd / cquads, jq = qd % cquads;
    for (; qd < quads; qd += stride) {
      const int64_t left = cols - jq * 4;
      const int nvalid = left >= 4 ? 4 : (int)left;
      acc = rd_fold<OP>(acc, eval(i, jq, nvalid), nvalid);
      i += di;
      jq += dj;
      if (jq >= cquads) {
        jq -= cquads;
        ++i;
      }
    }
    acc = rd_block<OP>(acc);
    if (threadIdx.x == 0) partial[blockIdx.x] = acc;
  }
};

// rd_axis, axis 0, pass 1: a block is 32 quad columns (lane) by 8 row
// lanes (warp) over one segment of seg_rows rows (blockIdx.y).  A thread
// keeps four accumulators, one per column of its quad, and combines its
// rows in ascending order; the 8 row lanes are combined in index order
// through shared memory (``s``: one quad per thread, the kernel's, so that
// the evaluators of a kernel share it).  The partials' rows are padded to
// whole quads.
template <int OP>
struct RdColsWalk {
  const RdParams& q;
  uint32_t* partial;
  uint4 (*s)[32];
  template <class E>
  __device__ __forceinline__ void operator()(E& eval) const {
    const int64_t rows = q.p.shape[0], cols = q.p.shape[1];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t cquads = (cols + 3) / 4;
    const int64_t jq = (int64_t)blockIdx.x * 32 + lane;
    const int64_t left = cols - jq * 4;
    const int nvalid = left >= 4 ? 4 : (left > 0 ? (int)left : 0);
    const int64_t i0 = (int64_t)blockIdx.y * q.seg_rows;
    const int64_t i1 = i0 + q.seg_rows < rows ? i0 + q.seg_rows : rows;
    uint4 acc = sm_splat(rd_identity<OP>());
    if (nvalid > 0) {
      eval.keep_column(jq, nvalid);
      int64_t i = i0 + warp;
      constexpr int B = E::kBatch;
      if constexpr (B > 1) {
        for (; i + (B - 1) * kWarps < i1; i += B * kWarps) {
          int64_t ii[B], jj[B];
          uint4 v[B];
#pragma unroll
          for (int u = 0; u < B; ++u) ii[u] = i + u * kWarps, jj[u] = jq;
          rd_batch(eval, ii, jj, nvalid, v);
#pragma unroll
          for (int u = 0; u < B; ++u) acc = rd_combine4<OP>(acc, v[u]);
        }
      }
      for (; i < i1; i += kWarps) acc = rd_combine4<OP>(acc, eval(i, jq, nvalid));
    }
    s[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && nvalid > 0) {
      uint4 out = s[0][lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) out = rd_combine4<OP>(out, s[w][lane]);
      reinterpret_cast<uint4*>(partial)[(int64_t)blockIdx.y * cquads + jq] = out;
    }
  }
};

// rd_axis, axis 1: a row's quads are folded in ascending order, lane by
// lane, by the threads of a block (quad jq by thread jq % 256), or, where a
// row has at most 32 quads (seg_rows = 8), by the lanes of a warp, a block
// taking 8 rows at once.
template <int OP>
struct RdRowsWalk {
  const RdParams& q;
  uint32_t* out;
  template <class E>
  __device__ __forceinline__ void operator()(E& eval) const {
    const int64_t rows = q.p.shape[0], cols = q.p.shape[1];
    const int64_t cquads = (cols + 3) / 4, whole = cols / 4;
    if (q.seg_rows == kWarps) {
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      for (int64_t i = (int64_t)blockIdx.x * kWarps + warp; i < rows;
           i += (int64_t)gridDim.x * kWarps) {
        uint32_t acc = rd_identity<OP>();
        for (int64_t jq = lane; jq < cquads; jq += 32) {
          const int nvalid = jq < whole ? 4 : (int)(cols - jq * 4);
          acc = rd_fold<OP>(acc, eval(i, jq, nvalid), nvalid);
        }
        acc = rd_warp<OP>(acc);
        if (lane == 0) out[i] = acc;
      }
      return;
    }
    for (int64_t i = blockIdx.x; i < rows; i += gridDim.x) {
      uint32_t acc = rd_identity<OP>();
      int64_t jq = threadIdx.x;
      constexpr int B = E::kBatch;
      if constexpr (B > 1) {
        for (; jq + (B - 1) * kThreads < whole; jq += B * kThreads) {
          int64_t ii[B], jj[B];
          uint4 v[B];
#pragma unroll
          for (int u = 0; u < B; ++u) ii[u] = i, jj[u] = jq + u * kThreads;
          rd_batch(eval, ii, jj, 4, v);
#pragma unroll
          for (int u = 0; u < B; ++u) acc = rd_fold<OP>(acc, v[u], 4);
        }
      }
      for (; jq < cquads; jq += kThreads) {
        const int nvalid = jq < whole ? 4 : (int)(cols - jq * 4);
        acc = rd_fold<OP>(acc, eval(i, jq, nvalid), nvalid);
      }
      acc = rd_block<OP>(acc);
      if (threadIdx.x == 0) out[i] = acc;
    }
  }
};

// The evaluator of kernel <OP, PATH>, handed to ``walk``.  PATH is
// RD_DIRECT, RD_DIRECT2, RD_SINGLE or RD_LANES4; a launch on the element
// path runs the RD_LANES4 kernel, whose loads look at q.path.
template <int OP, int PATH, bool FLAT, class Walk>
__device__ __forceinline__ void rd_run(const RdParams& q, const Walk& walk) {
  if constexpr (PATH == RD_DIRECT || PATH == RD_DIRECT2) {
    RdDirect<OP, FLAT, PATH == RD_DIRECT2> eval(q);
    walk(eval);
  } else if constexpr (PATH == RD_SINGLE) {
#define SM_CASE_RD(OPC)                         \
  case OPC:                                     \
    if constexpr (rd_single_takes<OP>(OPC)) {   \
      RdSingle<OP, OPC, FLAT> eval(q);          \
      walk(eval);                               \
    }                                           \
    break;
    switch (q.p.insts[0].op) { SM_FOR_EACH_OPCODE(SM_CASE_RD) }
#undef SM_CASE_RD
  } else {
    uint4 r[SM_MAX_REGS];
    if constexpr (FLAT) {
      if (q.strided == RD_ROWS) {
        RdLanes4<OP, false> eval(q, r);
        walk.rows(eval);
        return;
      }
    }
    RdLanes4<OP, FLAT> eval(q, r);
    walk(eval);
  }
}


}  // namespace

// The first pass of rd_full, of rd_axis along axis 0, and rd_axis along
// axis 1: kernel <OP, PATH> hands the evaluator of PATH to the walk.
template <int OP, int PATH>
__global__ void __launch_bounds__(kThreads) rd_full_partial(const __grid_constant__ RdParams q,
                                                            uint32_t* __restrict__ partial) {
  rd_run<OP, PATH, true>(q, RdFullWalk<OP>{q, partial});
}

template <int OP, int PATH>
__global__ void __launch_bounds__(kThreads) rd_cols_partial(const __grid_constant__ RdParams q,
                                                            uint32_t* __restrict__ partial) {
  __shared__ uint4 s[kWarps][32];
  rd_run<OP, PATH, false>(q, RdColsWalk<OP>{q, partial, s});
}

template <int OP, int PATH>
__global__ void __launch_bounds__(kThreads) rd_rows(const __grid_constant__ RdParams q,
                                                    uint32_t* __restrict__ out) {
  rd_run<OP, PATH, false>(q, RdRowsWalk<OP>{q, out});
}

// Launch ``KERNEL``<OP, path of q> on ``grid`` blocks; cudaErrorInvalidValue
// where the path has no kernel for OP (the hoisted loop exists for the sums
// and its opcodes only; the element path runs the lanes4 kernel; the direct
// loop over a 2-byte operand is RD_DIRECT2, for the float reductions).
#define RD_LAUNCH_PATH(KERNEL, OP, q, grid, s, arg)                                     \
  do {                                                                                  \
    const int path_ = (q).path == RD_ELEMENT ? (int)RD_LANES4 : (q).path;               \
    if (path_ == RD_DIRECT && sm_narrow((q).p.ops[(q).p.result].dtype)) {               \
      if constexpr (OP != RD_SUM_I32)                                                   \
        KERNEL<OP, RD_DIRECT2><<<grid, kThreads, 0, s>>>(q, arg);                       \
      else                                                                              \
        return (int)cudaErrorInvalidValue;                                              \
    } else if (path_ == RD_DIRECT) {                                                    \
      KERNEL<OP, RD_DIRECT><<<grid, kThreads, 0, s>>>(q, arg);                          \
    } else if (path_ == RD_LANES4) {                                                    \
      KERNEL<OP, RD_LANES4><<<grid, kThreads, 0, s>>>(q, arg);                          \
    } else if (path_ == RD_SINGLE && (q).p.n_insts == 1 &&                              \
               rd_single_takes<OP>((SmOpcode)(q).p.insts[0].op)) {                      \
      if constexpr (OP == RD_SUM || OP == RD_SUM_I32)                                   \
        KERNEL<OP, RD_SINGLE><<<grid, kThreads, 0, s>>>(q, arg);                        \
    } else {                                                                            \
      return (int)cudaErrorInvalidValue;                                                \
    }                                                                                   \
    return (int)cudaGetLastError();                                                     \
  } while (0)

#if !defined(__CUDACC_RTC__)
// The first passes' launchers, one source file each.
int rd_full_partial_launch(const RdParams& q, uint32_t* partial, cudaStream_t s);
int rd_cols_partial_launch(const RdParams& q, uint32_t* partial, cudaStream_t s);
int rd_rows_launch(const RdParams& q, uint32_t* out, cudaStream_t s);
#endif
