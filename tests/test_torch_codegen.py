"""The generated kernels of the strided elementwise kernel, and the
map-reduce kernel's generated evaluators, on the CPU.

``ew_strided`` launches a kernel written for its program and compiled at
run time (ops/codegen.py), whatever the program; its per-element
interpreter stays as ``elementwise.interpret``, the reference.  Held here:
the source of programs of every size, the signature a generated kernel is
cached by (what shares a kernel and what does not), the generated source
for every opcode of ``program.OPCODES``, and the names it uses against the
kernel sources; for the evaluators (kind ``"reduce"``), what their
signatures keep (the walk, the reduction, whether operands are gathered)
and their source on every walk.  ``ew_flat``'s generated kernels are
tests/test_torch_codegen_flat.py's.  The generated kernels run, against the interpreter bit
for bit, on the card (tests/test_torch_kernel_cuda.py).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import simplemath_tpu_torch as sm
from simplemath_tpu_torch.ops import codegen, elementwise, program, reduction, registry

CSRC = pathlib.Path(program.__file__).resolve().parent.parent / "csrc"


@pytest.fixture(autouse=True)
def _cpu():
    old = sm.config.device
    sm.configure(device="cpu")
    yield
    sm.configure(device=old)


def _sums(k, shape=(4, 8)):
    """A program of ``k`` instructions over one operand: x + x + ... + x."""
    x = program.leaf(shape, torch.float32)
    root = x
    for _ in range(k):
        root = root + x
    return program.lower(root, [x])


# ---------------------------------------------- programs of every size
_SIZES = [
    # (instructions, iterations): one-pass programs and recurrences, short
    # and long; every one is generated.
    (0, 100), (1, 1), (6, 1), (63, 1), (64, 1), (1, 63), (1, 64), (6, 10),
    (6, 11), (6, 16), (6, 400), (128, 1),
]


@pytest.mark.parametrize("insts,iterations", _SIZES, ids=str)
def test_every_program_has_a_source_whatever_its_size(insts, iterations):
    prog = _sums(insts)
    assert len(prog.insts) == insts
    sig = elementwise.signature(prog, prog.kernel_codes, (4, 8), [_t(4, 8)], iterations, 0)
    src = codegen.source(sig)
    assert src.count("sm_exec(") == insts and src.count("sm_store(") == 1
    assert ("for (int it = 0; it < p.iterations; ++it) {" in src) is (iterations > 1)
    # The shape never enters: the same program over another shape.
    wide = _sums(insts, (2048, 2048))
    assert codegen.source(elementwise.signature(
        wide, wide.kernel_codes, (2048, 2048), [_t(1, 1).expand(2048, 2048)], iterations, 0)) == src


def test_the_fused_recurrence_shares_one_kernel_across_iterations():
    """The BASELINE recurrence (6 instructions) at L = 16 and 400 is one
    kernel; as a one-pass program it is another, without the loop."""
    def chain(acc, a, e_row):
        return acc * np.float32(1e-3) + sm.exp(sm.pow(a + acc * np.float32(1e-6), e_row))

    leaves = [program.leaf((8, 8), torch.float32), program.leaf((8, 8), torch.float32),
              program.leaf((1, 8), torch.float32)]
    prog = program.lower(chain(*leaves), leaves)
    assert len(prog.insts) == 6
    ops = [_t(8, 8), _t(8, 8), _t(1, 8)]
    one, l16, l400 = (elementwise.signature(prog, prog.kernel_codes, (8, 8), ops, L, 0)
                      for L in (1, 16, 400))
    assert l16 == l400 != one
    assert not one.iterated and l16.iterated


# ----------------------------------------------------------- the signature
def _sig(root_fn, shapes, operands, iterations=1, carry=0, dtypes=None):
    dtypes = dtypes or [torch.float32] * len(shapes)
    leaves = [program.leaf(s, d) for s, d in zip(shapes, dtypes)]
    prog = program.lower(root_fn(*leaves), leaves)
    out_shape = tuple(torch.broadcast_shapes(*shapes))
    return elementwise.signature(prog, prog.kernel_codes, out_shape, operands, iterations, carry)


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def test_signature_leaves_out_constants_shape_and_strides():
    base = _sig(lambda x, r: x * r + 2.0, [(4, 8), (1, 8)], [_t(4, 8), _t(1, 8)])
    assert _sig(lambda x, r: x * r + 3.0, [(4, 8), (1, 8)], [_t(4, 8), _t(1, 8)]) == base
    assert _sig(lambda x, r: x * r + 2.0, [(40, 80), (1, 80)], [_t(40, 80), _t(1, 80)]) == base
    view = elementwise.View(_t(80, 4), 3, (4, 8), (1, -4))  # a transposed, reversed view
    assert _sig(lambda x, r: x * r + 2.0, [(4, 8), (1, 8)], [view, _t(1, 8)]) == base
    assert _sig(lambda x, r: x * r + 2.0, [(4, 8), (4, 8)], [_t(4, 8), _t(4, 8)]) == base
    # The count of iterations is read at run time too.
    l16 = _sig(lambda c, x: c * 0.5 + x, [(4, 8), (4, 8)], [_t(4, 8), _t(4, 8)], 16, 0)
    assert _sig(lambda c, x: c * 0.5 + x, [(4, 8), (4, 8)], [_t(4, 8), _t(4, 8)], 400, 0) == l16
    assert codegen.source(l16) == codegen.source(
        _sig(lambda c, x: c * 0.25 + x, [(8, 8), (8, 8)], [_t(8, 8), _t(8, 8)], 400, 0))


def test_signature_keeps_opcodes_types_rank_and_carry():
    ops2 = [_t(4, 8), _t(1, 8)]
    base = _sig(lambda x, r: x * r + 2.0, [(4, 8), (1, 8)], ops2)
    others = [
        _sig(lambda x, r: x * r - 2.0, [(4, 8), (1, 8)], ops2),                 # an opcode
        _sig(lambda x, r: r * x + 2.0, [(4, 8), (1, 8)], ops2),                 # the wiring
        _sig(lambda x, r: x * r + 2, [(4, 8), (1, 8)],
             [_t(4, 8, dtype=torch.int32), _t(1, 8, dtype=torch.int32)],
             dtypes=[torch.int32, torch.int32]),                                # the types
        _sig(lambda x, r: x * r + 2.0, [(2, 4, 8), (1, 8)], [_t(2, 4, 8), _t(1, 8)]),  # the rank
        _sig(lambda x, r: x * r + 2.0, [(4, 8), (1, 8)], ops2, 16, 0),          # iterated
        _sig(lambda x, r: x * r + 2.0, [(4, 8), (4, 8)], [_t(4, 8), _t(4, 8)], 16, 1),  # the carry
    ]
    keys = [base] + others
    assert len(set(keys)) == len(keys)
    with_carry0 = _sig(lambda x, r: x * r + 2.0, [(4, 8), (4, 8)], [_t(4, 8), _t(4, 8)], 16, 0)
    assert with_carry0 != others[-1]
    # An operand's memory type and the stored type are part of it (the
    # matmul epilogue reads bf16 extras as float32 registers).
    leaves = [program.leaf((4, 8), torch.float32)]
    prog = program.lower(leaves[0] * 2.0, leaves)
    f32 = codegen.signature(prog, prog.kernel_codes, [0], 0, 2, 1, 0, True)
    assert codegen.signature(prog, prog.kernel_codes, [3], 0, 2, 1, 0, True) != f32
    assert codegen.signature(prog, prog.kernel_codes, [0], 2, 2, 1, 0, True) != f32


_NARROW = [
    (100, [((10, 10), (10, 1))], True),
    ((1 << 31) - (1 << 21) - 1, [((1,), (1,))], True),
    ((1 << 31) - (1 << 21), [((1,), (1,))], False),
    (64, [((8, 8), (1 << 29, 1))], False),               # a view reaching past 2**31 elements
    (64, [((8, 8), (-(1 << 20), 1))], True),
    (64, [((1, 8), (1 << 40, 1))], True),                # a dim of size 1 reaches nothing
]


@pytest.mark.parametrize("n,layouts,want", _NARROW, ids=str)
def test_32_bit_index_arithmetic_only_where_every_offset_fits(n, layouts, want):
    assert codegen.narrow(n, layouts) is want


# -------------------------------------------------------------- the source
def _program_per_opcode():
    """One real program for each kernel opcode: every registered op on
    float32, int32 and uint32, the casts (float32 <-> float32 by register
    type is bfloat16 -> float32), ``where``, ``pow`` and ``ipow``."""
    progs = {}
    ops = list(registry.registered_ops().items()) + list(registry.INTERNAL.items())
    for name, op in ops:
        for dt in (torch.float32, torch.int32, torch.uint32):
            if dt not in op.opcodes:
                continue
            leaves = [program.leaf((3, 5), dt) for _ in range(op.arity)]
            if name == "where":
                leaves[0] = program.leaf((3, 5), torch.bool)
            if name in ("pow", "ipow"):
                node = program.Node(name, leaves, dt, (3, 5))
            else:
                node = program.apply(name, *leaves)
            prog = program.lower(node, leaves)
            progs.setdefault(program.OPCODES[prog.kernel_codes[-1]], prog)
    for src, dst in program._CASTS:
        if src == dst:
            src = torch.bfloat16
        leaf = program.leaf((3, 5), src)
        prog = program.lower(program.cast(leaf, dst), [leaf])
        progs.setdefault(program.OPCODES[prog.kernel_codes[-1]], prog)
    return progs


_PER_OPCODE = _program_per_opcode()


def test_every_opcode_has_a_program():
    assert sorted(_PER_OPCODE) == sorted(program.OPCODES)


@pytest.mark.parametrize("name", program.OPCODES)
def test_source_calls_every_opcode_by_name(name):
    prog = _PER_OPCODE[name]
    operands = [_t(3, 5, dtype=d) for d in prog.leaf_dtypes]
    sig = elementwise.signature(prog, prog.kernel_codes, (3, 5), operands)
    src = codegen.source(sig)
    base = len(prog.leaf_dtypes) + len(prog.consts)
    srcs = ", ".join(f"r{r}" if r >= 0 else "0u" for r in prog.insts[-1][3:])
    assert f"const uint32_t r{base + len(prog.insts) - 1} = sm_exec({name}, {srcs});" in src
    assert f"sm_store(out, i, {codegen.DTYPE_NAMES[elementwise._DTYPE_CODE[prog.dtype]]}, res);" in src
    assert src.count("{") == src.count("}") and src.count("(") == src.count(")")
    assert f'extern "C" __global__ void __launch_bounds__(256) {codegen.KERNEL}(' in src
    assert "const __grid_constant__ SmParams p" in src


def test_source_of_the_recurrence():
    """The carry loop, the rank-2 decode in 32-bit arithmetic, one load per
    operand and one store."""
    leaves = [program.leaf((8, 8), torch.float32), program.leaf((8, 8), torch.float32),
              program.leaf((1, 8), torch.float32)]
    prog = program.lower(leaves[0] * np.float32(1e-3)
                         + sm.exp(sm.pow(leaves[1] + leaves[0] * np.float32(1e-6), leaves[2])),
                         leaves)
    sig = elementwise.signature(prog, prog.kernel_codes, (8, 8), [_t(8, 8), _t(8, 8), _t(1, 8)],
                                400, 0)
    src = codegen.source(sig)
    assert "for (int it = 0; it < p.iterations; ++it) {" in src
    assert "      r0 = res;" in src and f"      res = r{prog.result};" in src
    assert "for (int i = (int)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step)" in src
    assert "const unsigned c1 = rest % (unsigned)p.shape[1];" in src
    assert src.count("sm_load(") == 3 and src.count("sm_store(") == 1
    assert src.count("sm_exec(") == 6 and "sm_exec(POW_F, r7, r2, 0u)" in src
    assert "p.consts[0]" in src and "p.consts[1]" in src
    wide = codegen.Signature(**{**sig.__dict__, "narrow": False})
    assert "for (long long i = " in codegen.source(wide)


def test_source_at_the_kernel_limits():
    """A program of MAX_INSTS instructions over MAX_OPERANDS operands of
    rank 8: one line per instruction, every operand loaded through 8
    strides."""
    leaves = [program.leaf((2,) * 8, torch.float32) for _ in range(program.MAX_OPERANDS)]
    root = leaves[0]
    k = 0
    while True:
        nxt = root * leaves[(k + 1) % len(leaves)]
        if len(program.lower(nxt, leaves).insts) > program.MAX_INSTS:
            break
        root, k = nxt, k + 1
    prog = program.lower(root, leaves)
    assert len(prog.insts) == program.MAX_INSTS and prog.within_limits()
    sig = elementwise.signature(prog, prog.kernel_codes, (2,) * 8, [_t(*(2,) * 8)] * 16)
    src = codegen.source(sig)
    assert src.count("sm_exec(") == program.MAX_INSTS
    assert src.count("sm_load(") == program.MAX_OPERANDS
    assert "p.ops[15].strides[7]" in src and "const unsigned c7 = " in src


def test_dtype_names_follow_the_kernel_enum():
    enum = re.search(r"enum SmDtype : int32_t \{(.*?)\};", (CSRC / "tiles.cuh").read_text(), re.S)
    names = [e.split("=")[0].strip() for e in enum.group(1).split(",") if e.strip()]
    codes = [int(e.split("=")[1]) for e in enum.group(1).split(",") if e.strip()]
    assert codes == list(range(len(codes)))
    assert list(codegen.DTYPE_NAMES) == names[:len(codegen.DTYPE_NAMES)]
    for dtype, code in elementwise._DTYPE_CODE.items():
        assert codegen.DTYPE_NAMES[code].lower().endswith(
            {torch.float32: "f32", torch.int32: "i32", torch.bool: "bool", torch.bfloat16: "bf16",
             torch.int8: "i8", torch.uint8: "u8", torch.uint32: "u32",
             torch.float16: "f16"}[dtype])


def test_the_disk_cache_name_follows_the_source():
    a, b = codegen.source(_sig(lambda x: x * 2.0, [(4, 8)], [_t(4, 8)])), \
        codegen.source(_sig(lambda x: x * 2.0 + 1.0, [(4, 8)], [_t(4, 8)]))
    assert codegen._digest(a) == codegen._digest(a) != codegen._digest(b)
    assert re.fullmatch(r"[0-9a-f]{24}", codegen._digest(a))


def test_the_cpu_never_generates():
    """On CPU tensors the wrapper runs the plain version, and counts no
    launch."""
    elementwise.reset_launches()
    prog = _sums(70)
    x = torch.ones(4, 8)
    out = elementwise.elementwise(prog, (4, 8), torch.float32, x.T.contiguous().T)
    assert torch.equal(out, torch.full((4, 8), 71.0))
    assert elementwise.PATHS == {"interp": 0, "generated": 0}
    assert codegen.STATS == {"compiled": 0, "disk": 0, "memory": 0}


@pytest.mark.parametrize("iterations", [1, 16])
def test_interpret_on_the_cpu_is_the_plain_version(iterations):
    """The interpreter, the generated kernels' reference, runs the plain
    version on CPU tensors too, and counts no launch."""
    elementwise.reset_launches()
    leaves = [program.leaf((4, 8), torch.float32), program.leaf((1, 8), torch.float32)]
    prog = program.lower(leaves[0] * 0.5 + leaves[1], leaves)
    rng = np.random.default_rng(3)
    acc = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    row = torch.from_numpy(rng.standard_normal((1, 8)).astype(np.float32))
    got = elementwise.interpret(prog, (4, 8), acc, row, iterations=iterations, carry=0)
    want = elementwise.elementwise(prog, (4, 8), torch.float32, acc, row,
                                   iterations=iterations, carry=0)
    assert torch.equal(got, want)
    assert torch.equal(got, program.run_plain(prog, [acc, row], (4, 8), iterations, 0))
    assert elementwise.LAUNCHES == {"ew_flat": 0, "ew_strided": 0}
    assert elementwise.PATHS == {"interp": 0, "generated": 0}


def _lowered(fn, *operands):
    leaves = [program.leaf(tuple(o.shape), o.dtype) for o in operands]
    return program.lower(fn(*leaves), leaves)


# -------------------------------------------------- the generated evaluators
def test_reduce_signature_keeps_the_walk_the_reduction_and_the_gather():
    m, row, col = _t(16, 12), _t(1, 12), _t(16, 1)
    prog = _lowered(lambda x, r, c: x * r - c, m, row, col)
    sig = {}
    for label, op, operands, axis in (
            ("rows", 0, [m, row, col], None), ("max", 1, [m, row, col], None),
            ("axis0", 0, [m, row, col], 0), ("axis1", 0, [m, row, col], 1),
            ("gathered", 0, [elementwise.View(_t(16 * 12 + 1), 1, (16, 12), (12, 1)), m, m], None),
            ("strided", 0, [elementwise.View(m, 0, (16, 12), (1, 16)), row, col], None)):
        sig[label] = reduction.signature(prog, prog.kernel_codes, op, (16, 12), operands, axis)
    assert len(set(sig.values())) == len(sig)
    assert (sig["rows"].walk, sig["rows"].gathered) == ("rows", False)
    assert (sig["axis0"].walk, sig["axis1"].walk) == ("axis0", "axis1")
    assert sig["max"].reduce == 1 and sig["rows"].reduce == 0
    assert (sig["gathered"].walk, sig["gathered"].gathered) == ("flat", True)
    assert (sig["strided"].walk, sig["strided"].gathered) == ("strided", True)
    # Not the shape, nor the constants' values, nor the strides of quads.
    big = reduction.signature(prog, prog.kernel_codes, 0, (160, 120),
                              [_t(160, 120), _t(1, 120), _t(160, 1)])
    assert big == sig["rows"]


# --------------------------------------------------------- the reduce source
_WALK_CALLS = {
    "flat": "RdFullWalk<RD_SUM>{q, dst}(eval);",
    "rows": "RdFullWalk<RD_SUM>{q, dst}.rows(eval);",
    "strided": "RdFullWalk<RD_SUM>{q, dst}(eval);",
    "axis0": "RdColsWalk<RD_SUM>{q, dst, s}(eval);",
    "axis1": "RdRowsWalk<RD_SUM>{q, dst}(eval);",
}


@pytest.mark.parametrize("case", ["flat", "rows", "axis0", "axis1", "flat gathered", "strided",
                                  "axis0 gathered", "bf16 flat", "bf16 axis1", "f16 gathered"])
def test_reduce_source_per_walk(case):
    """The evaluator reads each operand at its type's constant width
    (``rd_load_quad<true>`` for a 2-byte type, no ``rd_read_narrow``),
    gathers where its walk says so, splats scalars and constants once,
    keeps (1, C) rows on the axis-0 walk, and hands itself to the walk."""
    dt = {"bf16": torch.bfloat16, "f16": torch.float16}.get(case.split()[0], torch.float32)
    R, C = 16, 12
    m, row, one = _t(R, C, dtype=dt), _t(1, C, dtype=dt), _t(dtype=dt)
    flat_v = _t(R * C, dtype=dt)
    fn = (lambda x: x) if dt == torch.float16 else (lambda x, *rest: x * x + x)
    operands = {
        "flat": [flat_v], "rows": [m, row], "axis0": [m, row], "axis1": [m, one],
        "flat gathered": [elementwise.View(_t(R * C + 1), 1, (R * C,), (1,))],
        "strided": [elementwise.View(m, 0, (C, R), (1, C))],
        "axis0 gathered": [elementwise.View(m, 0, (C, R), (1, C))],
        "bf16 flat": [flat_v], "bf16 axis1": [m, one],
        "f16 gathered": [elementwise.View(_t(R * C + 1, dtype=dt), 1, (R * C,), (1,))],
    }[case]
    shape = tuple(operands[0].shape)
    axis = {"axis0": 0, "axis1": 1, "axis0 gathered": 0, "bf16 axis1": 1}.get(case)
    prog = _lowered(lambda *ops: fn(*ops) if len(ops) == 1 else ops[0] * ops[1] + ops[0], *operands)
    where = reduction.layout(operands)
    assert reduction.path(prog, "sum", shape, where, axis) == "generated"
    walk, gathered = reduction.walk(shape, where, axis)
    sig = reduction.signature(prog, prog.kernel_codes, 0, shape, operands, axis)
    src = codegen.source(sig)
    assert '#include "reduction.cuh"' in src and _WALK_CALLS[walk] in src
    assert "SM_MAX_REGS" not in src and "rd_read_narrow" not in src and "rd_run4" not in src
    name = codegen.DTYPE_NAMES[elementwise._DTYPE_CODE[dt]]
    if gathered:
        assert ("rd_gather_strided(" in src) is (walk == "strided")
        assert ("rd_gather_as<" in src) is (walk != "strided")
    else:
        wide = "true" if dt != torch.float32 else "false"
        assert f"rd_load_quad<{wide}>(q.p.ops[0].ptr, " in src and f", {name});" in src
    for o, scalar in enumerate(sig.scalars):
        if scalar:
            assert f"s{o} = sm_splat(sm_load(q.p.ops[{o}].ptr, 0, {name}));" in src
    assert ("if (q.p.ops[1].strides[0] == 0) {" in src) is (case == "axis0")
    assert f"return rd_value4<RD_SUM>({codegen.DTYPE_NAMES[sig.out_dtype]}, v{prog.result});" in src
    assert src.count("{") == src.count("}") and src.count("(") == src.count(")")


def test_reduce_headers_enter_the_disk_cache_name():
    """A generated evaluator includes reduction.cuh, so the disk cache's
    digest follows it, and NVRTC compiles it without host headers."""
    from simplemath_tpu_torch import _build

    assert "reduction.cuh" in codegen.HEADERS
    assert "#if !defined(__CUDACC_RTC__)" in (_build.CSRC / "reduction.cuh").read_text()


@pytest.mark.parametrize("flags", [(), ("-DPSD_NREG_F32=11", "-DPSD_NREG_F64=8")], ids=["header", "flags"])
def test_build_units_instantiate_each_psd_n_once(flags):
    """``_build.units`` compiles every source once and the PSD thread path's
    instantiations in groups that cover each n of each type up to its
    ``N_REG`` once: those below ``PSD_ALONE`` together, each larger n alone."""
    from simplemath_tpu_torch import _build

    units = _build.units(_build.NVCC_FLAGS + flags)
    plain = [src for _, src, defines in units if not defines]
    assert sorted(plain) == sorted(s for s in _build.SOURCES if s != _build.PER_INSTANTIATION)
    nreg = _build._psd_nreg(_build.NVCC_FLAGS + flags)
    for typ, key in (("float", "PSD_NREG_F32"), ("double", "PSD_NREG_F64")):
        ranges = [tuple(int(d.split("=")[1]) for d in defines[1:]) for _, src, defines in units
                  if src == _build.PER_INSTANTIATION and defines[0] == f"-DPSD_UNIT_T={typ}"]
        covered = [n for lo, hi in ranges for n in range(lo, hi + 1)]
        assert sorted(covered) == list(range(1, nreg[key] + 1)), (typ, ranges)
        assert all(lo == hi for lo, hi in ranges if hi >= _build.PSD_ALONE), ranges
    assert nreg == ({"PSD_NREG_F32": 11, "PSD_NREG_F64": 8} if flags else
                    {"PSD_NREG_F32": 10, "PSD_NREG_F64": 7})
