"""The CUDA kernels (elementwise, map-reduce and matmul) against their plain
PyTorch versions, on the card.  Every test needs a CUDA device and skips
without one.  The file imports no jax, so it also runs where only PyTorch
is installed:

    python -m pytest --noconftest tests/test_torch_kernel_cuda.py -q

Tolerance: exact for arithmetic, comparisons, casts and the integer ops
(the kernel is built with --fmad=false, so each float operation rounds
once, as torch's do); 2 ulp for the transcendentals.  The reductions' and
the matmul's tolerances are stated above their tests.
"""

import numpy as np
import pytest
import torch

import simplemath_tpu_torch as sm
from simplemath_tpu_torch.ops import (
    dispatch, elementwise, engine, matmul, program, reduction, registry,
)

pytestmark = pytest.mark.cuda

_TRANSCENDENTAL = {"exp", "log", "exp2", "log2", "tanh", "sin", "cos", "tan", "pow"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = sm.config.device
    sm.configure(device="cuda")
    yield torch.device("cuda")
    sm.configure(device=old)


def _max_ulp(got, want):
    g = got.double().cpu().numpy()
    w = want.double().cpu().numpy()
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    sp = np.spacing(np.abs(w).astype(np.float32)).astype(np.float64)
    with np.errstate(invalid="ignore"):
        d = np.where(same, 0.0, np.abs(g - w) / sp)
    return float(np.nan_to_num(d, nan=np.inf).max(initial=0.0))


def _both(prog, shape, operands, iterations=1, carry=0):
    k = elementwise.elementwise(prog, shape, prog.dtype, *operands,
                                iterations=iterations, carry=carry)
    p = program.run_plain(prog, [elementwise.read(o) for o in operands],
                          shape, iterations, carry)
    torch.cuda.synchronize()
    return k, p


def _inputs(dtype, n, device, seed=0):
    rng = np.random.default_rng(seed)
    if dtype in (torch.float32, torch.bfloat16):
        special = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 1.0, -1.0, 88.7]
        x = np.concatenate([rng.uniform(-8, 8, n - len(special)), special]).astype(np.float32)
        return torch.from_numpy(x).to(device).to(dtype)
    if dtype == torch.uint32:
        x = np.concatenate([rng.integers(0, 120, n - 5), [2**32 - 1, 2**31, 2**31 - 1, 0, 1]])
        return torch.from_numpy(x.astype(np.int64)).to(device).to(torch.uint32)
    x = np.concatenate([rng.integers(-60, 60, n - 4), [2**31 - 1, -2**31, 0, 1]]).astype(np.int32)
    return torch.from_numpy(x).to(device)


# Every registry op on every type the kernel computes in: float32, int32,
# uint32 (its own opcodes where they differ), bfloat16 (the float32 ones,
# each result rounded to bfloat16).  pow and ipow nodes are built as the
# engine builds them, which never computes pow in bfloat16.
_OPCODE_CASES = [
    (name, dtype)
    for name in sorted(set(registry.registered_ops()) | set(registry.INTERNAL))
    for dtype in (torch.float32, torch.int32, torch.uint32, torch.bfloat16)
    if program.register_type(dtype) in registry.op_def(name).opcodes
    and not (dtype == torch.bfloat16 and name in ("pow", "ipow"))
]

# Every cast the kernel has, by the types of its operand and result.
_CAST_CASES = [(s, d) for s, d in program._CASTS if s != d] + [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
    (torch.int32, torch.bfloat16), (torch.uint32, torch.bfloat16), (torch.bool, torch.bfloat16),
    (torch.bfloat16, torch.int32), (torch.bfloat16, torch.uint32), (torch.bfloat16, torch.bool),
]


def _cast_input(src, dst, n, device):
    """Operands of a cast within the destination's range (a float beyond
    it converts as C++ leaves unspecified); NaN only where it converts."""
    if src == torch.bool:
        return _inputs(torch.float32, n, device) > 0
    x = _inputs(src, n, device)
    if src.is_floating_point and dst not in (torch.float32, torch.bfloat16, torch.bool):
        low = 0.0 if dst == torch.uint32 else -1e6
        x = x.float().clamp(low, 1e6).nan_to_num(0.5).to(src)
    return x


def _bits(t):
    """A 4-byte tensor's bits as int32: torch compares no uint32 on the card."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _bf16_ulp(got, want):
    """Largest distance in bfloat16 ulps, NaN == NaN."""
    g, w = got.double().cpu().numpy(), want.double().cpu().numpy()
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    spacing = np.maximum(np.abs(w), 2.0 ** -126) * 2.0 ** -7
    with np.errstate(invalid="ignore"):
        d = np.where(same, 0.0, np.abs(g - w) / spacing)
    return float(np.nan_to_num(d, nan=np.inf).max(initial=0.0))


def _hold(name, k, p):
    """A kernel's result against its plain version: exact, but for the
    transcendentals (2 float32 ulps; a bfloat16 result, rounded once from
    float32 values that close, 1 bfloat16 ulp)."""
    assert k.dtype == p.dtype
    if name in _TRANSCENDENTAL:
        assert (_bf16_ulp(k, p) <= 1.0) if k.dtype == torch.bfloat16 else (_max_ulp(k, p) <= 2.0)
    elif k.is_floating_point():
        assert _max_ulp(k, p) == 0.0
    elif k.dtype == torch.uint32:  # compared by its bits: torch has few uint32 ops
        assert torch.equal(k.view(torch.int32), p.view(torch.int32))
    else:
        assert torch.equal(k, p)


@pytest.mark.parametrize("name,dtype", _OPCODE_CASES, ids=str)
def test_every_opcode_matches_plain(cuda, name, dtype):
    op = registry.op_def(name)
    n = 1 << 14
    leaves = [program.leaf((n,), dtype) for _ in range(op.arity)]
    operands = [_inputs(dtype, n, cuda, s) for s in range(op.arity)]
    if name == "where":
        leaves[0] = program.leaf((n,), torch.bool)
        operands[0] = _bits(operands[0]) > 0
    if name in ("pow", "ipow"):
        node = program.Node(name, leaves, dtype, (n,))
    else:
        node = program.apply(name, *leaves)
    k, p = _both(program.lower(node, leaves), (n,), operands)
    _hold(name, k, p)


@pytest.mark.parametrize("src,dst", _CAST_CASES, ids=str)
def test_casts_match_plain(cuda, src, dst):
    x = _cast_input(src, dst, 4096, cuda)
    leaf = program.leaf((4096,), src)
    k, p = _both(program.lower(program.cast(leaf, dst), [leaf]), (4096,), [x])
    _hold("cast", k, p)


@pytest.mark.parametrize("shape_b", [(1,), (1, 96), (64, 1), (96,), (5, 1, 96)])
def test_broadcast_and_rank(cuda, shape_b):
    a = _inputs(torch.float32, 64 * 96, cuda).reshape(64, 96)
    b = torch.from_numpy(np.random.default_rng(1).uniform(-2, 2, shape_b).astype(np.float32)).to(cuda)
    out = torch.broadcast_shapes(a.shape, b.shape)
    la, lb = program.leaf(a.shape, torch.float32), program.leaf(b.shape, torch.float32)
    k, p = _both(program.lower(program.apply("multiply", la, lb), [la, lb]), tuple(out), [a, b])
    assert _max_ulp(k, p) == 0.0


@pytest.mark.parametrize("key", ["T", "rev", "step", "offset"])
def test_view_operands_read_in_place(cuda, key):
    base = sm.Array(_inputs(torch.float32, 48 * 64, cuda).reshape(48, 64))
    view = {"T": base.T, "rev": base[::-1, ::-1], "step": base[1::3, ::-2],
            "offset": base[:, 1:]}[key]
    leaf = program.leaf(view.shape, torch.float32)
    k, p = _both(program.lower(program.apply("exp", leaf), [leaf]), view.shape, [view._operand()])
    assert _max_ulp(k, p) == 0.0


def test_iterated_chain_and_launch_counts(cuda):
    rng = np.random.default_rng(0)
    a = sm.Array(rng.uniform(0.5, 2.0, (256, 512)).astype(np.float32))
    e = sm.Array(rng.uniform(-2.0, 2.0, (1, 512)).astype(np.float32))
    acc = sm.zeros(256, 512)

    def chain(c, x, y):
        return c * np.float32(1e-3) + sm.exp(sm.pow(x + c * np.float32(1e-6), y))

    elementwise.reset_launches()
    out = sm.fuse(chain, donate=0, iterations=8)(acc, a, e).torch()
    s = sm.add(a, a).torch()
    torch.cuda.synchronize()
    assert elementwise.LAUNCHES == {"ew_flat": 1, "ew_strided": 1}
    leaves = [program.leaf((256, 512), torch.float32), program.leaf((256, 512), torch.float32),
              program.leaf((1, 512), torch.float32)]
    prog = program.lower(chain(*leaves), leaves)
    ref = program.run_plain(prog, [acc.torch(), a.torch(), e.torch()], (256, 512), 8, 0)
    assert _max_ulp(out, ref) == 0.0
    assert torch.equal(s, a.torch() * 2)
    assert bool((acc.torch() == 0).all())


def test_int_pow_and_static_pow(cuda):
    rng = np.random.default_rng(1)
    base = rng.integers(-4, 5, 4096).astype(np.int32)
    expo = rng.integers(-6, 12, 4096).astype(np.int32)
    lb, le = program.leaf((4096,), torch.int32), program.leaf((4096,), torch.int32)
    k, p = _both(program.lower(engine.pow_expr(lb, le), [lb, le]), (4096,),
                 [torch.from_numpy(base).to(cuda), torch.from_numpy(expo).to(cuda)])
    assert torch.equal(k, p)
    x = _inputs(torch.float32, 4096, cuda)
    for e in (-3, 0, 2, 7):
        leaf = program.leaf((4096,), torch.float32)
        k, p = _both(program.lower(engine.pow_expr(leaf, e), [leaf]), (4096,), [x])
        assert _max_ulp(k, p) == 0.0


def test_program_beyond_limits_raises_on_cuda(cuda):
    x = program.leaf((8,), torch.float32)
    deep = x
    for _ in range(program.MAX_INSTS + 1):
        deep = deep * x
    prog = program.lower(deep, [x])
    with pytest.raises(ValueError, match="exceeds the kernel's limits"):
        elementwise.elementwise(prog, (8,), torch.float32, torch.ones(8, device=cuda))


# ------------------------------------------------- the map-reduce kernel
# Tolerance: sums and dots within 2e-5 * sum|x| of the plain version and
# of float64 (both accumulate in float32, in different orders); max/min
# and the int32 dot exact; every kernel result bit-identical across two
# launches (no atomics, a grid fixed by the shape).
def _rd_both(fn, plain):
    reduction.reset_launches()
    k1, k2 = fn(), fn()
    torch.cuda.synchronize()
    assert sum(reduction.LAUNCHES.values()) == 2
    assert torch.equal(k1.view(torch.int32), k2.view(torch.int32))  # deterministic
    return k1, plain


def _close(k, p, ref64, scale):
    tol = 2e-5 * scale
    assert float((k.double() - p.double()).abs().max()) <= tol
    assert float((k.double().cpu() - ref64).abs().max()) <= tol


@pytest.mark.parametrize("kind", ["sum", "max", "min"])
@pytest.mark.parametrize("case", ["ragged", "2d", "T", "neg", "unaligned"])
def test_rd_full_matches_plain(cuda, kind, case):
    rng = np.random.default_rng(3)
    n = 4096 * 3 + 777
    base = torch.from_numpy(rng.standard_normal(n + 64 * 96).astype(np.float32)).to(cuda)
    m = base[: 64 * 96].reshape(64, 96)
    x = {"ragged": base[:n], "2d": m,
         "T": elementwise.View(m, 0, (96, 64), (1, 96)),
         "neg": elementwise.View(m, 63 * 96 + 95, (32, 48), (-2 * 96, -2)),
         "unaligned": elementwise.View(base, 1, (n,), (1,))}[case]
    t = elementwise.read(x)
    k, p = _rd_both(lambda: reduction.reduce(x, kind), reduction._plain(t, kind))
    ref = {"sum": torch.sum, "max": torch.max, "min": torch.min}[kind](t.double().cpu())
    if kind == "sum":
        _close(k, p, ref, float(t.abs().sum()))
    else:
        assert float(k) == float(p) == float(ref)
    if case == "unaligned":  # scalar loads and 16-byte loads combine in one order
        assert torch.equal(k, reduction.reduce(t.clone(), kind))
    if case == "ragged":  # so do the identity's direct path and the interpreter
        leaf = program.leaf(tuple(t.shape), torch.float32)
        times_one = program.lower(leaf * 1.0, [leaf])
        assert torch.equal(k, reduction.map_reduce(times_one, kind, tuple(t.shape), t))


@pytest.mark.parametrize("kind", ["sum", "max", "min"])
def test_rd_full_propagates_nan(cuda, kind):
    x = torch.linspace(-3, 3, 10_000, device=cuda)
    x[4321] = float("nan")
    assert bool(torch.isnan(reduction.reduce(x, kind)))
    assert bool(torch.isnan(reduction.reduce_axis(x.reshape(100, 100), kind, 1)[43]))


@pytest.mark.parametrize("dtypes", [("float32", "float32"), ("int32", "int32"),
                                    ("float32", "int32"), ("int32", "float32")])
def test_rd_full_dot(cuda, dtypes):
    rng = np.random.default_rng(4)
    n = 4096 * 3 + 777
    a, b = (torch.from_numpy((rng.integers(-100, 100, n) if d == "int32"
                              else rng.standard_normal(n)).astype(d)).to(cuda) for d in dtypes)
    prod = a.double() * b.double()
    k, _ = _rd_both(lambda: reduction.dot1d(a, b), None)
    if dtypes == ("int32", "int32"):
        assert k.dtype == torch.int32 and int(k) == int(prod.sum())
    else:
        assert k.dtype == torch.float32
        assert abs(float(k) - float(prod.sum())) <= 2e-5 * float(prod.abs().sum())


def test_rd_full_int32_dot_wraps(cuda):
    a = torch.full((70_000,), 40_000, dtype=torch.int32, device=cuda)
    want = (40_000 * 40_000 * 70_000) % (1 << 32)
    want = want - (1 << 32) if want >= 1 << 31 else want
    assert int(reduction.dot1d(a, a)) == want == int(reduction._plain_sum_i32(a * a))


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_rd_map_reduce_row_and_column(cuda, axis):
    rng = np.random.default_rng(5)
    R, C = 300, 257
    A, row, col = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
                   for s in ((R, C), (1, C), (R, 1)))
    la, lr, lc = (program.leaf(tuple(t.shape), torch.float32) for t in (A, row, col))
    prog = program.lower(sm.square(la * lr - lc), [la, lr, lc])
    vals = (A * row - col) ** 2
    for kind in ("sum", "max", "min"):
        if axis is None:
            k, p = _rd_both(lambda: reduction.map_reduce(prog, kind, (R, C), A, row, col),
                            reduction._plain(vals, kind))
        else:
            k, p = _rd_both(lambda: reduction.map_reduce_axis(prog, kind, axis, (R, C), A, row, col),
                            reduction._plain(vals, kind, axis))
        if kind == "sum":
            assert bool(((k - p).abs() <= 2e-5 * vals.abs().sum() + 1e-6).all())
        else:
            assert torch.equal(k, p)


@pytest.mark.parametrize("shape", [(300, 257), (7, 5), (1, 64), (2048, 8), (64, 1)])
@pytest.mark.parametrize("axis", [0, 1])
def test_rd_axis_matches_plain(cuda, shape, axis):
    X = torch.from_numpy(np.random.default_rng(6).standard_normal(shape).astype(np.float32)).to(cuda)
    for kind in ("sum", "max", "min"):
        k, p = _rd_both(lambda: reduction.reduce_axis(X, kind, axis), reduction._plain(X, kind, axis))
        if kind == "sum":
            assert bool(((k - p).abs() <= 2e-5 * X.abs().sum(axis) + 1e-6).all())
        else:
            assert torch.equal(k, p)


def test_reductions_through_the_api_launch_rd(cuda):
    rng = np.random.default_rng(7)
    a = sm.Array(rng.standard_normal((256, 384)).astype(np.float32))
    b = sm.Array(rng.standard_normal((256, 384)).astype(np.float32))
    elementwise.reset_launches()
    reduction.reset_launches()
    s = float(sm.sum(sm.square(sm.subtract(a, b))).item())
    m = sm.fuse(lambda x, y: sm.mean(x * y, axis=0))(a, b).torch()
    d = float(sm.dot(a[3], b[5]).item())
    torch.cuda.synchronize()
    assert elementwise.LAUNCHES == {"ew_flat": 0, "ew_strided": 0}
    assert reduction.LAUNCHES == {"rd_full": 2, "rd_axis": 1}
    at, bt = a.torch().double(), b.torch().double()
    assert abs(s - float(((at - bt) ** 2).sum())) <= 2e-5 * float(((at - bt) ** 2).sum())
    assert torch.allclose(m.double(), (at * bt).mean(0), rtol=2e-5, atol=2e-5)
    assert abs(d - float(at[3] @ bt[5])) <= 2e-5 * float((at[3] * bt[5]).abs().sum())


# Every path of both entry points (``reduction.PATHS`` says which one a
# launch took): the identity's direct loop, the hoisted loop of one
# instruction, the interpreter on four lanes, and quads gathered element by
# element, at ragged sizes.  A thread owns the same quads on every path and
# combines them in one order, so the same values give the same bits.
def _aligned(dev, *shape):
    base = torch.randn(int(np.prod(shape)) + 4, device=dev)
    skip = (-base.data_ptr() // 4) % 4
    t = base[skip:skip + int(np.prod(shape))].reshape(shape)
    assert t.data_ptr() % 16 == 0
    return t


def _lowered(fn, *operands):
    leaves = [program.leaf(tuple(o.shape), o.dtype) for o in operands]
    return program.lower(fn(*leaves), leaves)


def _rd_on(path, fn, plain):
    k, p = _rd_both(fn, plain)
    assert {name: c for name, c in reduction.PATHS.items() if c} == {path: 2}
    return k, p


def _rd_agree(kind, k, p, scale):
    if kind == "sum":
        assert bool(((k.double() - p.double()).abs() <= 2e-5 * scale.double() + 1e-6).all())
    else:
        assert torch.equal(k, p)


@pytest.mark.parametrize("kind", ["sum", "max", "min"])
@pytest.mark.parametrize("n", [1025, 4096 * 3 + 777, 40_002, 99_999, 1_000_003])
def test_rd_full_every_path(cuda, kind, n):
    x = _aligned(cuda, n)
    p, scale = reduction._plain(x, kind), x.abs().sum()
    direct, _ = _rd_on("direct", lambda: reduction.reduce(x, kind), p)
    _rd_agree(kind, direct, p, scale)
    one = _lowered(lambda a: a * 1.0, x)
    k, _ = _rd_on("single" if kind == "sum" else "lanes4",
                  lambda: reduction.map_reduce(one, kind, (n,), x), p)
    assert torch.equal(k, direct)
    two = _lowered(lambda a: a * 1.0 + 0.0, x)
    k, _ = _rd_on("lanes4", lambda: reduction.map_reduce(two, kind, (n,), x), p)
    assert torch.equal(k, direct)
    shifted = torch.empty(n + 5, device=cuda)
    off = (1 - shifted.data_ptr() // 4) % 4  # the view starts 4 bytes past a 16-byte boundary
    view = elementwise.View(shifted, off, (n,), (1,))
    elementwise.read(view).copy_(x)
    for prog in (reduction.identity(torch.float32), two):
        k, _ = _rd_on("element", lambda: reduction.map_reduce(prog, kind, (n,), view), p)
        assert torch.equal(k, direct)


@pytest.mark.parametrize("kind", ["sum", "max", "min"])
def test_rd_nan_in_the_tail_on_every_path(cuda, kind):
    n = 4096 + 3
    x = _aligned(cuda, n)
    x[n - 1] = float("nan")
    progs = {"direct": reduction.identity(torch.float32), "one": _lowered(lambda a: a * 1.0, x),
             "lanes4": _lowered(lambda a: a * 1.0 + 0.0, x)}
    for prog in progs.values():
        assert bool(torch.isnan(reduction.map_reduce(prog, kind, (n,), x)))
    assert bool(torch.isnan(reduction.reduce(x.clone()[1:], kind)))  # element path
    m = _aligned(cuda, 67, 132)[:, :131]
    m[66, 130] = float("nan")
    for prog in progs.values():
        for operand in (m, m.contiguous()):  # 16-byte rows; ragged rows (element path)
            k0 = reduction.map_reduce_axis(prog, kind, 0, (67, 131), operand)
            k1 = reduction.map_reduce_axis(prog, kind, 1, (67, 131), operand)
            assert bool(torch.isnan(k0[130])) and int(torch.isnan(k0).sum()) == 1
            assert bool(torch.isnan(k1[66])) and int(torch.isnan(k1).sum()) == 1


_SINGLE_SOURCES = {
    "scalar on the right": (lambda a, s: a / s, "as"),
    "scalar on the left": (lambda s, a: s - a, "sa"),
    "constant on the right": (lambda a: a * 2.5, "a"),
    "constant on the left": (lambda a: 2.5 - a, "a"),
    "unary": (lambda a: sm.square(a), "a"),
    "comparison": (lambda a, b: a > b, "ab"),
    "cast": (lambda i: program.cast(i, torch.float32), "i"),
    "one operand twice": (lambda a: a * a, "a"),
}


@pytest.mark.parametrize("case", sorted(_SINGLE_SOURCES))
def test_rd_single_sources(cuda, case):
    """The hoisted loop's sources: full-size operands, splatted scalar
    operands and splatted constants, on either side."""
    fn, names = _SINGLE_SOURCES[case]
    n = 4096 * 5 + 3
    pool = {"a": _aligned(cuda, n), "b": _aligned(cuda, n), "s": torch.tensor(0.75, device=cuda),
            "i": (_aligned(cuda, n) * 50).int()}
    operands = [pool[c] for c in names]
    prog = _lowered(fn, *operands)
    vals = reduction.values(prog, (n,), operands, cuda)
    k, p = _rd_on("single", lambda: reduction.map_reduce(prog, "sum", (n,), *operands),
                  reduction._plain(vals, "sum"))
    _rd_agree("sum", k, p, vals.float().abs().sum())
    m = _aligned(cuda, 96, 260)
    if names == "a":  # the same instruction along both axes of a matrix
        prog2 = _lowered(fn, m)
        v2 = reduction.values(prog2, (96, 260), [m], cuda)
        for axis in (0, 1):
            k, p = _rd_on("single", lambda: reduction.map_reduce_axis(prog2, "sum", axis, (96, 260), m),
                          reduction._plain(v2, "sum", axis))
            _rd_agree("sum", k, p, v2.abs().sum(axis))


def test_rd_int32_dot_paths(cuda):
    n = 4096 * 3 + 777
    rng = np.random.default_rng(8)
    a, b = (torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32)).to(cuda)
            for _ in range(2))
    want = reduction._plain_sum_i32(a * b)
    k, _ = _rd_on("single", lambda: reduction.dot1d(a, b), None)
    assert k.dtype == torch.int32 and int(k) == int(want)
    big = torch.empty(n + 1, dtype=torch.int32, device=cuda)
    big[1:] = b
    k, _ = _rd_on("element", lambda: reduction.dot1d(a, elementwise.View(big, 1, (n,), (1,))), None)
    assert int(k) == int(want)
    f = a.float() * 1e-6
    k, _ = _rd_on("lanes4", lambda: reduction.dot1d(b, f), None)  # a cast and a multiply
    assert abs(float(k) - float((b.double() * f.double()).sum())) <= 2e-5 * float(
        (b.double() * f.double()).abs().sum())


@pytest.mark.parametrize("shape", [(300, 257), (77, 1030), (1000, 131), (33, 5)])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("kind", ["sum", "max", "min"])
def test_rd_axis_every_path(cuda, shape, axis, kind):
    """Columns that are no multiple of 4, rows that are no multiple of the
    segment: a matrix whose rows start at 16-byte boundaries takes the
    16-byte paths, its contiguous clone (ragged rows) the element path,
    and both give the same bits."""
    R, C = shape
    m = _aligned(cuda, R, (C + 3) // 4 * 4)[:, :C]
    clone = m.contiguous()
    p, scale = reduction._plain(m, kind, axis), m.abs().sum(axis)
    direct, _ = _rd_on("direct", lambda: reduction.reduce_axis(m, kind, axis), p)
    _rd_agree(kind, direct, p, scale)
    k, _ = _rd_on("element", lambda: reduction.reduce_axis(clone, kind, axis), p)
    assert torch.equal(k, direct)
    one = _lowered(lambda a: a * 1.0, m)
    k, _ = _rd_on("single" if kind == "sum" else "lanes4",
                  lambda: reduction.map_reduce_axis(one, kind, axis, shape, m), p)
    assert torch.equal(k, direct)
    two = _lowered(lambda a: a * 1.0 + 0.0, m)
    for operand, path in ((m, "lanes4"), (clone, "element")):
        k, _ = _rd_on(path, lambda: reduction.map_reduce_axis(two, kind, axis, shape, operand), p)
        assert torch.equal(k, direct)
    t = elementwise.View(clone.T.contiguous(), 0, (R, C), (1, R))  # the same values, transposed
    k, _ = _rd_on("element", lambda: reduction.reduce_axis(t, kind, axis), p)
    assert torch.equal(k, direct)


@pytest.mark.parametrize("shape", [(300, 260), (77, 1030), (5, 7), (1000, 4)])
def test_rd_full_walks_the_rows_of_broadcast_operands(cuda, shape):
    """rd_full of a 2-D expression with a (1, C) row and an (R, 1) column:
    16 bytes at a time along rows that start at 16-byte boundaries
    (lanes4), element by element otherwise."""
    R, C = shape
    m = _aligned(cuda, R, (C + 3) // 4 * 4)[:, :C]
    row, col = _aligned(cuda, 1, C), _aligned(cuda, R, 1)
    for fn, operands in ((lambda a, r, c: sm.square(a * r - c), [m, row, col]),
                         (lambda a, r: a * r, [m, row])):
        prog = _lowered(fn, *operands)
        vals = reduction.values(prog, shape, operands, cuda)
        for kind in ("sum", "max", "min"):
            p = reduction._plain(vals, kind)
            k, _ = _rd_on("lanes4", lambda: reduction.map_reduce(prog, kind, shape, *operands), p)
            _rd_agree(kind, k, p, vals.abs().sum())
            if C % 4:
                ragged = [m.contiguous()] + operands[1:]
                k, _ = _rd_on("element", lambda: reduction.map_reduce(prog, kind, shape, *ragged), p)
                _rd_agree(kind, k, p, vals.abs().sum())


@pytest.mark.parametrize("axis", [0, 1])
def test_rd_axis_broadcast_operands_keep_the_16_byte_paths(cuda, axis):
    R, C = 200, 516
    m, row, col, one = (_aligned(cuda, *s) for s in ((R, C), (1, C), (R, 1), (1, 1)))
    cases = [(lambda a, r: a * r, [m, row], "single"), (lambda c, a: c - a, [col, m], "single"),
             (lambda a, s: a * s, [m, one], "single"),
             (lambda a, r, c: sm.square(a * r - c), [m, row, col], "lanes4"),
             (lambda a, s: sm.where(a > s, a, 0.0), [m, one], "lanes4")]
    for fn, operands, path in cases:
        prog = _lowered(fn, *operands)
        vals = reduction.values(prog, (R, C), operands, cuda)
        k, p = _rd_on(path, lambda: reduction.map_reduce_axis(prog, "sum", axis, (R, C), *operands),
                      reduction._plain(vals, "sum", axis))
        _rd_agree("sum", k, p, vals.abs().sum(axis))
        km, pm = _rd_on("lanes4", lambda: reduction.map_reduce_axis(prog, "max", axis, (R, C), *operands),
                        reduction._plain(vals, "max", axis))
        assert torch.equal(km, pm)


# ------------------------------------------------------ the matmul kernel
# Tolerance: a float32 product within 2e-5 * (|A| @ |B|), elementwise, of
# the plain version (torch.matmul, TF32 off) and of float64: both sum in
# float32, in different orders, and no other difference is admitted.
# Integer products exact.  A bfloat16 result is the float32 result rounded
# once, so within one bfloat16 ulp of the plain version's.  Every result
# bit-identical across two launches (one thread, or for bf16 @ bf16 one
# warpgroup's tensor cores, sums each element in ascending k; no split-K,
# no atomics).  bf16 @ bf16 runs wgmma in the tensor-core kernel whatever
# its shape or strides (``matmul.VARIANTS``), and a view gives the bits of
# its contiguous clone.
def _mm_both(a, b, out_dtype=None, epilogue=None, extras=()):
    matmul.reset_launches()
    k1 = matmul.matmul(a, b, out_dtype, epilogue=epilogue, extras=extras)
    k2 = matmul.matmul(a, b, out_dtype, epilogue=epilogue, extras=extras)
    torch.cuda.synchronize()
    assert sum(matmul.LAUNCHES.values()) == 2
    assert torch.equal(k1.view(torch.int16 if k1.element_size() == 2 else torch.int32)
                       if k1.dtype != torch.bool else k1,
                       k2.view(torch.int16 if k2.element_size() == 2 else torch.int32)
                       if k2.dtype != torch.bool else k2)
    p = matmul.matmul_plain(a, b, k1.dtype, epilogue,
                            [matmul._extra3(e, matmul.product_shape(a.shape, b.shape),
                                            len(a.shape) == 3) for e in extras])
    return k1, p


def _f32(rng, shape, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)


def _abs_product(a, b):
    return elementwise.read(a).double().abs() @ elementwise.read(b).double().abs()


@pytest.mark.parametrize("shape", [((300, 270), (270, 515)), ((1, 1), (1, 1)), ((5, 17), (17, 3)),
                                   ((128, 16), (16, 128)), ((129, 33), (33, 257)),
                                   ((3, 70, 33), (3, 33, 140))], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_mm_float_matches_plain(cuda, shape, dtype):
    rng = np.random.default_rng(8)
    a, b = _f32(rng, shape[0], cuda).to(dtype), _f32(rng, shape[1], cuda).to(dtype)
    k, p = _mm_both(a, b, torch.float32)
    tol = 2e-5 * _abs_product(a, b)
    assert bool(((k.double() - p.double()).abs() <= tol).all())
    assert bool(((k.double() - a.double() @ b.double()).abs() <= tol).all())
    if dtype == torch.bfloat16:
        kb, pb = _mm_both(a, b, torch.bfloat16)
        assert torch.equal(kb, k.bfloat16())  # the float32 result, rounded once
        assert bool(((kb.float() - pb.float()).abs() <= pb.float().abs() * 2.0 ** -7 + 1e-30).all())


@pytest.mark.parametrize("case", ["T", "neg", "slice", "both"])
def test_mm_view_operands_read_in_place(cuda, case):
    rng = np.random.default_rng(9)
    base_a = sm.Array(_f32(rng, (270, 300), cuda))
    base_b = sm.Array(_f32(rng, (540, 330), cuda))
    a = base_a.T                                   # (300, 270)
    b = base_b[::2, 10:310]                        # (270, 300)
    if case == "T":
        b = sm.Array(b.torch().clone())
    elif case == "neg":
        a, b = sm.Array(a.torch().clone()), base_b[::-2, ::-1][:, :300]
    elif case == "slice":
        a = sm.Array(a.torch().clone())
    k, _ = _mm_both(a._operand(), b._operand())
    ref = a.torch().double() @ b.torch().double()
    tol = 2e-5 * (a.torch().double().abs() @ b.torch().double().abs())
    assert bool(((k.double() - ref).abs() <= tol).all())


@pytest.mark.parametrize("dtypes", [("int8", "int8"), ("int8", "uint8"), ("uint8", "uint8"),
                                    ("int32", "int32"), ("int32", "int8")], ids=str)
@pytest.mark.parametrize("batched", [False, True])
def test_mm_integers_exact(cuda, dtypes, batched):
    rng = np.random.default_rng(10)
    lead = (2,) if batched else ()

    def make(name, shape):
        if name == "int32":  # no wraparound here: test_mm_int32_wraps has it
            return rng.integers(-1000, 1000, shape).astype(name)
        info = np.iinfo(name)
        return rng.integers(info.min, info.max + 1, shape).astype(name)

    a_np, b_np = make(dtypes[0], lead + (130, 200)), make(dtypes[1], lead + (200, 129))
    want = np.matmul(a_np.astype(np.int64), b_np.astype(np.int64))
    k, p = _mm_both(torch.from_numpy(a_np).to(cuda), torch.from_numpy(b_np).to(cuda))
    assert k.dtype == torch.int32
    assert np.array_equal(k.cpu().numpy(), want) and torch.equal(k, p)


def test_mm_int32_wraps(cuda):
    a = torch.full((20, 600), 40_000, dtype=torch.int32, device=cuda)
    b = torch.full((600, 17), 40_000, dtype=torch.int32, device=cuda)
    want = (40_000 * 40_000 * 600) % (1 << 32)
    want = want - (1 << 32) if want >= 1 << 31 else want
    k, p = _mm_both(a, b)
    assert bool((k == want).all()) and torch.equal(k, p)


@pytest.mark.parametrize("batched", [False, True])
def test_mm_epilogue_every_extra_shape(cuda, batched):
    """A (1, N) row, an (M, 1) column, a full extra, a 0-d extra and (rank
    3) a per-batch (B, 1, 1) extra, in one epilogue with a transcendental."""
    rng = np.random.default_rng(11)
    lead = (3,) if batched else ()
    M, K, N = 70, 33, 140
    a, b = _f32(rng, lead + (M, K), cuda), _f32(rng, lead + (K, N), cuda)
    extras = [_f32(rng, (1, N), cuda), _f32(rng, (M, 1), cuda), _f32(rng, lead + (M, N), cuda),
              _f32(rng, (), cuda), _f32(rng, lead + (1, 1), cuda)]
    acc = program.leaf(lead + (M, N), torch.float32)
    ls = [program.leaf(tuple(t.shape), t.dtype) for t in extras]
    root = sm.tanh(sm.maximum(acc * ls[1] + ls[0], 0.0) - ls[2]) * ls[3] + ls[4]
    prog = program.lower_epilogue(root, acc, ls)
    k, p = _mm_both(a, b, torch.float32, prog, extras)
    # The epilogue is exact given the accumulator; the accumulators differ
    # by the order of summation, which tanh (slope <= 1) does not amplify.
    tol = 2e-5 * _abs_product(a, b) * extras[1].double().abs() * extras[3].double().abs() + 1e-6
    assert bool(((k.double() - p.double()).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_mm_epilogue_is_ew_strided_on_the_stored_product(cuda, dtype):
    """The epilogue gives bit for bit what the elementwise kernel gives on
    the stored product (bf16 operands: the tensor-core kernel's f32 product)."""
    rng = np.random.default_rng(12)
    a, b, row = _f32(rng, (200, 64), cuda), _f32(rng, (64, 130), cuda), _f32(rng, (1, 130), cuda)
    a, b = a.to(dtype), b.to(dtype)
    acc, lrow = program.leaf((200, 130), torch.float32), program.leaf((1, 130), torch.float32)
    root = sm.exp(sm.minimum(acc * 0.01 + lrow, 3.0))
    fused = matmul.matmul(a, b, torch.float32, epilogue=program.lower_epilogue(root, acc, [lrow]),
                          extras=[row])
    stored = matmul.matmul(a, b, torch.float32)
    after = elementwise.elementwise(program.lower(root, [acc, lrow]), (200, 130), torch.float32,
                                    stored, row)
    assert torch.equal(fused, after)


def test_mm_bf16_fused_relu_bias(cuda):
    rng = np.random.default_rng(13)
    a, b = _f32(rng, (3, 70, 33), cuda).bfloat16(), _f32(rng, (3, 33, 140), cuda).bfloat16()
    row = _f32(rng, (1, 1, 140), cuda).bfloat16()
    acc = program.leaf((3, 70, 140), torch.float32)
    lrow = program.leaf((1, 1, 140), torch.bfloat16)
    prog = program.lower_epilogue(sm.maximum(acc + lrow, 0.0) * 0.5 - 0.25, acc, [lrow])
    k, p = _mm_both(a, b, torch.bfloat16, prog, [row])
    assert k.dtype == torch.bfloat16
    assert bool(((k.float() - p.float()).abs() <= p.float().abs() * 2.0 ** -7 + 1e-3).all())


@pytest.mark.parametrize("scale", ["scalar", "channel"])
def test_mm_dequant_epilogue(cuda, scale):
    rng = np.random.default_rng(14)
    a = torch.from_numpy(rng.integers(-128, 128, (130, 200)).astype(np.int8)).to(cuda)
    b = torch.from_numpy(rng.integers(0, 256, (200, 129)).astype(np.uint8)).to(cuda)
    s = torch.tensor(0.5, device=cuda) if scale == "scalar" else _f32(rng, (1, 129), cuda).abs()
    matmul.reset_launches()
    k = matmul.int8_matmul(a, b, scale=s)
    assert matmul.LAUNCHES == {"mm": 1, "bmm": 0} and k.dtype == torch.float32
    want = (a.cpu().numpy().astype(np.int64) @ b.cpu().numpy().astype(np.int64)).astype(np.float32)
    assert np.array_equal(k.cpu().numpy(), want * s.cpu().numpy())


def test_matmul_path_through_the_api_launches_mm(cuda):
    rng = np.random.default_rng(15)
    x, w = (sm.Array(rng.standard_normal(s).astype(np.float32)) for s in ((300, 270), (270, 515)))
    bias = sm.Array(rng.standard_normal((1, 515)).astype(np.float32))
    layer = sm.fuse(lambda x, w, b: sm.maximum(x @ w + b, 0.0))
    elementwise.reset_launches()
    matmul.reset_launches()
    dispatch.reset()
    y = layer(x, w, bias).torch()
    yt = layer(w.T, x.T, bias.T).torch()           # transposed views, read in place
    ai = sm.Array(rng.integers(-50, 50, (64, 96)).astype(np.int32))
    di = sm.dot(ai, ai.T).torch()
    q = sm.int8_matmul(sm.Array(rng.integers(-127, 128, (2, 64, 64)).astype(np.int8)),
                       sm.Array(rng.integers(-127, 128, (2, 64, 64)).astype(np.int8))).torch()
    f = sm.matmul(x, w).torch()                     # float: torch.matmul, no launch
    torch.cuda.synchronize()
    assert matmul.LAUNCHES == {"mm": 3, "bmm": 1}
    assert elementwise.LAUNCHES == {"ew_flat": 0, "ew_strided": 0}
    assert dispatch.count("matmul", "mm_epilogue") == 2 and dispatch.count("torch_path", "matmul") == 1
    ref = torch.relu(x.torch().double() @ w.torch().double() + bias.torch().double())
    tol = 2e-5 * (x.torch().double().abs() @ w.torch().double().abs()) + 1e-6
    assert bool(((y.double() - ref).abs() <= tol).all())
    ref_t = torch.relu(w.torch().T.double() @ x.torch().T.double() + bias.torch().T.double())
    assert bool(((yt.double() - ref_t).abs() <= tol.T).all())
    assert torch.equal(di.cpu(), (ai.torch().cpu().long() @ ai.torch().cpu().long().T).int())
    assert q.dtype == torch.int32 and f.dtype == torch.float32
    assert bool(((f.double() - x.torch().double() @ w.torch().double()).abs() <= tol).all())


# --------------------------------- the tensor-core kernel (bf16 @ bf16)
def _bf16(rng, shape, device):
    return _f32(rng, shape, device).bfloat16()


def _check_bf16(a, b):
    """The f32 product of two bf16 operands through the tensor-core kernel:
    within tolerance of plain and float64, a bf16 output the f32 one
    rounded once, every launch a wgmma launch."""
    matmul.reset_launches()
    k, p = _mm_both(a, b, torch.float32)
    assert matmul.VARIANTS == {"wgmma_bf16": 2, "wgmma_s8": 0, "fma_f32": 0, "imad_i32": 0, "imad_i64": 0}
    at, bt = elementwise.read(a).double(), elementwise.read(b).double()
    tol = 2e-5 * (at.abs() @ bt.abs())
    assert bool(((k.double() - p.double()).abs() <= tol).all())
    assert bool(((k.double() - at @ bt).abs() <= tol).all())
    kb, _ = _mm_both(a, b, torch.bfloat16)
    assert torch.equal(kb, k.bfloat16())
    return k


@pytest.mark.parametrize("path", ["elements", "chunks"])
@pytest.mark.parametrize("order", ["ab", "aTb", "abT", "aTbT"])
def test_mm_bf16_operand_orders(cuda, order, path):
    """(300, 270) @ (270, 515) with each operand row-major or a transposed
    view: the four shared-memory layout pairs.  ``elements``: the strides
    (270, 515, 300) are no multiples of 8, so tiles are read element by
    element; ``chunks``: the same shapes cut from bases whose rows are
    multiples of 8, copied 16 bytes at a time with a short last copy."""
    rng = np.random.default_rng(20)
    pad = 0 if path == "elements" else 1

    def round8(n):
        return n + (-n % 8) * pad

    def operand(rows, cols, transposed):
        if transposed:  # (rows, cols) with the rows contiguous
            return _bf16(rng, (cols, round8(rows)), cuda)[:, :rows].T
        return _bf16(rng, (rows, round8(cols)), cuda)[:, :cols]

    a = operand(300, 270, order in ("aTb", "aTbT"))
    b = operand(270, 515, order in ("abT", "aTbT"))
    assert tuple(a.shape) == (300, 270) and tuple(b.shape) == (270, 515)
    for x, contraction in ((a, 2), (b, 1)):
        s3 = matmul._strides3(tuple(x.shape), tuple(x.stride()), False)
        k_major, vec16 = matmul.staging(s3, contraction, x.data_ptr())
        assert vec16 == (path == "chunks")
        assert k_major == (x.stride(-1 if contraction == 2 else -2) == 1)
    _check_bf16(a, b)


@pytest.mark.parametrize("case", ["unaligned_slice", "negative_step", "row_step", "broadcast"])
def test_mm_bf16_view_gives_the_bits_of_its_clone(cuda, case):
    rng = np.random.default_rng(21)
    base_a = sm.Array(_bf16(rng, (270, 304), cuda))
    base_b = sm.Array(_bf16(rng, (540, 336), cuda))
    a = base_a.T[:300]._operand()                     # (300, 270), m contiguous
    if case == "broadcast":                           # one row read 270 times: stride 0 over k
        b = base_b.torch()[5:6, :300].expand(270, 300)
    else:
        b = {"unaligned_slice": base_b[::2, 10:310],          # first element 20 bytes in
             "negative_step": base_b[::-2, ::-1][:, :300],
             "row_step": base_b[:270, 8:308]}[case]._operand()  # aligned: 16-byte copies
    k = _check_bf16(a, b)
    clone = matmul.matmul(elementwise.read(a).contiguous(), elementwise.read(b).contiguous(),
                          torch.float32)
    assert torch.equal(k, clone)


@pytest.mark.parametrize("shape", [((40, 1), (1, 24)), ((64, 2053), (2053, 72)),
                                   ((1, 1), (1, 1)), ((130, 64), (64, 264)),
                                   ((3, 70, 33), (3, 33, 136)), ((2, 128, 256), (2, 256, 512))],
                         ids=str)
def test_mm_bf16_edges(cuda, shape):
    """K = 1, K = 2048 + 5, one element, N % 8 == 0 with ragged M (whole
    rows stored), rank 3."""
    rng = np.random.default_rng(22)
    _check_bf16(_bf16(rng, shape[0], cuda), _bf16(rng, shape[1], cuda))


@pytest.mark.parametrize("out", ["float32", "bfloat16", "bool"])
@pytest.mark.parametrize("n", [257, 258, 260, 264, 272])
def test_mm_bf16_epilogue_every_store_width(cuda, n, out):
    """The fused epilogue with a per-batch extra, stored as f32, bf16 and
    (a comparison) bool, at widths whose rows do and do not start on 16
    bytes: the kernel against its plain version, and bf16 = f32 rounded."""
    rng = np.random.default_rng(23)
    a, b = _bf16(rng, (2, 70, 40), cuda), _bf16(rng, (2, 40, n), cuda)
    row, per_batch = _bf16(rng, (1, 1, n), cuda), _f32(rng, (2, 1, 1), cuda)
    acc = program.leaf((2, 70, n), torch.float32)
    lrow, lb = program.leaf((1, 1, n), torch.bfloat16), program.leaf((2, 1, 1), torch.float32)
    root = sm.maximum(acc + lrow, 0.0) * 0.5 - lb
    if out == "bool":
        root = root > 0.25
    prog = program.lower_epilogue(root, acc, [lrow, lb])
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16, "bool": torch.bool}[out]
    matmul.reset_launches()
    k, p = _mm_both(a, b, dtype, prog, [row, per_batch])
    assert matmul.VARIANTS["wgmma_bf16"] == 2 and k.dtype == dtype
    k32, p32 = _mm_both(a, b, torch.float32 if out != "bool" else torch.bool, prog, [row, per_batch])
    if out == "bool":
        # a sum within 2e-5 * (|A| @ |B|) of the threshold may fall either way
        margin = 2e-5 * (a.double().abs() @ b.double().abs()) * 0.5
        full = matmul.matmul_plain(a, b, torch.float32, program.lower_epilogue(
            sm.maximum(acc + lrow, 0.0) * 0.5 - lb, acc, [lrow, lb]),
            [matmul._extra3(e, (2, 70, n, 40), True) for e in (row, per_batch)])
        assert bool(((k == p) | ((full.double() - 0.25).abs() <= margin)).all())
    else:
        tol = 2e-5 * (a.double().abs() @ b.double().abs()) * 0.5 + 1e-6
        assert bool(((k32.double() - p32.double()).abs() <= tol).all())
        if out == "bfloat16":
            assert torch.equal(k, k32.bfloat16())


@pytest.mark.parametrize("terms", [1, 12])
def test_mm_bf16_epilogue_short_and_long_programs(cuda, terms):
    """The tensor-core kernel's epilogue runs four columns at a time; a
    short and a long program both give bit for bit what the elementwise
    kernel gives on the stored product."""
    rng = np.random.default_rng(26)
    a, b, row = _bf16(rng, (200, 64), cuda), _bf16(rng, (64, 136), cuda), _f32(rng, (1, 136), cuda)
    acc, lrow = program.leaf((200, 136), torch.float32), program.leaf((1, 136), torch.float32)
    root = acc
    for i in range(terms):
        root = sm.minimum(root * (0.5 + 0.01 * i) + lrow, 3.0 + i)
    prog = program.lower_epilogue(root, acc, [lrow])
    fused = matmul.matmul(a, b, torch.float32, epilogue=prog, extras=[row])
    stored = matmul.matmul(a, b, torch.float32)
    after = elementwise.elementwise(program.lower(root, [acc, lrow]), (200, 136), torch.float32,
                                    stored, row)
    assert torch.equal(fused, after)


def test_mm_mixed_and_other_types_keep_their_kernels(cuda):
    """f32 @ bf16 and bf16 @ f32 run the CUDA-core f32 kernel and give the
    bits of the same product with the bf16 operand widened beforehand
    (widening is exact); a pair with an int32 operand runs the CUDA-core
    integer kernel, a pair of 1-byte integers the int8 tensor-core kernel."""
    rng = np.random.default_rng(24)
    a, b = _f32(rng, (130, 70), cuda), _f32(rng, (70, 90), cuda)
    matmul.reset_launches()
    both = matmul.matmul(a, b.bfloat16().float())
    assert torch.equal(matmul.matmul(a, b.bfloat16()), both)
    assert torch.equal(matmul.matmul(a.bfloat16(), b), matmul.matmul(a.bfloat16().float(), b))
    assert matmul.VARIANTS == {"wgmma_bf16": 0, "wgmma_s8": 0, "fma_f32": 4, "imad_i32": 0, "imad_i64": 0}
    matmul.matmul(a.to(torch.int8), b.to(torch.int32))
    assert matmul.VARIANTS == {"wgmma_bf16": 0, "wgmma_s8": 0, "fma_f32": 4, "imad_i32": 1, "imad_i64": 0}
    matmul.matmul(a.to(torch.int8), b.to(torch.uint8))
    assert matmul.VARIANTS == {"wgmma_bf16": 0, "wgmma_s8": 1, "fma_f32": 4, "imad_i32": 1, "imad_i64": 0}


def test_bf16_root_through_the_api_takes_the_tensor_core_kernel(cuda):
    rng = np.random.default_rng(25)
    x, w, bias = (sm.Array(_bf16(rng, s, cuda)) for s in ((300, 272), (272, 520), (1, 520)))
    layer = sm.fuse(lambda x, w, b: sm.maximum(x @ w + b, 0.0))
    matmul.reset_launches()
    elementwise.reset_launches()
    dispatch.reset()
    y = layer(x, w, bias).torch()
    yt = layer(w.T, x.T, bias.T).torch()
    torch.cuda.synchronize()
    assert matmul.LAUNCHES == {"mm": 2, "bmm": 0} and matmul.VARIANTS["wgmma_bf16"] == 2
    assert sum(elementwise.LAUNCHES.values()) == 0
    assert dispatch.count("matmul", "wgmma_bf16") == 2
    ref = torch.relu(x.torch().double() @ w.torch().double() + bias.torch().double())
    tol = 2.0 ** -8 * ref.abs() + 2e-5 * (x.torch().double().abs() @ w.torch().double().abs()) + 1e-6
    assert y.dtype == torch.bfloat16 and bool(((y.double() - ref).abs() <= tol).all())
    assert bool(((yt.double() - ref.T).abs() <= tol.T).all())


# ------------------------- the int8 tensor-core kernel (int8/uint8 pairs)
# Exact: the int32 accumulator of the 8-bit wgmma wraps mod 2**32 like the
# plain version's, uint8 is read as unsigned, and every launch gives the
# same bits.  The kernel runs whatever the shape or the strides
# (``matmul.VARIANTS``), and a view gives the bits of its contiguous clone.
def _i8(rng, dtype, shape, device):
    info = np.iinfo(dtype)
    return torch.from_numpy(rng.integers(info.min, info.max + 1, shape).astype(dtype)).to(device)


def _check_int8(a, b):
    matmul.reset_launches()
    k, p = _mm_both(a, b)
    assert matmul.VARIANTS == {"wgmma_bf16": 0, "wgmma_s8": 2, "fma_f32": 0, "imad_i32": 0, "imad_i64": 0}
    assert k.dtype == torch.int32 and torch.equal(k, p)
    assert torch.equal(k, matmul.int_product(elementwise.read(a), elementwise.read(b)))
    return k


@pytest.mark.parametrize("db", ["int8", "uint8"])
@pytest.mark.parametrize("da", ["int8", "uint8"])
def test_mm_int8_signed_and_unsigned_pairs(cuda, da, db):
    rng = np.random.default_rng(30)
    a, b = _i8(rng, da, (130, 200), cuda), _i8(rng, db, (200, 129), cuda)
    assert da == "int8" or int(a.max()) > 127
    k = _check_int8(a, b)
    want = a.cpu().numpy().astype(np.int64) @ b.cpu().numpy().astype(np.int64)
    assert np.array_equal(k.cpu().numpy(), want)


@pytest.mark.parametrize("path", ["bytes", "chunks"])
@pytest.mark.parametrize("order", ["ab", "aTb", "abT", "aTbT"])
def test_mm_int8_operand_orders(cuda, order, path):
    """(300, 270) @ (270, 515) with each operand row-major or a transposed
    view.  ``bytes``: the strides (270, 515, 300) are no multiples of 16, so
    tiles are read byte by byte; ``chunks``: the same shapes cut from bases
    whose rows are multiples of 16, so an operand with k contiguous is
    copied and one with m or n contiguous is transposed on its way in, 16
    bytes at a time."""
    rng = np.random.default_rng(31)

    def round16(n):
        return n + (-n % 16) * (path == "chunks")

    def operand(dtype, rows, cols, transposed):
        if transposed:  # (rows, cols) with the rows contiguous
            return _i8(rng, dtype, (cols, round16(rows)), cuda)[:, :rows].T
        return _i8(rng, dtype, (rows, round16(cols)), cuda)[:, :cols]

    a = operand("int8", 300, 270, order in ("aTb", "aTbT"))
    b = operand("uint8", 270, 515, order in ("abT", "aTbT"))
    for x, contraction in ((a, 2), (b, 1)):
        s3 = matmul._strides3(tuple(x.shape), tuple(x.stride()), False)
        k_major, vec16 = matmul.staging(s3, contraction, x.data_ptr(), 1)
        assert vec16 == (path == "chunks")
        assert k_major == (x.stride(-1 if contraction == 2 else -2) == 1)
    _check_int8(a, b)


@pytest.mark.parametrize("shape", [((40, 1), (1, 24)), ((64, 2053), (2053, 72)),
                                   ((1, 1), (1, 1)), ((130, 128), (128, 264)),
                                   ((129, 33), (33, 257)), ((3, 70, 33), (3, 33, 136)),
                                   ((2, 128, 256), (2, 256, 512))], ids=str)
def test_mm_int8_edges(cuda, shape):
    """K = 1, K = 2048 + 5, one element, whole and ragged tiles, rank 3."""
    rng = np.random.default_rng(32)
    _check_int8(_i8(rng, "int8", shape[0], cuda), _i8(rng, "uint8", shape[1], cuda))
    _check_int8(_i8(rng, "uint8", shape[0], cuda).contiguous(), _i8(rng, "int8", shape[1], cuda))


def test_mm_int8_wraps(cuda):
    """255 * 255 * 33,280 passes 2**31: the accumulator wraps, it does not
    saturate."""
    a = torch.full((20, 33_280), 255, dtype=torch.uint8, device=cuda)
    b = torch.full((33_280, 24), 255, dtype=torch.uint8, device=cuda)
    want = 255 * 255 * 33_280
    assert want >= 1 << 31
    k = _check_int8(a, b)
    assert bool((k == want - (1 << 32)).all())
    assert bool((_check_int8(a, b.T.contiguous().T) == want - (1 << 32)).all())


@pytest.mark.parametrize("case", ["one_byte_off", "negative_step", "row_step", "broadcast"])
def test_mm_int8_view_gives_the_bits_of_its_clone(cuda, case):
    rng = np.random.default_rng(33)
    base_a = sm.Array(_i8(rng, "uint8", (270, 304), cuda))
    base_b = sm.Array(_i8(rng, "int8", (540, 336), cuda))
    a = base_a.T[:300]._operand()                     # (300, 270), m contiguous: transposed
    if case == "broadcast":                           # one row read 270 times: stride 0 over k
        b = base_b.torch()[5:6, :300].expand(270, 300)
    else:
        b = {"one_byte_off": base_b[::2, 1:301],
             "negative_step": base_b[::-2, ::-1][:, :300],
             "row_step": base_b[:270, 16:316]}[case]._operand()  # aligned: 16-byte reads
    k = _check_int8(a, b)
    clone = matmul.matmul(elementwise.read(a).contiguous(), elementwise.read(b).contiguous())
    assert torch.equal(k, clone)


@pytest.mark.parametrize("scale", ["scalar", "channel"])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("n", [129, 136])
def test_mm_int8_dequant_epilogue_runs_in_the_tensor_core_kernel(cuda, n, batched, scale):
    rng = np.random.default_rng(34)
    lead = (3,) if batched else ()
    a, b = _i8(rng, "int8", lead + (130, 200), cuda), _i8(rng, "uint8", lead + (200, n), cuda)
    s = (torch.tensor(0.5, device=cuda) if scale == "scalar"
         else _f32(rng, (1,) * (len(lead) + 1) + (n,), cuda).abs())
    matmul.reset_launches()
    k1, k2 = matmul.int8_matmul(a, b, scale=s), matmul.int8_matmul(a, b, scale=s)
    assert matmul.VARIANTS == {"wgmma_bf16": 0, "wgmma_s8": 2, "fma_f32": 0, "imad_i32": 0, "imad_i64": 0}
    assert k1.dtype == torch.float32 and torch.equal(k1, k2)
    assert torch.equal(k1, matmul.int_product(a, b).float() * s)


@pytest.mark.parametrize("out", ["int32", "float32", "bfloat16", "bool"])
@pytest.mark.parametrize("n", [257, 260, 272])
def test_mm_int8_epilogue_every_store_width(cuda, n, out):
    """Integer and float epilogues on the int32 accumulator, stored as
    int32, f32, bf16 and (a comparison) bool, at widths whose rows do and do
    not start on 16 bytes: exactly the plain version's values (the
    accumulator is exact, so nothing may differ), and ew_strided's on the
    stored product."""
    rng = np.random.default_rng(35)
    a, b = _i8(rng, "int8", (2, 70, 40), cuda), _i8(rng, "uint8", (2, 40, n), cuda)
    row = torch.from_numpy(rng.integers(-500, 500, (1, 1, n)).astype(np.int32)).to(cuda)
    acc, lrow = program.leaf((2, 70, n), torch.int32), program.leaf((1, 1, n), torch.int32)
    root = sm.maximum(acc * 3 - lrow, 0)
    dtype = getattr(torch, out)
    if out in ("float32", "bfloat16"):
        root = program.cast(root, torch.float32) * 0.125
    elif out == "bool":
        root = root > 1000
    prog = program.lower_epilogue(root, acc, [lrow])
    matmul.reset_launches()
    k, p = _mm_both(a, b, dtype, prog, [row])
    assert matmul.VARIANTS["wgmma_s8"] == 2 and k.dtype == dtype
    assert torch.equal(k, p)
    if out != "bfloat16":
        stored = matmul.matmul(a, b)
        after = elementwise.elementwise(program.lower(root, [acc, lrow]), (2, 70, n), dtype,
                                        stored, row)
        assert torch.equal(k, after)


def test_int8_matmul_through_the_api_takes_the_tensor_core_kernel(cuda):
    rng = np.random.default_rng(36)
    qa = sm.Array(rng.integers(-127, 128, (300, 272)).astype(np.int8))
    qb = sm.Array(rng.integers(0, 256, (272, 520)).astype(np.uint8))
    scale = sm.Array(np.abs(rng.standard_normal((1, 520))).astype(np.float32))
    matmul.reset_launches()
    elementwise.reset_launches()
    dispatch.reset()
    y = sm.int8_matmul(qa, qb).torch()
    ys = sm.int8_matmul(qa, qb, scale=scale).torch()
    yt = sm.int8_matmul(qb.T, qa.T).torch()            # transposed views, read in place
    d = sm.dot(qa, qb).torch()                          # the engine's integer route
    torch.cuda.synchronize()
    assert matmul.LAUNCHES == {"mm": 4, "bmm": 0}
    assert matmul.VARIANTS == {"wgmma_bf16": 0, "wgmma_s8": 4, "fma_f32": 0, "imad_i32": 0, "imad_i64": 0}
    assert sum(elementwise.LAUNCHES.values()) == 0
    assert dispatch.count("matmul", "wgmma_s8") == 4 and dispatch.count("matmul", "int8") == 3
    want = matmul.int_product(qa.torch(), qb.torch())
    assert torch.equal(y, want) and torch.equal(yt, want.T)
    assert torch.equal(d, want.to(d.dtype))            # jnp.dot's type: the product mod 2**16
    assert torch.equal(ys, want.float() * scale.torch())


# ------------------------------------- ew_flat's paths against each other
def _flat_programs(n):
    x, y, s = (program.leaf((n,), torch.float32), program.leaf((n,), torch.float32),
               program.leaf((), torch.float32))
    i, j = program.leaf((n,), torch.int32), program.leaf((n,), torch.int32)
    return {
        "add": (x + y, [x, y]), "chain": (x * y + x - y, [x, y]),
        "long_chain": (sm.minimum(sm.maximum(x * 0.5 + y, -1.0) * y - x, 2.0) + x * y, [x, y]),
        "scalar_right": (x / s, [x, s]), "scalar_left": (s - x, [s, x]),
        "constant": (x * 2.5, [x]), "twice": (x + x, [x]),
        "transcendental": (sm.exp(x * 0.25), [x]), "compare": (x > y, [x, y]),
        "select": (sm.where(x > y, x, y), [x, y]), "int": (i * j - i, [i, j]),
        "int_compare": (i >= j, [i, j]), "cast": (program.cast(i, torch.float32) * x, [i, x]),
        "identity": (x, [x]),
    }


@pytest.mark.parametrize("n", [3, 4, 1027, (1 << 16) + 2])
@pytest.mark.parametrize("name", sorted(_flat_programs(4)))
def test_ew_flat_is_the_plain_interpreter_and_ew_strided(cuda, name, n):
    """Every shape of program on ew_flat's paths (one instruction with the
    dispatch hoisted, the interpreter on four elements at a time, the
    per-element tail; n = 3 has only a tail): bit for bit the plain
    interpreter's values, and ew_strided's, which reads the same operands
    backwards."""
    root, leaves = _flat_programs(n)[name]
    prog = program.lower(root, leaves)
    operands = [(_inputs(l.dtype, max(n, 16), cuda, seed)[:n] if l.shape else
                 torch.tensor(1.75, device=cuda)) for seed, l in enumerate(leaves)]
    elementwise.reset_launches()
    k, p = _both(prog, (n,), operands)
    backwards = [elementwise.View(o, n - 1, (n,), (-1,)) if o.dim() else o for o in operands]
    k2 = elementwise.elementwise(prog, (n,), prog.dtype, *backwards)
    assert elementwise.LAUNCHES == {"ew_flat": 1, "ew_strided": 1}
    for got in (k, k2.flip(0)):
        assert got.dtype == p.dtype
        if name == "transcendental":
            assert _max_ulp(got, p) <= 2.0
        elif got.is_floating_point():
            assert _max_ulp(got, p) == 0.0
        else:
            assert torch.equal(got, p)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_ew_flat_unaligned_operands_take_the_per_element_path(cuda, offset):
    n = 4099
    x, y = _inputs(torch.float32, n + 4, cuda, 1), _inputs(torch.float32, n + 4, cuda, 2)
    lx, ly = program.leaf((n,), torch.float32), program.leaf((n,), torch.float32)
    k, p = _both(program.lower(lx * ly + lx, [lx, ly]), (n,), [x[offset:offset + n], y[:n]])
    assert _max_ulp(k, p) == 0.0


def test_ew_flat_iterated_carry(cuda):
    n = (1 << 14) + 1
    x, y = _inputs(torch.float32, n, cuda, 1).clamp(-2, 2).nan_to_num(0.5), _inputs(torch.float32, n, cuda, 2)
    lx, ly = program.leaf((n,), torch.float32), program.leaf((n,), torch.float32)
    prog = program.lower(lx * 0.5 + ly, [lx, ly])
    k, p = _both(prog, (n,), [x, y], iterations=5, carry=0)
    assert _max_ulp(k, p) == 0.0
    k1, p1 = _both(program.lower(lx * 0.5, [lx]), (n,), [x], iterations=7, carry=0)
    assert _max_ulp(k1, p1) == 0.0  # one instruction, iterated: not the hoisted loop


# ------------------------ ew_strided's generated kernels (ops/codegen.py)
# Bit for bit the interpreter's values (``elementwise.interpret``) on every
# opcode, rank, operand layout and carry; ``elementwise.PATHS`` says which
# kernel a launch took.
def _on_both_kernels(prog, shape, operands, iterations=1, carry=0):
    """The program on ew_strided's interpreter and on its generated kernel
    (bits equal), and its plain version."""
    outs = []
    for name, run in (("interp", lambda: elementwise.interpret(
                          prog, shape, *operands, iterations=iterations, carry=carry)),
                      ("generated", lambda: elementwise.elementwise(
                          prog, shape, prog.dtype, *operands, iterations=iterations, carry=carry))):
        elementwise.reset_launches()
        outs.append(run())
        torch.cuda.synchronize()
        assert elementwise.LAUNCHES == {"ew_flat": 0, "ew_strided": 1}
        assert elementwise.PATHS == {"interp": int(name == "interp"),
                                     "generated": int(name == "generated")}
    k, g = outs
    assert k.dtype == g.dtype
    bits = {4: torch.int32, 2: torch.int16, 1: torch.uint8}[k.element_size()]
    assert torch.equal(k.view(bits), g.view(bits))
    p = program.run_plain(prog, [elementwise.read(o) for o in operands], shape, iterations, carry)
    return g, p


def _backwards(x):
    """A 1-D operand read back to front (a negative stride): the strided
    entry point."""
    return elementwise.View(x, x.numel() - 1, (x.numel(),), (-1,)) if x.dim() else x


@pytest.mark.parametrize("name,dtype", _OPCODE_CASES, ids=str)
def test_generated_every_opcode_is_the_interpreter(cuda, name, dtype):
    op = registry.op_def(name)
    n = 4099
    leaves = [program.leaf((n,), dtype) for _ in range(op.arity)]
    operands = [_inputs(dtype, n, cuda, s) for s in range(op.arity)]
    if name == "where":
        leaves[0] = program.leaf((n,), torch.bool)
        operands[0] = _bits(operands[0]) > 0
    node = program.Node(name, leaves, dtype, (n,)) if name in ("pow", "ipow") else \
        program.apply(name, *leaves)
    g, p = _on_both_kernels(program.lower(node, leaves), (n,), [_backwards(o) for o in operands])
    _hold(name, g, p)


@pytest.mark.parametrize("src,dst", _CAST_CASES, ids=str)
def test_generated_casts_are_the_interpreter(cuda, src, dst):
    x = _cast_input(src, dst, 4099, cuda)
    leaf = program.leaf((4099,), src)
    g, p = _on_both_kernels(program.lower(program.cast(leaf, dst), [leaf]), (4099,),
                           [_backwards(x)])
    _hold("cast", g, p)


@pytest.mark.parametrize("rank", range(1, 9))
def test_generated_every_rank_with_broadcast_and_negative_steps(cuda, rank):
    """An operand read backwards along its last dim and with every other
    row skipped, a broadcast row (stride 0), a full operand: ranks 1 to 8."""
    rng = np.random.default_rng(30 + rank)
    shape = tuple(int(d) for d in rng.integers(1, 4, rank - 1)) + (37,)
    base = torch.from_numpy(rng.standard_normal(tuple(2 * d for d in shape)).astype(np.float32)).to(cuda)
    steps = tuple(2 * st for st in base.stride())
    view = elementwise.View(base, (shape[-1] - 1) * steps[-1], shape, steps[:-1] + (-steps[-1],))
    row = torch.from_numpy(rng.standard_normal((1,) * (rank - 1) + (37,)).astype(np.float32)).to(cuda)
    full = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    ls = [program.leaf(shape, torch.float32), program.leaf(row.shape, torch.float32),
          program.leaf(shape, torch.float32)]
    prog = program.lower(sm.maximum(ls[0] * ls[1] - ls[2], 0.25) + sm.exp(ls[1] * 0.5), ls)
    g, p = _on_both_kernels(prog, shape, [view, row, full])
    assert _max_ulp(g, p) <= 2.0


@pytest.mark.parametrize("iterations", [1, 16])
def test_generated_iterated_carry_is_the_interpreter(cuda, iterations):
    """The BASELINE recurrence at a small size, once and 16 times, the
    carry in register 0."""
    rng = np.random.default_rng(40)
    shape = (96, 260)
    a = torch.from_numpy(rng.uniform(0.5, 2.0, shape).astype(np.float32)).to(cuda)
    e = torch.from_numpy(rng.uniform(-2.0, 2.0, (1, 260)).astype(np.float32)).to(cuda)
    acc = torch.zeros(shape, device=cuda)
    ls = [program.leaf(shape, torch.float32), program.leaf(shape, torch.float32),
          program.leaf((1, 260), torch.float32)]
    prog = program.lower(ls[0] * np.float32(1e-3)
                         + sm.exp(sm.pow(ls[1] + ls[0] * np.float32(1e-6), ls[2])), ls)
    g, p = _on_both_kernels(prog, shape, [acc, a, e], iterations, 0)
    assert _max_ulp(g, p) <= 2.0
    assert bool((acc == 0).all())


def test_generated_program_at_the_instruction_limit(cuda):
    x, y = program.leaf((77, 50), torch.float32), program.leaf((1, 50), torch.float32)
    root = x
    while len(program.lower(root * y + 0.5, [x, y]).insts) <= program.MAX_INSTS:
        root = root * y + 0.5
    prog = program.lower(root, [x, y])
    assert len(prog.insts) in (program.MAX_INSTS - 1, program.MAX_INSTS)
    rng = np.random.default_rng(41)
    xs = torch.from_numpy(rng.uniform(-1, 1, (77, 50)).astype(np.float32)).to(cuda)
    ys = torch.from_numpy(rng.uniform(-1, 1, (1, 50)).astype(np.float32)).to(cuda)
    g, p = _on_both_kernels(prog, (77, 50), [xs, ys])
    assert _max_ulp(g, p) == 0.0


def test_generated_kernels_are_cached_by_signature(cuda):
    """``a + 2.0`` and ``a + 3.0`` over other shapes share one kernel; a
    second call is served from the process's cache."""
    from simplemath_tpu_torch.ops import codegen

    x = program.leaf((33, 7), torch.float32)
    progs = [program.lower(x * 1.5 + c, [x]) for c in (2.0, 3.0)]
    before = dict(codegen.STATS)
    a = _inputs(torch.float32, 33 * 7, cuda).reshape(33, 7).T.contiguous().T
    for prog in progs:
        elementwise.elementwise(prog, (33, 7), torch.float32, a)
    b = _inputs(torch.float32, 40 * 9, cuda).reshape(9, 40).T  # (40, 9), a transposed view
    y = program.leaf((40, 9), torch.float32)
    elementwise.elementwise(program.lower(y * 1.5 + 4.0, [y]), (40, 9), torch.float32, b)
    got = {k: codegen.STATS[k] - before[k] for k in before}
    assert got["compiled"] + got["disk"] <= 1 and got["memory"] >= 2


# ------------------- the CUDA-core kernel: the parent's order, bit for bit
# Every float32 output element is one thread's chain of __fmaf_rn from 0 in
# ascending k, k padded to a multiple of 16 with zero products: the
# product of the kernel this one replaces, bit for bit.  Emulated here in
# float64 (a float32 product is exact there, and the sum then rounds once
# to float32, as the fused multiply-add does, except in cases of double
# rounding, which these inputs do not reach: the tests compare exactly).
def _fma_in_order(a, b):
    """One chain of fused multiply-adds in ascending k, k padded to a
    multiple of 16, emulated in float64: each exact sum rounded to odd in
    float64 and then to float32 is the sum rounded to float32 once (a
    nearest float64 sum first could round twice)."""
    a, b = elementwise.read(a).double(), elementwise.read(b).double()
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32, device=a.device)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=a.device)
    for k in range((a.shape[1] + 15) // 16 * 16):
        if k >= a.shape[1]:
            acc = acc + 0.0
            continue
        term, c = a[:, k:k + 1] * b[k:k + 1], acc.double()
        total = term + c
        back = total - term
        err = (term - (total - back)) + (c - back)
        odd = (err != 0) & ((total.view(torch.int64) & 1) == 0)
        acc = torch.where(odd, torch.nextafter(total, torch.where(err > 0, inf, -inf)), total).float()
    return acc


def _f32_operand(rng, rows, cols, transposed, path, device):
    """(rows, cols) float32, row-major or a transposed view, cut from a base
    whose rows are a multiple of 4 elements (``chunks``: 16-byte copies) or
    not (``elements``)."""
    def width(n):
        if path == "chunks":
            return n + (-n % 4)
        return n + 1 if n % 4 == 0 else n
    if transposed:
        return _f32(rng, (cols, width(rows)), device)[:, :rows].T
    return _f32(rng, (rows, width(cols)), device)[:, :cols]


@pytest.mark.parametrize("path", ["elements", "chunks"])
@pytest.mark.parametrize("order", ["ab", "aTb", "abT", "aTbT"])
def test_mm_f32_operand_orders_give_the_parent_bits(cuda, order, path):
    """(300, 270) @ (270, 515), each operand row-major or a transposed view
    (the four layout pairs), copied 16 bytes at a time or read element by
    element (270, 515 and 300 are no multiples of 4): the parent kernel's
    bits, and within 2e-5 * (|A| @ |B|) of float64."""
    rng = np.random.default_rng(50)
    a = _f32_operand(rng, 300, 270, order in ("aTb", "aTbT"), path, cuda)
    b = _f32_operand(rng, 270, 515, order in ("abT", "aTbT"), path, cuda)
    for x, contraction in ((a, 2), (b, 1)):
        s3 = matmul._strides3(tuple(x.shape), tuple(x.stride()), False)
        k_major, vec16 = matmul.staging(s3, contraction, x.data_ptr(), 4)
        assert vec16 == (path == "chunks")
        assert k_major == (x.stride(-1 if contraction == 2 else -2) == 1)
    k, p = _mm_both(a, b, torch.float32)
    assert matmul.VARIANTS["fma_f32"] == 2
    assert torch.equal(k, _fma_in_order(a, b))
    tol = 2e-5 * _abs_product(a, b)
    assert bool(((k.double() - a.double() @ b.double()).abs() <= tol).all())
    assert bool(((k.double() - p.double()).abs() <= tol).all())


@pytest.mark.parametrize("shape", [((40, 1), (1, 24)), ((64, 2053), (2053, 72)), ((1, 1), (1, 1)),
                                   ((129, 16), (16, 257)), ((33, 48), (48, 20)), ((7, 77), (77, 5))],
                         ids=str)
def test_mm_f32_edges_give_the_parent_bits(cuda, shape):
    """K = 1, K = 2048 + 5, one element, K = 16 and K = 48 (steps of 32 k,
    half a step left over), a ragged K of 77."""
    rng = np.random.default_rng(51)
    a, b = _f32(rng, shape[0], cuda), _f32(rng, shape[1], cuda)
    assert torch.equal(matmul.matmul(a, b), _fma_in_order(a, b))


@pytest.mark.parametrize("k", [16, 20, 48])
def test_mm_f32_signed_zero_as_the_parent(cuda, k):
    """A sum whose last product underflows to -0.0 stays -0.0 where the
    parent added no padded product (K a multiple of 16) and becomes +0.0
    where it did."""
    a, b = torch.zeros(3, k, device=cuda), torch.zeros(k, 5, device=cuda)
    a[:, k - 1], b[k - 1, :] = -1e-30, 1e-30
    got = matmul.matmul(a, b)
    assert torch.equal(got.view(torch.int32), _fma_in_order(a, b).view(torch.int32))
    assert bool(torch.signbit(got).all()) == (k % 16 == 0)


@pytest.mark.parametrize("case", ["transposed", "negative_step", "four_bytes_off", "broadcast",
                                  "batched_view"])
def test_mm_f32_view_gives_the_bits_of_its_clone(cuda, case):
    rng = np.random.default_rng(52)
    base = sm.Array(_f32(rng, (540, 336), cuda))
    a = _f32(rng, (300, 270), cuda)
    if case == "transposed":
        b = base.T[:270, :300]._operand()
    elif case == "negative_step":
        b = base[::-2, ::-1][:, :300]._operand()
    elif case == "four_bytes_off":
        b = base[:270, 1:301]._operand()
    elif case == "broadcast":
        b = base.torch()[5:6, :300].expand(270, 300)
    else:  # rank 3, B a transposed view in each batch
        a = _f32(rng, (2, 300, 270), cuda)
        b = _f32(rng, (2, 300, 270), cuda).transpose(1, 2)
    k = matmul.matmul(a, b, torch.float32)
    clone = matmul.matmul(elementwise.read(a).contiguous(), elementwise.read(b).contiguous(),
                          torch.float32)
    assert torch.equal(k, clone)
    if len(a.shape) == 2:
        assert torch.equal(k, _fma_in_order(a, b))


@pytest.mark.parametrize("path", ["elements", "chunks"])
def test_mm_int32_on_both_paths(cuda, path):
    rng = np.random.default_rng(53)
    cols = 272 if path == "chunks" else 270
    a = torch.from_numpy(rng.integers(-2**31, 2**31, (300, cols)).astype(np.int32)).to(cuda)[:, :270]
    b = torch.from_numpy(rng.integers(-2**31, 2**31, (270, 516)).astype(np.int32)).to(cuda)[:, :515]
    matmul.reset_launches()
    k, again = matmul.matmul(a, b), matmul.matmul(a, b)
    assert matmul.VARIANTS["imad_i32"] == 2 and k.dtype == torch.int32 and torch.equal(k, again)
    # Full-range values: the plain version's float64 product is not exact
    # here, the CPU's int64 one wraps mod 2**64 and its low 32 bits are the
    # int32 product.
    want = a.cpu().long() @ b.cpu().long()
    assert torch.equal(k.cpu(), matmul._wrap_int32(want))


# ------------------------------------- 64-bit integer products on the card
def _wide(rng, dtype, shape, device):
    if dtype == "uint64":
        x = rng.integers(0, 2**63, shape, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    elif dtype == "int64":
        x = rng.integers(-2**63, 2**63 - 1, shape, dtype=np.int64)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, shape, dtype=np.int64).astype(dtype)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("pair", [("int64", "int64"), ("uint64", "uint64"), ("int64", "int32"),
                                  ("int8", "int64"), ("uint8", "uint64"), ("uint64", "int32")],
                         ids=str)
@pytest.mark.parametrize("batched", [False, True])
def test_mm_int64_exact_and_wrapping(cuda, pair, batched):
    """Full-range 64-bit values: every product wraps mod 2**64, exactly as
    the CPU's int64 product."""
    rng = np.random.default_rng(60)
    lead = (2,) if batched else ()
    a, b = _wide(rng, pair[0], lead + (130, 200), cuda), _wide(rng, pair[1], lead + (200, 129), cuda)
    matmul.reset_launches()
    k = matmul.matmul(a, b, torch.int64)
    assert matmul.VARIANTS["imad_i64"] == 1 and k.dtype == torch.int64
    want = torch.matmul(matmul._int64(a.cpu()), matmul._int64(b.cpu()))
    assert torch.equal(k.cpu(), want)
    assert torch.equal(k, matmul.matmul_plain(a, b, torch.int64))


def test_int64_dot_and_matmul_through_the_api(cuda):
    """``sm.dot``/``sm.matmul`` of int64 and uint64 arrays run the kernel
    (no longer raise), views read in place, the CPU's product exactly."""
    rng = np.random.default_rng(61)
    a = sm.Array(_wide(rng, "int64", (64, 96), cuda))
    u = sm.Array(_wide(rng, "uint64", (96, 40), cuda))
    matmul.reset_launches()
    for got, want in ((sm.matmul(a, a.T), a.torch().cpu() @ a.torch().cpu().T),
                      (sm.dot(a[::2], a[::-3].T), a.torch().cpu()[::2] @ a.torch().cpu().flip(0)[::3].T),
                      (sm.matmul(u.T, u), (u.torch().cpu().view(torch.int64).T
                                           @ u.torch().cpu().view(torch.int64)).view(torch.uint64))):
        assert got.dtype == want.dtype and torch.equal(got.torch().cpu(), want)
    i32 = sm.Array(_wide(rng, "int32", (64, 96), cuda))
    got = sm.matmul(i32, a.T)
    assert got.dtype == torch.int64 and torch.equal(got.torch().cpu(),
                                                     i32.torch().cpu().long() @ a.torch().cpu().T)
    assert matmul.VARIANTS["imad_i64"] == 4 and sum(matmul.VARIANTS.values()) == 4


def test_fused_int64_root_takes_the_64_bit_product(cuda):
    """A fused root over an int64 product, as the JAX package computes it:
    the product (here the 64-bit accumulator, wrapping), then the epilogue
    as torch."""
    rng = np.random.default_rng(62)
    x = sm.Array(_wide(rng, "int64", (40, 64), cuda))
    w = sm.Array(_wide(rng, "int64", (64, 24), cuda))
    c = sm.Array(torch.from_numpy(rng.integers(-9, 9, (1, 24))).to(cuda))
    matmul.reset_launches()
    dispatch.reset()
    got = sm.fuse(lambda a, b, e: sm.maximum(a @ b + e, 0) * 3)(x, w, c)
    want = torch.clamp(x.torch().cpu() @ w.torch().cpu() + c.torch().cpu(), min=0) * 3
    assert got.dtype == torch.int64 and torch.equal(got.torch().cpu(), want)
    assert matmul.VARIANTS["imad_i64"] == 1 and sum(matmul.VARIANTS.values()) == 1
    assert dispatch.count("torch_path", "matmul_epilogue") == 1


# ------------------------------------------------------------ the solvers
# The solver stack (simplemath_tpu_torch.models) is plain torch on the card,
# held against the same calls on the CPU at the tolerance the CPU tests hold
# it to the JAX package: costs within rtol 1e-4, controls within rtol 1e-3
# and 1e-4 times the largest control (the card's sin/cos and its reduction
# orders differ from the CPU's by ulps, which several iterations carry).
def _solver_close(card, cpu):
    np.testing.assert_allclose(card.cost.cpu().numpy(), cpu.cost.numpy(), rtol=1e-4)
    want = cpu.us.numpy()
    np.testing.assert_allclose(card.us.cpu().numpy(), want, rtol=1e-3,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("name,batch,horizon", [("cartpole", 16, 20), ("quadrotor", 4, 8)])
def test_solve_batched_on_card_matches_cpu(cuda, name, batch, horizon):
    from simplemath_tpu_torch.models import SYSTEMS, ilqr

    system = SYSTEMS[name]()
    rng = np.random.default_rng(70)
    x0 = torch.from_numpy((0.2 * rng.standard_normal((batch, system.nx))).astype(np.float32))
    us = torch.zeros((batch, horizon, system.nu))
    cfg = ilqr.ILQRConfig(iterations=3)
    card = ilqr.solve_batched(system, x0.to(cuda), us.to(cuda), cfg)
    cpu = ilqr.solve_batched(system, x0, us, cfg)
    assert card.cost.device.type == cuda.type and card.us.dtype == torch.float32
    _solver_close(card, cpu)


@pytest.mark.parametrize("name,horizon", [("cartpole", 20), ("quadrotor", 10)])
def test_solve_on_card_matches_cpu(cuda, name, horizon):
    from simplemath_tpu_torch.models import SYSTEMS, ilqr

    system = SYSTEMS[name]()
    x0 = torch.from_numpy((0.3 * np.random.default_rng(71).standard_normal(system.nx)).astype(np.float32))
    us = torch.zeros((horizon, system.nu))
    cfg = ilqr.ILQRConfig(iterations=3)
    _solver_close(ilqr.solve(system, x0.to(cuda), us.to(cuda), cfg), ilqr.solve(system, x0, us, cfg))


def test_solve_batched_on_card_has_no_host_sync(cuda):
    """The batched solve reads nothing back to the host: any synchronizing
    call inside it raises under sync debug mode "error"."""
    from simplemath_tpu_torch.models import ilqr, make_cartpole

    system = make_cartpole()
    x0 = 0.2 * torch.randn((32, 4), generator=torch.Generator().manual_seed(0)).to(cuda)
    us = torch.zeros((32, 10, 1), device=cuda)
    ilqr.solve_batched(system, x0, us, ilqr.ILQRConfig(iterations=1))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r = ilqr.solve_batched(system, x0, us, ilqr.ILQRConfig(iterations=2))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(r.cost).all())


def test_cholesky_nan_masking_on_card(cuda):
    """A non-PD matrix in a batch gives an all-NaN solve (as jnp's Cholesky
    does), its PD neighbours the CPU's solution, with no host round trip."""
    from simplemath_tpu_torch.models import ilqr

    M = torch.tensor([[[1.0, 2.0], [2.0, 1.0]], [[2.0, 0.5], [0.5, 3.0]],
                      [[-1.0, 0.0], [0.0, 1.0]], [[4.0, 1.0], [1.0, 2.0]]])
    rhs = torch.tensor([[1.0, 2.0], [1.0, -1.0], [3.0, 1.0], [0.5, 0.25]])
    Mc, rc = M.to(cuda), rhs.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ilqr._solve_psd(Mc, rc)
        got_m = ilqr._solve_psd(Mc, rc[..., None].expand(4, 2, 3))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = ilqr._solve_psd(M, rhs)
    nan = torch.tensor([True, False, True, False])
    assert bool(torch.isnan(got.cpu()[nan]).all()) and bool(torch.isnan(want[nan]).all())
    np.testing.assert_allclose(got.cpu()[~nan].numpy(), want[~nan].numpy(), rtol=1e-6, atol=1e-6)
    assert bool(torch.isnan(got_m.cpu()[nan]).all())
    np.testing.assert_allclose(got_m.cpu()[~nan][..., 2].numpy(), want[~nan].numpy(), rtol=1e-6)


@pytest.mark.parametrize("H", [1, 2, 3, 7, 20])
def test_associative_scan_on_card_matches_fold(cuda, H):
    from simplemath_tpu_torch.models.scan import associative_scan

    rng = np.random.default_rng(H)
    A = torch.from_numpy((0.5 * rng.standard_normal((H, 3, 3))).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal((H, 3)).astype(np.float32)).to(cuda)

    def affine(e1, e2):
        return e2[0] @ e1[0], (e2[0] @ e1[1][..., None])[..., 0] + e2[1]

    got = associative_scan(affine, (A, b))
    acc = (A[:1], b[:1])
    folds = [acc]
    for k in range(1, H):
        acc = affine(acc, (A[k:k + 1], b[k:k + 1]))
        folds.append(acc)
    for g, w in zip(got, (torch.cat([f[0] for f in folds]), torch.cat([f[1] for f in folds]))):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-5, atol=1e-5)
    ints = torch.from_numpy(rng.integers(-5, 6, H)).to(cuda)
    tree = associative_scan(lambda x, y: (2 * x[0] + 3 * y[0],), (ints,))[0]
    cpu_tree = associative_scan(lambda x, y: (2 * x[0] + 3 * y[0],), (ints.cpu(),))[0]
    assert torch.equal(tree.cpu(), cpu_tree)


# ----------------------------------------- bfloat16 and float16 reductions
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("kind", ["sum", "max", "min"])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_rd_half_inputs_match_plain(cuda, dtype, kind, axis):
    """bfloat16 and float16 inputs, widened exactly at the load and summed
    in float32, against the plain version: sums within 2e-5 * sum|x| of it
    and of float64, max and min exact, the bits repeating.  In full the
    quad-aligned operand takes the direct loop's 8-byte quads; along an
    axis its rows of 257 elements are no whole quads, so the element
    path."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((300, 257)).astype(np.float32)).to(cuda).to(dtype)
    t = x
    if axis is None:
        fn = lambda: reduction.reduce(x, kind)  # noqa: E731
    else:
        fn = lambda: reduction.reduce_axis(x, kind, axis)  # noqa: E731
    k, p = _rd_both(fn, reduction._plain(t, kind, axis))
    taken = "direct" if axis is None else "element"
    assert reduction.path(reduction.identity(dtype), kind, x.shape, reduction.layout([x]),
                          axis) == taken
    assert reduction.PATHS[taken] == 2
    ref = t.double().cpu()
    if kind == "sum":
        _close(k, p, ref.sum() if axis is None else ref.sum(axis), float(t.float().abs().sum()))
    else:
        fn64 = torch.amax if kind == "max" else torch.amin
        want = fn64(ref) if axis is None else fn64(ref, axis)
        assert torch.equal(k.double().cpu(), want) and torch.equal(k, p)


def test_rd_rounding_program_and_integer_division(cuda):
    """A map-reduce of a bfloat16 program (each instruction's result rounded
    in the register) and the sum of an int32 floor division, both on
    lanes4, against the plain version."""
    rng = np.random.default_rng(5)
    n = 4096 * 3 + 777
    a = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda).to(torch.bfloat16)
    la, lb = program.leaf((n,), torch.bfloat16), program.leaf((n,), torch.bfloat16)
    prog = program.lower(la * lb + la, [la, lb])
    assert prog.kernel_rounds == (True, True)
    k, p = _rd_both(lambda: reduction.map_reduce(prog, "sum", (n,), a, b),
                    reduction._plain(reduction.values(prog, (n,), [a, b], cuda), "sum"))
    vals = reduction.values(prog, (n,), [a, b], cuda)
    _close(k, p, vals.double().cpu().sum(), float(vals.float().abs().sum()))
    i = torch.from_numpy(rng.integers(-1000, 1000, n).astype(np.int32)).to(cuda)
    li = program.leaf((n,), torch.int32)
    div = program.lower(li // 7, [li])
    assert reduction.path(div, "sum", (n,), reduction.layout([i])) == "lanes4"
    k, p = _rd_both(lambda: reduction.map_reduce(div, "sum", (n,), i),
                    reduction._plain(reduction.values(div, (n,), [i], cuda), "sum"))
    assert float(k) == float(p)


def test_bf16_chain_rounds_each_instruction_on_both_kernels(cuda):
    """A lazy bfloat16 chain (one program, one launch) gives the bits of the
    same ops launched one at a time, on ew_flat and on ew_strided's
    generated kernel: the kernel rounds each bfloat16 result."""
    rng = np.random.default_rng(6)
    x, y, z = (torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32)).to(cuda)
               .to(torch.bfloat16) for _ in range(3))

    def chain(a, b, c):
        return (a + b) * c - a / (b * b + 1.0)

    for view in (lambda t: t, lambda t: t.T):
        arrays = [sm.Array(view(t)) if view(t).is_contiguous() else sm.Array(t).T
                  for t in (x, y, z)]
        elementwise.reset_launches()
        lazy = chain(*arrays).torch()
        torch.cuda.synchronize()
        assert sum(elementwise.LAUNCHES.values()) == 1
        old = sm.config.deferred_eager
        sm.configure(deferred_eager=False)
        try:
            eager = chain(*arrays).torch()
        finally:
            sm.configure(deferred_eager=old)
        assert lazy.dtype == torch.bfloat16
        assert torch.equal(lazy.view(torch.int16), eager.view(torch.int16))


# ------------------------------------------------ sm ops under torch.func
def _launches():
    return sum(elementwise.LAUNCHES.values()), sum(reduction.LAUNCHES.values())


def test_sm_ops_under_transforms_launch_the_kernels(cuda):
    """grad, vmap, jvp and the hessian of an sm function run ew_* and rd_*
    (ops/autodiff.py), take no plain-torch route and make no host sync;
    each value equals plain torch's autograd of the same function on the
    same CUDA tensors within 2e-5 relative (the crafted sin and the
    kernel's summation order)."""
    x = torch.linspace(-1.5, 2.0, 96, device=cuda)
    y = torch.linspace(0.5, -0.5, 96, device=cuda)

    def f_sm(t, u):
        a, b = sm.Array(t), sm.Array(u)
        return sm.sum(sm.sin(a) * b + a * a / (sm.exp(b) + 1.0) + sm.maximum(a, 0.25)).torch()

    def f_plain(t, u):
        return (torch.sin(t) * u + t * t / (torch.exp(u) + 1.0) + torch.maximum(t, torch.tensor(0.25, device=t.device))).sum()

    def close(got, want):
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)

    for name, run_sm, run_plain in (
        ("grad", lambda f: torch.func.grad(f, (0, 1))(x, y), None),
        ("vmap", lambda f: torch.func.vmap(f)(torch.stack([x, -x]), torch.stack([y, y * 2])), None),
        ("jvp", lambda f: torch.func.jvp(f, (x, y), (torch.ones_like(x), y))[1], None),
        ("hessian", lambda f: torch.func.hessian(lambda t: f(t, y[:8]))(x[:8].contiguous()), None),
    ):
        elementwise.reset_launches()
        reduction.reset_launches()
        dispatch.reset()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = run_sm(f_sm)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ew, rd = _launches()
        assert ew > 0 and rd > 0, name
        assert not any(k.startswith("torch_path") for k in dispatch.counts()), dispatch.counts()
        if name == "hessian":
            want = torch.func.hessian(lambda t: f_plain(t, y[:8]))(x[:8].contiguous())
        else:
            want = run_sm(f_plain)
        if isinstance(got, tuple):
            for g, w in zip(got, want):
                close(g, w)
        else:
            close(got, want)
    f_sm(x, y)


def _under_sync_error(fn):
    """``fn()`` with every counter at 0 and sync debug mode "error": (its
    result, (ew, rd, mm) launches, dispatch counts)."""
    elementwise.reset_launches()
    reduction.reset_launches()
    matmul.reset_launches()
    dispatch.reset()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = dispatch.counts()
    assert not any(k.startswith("torch_path") for k in counts), counts
    return out, (*_launches(), sum(matmul.LAUNCHES.values())), counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_matmul_root_under_transforms_on_card(cuda, dtype):
    """sm.fuse's matmul root under grad, jvp and vmap runs mm/bmm
    (autodiff.Product) and its epilogue's derivative programs on ew_*, with
    no plain-torch route and no host sync; values equal plain torch's
    autograd of the same function in float32 within 2e-5 relative and
    absolute (float32 sums in the kernel's order; bfloat16 operands are
    exact in float32), 4e-3 for bfloat16 gradients of bfloat16 operands
    (rounded once to bfloat16)."""
    g = torch.Generator(device="cpu").manual_seed(31)
    x, w, b = (torch.randn(s, generator=g).to(cuda).to(dtype) for s in ((96, 40), (40, 72), (1, 72)))
    t_x = torch.randn((96, 40), generator=g).to(cuda).to(dtype)
    layer = sm.fuse(lambda x, w, b: sm.tanh(x @ w + b) * 2.0 - b)

    def f_sm(x, w, b):
        return layer(x, w, b).torch()

    def f_plain(x, w, b):
        x, w, b = x.float(), w.float(), b.float()
        return torch.tanh(x @ w + b) * 2.0 - b

    def close(got, want):
        tol = 2e-5 if got.dtype == torch.float32 else 4e-3
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)

    with matmul.exact_float32():
        for name, run in (
            ("grad", lambda f: torch.func.grad(lambda *a: f(*a).float().sum(), (0, 1, 2))(x, w, b)),
            ("jvp", lambda f: torch.func.jvp(f, (x, w, b), (t_x, w, b))[1]),
            ("vmap", lambda f: torch.func.vmap(f, (0, None, 0))(torch.stack([x, t_x]), w,
                                                               torch.stack([b, -b]))),
        ):
            got, (ew, rd, mm), counts = _under_sync_error(lambda: run(f_sm))
            assert mm > 0 and counts.get("transform:matmul", 0) > 0, (name, counts)
            assert name == "vmap" or ew > 0, name
            want = run(f_plain)
            for u, v in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                close(u, v)


def test_integer_dot_and_product_under_vmap_on_card(cuda):
    """The int32 1-D dot under vmap runs rd_axis's int32 accumulator along
    the rows (one pass), and an int32 product under vmap one bmm; both
    bit-equal to the product computed in int64 and wrapped to 32 bits."""
    rng = np.random.default_rng(32)
    a = rng.integers(-2**31, 2**31, (6, 1000), dtype=np.int64).astype(np.int32)
    b = rng.integers(-1000, 1000, 1000).astype(np.int32)
    at, bt = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    got, (ew, rd, _), _ = _under_sync_error(
        lambda: torch.func.vmap(lambda x: sm.dot(sm.Array(x), sm.Array(bt)).torch())(at))
    assert reduction.LAUNCHES["rd_axis"] == 1 and rd == 1 and ew == 0
    want = ((a.astype(np.int64) * b).sum(1) + 2**31) % 2**32 - 2**31
    np.testing.assert_array_equal(got.cpu().numpy(), want.astype(np.int32))
    m = rng.integers(-50, 50, (3, 17, 9)).astype(np.int32)
    k = rng.integers(-50, 50, (9, 5)).astype(np.int32)
    mt, kt = torch.from_numpy(m).to(cuda), torch.from_numpy(k).to(cuda)
    got, (_, _, mm), _ = _under_sync_error(
        lambda: torch.func.vmap(lambda x: sm.matmul(sm.Array(x), sm.Array(kt)).torch())(mt))
    assert mm == 1 and matmul.LAUNCHES["bmm"] == 1
    np.testing.assert_array_equal(got.cpu().numpy(), m @ k)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_half_reductions_under_transforms_on_card(cuda, dtype):
    """bfloat16 and float16 sum/max under grad, jvp and vmap run rd_* (and
    ew_* for the derivative programs, in float32), with no plain-torch
    route; the gradient is exact (ones; the tie of the max shared) and in
    the input's type, values within one ulp of the type of plain torch."""
    x = torch.linspace(-2.0, 3.0, 517, device=cuda).to(dtype)
    x[[7, 400]] = 3.0
    ulp = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -10
    for kind in ("sum", "max"):
        def f(t):
            return getattr(sm.Array(t), kind)().torch()

        grad, (ew, rd, _), _ = _under_sync_error(lambda: torch.func.grad(lambda t: f(t).float())(x))
        assert rd > 0 and ew > 0 and grad.dtype == dtype, kind
        want = torch.func.grad(lambda t: getattr(t.float(), "sum" if kind == "sum" else "amax")())(x)
        torch.testing.assert_close(grad.float(), want.float(), rtol=0.0, atol=0.0)
        (out, tan), (_, rd, _), _ = _under_sync_error(
            lambda: torch.func.jvp(f, (x,), (torch.ones_like(x),)))
        assert rd > 0 and tan.dtype == dtype
        plain = x.float().sum() if kind == "sum" else x.float().amax()
        torch.testing.assert_close(out.float(), plain.to(dtype).float(), rtol=ulp, atol=0.0)
        rows, (_, rd, _), _ = _under_sync_error(lambda: torch.func.vmap(f)(torch.stack([x, -x])))
        assert reduction.LAUNCHES["rd_axis"] > 0
        want = torch.stack([x, -x]).float()
        want = want.sum(1) if kind == "sum" else want.amax(1)
        torch.testing.assert_close(rows.float(), want.to(dtype).float(), rtol=ulp, atol=ulp)


def test_bfloat16_fused_reduction_root_on_card(cuda):
    """A bfloat16 expression rooting sm.fuse runs rd_full (and rd_axis for
    an axis root): its max bit-equal to the plain version (the mapped
    values, float32 max), its sum within one bfloat16 ulp of it."""
    x = torch.linspace(-3.0, 2.5, 4099, device=cuda).bfloat16()
    y = torch.linspace(-1.0, 1.0, 40 * 33, device=cuda).reshape(40, 33).bfloat16()
    f_sum = sm.fuse(lambda a: sm.sum(a * a + a))
    f_max = sm.fuse(lambda a: sm.max(sm.tanh(a) * 3.0 - a))
    f_axis = sm.fuse(lambda a: sm.sum(a * 0.5 + 1.0, axis=0))
    for fn, kind, arg, axis in ((f_sum, "sum", x, None), (f_max, "max", x, None),
                                (f_axis, "sum", y, 0)):
        got, (ew, rd, _), _ = _under_sync_error(lambda: fn(arg).torch())
        assert rd == 1 and ew == 0 and got.dtype == torch.bfloat16
        leaf = program.leaf(tuple(arg.shape), torch.bfloat16)
        trace = fn.__wrapped__(leaf)
        prog = program.lower(trace.expr, [leaf])
        vals = program.run_plain(prog, [arg], tuple(arg.shape)).float()
        plain = (vals.sum() if axis is None else vals.sum(axis)) if kind == "sum" else vals.amax()
        tol = 0.0 if kind == "max" else 2.0 ** -8
        torch.testing.assert_close(got.float(), plain.bfloat16().float(), rtol=tol, atol=0.0)


# ------------------------------------- 2-byte operands on the quad paths
# ew_flat and rd_* read quads of 2-byte operands with one 8-byte load,
# widened in registers to the float32 bits the element path loads one by
# one: the same values, the same order of combination, so the same bits.
# Each case runs the quad path on a quad-aligned copy of the data and the
# element path on a copy 2 bytes past a 16-byte boundary.
def _placed(t, skip):
    """A contiguous copy of ``t`` starting ``skip`` elements past a 16-byte
    boundary."""
    n, size = t.numel(), t.element_size()
    base = torch.empty(n + 32 // size, dtype=t.dtype, device=t.device)
    start = (-base.data_ptr() // size) % (16 // size) + skip
    out = base[start:start + n].view(t.shape)
    out.copy_(t)
    assert (out.data_ptr() - skip * size) % 16 == 0
    return out


def _f16_inputs(n, device, seed):
    """float16 values with the widening's edges: subnormals, the largest
    finite values, signed zeros, infinities and NaN."""
    rng = np.random.default_rng(seed)
    special = [0.0, -0.0, np.inf, -np.inf, np.nan, 6e-8, -6e-8, 3e-5, 6.1e-5, 65504.0, -65504.0,
               1.0, -1.0]
    x = np.concatenate([rng.uniform(-8, 8, n - len(special)), special]).astype(np.float16)
    return torch.from_numpy(rng.permutation(x)).to(device)


def _half_programs(n):
    x, y = program.leaf((n,), torch.bfloat16), program.leaf((n,), torch.bfloat16)
    f, s = program.leaf((n,), torch.float32), program.leaf((), torch.bfloat16)
    return {
        "add": (x + y, [x, y]), "scale": (x * 2.5, [x]), "scalar_left": (s - x, [s, x]),
        "maximum": (sm.maximum(x, y), [x, y]), "minimum": (sm.minimum(x, y), [x, y]),
        "chain": ((x + y) * x - y, [x, y]), "exp": (sm.exp(x * 0.25), [x]),
        "mixed_f32_out": (x + f, [x, f]),
        "mixed_bf16_out": (x * program.cast(f, torch.bfloat16), [x, f]),
    }


@pytest.mark.parametrize("n", [3, 4, 1025, 1026, 1027, 1028, (1 << 16) + 5])
@pytest.mark.parametrize("name", sorted(_half_programs(4)))
def test_ew_flat_bf16_wide_path_is_the_element_path(cuda, name, n):
    """A bfloat16 (or mixed bfloat16/float32) program on ew_flat's wide path
    (one 8-byte load a quad, the result rounded and packed into one 8-byte
    store; the last n % 4 elements one by one) gives bit for bit the
    element path's values on the same data 2 bytes off, the interpreter's
    (elementwise.interpret) and the plain version's; max/min propagate NaN.
    FLAT_PATHS counts each launch on its path."""
    root, leaves = _half_programs(n)[name]
    prog = program.lower(root, leaves)
    operands = [(_inputs(l.dtype, max(n, 16), cuda, seed)[:n] if l.shape else
                 torch.tensor(1.75, device=cuda, dtype=l.dtype)) for seed, l in enumerate(leaves)]
    wide = [_placed(o, 0) if o.dim() else o for o in operands]
    off = [_placed(o, 1) if o.dim() and o.element_size() == 2 else o for o in operands]
    assert elementwise.flat_path(prog, (n,), elementwise.layout(wide)) == "wide"
    assert elementwise.flat_path(prog, (n,), elementwise.layout(off)) == "element"
    elementwise.reset_launches()
    k = elementwise.elementwise(prog, (n,), prog.dtype, *wide)
    e = elementwise.elementwise(prog, (n,), prog.dtype, *off)
    torch.cuda.synchronize()
    assert elementwise.FLAT_PATHS == {"wide": 1, "element": 1}
    assert elementwise.LAUNCHES == {"ew_flat": 2, "ew_strided": 0}
    i = elementwise.interpret(prog, (n,), *wide)
    p = program.run_plain(prog, operands, (n,))
    as_bits = torch.int16 if prog.dtype == torch.bfloat16 else torch.int32
    assert k.dtype == prog.dtype
    assert torch.equal(k.view(as_bits), e.view(as_bits))
    assert torch.equal(k.view(as_bits), i.view(as_bits))
    _hold("exp" if name == "exp" else name, k, p)
    if name in ("maximum", "minimum"):
        nan = torch.isnan(operands[0].float()) | torch.isnan(operands[1].float())
        assert bool(torch.isnan(k[nan].float()).all())


def test_ew_flat_bf16_add_through_the_api_takes_the_wide_path(cuda):
    """sm.add of two 1M-element bfloat16 Arrays: one ew_flat launch on the
    wide path, the float32 sum rounded once."""
    rng = np.random.default_rng(11)
    a, b = (torch.from_numpy(rng.standard_normal(1_000_000).astype(np.float32)).to(cuda)
            for _ in range(2))
    elementwise.reset_launches()
    out = sm.add(sm.Array(a.bfloat16()), sm.Array(b.bfloat16())).torch()
    torch.cuda.synchronize()
    assert elementwise.FLAT_PATHS == {"wide": 1, "element": 0}
    want = (a.bfloat16().float() + b.bfloat16().float()).bfloat16()
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))


def _half_values(dtype, shape, cuda, seed):
    """``shape`` values of ``dtype`` (bfloat16: ``_inputs``' with its special
    values; float16: ``_f16_inputs``), shuffled."""
    n = int(np.prod(shape))
    m = max(n, 64)
    x = _f16_inputs(m, cuda, seed) if dtype == torch.float16 else _inputs(torch.bfloat16, m, cuda, seed)
    order = torch.from_numpy(np.random.default_rng(seed).permutation(m)[:n]).to(cuda)
    return x[order].reshape(shape)


@pytest.mark.parametrize("n", [4, 5, 6, 7, 4096 * 3 + 777, 1_000_003])
@pytest.mark.parametrize("kind", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_rd_full_half_direct_is_the_element_path(cuda, dtype, kind, n):
    """rd_full of a quad-aligned bfloat16 or float16 operand runs ``direct``
    (eight 8-byte quads a thread in flight), and gives the bits of the same
    values 2 bytes off (``element``) and of their contiguous clone; the
    float16 widening is exact (subnormals, infinities, NaN: max/min
    propagate it, as does the sum)."""
    x = _half_values(dtype, (n,), cuda, n)
    if kind == "sum":
        x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))  # a finite sum to compare
    wide, off = _placed(x, 0), _placed(x, 1)
    p = reduction._plain(x, kind)
    k, _ = _rd_on("direct", lambda: reduction.reduce(wide, kind), p)
    e, _ = _rd_on("element", lambda: reduction.reduce(off, kind), p)
    c, _ = _rd_on("direct", lambda: reduction.reduce(off.clone(), kind), p)
    assert torch.equal(k.view(torch.int32), e.view(torch.int32))
    assert torch.equal(k.view(torch.int32), c.view(torch.int32))
    if kind == "sum":
        _rd_agree(kind, k, p, x.float().abs().sum())
    else:
        torch.testing.assert_close(k, p, rtol=0.0, atol=0.0, equal_nan=True)
        assert bool(torch.isnan(k)) == bool(torch.isnan(x.float()).any())


@pytest.mark.parametrize("shape", [(300, 256), (517, 1032), (33, 4), (8, 8192)], ids=str)
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("kind", ["sum", "max"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_rd_axis_half_direct_is_the_element_path(cuda, dtype, kind, axis, shape):
    """rd_axis along both axes of a bfloat16 or float16 matrix whose rows
    are whole quads runs ``direct`` and gives the bits of the same values 2
    bytes off (``element``)."""
    m = _half_values(dtype, shape, cuda, 7)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    wide, off = _placed(m, 0), _placed(m, 1)
    p = reduction._plain(m, kind, axis)
    k, _ = _rd_on("direct", lambda: reduction.reduce_axis(wide, kind, axis), p)
    e, _ = _rd_on("element", lambda: reduction.reduce_axis(off, kind, axis), p)
    assert torch.equal(k.view(torch.int32), e.view(torch.int32))
    _rd_agree(kind, k, p, m.float().abs().sum(axis))


def _rounding_cases(cuda, n, R, C):
    """(label, prog, kind, axis, shape, operands, path) of the rounding and
    mixed-width programs on the quad paths."""
    bf = torch.bfloat16
    a, b = _inputs(bf, n, cuda, 1).nan_to_num(0.5, 4.0, -4.0), _inputs(bf, n, cuda, 2).nan_to_num(0.25, 3.0, -3.0)
    f = _inputs(torch.float32, n, cuda, 3).nan_to_num(0.75, 2.0, -2.0)
    m, row = a[:R * C].reshape(R, C), b[:C].reshape(1, C)
    mul = lambda p, q: p * q  # noqa: E731
    return [
        ("bf16 a*b sum", _lowered(mul, a, b), "sum", None, (n,), [a, b], "single"),
        ("bf16 a*2.5 sum", _lowered(lambda p: p * 2.5, a), "sum", None, (n,), [a], "single"),
        ("bf16 a*row axis 0", _lowered(mul, m, row), "sum", 0, (R, C), [m, row], "single"),
        ("bf16 a*row axis 1", _lowered(mul, m, row), "sum", 1, (R, C), [m, row], "single"),
        ("bf16 a*b+a sum", _lowered(lambda p, q: p * q + p, a, b), "sum", None, (n,), [a, b],
         "lanes4"),
        ("f32 * bf16 sum", _lowered(mul, f, b), "sum", None, (n,), [f, b], "lanes4"),
        ("bf16 (a+b)*a max", _lowered(lambda p, q: (p + q) * p, a, b), "max", None, (n,), [a, b],
         "lanes4"),
    ]


@pytest.mark.parametrize("n", [4096 * 3 + 776, 4096 * 3 + 777])
@pytest.mark.parametrize("case", range(7))
def test_rd_half_programs_on_the_quad_paths_are_the_element_path(cuda, case, n):
    """The rounding ``single`` routes (a bfloat16 instruction's result
    rounded on each lane before it is summed), a bfloat16 program on
    ``lanes4`` and a mixed float32/bfloat16 one: bit for bit the element
    path's on the same values 2 bytes off, within 2e-5 * sum|v| of the
    plain version."""
    label, prog, kind, axis, shape, operands, want = _rounding_cases(cuda, n, 96, 128)[case]
    wide = [_placed(o, 0) for o in operands]
    off = [_placed(o, 1) for o in operands]
    assert reduction.path(prog, kind, shape, reduction.layout(wide), axis) == want, label
    vals = reduction.values(prog, shape, operands, cuda)
    p = reduction._plain(vals, kind, axis)

    def run(ops):
        if axis is None:
            return reduction.map_reduce(prog, kind, shape, *ops)
        return reduction.map_reduce_axis(prog, kind, axis, shape, *ops)

    k, _ = _rd_on(want, lambda: run(wide), p)
    e, _ = _rd_on("element", lambda: run(off), p)
    assert torch.equal(k.view(torch.int32), e.view(torch.int32)), label
    _rd_agree(kind, k, p, vals.float().abs().sum(axis) if axis is not None else vals.float().abs().sum())


_BOOL_INT_OPS = {"abs": 1, "square": 1, "floor_divide": 2, "remainder": 2}


@pytest.mark.parametrize("op", sorted(_BOOL_INT_OPS))
def test_bool_operands_of_integer_ops_on_the_kernels(cuda, op):
    """abs of bool (the bool array), square, // and % of bools (int32, with
    XLA's values at a False divisor) run on ew_flat and ew_strided and give
    the plain version's values, and the CPU's through the public API."""
    n = 4096 * 3 + 5
    rng = np.random.default_rng(1)
    a_np, b_np = rng.integers(0, 2, n).astype(bool), rng.integers(0, 2, n).astype(bool)
    a, b = torch.from_numpy(a_np).to(cuda), torch.from_numpy(b_np).to(cuda)
    arity = _BOOL_INT_OPS[op]
    leaves = [program.leaf((n,), torch.bool) for _ in range(arity)]
    prog = program.lower(program.apply(op, *leaves), leaves)
    assert prog.kernel_codes is not None
    assert prog.dtype == (torch.bool if op == "abs" else torch.int32)
    operands = [a, b][:arity]
    elementwise.reset_launches()
    k, p = _both(prog, (n,), operands)
    assert k.dtype == p.dtype and torch.equal(k, p)
    backwards = [elementwise.View(o, n - 1, (n,), (-1,)) for o in operands]
    g = elementwise.elementwise(prog, (n,), prog.dtype, *backwards)
    assert torch.equal(g.flip(0), k)
    assert elementwise.LAUNCHES == {"ew_flat": 1, "ew_strided": 1}

    f = {"abs": lambda x, y: sm.abs(x), "square": lambda x, y: sm.square(x),
         "floor_divide": lambda x, y: x // y, "remainder": lambda x, y: x % y}[op]
    dispatch.reset()
    got = f(sm.Array(a), sm.Array(b)).torch()
    assert not any(key.startswith("torch_path") for key in dispatch.counts())
    sm.configure(device="cpu")
    try:
        want = f(sm.Array(a_np), sm.Array(b_np)).torch()
    finally:
        sm.configure(device="cuda")
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want)
    if op == "floor_divide":
        tf = torch.tensor([True, False, True, False], device=cuda)
        tt = torch.tensor([True, True, False, False], device=cuda)
        assert (sm.Array(tf) // sm.Array(tt)).torch().cpu().tolist() == [1, 0, -2, -1]
