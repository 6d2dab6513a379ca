"""The CUDA kernels (elementwise and map-reduce) against their plain
PyTorch versions, on the card.  Every test needs a CUDA device and skips
without one.  The file imports no jax, so it also runs where only PyTorch
is installed:

    python -m pytest --noconftest tests/test_torch_kernel_cuda.py -q

Tolerance: exact for arithmetic, comparisons, casts and the integer ops
(the kernel is built with --fmad=false, so each float operation rounds
once, as torch's do); 2 ulp for the transcendentals.  The reductions'
tolerances are stated above their tests.
"""

import numpy as np
import pytest
import torch

import simplemath_tpu_torch as sm
from simplemath_tpu_torch.ops import elementwise, engine, program, reduction, registry

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
    if dtype == torch.float32:
        special = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 1.0, -1.0, 88.7]
        x = np.concatenate([rng.uniform(-8, 8, n - len(special)), special]).astype(np.float32)
    else:
        x = np.concatenate([rng.integers(-60, 60, n - 4), [2**31 - 1, -2**31, 0, 1]]).astype(np.int32)
    return torch.from_numpy(x).to(device)


_OPCODE_CASES = [
    (name, dtype)
    for name in sorted(set(registry.registered_ops()) | set(registry.INTERNAL))
    for dtype in (torch.float32, torch.int32)
    if dtype in registry.op_def(name).opcodes
]


@pytest.mark.parametrize("name,dtype", _OPCODE_CASES, ids=str)
def test_every_opcode_matches_plain(cuda, name, dtype):
    op = registry.op_def(name)
    n = 1 << 14
    leaves = [program.leaf((n,), dtype) for _ in range(op.arity)]
    operands = [_inputs(dtype, n, cuda, s) for s in range(op.arity)]
    if name == "where":
        leaves[0] = program.leaf((n,), torch.bool)
        operands[0] = operands[0] > 0
    if name in ("pow", "ipow"):
        node = program.Node(name, leaves, dtype, (n,))
    else:
        node = program.apply(name, *leaves)
    k, p = _both(program.lower(node, leaves), (n,), operands)
    if name in _TRANSCENDENTAL:
        assert _max_ulp(k, p) <= 2.0
    elif k.is_floating_point():
        assert _max_ulp(k, p) == 0.0
    else:
        assert torch.equal(k, p)


@pytest.mark.parametrize("src,dst", list(program._CASTS))
def test_casts_match_plain(cuda, src, dst):
    x = {torch.float32: _inputs(torch.float32, 4096, cuda).clamp(-1e6, 1e6).nan_to_num(0.5),
         torch.int32: _inputs(torch.int32, 4096, cuda),
         torch.bool: _inputs(torch.float32, 4096, cuda) > 0}[src]
    leaf = program.leaf((4096,), src)
    k, p = _both(program.lower(program.cast(leaf, dst), [leaf]), (4096,), [x])
    assert torch.equal(k, p)


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
