"""The port's ops against the JAX package's: every registry op, the crafted
transcendentals and ``ipow_tile``, ``engine.pow``'s ladder, and the
expression lowering with its plain interpreter (the plain version of the
elementwise kernel, which is what runs on CPU tensors).

Tolerances: arithmetic exact; the crafted transcendentals within 2 ulp of
the JAX functions and within ``_IMPL_TOLS["crafted"]``
(tests/test_transcendental.py) of float64; sin/cos/tan are native on both
sides (XLA's and torch's own), so those are held to float64 at 2 ulp.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import simplemath_tpu as jsm
import simplemath_tpu_torch as sm
from simplemath_tpu.ops import transcendental as jtr
from simplemath_tpu_torch import dtypes
from simplemath_tpu_torch.ops import dispatch, program, registry
from simplemath_tpu_torch.ops import transcendental as ttr

_CRAFTED = dict(exp=1e-6, log=1e-6, log_atol=1e-6, pow=4e-6)


@pytest.fixture(autouse=True)
def _reference_crafted():
    """The port is crafted everywhere; hold it against the JAX package's
    crafted mode (its "auto" picks native exp/pow by TPU measurements).
    The tests run on the CPU and ask for it."""
    from simplemath_tpu.config import config as jconfig

    old = (jconfig.transcendental_impl, sm.config.device)
    jconfig.transcendental_impl = "crafted"
    sm.configure(device="cpu")  # the port's default device is the card
    yield
    jconfig.transcendental_impl = old[0]
    sm.configure(device=old[1])


def max_ulp(got, want):
    """Largest distance in float32 ulps of ``want``, NaN == NaN."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    sp = np.spacing(np.abs(w).astype(np.float32)).astype(np.float64)
    with np.errstate(invalid="ignore"):
        d = np.where(same, 0.0, np.abs(g - w) / sp)
    return float(np.nan_to_num(d, nan=np.inf).max(initial=0.0))


def _inputs(rng, dtype, n=4096):
    if dtype == "float32":
        special = [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 0.5]
        x = np.concatenate([rng.uniform(-6, 6, n - 8), special])
        return x.astype(np.float32)
    return rng.integers(-50, 50, n).astype(np.int32)


_BINARY = ["add", "subtract", "multiply", "divide", "maximum", "minimum",
           "equal", "not_equal", "less", "less_equal", "greater", "greater_equal"]
_UNARY = ["negative", "abs", "sqrt", "square", "sign"]


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("name", _BINARY + ["floor_divide", "remainder"])
def test_binary_registry_ops_match(rng, name, dtype):
    a, b = _inputs(rng, dtype), _inputs(rng, dtype)
    if name in ("floor_divide", "remainder"):
        b = np.where(b == 0, 3, b).astype(b.dtype)
        b = np.where(np.isfinite(b), b, 2).astype(b.dtype)
    want = jsm.apply_op(name, jsm.Array(a), jsm.Array(b))
    got = sm.apply_op(name, sm.Array(a), sm.Array(b))
    assert dtypes.name(got.dtype) == np.dtype(want.dtype).name
    np.testing.assert_array_equal(got.numpy(), want.numpy())


_BY_ZERO = {
    "int32": (np.array([7, -7, 0, -2**31, 2**31 - 1, -2**31, 5, -9, 0], np.int32),
              np.array([0, 0, 0, -1, -1, 0, -3, 2, -1], np.int32)),
    "float32": (np.array([7.0, -7.0, 0.0, -0.0, np.inf, -np.inf, np.nan, 5.0, -1.0],
                         np.float32),
                np.array([0.0, 0.0, 0.0, 0.0, 0.0, -0.0, 0.0, -3.0, np.inf], np.float32)),
    "uint32": (np.array([7, 0, 4294967295, 5], np.uint32), np.array([0, 0, 0, 2], np.uint32)),
}
_DIVISIONS = {"floor_divide": lambda m, x, y: x // y, "remainder": lambda m, x, y: x % y,
              "fused": lambda m, x, y: m.fuse(lambda a, b: (a // b) * 3 + a % b)(x, y)}


@pytest.mark.parametrize("deferred", [False, True])
@pytest.mark.parametrize("op", sorted(_DIVISIONS))
@pytest.mark.parametrize("dtype", sorted(_BY_ZERO))
def test_floor_divide_and_remainder_by_zero_match_jax(dtype, op, deferred):
    """x // 0 and x % 0 give the JAX package's values, eager, lazy and
    inside sm.fuse: NaN for floats; for integers XLA's (-1 or -2 signed,
    all ones unsigned, x % 0 == 0), and INT_MIN // -1 wraps.  torch alone
    raises (CPU) or is unspecified (CUDA) on an integer zero divisor and
    gives ±inf for a float one."""
    from simplemath_tpu.config import config as jconfig
    from simplemath_tpu_torch.config import config

    x, y = _BY_ZERO[dtype]
    f = _DIVISIONS[op]
    old = (config.deferred_eager, jconfig.deferred_eager)
    config.deferred_eager = jconfig.deferred_eager = deferred
    try:
        got = f(sm, sm.Array(x), sm.Array(y))
        want = f(jsm, jsm.Array(x), jsm.Array(y)).numpy()
        got_np = got.numpy()
    finally:
        config.deferred_eager, jconfig.deferred_eager = old
    assert dtypes.name(got.dtype) == want.dtype.name
    np.testing.assert_array_equal(got_np, want)  # NaN == NaN here


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("name", _UNARY)
def test_unary_registry_ops_match(rng, name, dtype):
    a = _inputs(rng, dtype)
    want = jsm.apply_op(name, jsm.Array(a)).numpy()
    got = sm.apply_op(name, sm.Array(a))
    assert dtypes.name(got.dtype) == want.dtype.name
    if name == "sqrt":  # correctly rounded on both sides; CPU vector paths may differ by 1 ulp
        assert max_ulp(got.numpy(), want) <= 1.0
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["where", "clip"])
def test_ternary_registry_ops_match(rng, name):
    a = _inputs(rng, "float32")
    if name == "where":
        args = (a > 0, a, _inputs(rng, "float32"))
    else:
        args = (a, np.float32(-1.0) * np.ones_like(a), np.full_like(a, 2.5))
    want = jsm.apply_op(name, *[jsm.Array(x) for x in args])
    got = sm.apply_op(name, *[sm.Array(x) for x in args])
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_scalar_operands_promote_weakly():
    i = sm.Array([1, 2])
    f = sm.Array([1.0, 2.0])
    cases = [(i, 1.5), (i, 2), (f, 2), (f, np.float64(2.0)), (i, True)]
    for arr, s in cases:
        jarr = jsm.Array(arr.numpy())
        got, want = arr + s, jarr + s
        assert dtypes.name(got.dtype) == np.dtype(want.dtype).name, (arr.dtype, s)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------- transcendentals
_SWEEPS = {
    "exp": np.concatenate([np.linspace(-87.0, 88.0, 20001), np.linspace(-1.5, 1.1, 4001)]),
    "log": np.concatenate([np.geomspace(1e-38, 3e38, 20001), np.linspace(0.9, 1.1, 4001)]),
    "exp2": np.linspace(-120.0, 120.0, 20001),
    "log2": np.geomspace(1e-38, 3e38, 20001),
    "tanh": np.linspace(-12.0, 12.0, 20001),
}
_EDGES = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 88.7, 89.0,
                   -103.9, -110.0, 3.0, 1.0, -1.0])


@pytest.mark.parametrize("name", sorted(_SWEEPS))
def test_crafted_unary_matches_jax_and_float64(name):
    x = np.concatenate([_SWEEPS[name], _EDGES]).astype(np.float32)
    got = getattr(ttr, f"{name}_f32")(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jtr, f"{name}_f32")(x))
    # XLA:CPU flushes subnormal products to zero; exp's k = -126 band
    # (x just above -87.34) is built by a multiply there, so compare
    # the subnormal outputs with float64 only.
    normal = ~((np.abs(got) < np.finfo(np.float32).tiny) & (got != 0))
    assert max_ulp(got[normal], want[normal]) <= 2.0
    ref = getattr(np, name)(x.astype(np.float64))
    f32 = np.finfo(np.float32)
    fin = (np.abs(ref) >= f32.tiny) & (np.abs(ref) <= f32.max)
    assert max_ulp(got[fin], ref[fin]) < 4.0
    # The crafted exp2 of ±inf is NaN in both packages (x - round(x) is
    # NaN there), so NaN placement is held to float64 on finite inputs.
    finite = np.isfinite(x)
    np.testing.assert_array_equal(np.isnan(got[finite]), np.isnan(ref[finite]))


def test_exp_subnormal_results_are_right():
    x = np.linspace(-103.0, -87.4, 4001).astype(np.float32)
    got = ttr.exp_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.exp(x.astype(np.float64)), rtol=1e-3, atol=1.5e-45)


def test_crafted_public_path_bounds():
    """The JAX package's "crafted" accuracy contract through the public
    port API (tests/test_transcendental.py::test_public_path_accuracy_all_impls)."""
    x = np.linspace(0.01, 20.0, 50_001).astype(np.float32)
    b = np.linspace(0.5, 4.0, 50_001).astype(np.float32)
    e = np.linspace(-3.0, 3.0, 50_001).astype(np.float32)
    np.testing.assert_allclose(sm.exp(sm.Array(-x / 4)).numpy(),
                               np.exp(-x.astype(np.float64) / 4), rtol=_CRAFTED["exp"])
    np.testing.assert_allclose(sm.log(sm.Array(x)).numpy(), np.log(x.astype(np.float64)),
                               rtol=_CRAFTED["log"], atol=_CRAFTED["log_atol"])
    np.testing.assert_allclose(sm.pow(sm.Array(b), sm.Array(e)).numpy(),
                               np.power(b.astype(np.float64), e.astype(np.float64)),
                               rtol=_CRAFTED["pow"])
    assert abs(float(sm.log(sm.Array(np.float32(3.0))).numpy()) - np.log(3.0)) < 1e-7


def test_pow_f32_matches_jax(rng):
    specials = np.array([0.0, -0.0, 1.0, -1.0, 2.0, -2.0, np.inf, -np.inf, np.nan, 0.5])
    x = np.concatenate([rng.uniform(-8, 8, 4000), np.repeat(specials, 10)]).astype(np.float32)
    y = np.concatenate([rng.uniform(-6, 6, 2000), np.round(rng.uniform(-6, 6, 2000)),
                        np.tile(specials, 10)]).astype(np.float32)
    got = ttr.pow_f32(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(jtr.pow_f32(x, y))
    assert max_ulp(got, want) <= 2.0


@pytest.mark.parametrize("name", ["sin", "cos", "tan"])
def test_native_trig_against_float64(rng, name):
    x = rng.uniform(-50, 50, 20000).astype(np.float32)
    got = getattr(sm, name)(sm.Array(x)).numpy()
    assert max_ulp(got, getattr(np, name)(x.astype(np.float64))) <= 2.0
    want = getattr(jsm, name)(jsm.Array(x)).numpy()
    assert max_ulp(got, want) <= 4.0


def test_ipow_tile_matches_jax(rng):
    base = np.concatenate([rng.integers(-6, 7, 4000), [2, -2, 3, 7, 1, -1, 0, -1]]).astype(np.int32)
    expo = np.concatenate([rng.integers(-8, 40, 4000), [31, 31, 21, 12, -5, -5, -1, -2**31]]).astype(np.int32)
    got = ttr.ipow_tile(torch.from_numpy(base), torch.from_numpy(expo)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jtr.ipow_tile(base, expo)))


# ------------------------------------------------------------ pow ladder
_POW_CASES = [
    ("float32", 2, "powi"), ("float32", -3, "powi"), ("float32", 7, "powi"),
    ("float32", 0, "powi"), ("float32", 2.5, "pow"), ("float32", 65, "pow"),
    ("float32", "float32", "pow"), ("int32", "int32", "ipow"), ("int32", 3, "ipow"),
    ("int32", "float32", "pow"), ("float64", 2.5, "pow"), ("float64", "float64", "pow"),
]


@pytest.mark.parametrize("a_dt,b,label", _POW_CASES, ids=str)
@pytest.mark.parametrize("deferred", [False, True])
def test_pow_ladder_matches_jax(rng, a_dt, b, label, deferred):
    from simplemath_tpu_torch.config import config

    if a_dt == "int32":
        a = rng.integers(-5, 6, 512).astype(np.int32)
    else:
        a = rng.uniform(0.5, 3.0, 512).astype(a_dt)
    if isinstance(b, str):
        b = (rng.integers(-3, 9, 512) if b == "int32" else rng.uniform(-3, 3, 512)).astype(b)
        jb, pb = jsm.Array(b), sm.Array(b)
    else:
        jb = pb = b
    old = config.deferred_eager
    config.deferred_eager = deferred
    dispatch.reset()
    try:
        got = sm.pow(sm.Array(a), pb)
        got_np = got.numpy()
    finally:
        config.deferred_eager = old
    want = jsm.pow(jsm.Array(a), jb).numpy()
    assert dtypes.name(got.dtype) == want.dtype.name
    path = "elementwise" if label != "pow" or got.dtype == torch.float32 else "torch_path"
    assert dispatch.count(path, label) == 1, dispatch.counts()
    if label in ("ipow", "powi"):
        np.testing.assert_array_equal(got_np, want)
    else:
        assert max_ulp(got_np, want) <= 2.0


# -------------------------------------------------- lowering and interpreter
def test_lowering_shares_nodes_and_constants():
    la, lb = program.leaf((4,), torch.float32), program.leaf((1,), torch.float32)
    s = la + lb
    root = (s * 2.0 + s) * 2.0
    prog = program.lower(root, [la, lb])
    assert prog.leaf_dtypes == (torch.float32, torch.float32)
    assert prog.consts == ((2.0, torch.float32),)  # the weak 2.0 became f32, once
    assert [i[0] for i in prog.insts] == ["add", "multiply", "add", "multiply"]
    assert prog.insts[0][3:] == (0, 1, -1)  # s reads both leaves
    assert prog.result == prog.n_regs - 1
    assert prog.kernel_codes == tuple(program.OPCODE_INDEX[c] for c in
                                      ("ADD_F", "MUL_F", "ADD_F", "MUL_F"))
    a = torch.arange(4, dtype=torch.float32)
    b = torch.tensor([0.5])
    out = program.run_plain(prog, [a, b], (4,))
    np.testing.assert_array_equal(out.numpy(), (((a + b) * 2 + (a + b)) * 2).numpy())


def test_lowering_inserts_casts_and_types_comparisons():
    li, lf = program.leaf((3,), torch.int32), program.leaf((3,), torch.float32)
    prog = program.lower(program.apply("less", li, lf), [li, lf])
    assert [(op, c, d) for op, c, d, *_ in prog.insts] == [
        ("cast", torch.int32, torch.float32), ("less", torch.float32, torch.bool)]
    assert prog.dtype == torch.bool and prog.kernel_codes is not None


@pytest.mark.parametrize("dtype,kernel", [
    (torch.float64, False), (torch.int64, False), (torch.bfloat16, True),
    (torch.float32, True), (torch.int32, True), (torch.uint32, True), (torch.float16, False),
])
def test_kernel_takes_only_its_dtypes(dtype, kernel):
    la, lb = program.leaf((2,), dtype), program.leaf((2,), dtype)
    prog = program.lower(program.apply("add", la, lb), [la, lb])
    assert (prog.kernel_codes is not None) == kernel


def test_program_limits():
    leaves = [program.leaf((2,), torch.float32) for _ in range(program.MAX_OPERANDS + 1)]
    root = leaves[0]
    for leaf in leaves[1:]:
        root = root + leaf
    assert not program.lower(root, leaves).within_limits()
    x = program.leaf((2,), torch.float32)
    deep = x
    for _ in range(program.MAX_INSTS + 1):
        deep = deep * x
    assert not program.lower(deep, [x]).within_limits()
    assert program.lower(deep, [x]).kernel_codes is not None


def test_iterated_interpreter_feeds_the_carry():
    acc, a = program.leaf((3,), torch.float32), program.leaf((3,), torch.float32)
    prog = program.lower(acc * 0.5 + a, [acc, a])
    x0, av = torch.zeros(3), torch.tensor([1.0, 2.0, 4.0])
    want = x0.clone()
    for _ in range(5):
        want = want * 0.5 + av
    out = program.run_plain(prog, [x0, av], (3,), iterations=5, carry=0)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    assert x0.abs().sum() == 0  # the operand is never written


def test_opcode_table_matches_cuda_enum():
    src = (pathlib.Path(program.__file__).resolve().parent.parent / "csrc" / "tiles.cuh").read_text()
    body = re.search(r"enum SmOpcode : uint8_t \{(.*?)\};", src, re.S).group(1)
    names = [w.strip() for w in body.replace("\n", " ").split(",") if w.strip()]
    assert tuple(names) == program.OPCODES
    for op in list(registry.registered_ops().values()) + list(registry.INTERNAL.values()):
        for code in op.opcodes.values():
            assert code in program.OPCODE_INDEX


def test_user_op_traces_onto_the_kernel_or_runs_as_torch(rng):
    a = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    sm.register_op("twice_sum_port", lambda x, y: (x + y) * 2, overwrite=True)
    sm.register_op("torch_only_port", lambda x, y: torch.atan2(x, y), overwrite=True)
    dispatch.reset()
    got = sm.apply_op("twice_sum_port", sm.Array(a), sm.Array(b)).numpy()
    np.testing.assert_array_equal(got, (a + b) * 2)
    assert dispatch.count("elementwise", "twice_sum_port") == 1
    got = sm.apply_op("torch_only_port", sm.Array(a), sm.Array(b)).numpy()
    np.testing.assert_allclose(got, np.arctan2(a, b), rtol=1e-6)
    assert dispatch.count("torch_path", "torch_only_port") == 1
    with pytest.raises(ValueError, match="already registered"):
        sm.register_op("add", lambda x, y: x)
    with pytest.raises(KeyError, match="register_op"):
        sm.apply_op("no_such_op", sm.Array(a))


_U32_PROGRAMS = {
    "add": lambda m, x, y: x + y, "subtract": lambda m, x, y: x - y,
    "multiply": lambda m, x, y: x * y, "maximum": lambda m, x, y: m.maximum(x, y),
    "less": lambda m, x, y: x < y, "negative": lambda m, x, y: -x,
    "floor_divide": lambda m, x, y: x // y, "divide": lambda m, x, y: x / y,
    "where": lambda m, x, y: m.where(x < y, x, y), "ipow": lambda m, x, y: m.pow(x, y),
}


@pytest.mark.parametrize("name", sorted(_U32_PROGRAMS))
def test_uint32_runs_widened_on_the_torch_path(name):
    """uint32 runs the kernel's opcodes (the int32 ones where the bits are
    the same, unsigned compare, max and floor division, the U2F cast of
    true division) and matches the JAX package.  torch implements little
    uint32 arithmetic on the CPU, so the kernel's plain version widens to
    int64 and wraps back; ipow, which has no uint32 opcode, runs as plain
    torch so."""
    a = np.array([1, 5, 4294967295, 70000], np.uint32)
    b = np.array([3, 2, 2, 70000], np.uint32)
    f = _U32_PROGRAMS[name]
    dispatch.reset()
    got = f(sm, sm.Array(a), sm.Array(b))
    want = f(jsm, jsm.Array(a), jsm.Array(b)).numpy()
    assert dtypes.name(got.dtype) == want.dtype.name
    np.testing.assert_array_equal(got.numpy(), want)
    counts = dispatch.counts()
    assert sum(v for k, v in counts.items() if k.startswith("torch_path")) == (name == "ipow")
    assert sum(v for k, v in counts.items() if k.startswith("elementwise")) == (name != "ipow")


@pytest.mark.parametrize("name", ["add", "pow"])
def test_bfloat16_runs_on_the_torch_path(rng, name):
    x = rng.uniform(0.5, 2.0, 256).astype(np.float32)
    y = rng.uniform(-2.0, 2.0, 256).astype(np.float32)
    run = {"add": lambda m, a, b: a + b, "exp": lambda m, a, b: m.exp(a),
           "pow": lambda m, a, b: m.pow(a, b), "tanh": lambda m, a, b: m.tanh(b)}[name]
    dispatch.reset()
    got = run(sm, sm.Array(x, dtype="bfloat16"), sm.Array(y, dtype="bfloat16"))
    want = run(jsm, jsm.Array(x, dtype="bfloat16"), jsm.Array(y, dtype="bfloat16"))
    assert got.dtype == torch.bfloat16 and want.dtype == np.dtype("bfloat16")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy(), np.float32))
    # bfloat16 runs the kernel (float32 opcodes, each result rounded to
    # bfloat16); this checks its plain version.
    counts = dispatch.counts()
    assert not any(k.startswith("torch_path") for k in counts)
    assert sum(v for k, v in counts.items() if k.startswith("elementwise")) == 1


# -------------------------------------- bfloat16 and uint32 on the kernel
def _bf16_ulps(got, want):
    """Largest distance in bfloat16 ulps (the values' own spacing), NaN ==
    NaN."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    spacing = np.maximum(np.abs(w), 2.0 ** -126) * 2.0 ** -7
    with np.errstate(invalid="ignore"):
        d = np.where(same, 0.0, np.abs(g - w) / spacing)
    return float(np.nan_to_num(d, nan=np.inf).max(initial=0.0))


_BF16_OPS = {
    **{n: (lambda n: lambda m, a, b: m.apply_op(n, a, b))(n) for n in _BINARY},
    **{n: (lambda n: lambda m, a, b: getattr(m, n)(a))(n) for n in _UNARY},
    **{n: (lambda n: lambda m, a, b: getattr(m, n)(a))(n)
       for n in ("exp", "log", "exp2", "log2", "tanh", "sin", "cos", "tan")},
    "where": lambda m, a, b: m.where(a > b, a, b),
    "clip": lambda m, a, b: m.clip(a, -1.5, b),
    "pow": lambda m, a, b: m.pow(m.abs(a), b),
    "pow_static_3": lambda m, a, b: a ** 3,
    "scalar": lambda m, a, b: a * 2.5 - 1.0,
    "int32_operand": lambda m, a, b: a + m.Array(np.arange(-6, 6, dtype=np.int32).repeat(22)[:256]),
    "float32_operand": lambda m, a, b: a * m.Array(np.linspace(-3, 3, 256, dtype=np.float32)),
}


@pytest.mark.parametrize("name", sorted(_BF16_OPS))
def test_bfloat16_op_by_op_matches_jax(rng, name):
    """Every op on bfloat16 runs the kernel's float32 opcode and rounds its
    result to bfloat16 once (casts from int32 and to float32 included):
    the JAX package's values op by op, bit for bit, where its ops are
    computed one at a time (deferred queue off on both sides); sin, cos and
    tan are torch's and XLA's own, within 1 bfloat16 ulp."""
    from simplemath_tpu.config import config as jconfig
    from simplemath_tpu_torch.config import config

    x = np.concatenate([rng.uniform(-4, 4, 250), [0.0, -0.0, 1.0, np.inf, -2.0, np.nan]])
    y = rng.uniform(-2, 2, 256)
    x, y = x.astype(np.float32), y.astype(np.float32)
    f = _BF16_OPS[name]
    old = (config.deferred_eager, jconfig.deferred_eager)
    config.deferred_eager = jconfig.deferred_eager = False
    try:
        dispatch.reset()
        got = f(sm, sm.Array(x, dtype="bfloat16"), sm.Array(y, dtype="bfloat16"))
        counts = dispatch.counts()
        want = f(jsm, jsm.Array(x, dtype="bfloat16"), jsm.Array(y, dtype="bfloat16"))
    finally:
        config.deferred_eager, jconfig.deferred_eager = old
    want_np = np.asarray(want.numpy())
    assert dtypes.name(got.dtype) == want_np.dtype.name
    assert not any(k.startswith("torch_path") for k in counts), counts
    g, w = got.numpy().astype(np.float64), want_np.astype(np.float64)
    if name in ("sin", "cos", "tan"):
        assert _bf16_ulps(g, w) <= 1.0
    else:
        np.testing.assert_array_equal(g, w)


def test_bfloat16_chain_rounds_where_jnp_rounds(rng):
    """A chain of bfloat16 ops recorded by the lazy queue (one program)
    gives the bits of the same ops run one by one: the kernel rounds each
    bfloat16 result.  XLA's CPU fusion of the JAX package's lazy chain keeps
    a float32 intermediate where jnp's ops round (a / (b * b + 1.0) differs
    by up to 2 bfloat16 ulps), so against it the chain is held within 3
    ulps (2 of the division, 1 of the last rounding) of the sum of its
    terms' magnitudes; op by op, and against the JAX package's sm.fuse, it
    is equal."""
    from simplemath_tpu_torch.config import config

    x, y, z = (rng.standard_normal(4096).astype(np.float32) for _ in range(3))

    def chain(m, a, b, c):
        return (a + b) * c - a / (b * b + 1.0)

    port = [sm.Array(v, dtype="bfloat16") for v in (x, y, z)]
    ref = [jsm.Array(v, dtype="bfloat16") for v in (x, y, z)]
    lazy = chain(sm, *port).numpy()
    old = config.deferred_eager
    config.deferred_eager = False
    try:
        eager = chain(sm, *port).numpy()
    finally:
        config.deferred_eager = old
    np.testing.assert_array_equal(lazy, eager)
    fused = np.asarray(jsm.fuse(lambda a, b, c: chain(jsm, a, b, c))(*ref).numpy(), np.float32)
    np.testing.assert_array_equal(lazy, fused)
    jax_lazy = np.asarray(chain(jsm, *ref).numpy(), np.float64)
    fx, fy, fz = (np.asarray(r.numpy(), np.float64) for r in ref)
    scale = np.abs((fx + fy) * fz) + np.abs(fx / (fy * fy + 1.0))
    assert np.all(np.abs(lazy - jax_lazy) <= 3 * 2.0 ** -7 * scale)


_U32_MORE = {
    "remainder": lambda m, x, y: x % y, "minimum": lambda m, x, y: m.minimum(x, y),
    "less_equal": lambda m, x, y: x <= y, "greater": lambda m, x, y: x > y,
    "greater_equal": lambda m, x, y: x >= y, "not_equal": lambda m, x, y: x != y,
    "abs": lambda m, x, y: m.abs(x), "sign": lambda m, x, y: m.sign(x),
    "square": lambda m, x, y: m.square(x), "weak_int": lambda m, x, y: x * 3 + 7,
    "bool": lambda m, x, y: x + (x > y), "float32": lambda m, x, y: x * m.Array(
        np.array([0.5, -1.0, 2.0, 3.0, 1.0, 0.0], np.float32)),
    "fused": lambda m, x, y: m.fuse(lambda a, b: m.where(a > b, a // b, a % b) - b)(x, y),
}


@pytest.mark.parametrize("name", sorted(_U32_MORE))
def test_uint32_opcodes_match_jax(name):
    """The unsigned opcodes (compare, max/min, sign, abs, floor division and
    remainder), the int32 ones uint32 shares, and the casts to float32 and
    from bool, on values above 2**31: the JAX package's, exactly."""
    a = np.array([1, 5, 4294967295, 70000, 2147483648, 0], np.uint32)
    b = np.array([3, 2, 2, 70000, 7, 4294967295], np.uint32)
    f = _U32_MORE[name]
    dispatch.reset()
    got = f(sm, sm.Array(a), sm.Array(b))
    want = f(jsm, jsm.Array(a), jsm.Array(b)).numpy()
    assert dtypes.name(got.dtype) == want.dtype.name
    np.testing.assert_array_equal(got.numpy(), want)
    assert not any(k.startswith("torch_path") for k in dispatch.counts())


def _both_modes(deferred, f):
    """``f()`` with the deferred queue of both packages on or off."""
    from simplemath_tpu.config import config as jconfig
    from simplemath_tpu_torch.config import config

    old = (config.deferred_eager, jconfig.deferred_eager)
    config.deferred_eager = jconfig.deferred_eager = deferred
    try:
        return f()
    finally:
        config.deferred_eager, jconfig.deferred_eager = old


_BOOL_A = np.array([True, False, True, False])
_BOOL_B = np.array([True, True, False, False])
_BOOL_OPS = {
    "abs": lambda m, x, y: m.abs(x),
    "square": lambda m, x, y: m.square(x),
    "floor_divide": lambda m, x, y: x // y,
    "remainder": lambda m, x, y: x % y,
}
# Operand patterns: two arrays, a broadcast column, a Python bool on either
# side, and the op inside sm.fuse.
_BOOL_PATTERNS = {
    "arrays": lambda m: (m.Array(_BOOL_A), m.Array(_BOOL_B)),
    "broadcast": lambda m: (m.Array(_BOOL_A), m.Array(_BOOL_B[:, None])),
    "scalar_right": lambda m: (m.Array(_BOOL_A), True),
    "scalar_left": lambda m: (True, m.Array(_BOOL_B)),
}


@pytest.mark.parametrize("deferred", [False, True])
@pytest.mark.parametrize("op,pattern", [
    (op, pattern) for op in sorted(_BOOL_OPS)
    for pattern in sorted(_BOOL_PATTERNS) + ["fused"]
    # a unary op reads its left operand alone
    if not (op in ("abs", "square") and pattern in ("scalar_left", "broadcast"))])
def test_bool_operands_of_integer_ops_match_jax(op, pattern, deferred):
    """abs of bool is the bool array; square, // and % of bools are int32,
    // and % with XLA's values at a False divisor ([T,F,T,F] // [T,T,F,F]
    is [1, 0, -2, -1]); eager, deferred and inside sm.fuse."""
    f = _BOOL_OPS[op]

    def run(m):
        if pattern == "fused":
            return m.fuse(lambda x, y: f(m, x, y))(_BOOL_A, _BOOL_B).numpy()
        return np.asarray(f(m, *_BOOL_PATTERNS[pattern](m)).numpy())

    got, want = _both_modes(deferred, lambda: (run(sm), run(jsm)))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_bool_floor_divide_values():
    got = (sm.Array(_BOOL_A) // sm.Array(_BOOL_B)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, [1, 0, -2, -1])
    np.testing.assert_array_equal((sm.Array(_BOOL_A) % sm.Array(_BOOL_B)).numpy(), [0, 0, 0, 0])
    np.testing.assert_array_equal(sm.abs(sm.Array(_BOOL_A)).numpy(), _BOOL_A)


_UNSIGNED_VS_INT = {
    "greater": lambda m, x, s: x > s,
    "greater_equal": lambda m, x, s: x >= s,
    "less": lambda m, x, s: x < s,
    "less_equal": lambda m, x, s: x <= s,
    "equal": lambda m, x, s: x == s,
    "not_equal": lambda m, x, s: x != s,
    "reversed_less": lambda m, x, s: s < x,
    "maximum": lambda m, x, s: m.maximum(x, s),
    "minimum": lambda m, x, s: m.minimum(x, s),
    "clip_low": lambda m, x, s: m.clip(x, s, 2),
    "clip_high": lambda m, x, s: m.clip(x, 1, s),
}


@pytest.mark.parametrize("scalar", [-1, -300, 2**40])
@pytest.mark.parametrize("dtype", ["uint8", "uint32"])
@pytest.mark.parametrize("op", sorted(_UNSIGNED_VS_INT))
def test_unsigned_against_out_of_range_int_matches_deferred_jax(op, dtype, scalar):
    """The JAX package's deferred queue (its default) carries a Python int
    in int32's range as an int32 operand: an unsigned array against -1 or
    -300 compares, takes its maximum, minimum and clip by value.  2**40
    lies outside int32 and wraps to the array's type there, as in jnp."""
    x = np.array([0, 1, 3, 7, 255], dtype)
    f = _UNSIGNED_VS_INT[op]
    got, want = _both_modes(True, lambda: (
        np.asarray(f(sm, sm.Array(x), scalar).numpy()),
        np.asarray(f(jsm, jsm.Array(x), scalar).numpy())))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_unsigned_against_negative_int_by_value():
    u = sm.array(np.array([0, 1, 3, 7], np.uint32))
    assert (u > -1).numpy().all()
    np.testing.assert_array_equal(sm.maximum(u, -1).numpy(), [0, 1, 3, 7])
    np.testing.assert_array_equal(sm.clip(u, -1, 2).numpy(), [0, 1, 2, 2])


@pytest.mark.parametrize("op", ["greater", "maximum", "clip_low"])
def test_eager_path_wraps_as_jnp_does(op):
    """The JAX package's eager path (deferred_eager=False) wraps -1 to the
    unsigned type, as plain jnp does, and so differs from its deferred
    queue; the port's eager path follows it."""
    x = np.array([0, 1, 3, 7], np.uint32)
    f = _UNSIGNED_VS_INT[op]
    got, want = _both_modes(False, lambda: (
        np.asarray(f(sm, sm.Array(x), -1).numpy()),
        np.asarray(f(jsm, jsm.Array(x), -1).numpy())))
    np.testing.assert_array_equal(got, want)
    import jax.numpy as jnp

    plain = {"greater": lambda: jnp.asarray(x) > -1,
             "maximum": lambda: jnp.maximum(jnp.asarray(x), -1),
             "clip_low": lambda: jnp.minimum(jnp.maximum(jnp.asarray(x), -1), 2)}[op]()
    np.testing.assert_array_equal(want, np.asarray(plain))
    deferred = _both_modes(True, lambda: np.asarray(f(jsm, jsm.Array(x), -1).numpy()))
    assert not np.array_equal(deferred, want)
