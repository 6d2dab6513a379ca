"""``sm`` ops under ``torch.func`` transforms (ops/autodiff.py) against the
JAX package's sm ops under ``jax.grad``/``jax.jvp``/``jax.vmap``/
``jax.hessian``: the same ``sm`` function, written once over either
package's module, the same float32 numpy inputs from a seed.  On the CPU
the Functions' forwards run the kernels' plain versions, so what is held
here is the derivative rules the card runs.

The JAX package runs in its "native" transcendental mode here: ``jax.grad``
of its crafted ``log``/``log2`` is 0 (the derivative dies in the bitcast
that splits off the exponent), so the reference for a derivative rule is
jnp's.  The port keeps its crafted forwards; the two differ by a few ulps.

Tolerances: values and derivatives within ``rtol=2e-5, atol=1e-6`` (a few
float32 ulps: crafted against native transcendentals, and float32 sums in
another order); NaN and inf where JAX has them, at the same positions.
The sm pendulum solves: the tolerances of tests/test_models.py's sm-vs-native
test (costs ``rtol=1e-4``, controls ``rtol=1e-3, atol=1e-4``), the absolute
part scaled by the largest control as tests/test_torch_models.py scales it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplemath_tpu as jsm
import simplemath_tpu_torch as sm
from simplemath_tpu import models as jm
from simplemath_tpu.models import ilqr as jilqr
from simplemath_tpu_torch import models as tm
from simplemath_tpu_torch.models import ilqr as tilqr
from simplemath_tpu_torch.ops import dispatch

RTOL, ATOL = 2e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu_and_native_reference():
    from simplemath_tpu.config import config as jconfig

    old = (jconfig.transcendental_impl, sm.config.device)
    jconfig.transcendental_impl = "native"
    sm.configure(device="cpu")  # the port's default device is the card
    yield
    jconfig.transcendental_impl = old[0]
    sm.configure(device=old[1])


def _np(x):
    if isinstance(x, sm.Array):
        x = x.torch()
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(port), np.asarray(ref), rtol=rtol, atol=atol)


def _f32(*shape_or_values, seed=0, scale=1.0):
    if len(shape_or_values) == 1 and isinstance(shape_or_values[0], (list, tuple)):
        return np.asarray(shape_or_values[0], np.float32)
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape_or_values)).astype(np.float32)


def _port(fn):
    """``fn(module, *Arrays)`` as a function of tensors for torch.func."""
    def f(*ts):
        out = fn(sm, *(sm.Array(t) for t in ts))
        return out.torch() if isinstance(out, sm.Array) else out
    return f


def _ref(fn):
    """``fn(module, *Arrays)`` as a function of jax arrays for jax."""
    def f(*xs):
        out = fn(jsm, *(jsm.Array(x) for x in xs))
        return out.jax() if isinstance(out, jsm.Array) else out
    return f


def _grads(fn, *xs, argnums=0):
    """(port, reference) gradients of the scalar ``fn`` at ``xs``."""
    got = torch.func.grad(_port(fn), argnums)(*(torch.from_numpy(x.copy()) for x in xs))
    want = jax.grad(_ref(fn), argnums)(*(jnp.asarray(x) for x in xs))
    return got, want


def _hold_grads(fn, *xs, argnums=0):
    got, want = _grads(fn, *xs, argnums=argnums)
    if isinstance(argnums, tuple):
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


# ------------------------------------------------ one case per derivative rule
_EDGE = [0.0, -0.0, 0.5, -1.25, 2.0, 1e-3, -3.5, 1.0]
_POSITIVE = [0.0, 0.5, 1e-3, 2.0, 7.5, 1.0]

UNARY = {
    "abs": _EDGE, "sign": _EDGE, "sqrt": _EDGE, "square": _EDGE, "negative": _EDGE,
    "exp": _EDGE, "exp2": _EDGE, "log": _POSITIVE, "log2": _POSITIVE,
    "tanh": _EDGE + [0.49, 0.51, 30.0], "sin": _EDGE, "cos": _EDGE, "tan": [0.0, 0.5, -1.25, 1.5],
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_rule_at_edge_points(name):
    """abs at 0 (derivative 1), sign (0), sqrt at 0 (inf) and below (NaN),
    log at 0 (inf), tanh on both sides of its two branches: each as
    ``jax.grad`` gives it."""
    x = _f32(UNARY[name])
    _hold_grads(lambda m, a: m.sum(getattr(m, name)(a)), x)


_X = [0.0, 1.5, -2.0, 0.5, 2.0, -0.75]
_Y = [0.0, 1.5, 2.0, -0.5, 2.0, 0.25]

BINARY = {
    "add": lambda m, a, b: a + b,
    "subtract": lambda m, a, b: a - b,
    "multiply": lambda m, a, b: a * b,
    "divide": lambda m, a, b: a / (b + 3.0),
    "maximum": lambda m, a, b: m.maximum(a, b),      # ties at 0, 1.5, 2.0
    "minimum": lambda m, a, b: m.minimum(a, b),
}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_rule_both_arguments(name):
    """maximum and minimum share the cotangent at ties, as JAX does."""
    _hold_grads(lambda m, a, b: m.sum(BINARY[name](m, a, b)), _f32(_X), _f32(_Y), argnums=(0, 1))


POW = {
    "static_2.5": lambda m, a, b: m.pow(a, 2.5),     # 0 and a negative base
    "static_int_3": lambda m, a, b: a ** 3,          # the repeated-squaring ladder
    "static_int_-2": lambda m, a, b: (a + 4.0) ** -2,
    "base_2": lambda m, a, b: m.pow(2.0, a),         # the derivative in the exponent
    "both": lambda m, a, b: m.pow(a, b),
}


@pytest.mark.parametrize("name", sorted(POW))
def test_pow_rules(name):
    """pow's derivative in the base and in the exponent at base 0 and at
    negative bases (NaN where JAX has NaN), and the static integer ladder."""
    x = _f32([0.0, 0.0, 1.5, -2.0, -2.0, 0.5, 3.0])
    y = _f32([2.0, 3.0, 1.5, 3.0, 2.5, -1.0, 0.0])
    _hold_grads(lambda m, a, b: m.sum(POW[name](m, a, b)), x, y, argnums=(0, 1))


SELECT = {
    # The untaken branch's derivative is finite where x <= 0 (1/x), so JAX's
    # cotangent there is 0, and at x == 0 both give 0 * inf = NaN.
    "where_log": lambda m, a: m.where(a > 0.0, m.log(a), a * 3.0),
    "where_scalar": lambda m, a: m.where(a > 0.5, 1.0, 0.0) * a,
    "clip": lambda m, a: m.clip(a, -1.25, 1.5),       # ties at both bounds
    "compare": lambda m, a: (a > 0.0) * a + (a <= 0.0) * (a * a),
}


@pytest.mark.parametrize("name", sorted(SELECT))
def test_select_and_compare_rules(name):
    """where passes the cotangent to the taken branch alone; clip shares it
    at its bounds; comparisons and the bool->float cast carry none."""
    x = _f32([0.0, 1.5, -1.25, 0.5, 2.0, -3.0, 0.75])
    _hold_grads(lambda m, a: m.sum(SELECT[name](m, a)), x)


def test_integer_operands_carry_no_derivative():
    """An int32 operand is a constant of the derivative; int ops under vmap
    run the kernels' integer opcodes and equal jax.vmap's."""
    ints = np.array([3, -2, 0, 7], np.int32)
    x = _f32(4, seed=3)
    got = torch.func.grad(lambda t: (sm.Array(t) * sm.Array(ints)).sum().torch())(torch.from_numpy(x))
    _close(got, ints.astype(np.float32))
    batch = np.array([[7, -7, 0, 5], [-9, 4, 3, -1]], np.int32)
    want = jax.vmap(lambda a: jnp.stack([(jsm.Array(a) // 3).jax(), (jsm.Array(a) % -4).jax()]))(
        jnp.asarray(batch))
    got = torch.func.vmap(lambda a: torch.stack([(sm.Array(a) // 3).torch(), (sm.Array(a) % -4).torch()]))(
        torch.from_numpy(batch))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# --------------------------------------------------------------- transforms
def _program(m, x, y):
    """A vector-valued sm program with a broadcast operand (y of shape (4,))."""
    return m.tanh(x) * y + x * x / (m.exp(y * -1.0) + 1.0) - m.sin(x * y)


def _scalar(m, x, y):
    return m.sum(_program(m, x, y))


_XS, _YS = _f32(3, 4, seed=1), _f32(4, seed=2)


def test_grad_with_broadcast_operand():
    """grad in both arguments; y's cotangent summed over its broadcast dim."""
    _hold_grads(_scalar, _XS, _YS, argnums=(0, 1))


def test_vjp():
    ct = _f32(3, 4, seed=5)
    out, fn = torch.func.vjp(_port(_program), torch.from_numpy(_XS), torch.from_numpy(_YS))
    want_out, jfn = jax.vjp(_ref(_program), jnp.asarray(_XS), jnp.asarray(_YS))
    _close(out, want_out)
    for g, w in zip(fn(torch.from_numpy(ct)), jfn(jnp.asarray(ct))):
        _close(g, w)


def test_jvp_in_the_primal_dtype():
    """One tangent program for both arguments; the tangent stays float32."""
    tx, ty = _f32(3, 4, seed=6), _f32(4, seed=7)
    out, tan = torch.func.jvp(_port(_program), (torch.from_numpy(_XS), torch.from_numpy(_YS)),
                              (torch.from_numpy(tx), torch.from_numpy(ty)))
    want_out, want_tan = jax.jvp(_ref(_program), (jnp.asarray(_XS), jnp.asarray(_YS)),
                                 (jnp.asarray(tx), jnp.asarray(ty)))
    assert tan.dtype == torch.float32
    _close(out, want_out)
    _close(tan, want_tan)


def test_vmap_and_nested_vmap():
    xs = _f32(2, 5, 3, 4, seed=8)
    got = torch.func.vmap(torch.func.vmap(_port(_program), (0, None)), (0, None))(
        torch.from_numpy(xs), torch.from_numpy(_YS))
    want = jax.vmap(jax.vmap(_ref(_program), (0, None)), (0, None))(jnp.asarray(xs), jnp.asarray(_YS))
    _close(got, want)
    got = torch.func.vmap(_port(_program), (None, 0))(torch.from_numpy(_XS), torch.from_numpy(xs[0, :, 0]))
    want = jax.vmap(_ref(_program), (None, 0))(jnp.asarray(_XS), jnp.asarray(xs[0, :, 0]))
    _close(got, want)


def test_jacrev_and_hessian():
    """Reverse over reverse (jacrev of grad) and forward over reverse
    (torch.func.hessian is jacfwd of jacrev) against jax.hessian."""
    x = _f32(5, seed=9)

    def f(m, a):
        return m.sum(m.exp(a * 0.5) * m.cos(a) + a * a * a / (a * a + 1.0))

    want = jax.hessian(_ref(f))(jnp.asarray(x))
    _close(torch.func.jacrev(torch.func.grad(_port(f)))(torch.from_numpy(x)), want)
    _close(torch.func.hessian(_port(f))(torch.from_numpy(x)), want)
    _close(torch.func.jacrev(_port(lambda m, a: m.sin(a) * a))(torch.from_numpy(x)),
           jax.jacrev(_ref(lambda m, a: m.sin(a) * a))(jnp.asarray(x)))


def test_autograd_of_a_tensor_that_requires_grad():
    x = torch.from_numpy(_f32(6, seed=10)).requires_grad_()
    y = (sm.Array(x) * sm.Array(x) + 1.0).sum().torch()
    (g,) = torch.autograd.grad(y, x)
    _close(g, 2.0 * x.detach().numpy())


def test_view_of_a_transformed_array():
    """Indexing an Array whose buffer is a functorch wrapper: the view is
    passed to the Function materialized."""
    x = _f32(3, 4, seed=11)

    def f(m, a):
        return m.sum(a[1] * a[::-1][0] + a.T[:, 2] * 2.0)

    _hold_grads(f, x)
    got = torch.func.vmap(_port(lambda m, a: a[0] * a[1, ::-1]))(torch.from_numpy(x[None].repeat(2, 0)))
    _close(got, np.stack([x[0] * x[1, ::-1]] * 2))


# --------------------------------------------------------------- reductions
REDUCTIONS = {
    "sum": lambda m, a: m.sum(a),
    "mean": lambda m, a: m.mean(a),
    "max_ties": lambda m, a: m.max(m.minimum(a, 0.5)),     # every value above 0.5 ties
    "min": lambda m, a: m.min(a * a),
    "sum_axis0": lambda m, a: m.sum(m.sum(a, axis=0) * a[0]),
    "max_axis1": lambda m, a: m.sum(m.max(a, axis=1)),
    "mean_axis1_keepdims": lambda m, a: m.sum(m.mean(a, axis=1, keepdims=True) * a),
    "dot": lambda m, a: m.dot(a[0], a[1] * 2.0),
}


@pytest.mark.parametrize("name", sorted(REDUCTIONS))
def test_reduction_under_grad(name):
    """Gradients of full and axis reductions; max/min share the cotangent
    among positions equal to the result (JAX's chooser rule)."""
    x = _f32(4, 6, seed=12)
    x[1, 2] = x[3, 4] = x.max()
    _hold_grads(REDUCTIONS[name], x)


@pytest.mark.parametrize("name", sorted(REDUCTIONS))
def test_reduction_under_jvp_and_vmap(name):
    x, t = _f32(4, 6, seed=13), _f32(4, 6, seed=14)
    x[0, 0] = x[2, 5] = x.max()
    out, tan = torch.func.jvp(_port(REDUCTIONS[name]), (torch.from_numpy(x),), (torch.from_numpy(t),))
    want_out, want_tan = jax.jvp(_ref(REDUCTIONS[name]), (jnp.asarray(x),), (jnp.asarray(t),))
    _close(out, want_out)
    _close(tan, want_tan)
    xs = np.stack([x, t, x * 2.0])
    _close(torch.func.vmap(_port(REDUCTIONS[name]))(torch.from_numpy(xs)),
           jax.vmap(_ref(REDUCTIONS[name]))(jnp.asarray(xs)))


def test_bfloat16_fused_reduction_root_matches_jax():
    """A bfloat16 expression rooting sm.fuse runs the map-reduce kernel (its
    bfloat16 rounding steps, float32 accumulation), as the JAX package's
    pallas_map_reduce takes it: values, the grad and vmap against the JAX
    package within one bfloat16 ulp (2**-8 relative); no plain-torch
    route."""
    x, y = _f32(37, seed=29), _f32(5, 8, seed=30)
    root = sm.fuse(lambda a: sm.sum(a * a + a))
    jroot = jsm.fuse(lambda a: jsm.sum(a * a + a))
    axis = sm.fuse(lambda a: sm.max(sm.tanh(a) * 3.0, axis=1))
    jaxis = jsm.fuse(lambda a: jsm.max(jsm.tanh(a) * 3.0, axis=1))
    xt, xj = torch.from_numpy(x).bfloat16(), jnp.asarray(x).astype(jnp.bfloat16)
    dispatch.reset()
    got = root(xt)
    assert got.dtype == torch.bfloat16 and dispatch.counts() == {"reduce_fused:sum": 1}
    _close(got.torch().float(), jroot(xj).jax().astype(jnp.float32), 2.0 ** -8, 0.0)
    got = axis(torch.from_numpy(y).bfloat16())
    assert not any(k.startswith("torch_path") for k in dispatch.counts()), dispatch.counts()
    _close(got.torch().float(), jaxis(jnp.asarray(y).astype(jnp.bfloat16)).jax().astype(jnp.float32),
           2.0 ** -8, 0.0)
    g = torch.func.grad(lambda a: root(a).torch().float())(xt)
    _close(g.float(), jax.grad(lambda a: jroot(a).jax().astype(jnp.float32))(xj).astype(jnp.float32),
           2.0 ** -8, 0.0)
    xs = np.stack([x, -x])
    _close(torch.func.vmap(lambda a: root(a).torch())(torch.from_numpy(xs).bfloat16()).float(),
           jax.vmap(lambda a: jroot(a).jax())(jnp.asarray(xs).astype(jnp.bfloat16)).astype(jnp.float32),
           2.0 ** -8, 0.0)
    assert not any(k.startswith("torch_path") for k in dispatch.counts()), dispatch.counts()


def test_fused_reduction_root_under_grad_and_vmap():
    """sm.fuse's reduction root under a transform: one Reduce over the fused
    program (its derivative a program too)."""
    a, b = _f32(16, seed=15), _f32(16, seed=16)
    dist = sm.fuse(lambda x, y: sm.sum(sm.square(x - y)))
    dispatch.reset()
    g = torch.func.grad(lambda x: dist(x, torch.from_numpy(b)).torch())(torch.from_numpy(a))
    _close(g, 2.0 * (a - b))
    assert dispatch.count("transform", "reduce_sum") == 1
    v = torch.func.vmap(lambda x: dist(x, torch.from_numpy(b)).torch())(torch.from_numpy(np.stack([a, b])))
    _close(v, [((a - b) ** 2).sum(), 0.0], rtol=1e-5, atol=1e-5)


HALF = {"bfloat16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -8),
        "float16": (torch.float16, jnp.float16, 2.0 ** -10)}


@pytest.mark.parametrize("kind", ["sum", "max", "min", "mean"])
@pytest.mark.parametrize("half", sorted(HALF))
def test_half_precision_reduction_under_transforms(half, kind):
    """bfloat16 and float16 Array reductions (the kernel reads them and
    accumulates in float32) under grad, jvp and vmap: the derivative
    programs run in float32 (the elementwise kernel computes in no float16)
    and the cotangent comes back in the input's type.  Values within one
    ulp of the type (rtol 2**-8 for bfloat16, 2**-10 for float16: the
    float32 sum in another order, rounded once); derivatives exact."""
    t_dtype, j_dtype, ulp = HALF[half]
    x = _f32(37, seed=19)
    x[5] = x[30] = x.max()  # a tie for max
    t = _f32(37, seed=20)
    xt, tt = torch.from_numpy(x).to(t_dtype), torch.from_numpy(t).to(t_dtype)
    xj, tj = jnp.asarray(x).astype(j_dtype), jnp.asarray(t).astype(j_dtype)

    def port(a):
        return getattr(sm.Array(a), kind)().torch()

    def ref(a):
        return getattr(jsm.Array(a), kind)().jax()

    dispatch.reset()
    g = torch.func.grad(lambda a: port(a).float())(xt)
    assert g.dtype == t_dtype
    assert dispatch.count("transform", f"reduce_{'sum' if kind == 'mean' else kind}") > 0
    assert not any(k.startswith("torch_path") for k in dispatch.counts()), dispatch.counts()
    _close(g.float(), jax.grad(lambda a: ref(a).astype(jnp.float32))(xj).astype(jnp.float32), 0.0, 0.0)
    out, tan = torch.func.jvp(port, (xt,), (tt,))
    want_out, want_tan = jax.jvp(ref, (xj,), (tj,))
    assert out.dtype == tan.dtype == t_dtype
    _close(out.float(), want_out.astype(jnp.float32), ulp, 0.0)
    _close(tan.float(), want_tan.astype(jnp.float32), ulp, 0.0)
    xs = np.stack([x, t, -x])
    got = torch.func.vmap(port)(torch.from_numpy(xs).to(t_dtype))
    _close(got.float(), jax.vmap(ref)(jnp.asarray(xs).astype(j_dtype)).astype(jnp.float32), ulp, 0.0)


def test_integer_dot_under_vmap():
    """The int32 1-D dot under vmap and nested vmap: the wrapping sum of the
    rows of the batched a*b expression (rd_axis's int32 accumulator on the
    card), bit-equal to jax.vmap of the JAX package's dot."""
    rng = np.random.default_rng(21)
    a = rng.integers(-2**31, 2**31, (2, 3, 9), dtype=np.int64).astype(np.int32)
    b = rng.integers(-1000, 1000, 9).astype(np.int32)

    def port(x, y):
        return sm.dot(sm.Array(x), sm.Array(y)).torch()

    def ref(x, y):
        return jsm.dot(jsm.Array(x), jsm.Array(y)).jax()

    dispatch.reset()
    got = torch.func.vmap(port, (0, None))(torch.from_numpy(a[0]), torch.from_numpy(b))
    assert got.dtype == torch.int32 and dispatch.count("transform", "reduce_sum") == 2
    assert not any(k.startswith("torch_path") for k in dispatch.counts()), dispatch.counts()
    want = jax.vmap(ref, (0, None))(jnp.asarray(a[0]), jnp.asarray(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = torch.func.vmap(torch.func.vmap(port))(torch.from_numpy(a), torch.from_numpy(a[::-1].copy()))
    want = jax.vmap(jax.vmap(ref))(jnp.asarray(a), jnp.asarray(a[::-1]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


MATMUL_ROOTS = {
    "mm": ((5, 3), (3, 4), (1, 4)),
    "bmm": ((2, 5, 3), (2, 3, 4), (2, 1, 4)),
}


@pytest.mark.parametrize("rank", sorted(MATMUL_ROOTS))
def test_fused_matmul_root_under_transforms(rank):
    """sm.fuse's matmul root under grad, jvp, vmap and the hessian: the
    matmul kernel's Function (autodiff.Product), its epilogue's derivative
    programs on the elementwise kernel, against the JAX package's fused
    root differentiated by jax (its kernel_backend "xla" here: the product
    through jnp.matmul)."""
    from simplemath_tpu.config import config as jconfig

    old, jconfig.kernel_backend = jconfig.kernel_backend, "xla"
    try:
        shapes = MATMUL_ROOTS[rank]
        xs = [_f32(*s, seed=22 + i) for i, s in enumerate(shapes)]
        ts = [_f32(*s, seed=25 + i) for i, s in enumerate(shapes)]
        layer = sm.fuse(lambda x, w, b: sm.tanh(x @ w + b) * 2.0 - b)
        jlayer = jsm.fuse(lambda x, w, b: jsm.tanh(x @ w + b) * 2.0 - b)
        port = lambda *a: layer(*a).torch()  # noqa: E731
        ref = lambda *a: jlayer(*a).jax()  # noqa: E731
        tx = [torch.from_numpy(x) for x in xs]
        jx = [jnp.asarray(x) for x in xs]
        dispatch.reset()
        got = torch.func.grad(lambda *a: port(*a).sum(), (0, 1, 2))(*tx)
        assert dispatch.count("transform", "matmul") > 0
        assert not any(k.startswith("torch_path") for k in dispatch.counts()), dispatch.counts()
        want = jax.grad(lambda *a: ref(*a).sum(), (0, 1, 2))(*jx)
        for g, w in zip(got, want):
            _close(g, w)
        out, tan = torch.func.jvp(port, tuple(tx), tuple(torch.from_numpy(t) for t in ts))
        want_out, want_tan = jax.jvp(ref, tuple(jx), tuple(jnp.asarray(t) for t in ts))
        _close(out, want_out)
        _close(tan, want_tan)
        batch = np.stack([xs[0], ts[0], -xs[0]])
        _close(torch.func.vmap(port, (0, None, None))(torch.from_numpy(batch), tx[1], tx[2]),
               jax.vmap(ref, (0, None, None))(jnp.asarray(batch), jx[1], jx[2]))
        _close(torch.func.vmap(port, (None, 0, 0))(tx[0], *(torch.from_numpy(np.stack([x, -x]))
                                                             for x in xs[1:])),
               jax.vmap(ref, (None, 0, 0))(jx[0], *(jnp.asarray(np.stack([x, -x])) for x in xs[1:])))
        _close(torch.func.hessian(lambda x: port(x, tx[1], tx[2]).sum())(tx[0]),
               jax.hessian(lambda x: ref(x, jx[1], jx[2]).sum())(jx[0]), RTOL, 1e-5)
    finally:
        jconfig.kernel_backend = old


def test_integer_matmul_under_vmap():
    """An int32 product under vmap: the matmul kernel's int32 accumulator as
    one bmm over the batch, equal to numpy's product."""
    rng = np.random.default_rng(28)
    a = rng.integers(-50, 50, (3, 4, 5)).astype(np.int32)
    b = rng.integers(-50, 50, (5, 2)).astype(np.int32)
    dispatch.reset()
    got = torch.func.vmap(lambda x: sm.matmul(sm.Array(x), sm.Array(torch.from_numpy(b))).torch())(
        torch.from_numpy(a))
    assert dispatch.count("matmul", "bmm") == 1 and dispatch.count("transform", "matmul") == 2
    np.testing.assert_array_equal(got.numpy(), a @ b)


# ------------------------------------------------------------------ pytree
def test_pytree_round_trip():
    """Array is a pytree node, as in the JAX package: transforms take and
    return Arrays; a leaf is the materialized buffer, unflattening gives an
    identity view."""
    a = sm.Array(_f32(2, 3, seed=17))
    v = a.T  # a view flattens to its values
    leaves, spec = torch.utils._pytree.tree_flatten({"a": a, "v": v})
    assert len(leaves) == 2 and tuple(leaves[1].shape) == (3, 2)
    back = torch.utils._pytree.tree_unflatten(leaves, spec)
    assert isinstance(back["v"], sm.Array) and not back["v"].is_view
    _close(back["v"], _np(a).T)
    g = torch.func.grad(lambda x: (x * x).sum().torch())(a)
    assert isinstance(g, sm.Array)
    _close(g, 2.0 * _np(a))
    out = torch.func.vmap(lambda x: sm.exp(x) + 1.0)(a)
    assert isinstance(out, sm.Array)
    _close(out, np.exp(_np(a)) + 1.0)
    lazy = a * 2.0  # a pending expression flattens to its value
    assert torch.utils._pytree.tree_flatten(lazy)[0][0].shape == (2, 3)


# -------------------------------------------------- the sm pendulum solves
def _hold_solve(got, ref):
    """Costs within rtol 1e-4, controls within rtol 1e-3 and 1e-4 times
    the largest control (tests/test_torch_models.py::_hold: a control near
    zero inherits the rounding of the largest ones)."""
    want_us = np.asarray(_np(ref.us))
    _close(got.cost, np.asarray(_np(ref.cost)), 1e-4, 0.0)
    _close(got.us, want_us, 1e-3, 1e-4 * max(1.0, float(np.abs(want_us).max())))


def test_sm_pendulum_solve_batched_matches_native_and_jax():
    """The batch-polymorphic sm pendulum (models.make_sm_pendulum) through
    solve_batched, 8 x H=10: linearize_soa's jvp and forward-over-reverse
    and rollout_b's vmap run its sm ops through ops/autodiff.py, nothing as
    plain torch; the result matches the native pendulum's, of the port and
    of the JAX package."""
    rng = np.random.default_rng(18)
    x0 = (0.3 * rng.standard_normal((8, 2))).astype(np.float32)
    us = np.zeros((8, 10, 1), np.float32)
    cfg = dict(iterations=4)
    dispatch.reset()
    res_sm = tilqr.solve_batched(tm.make_sm_pendulum(), torch.from_numpy(x0), torch.from_numpy(us),
                                 tilqr.ILQRConfig(**cfg))
    counts = dispatch.counts()
    res_native = tilqr.solve_batched(tm.make_pendulum(), torch.from_numpy(x0), torch.from_numpy(us),
                                     tilqr.ILQRConfig(**cfg))
    res_jax = jax.jit(lambda a, b: jilqr.solve_batched(jm.make_pendulum(), a, b, jilqr.ILQRConfig(**cfg)))(
        jnp.asarray(x0), jnp.asarray(us))
    for op in ("sin", "multiply", "vjp", "jvp"):
        assert counts.get(f"transform:{op}", 0) > 0, op
    assert not any(k.startswith("torch_path") for k in counts), counts
    for ref in (res_native, res_jax):
        _hold_solve(res_sm, ref)


def test_sm_pendulum_solve_matches_native():
    """The same system through the single-trajectory solve (vmap of jacrev
    and of grad over the horizon, 0-d sm ops under the transforms)."""
    x0, us = torch.tensor([0.4, 0.0]), torch.zeros((15, 1))
    res_sm = tilqr.solve(tm.make_sm_pendulum(), x0, us, tilqr.ILQRConfig(iterations=5))
    res_native = tilqr.solve(tm.make_pendulum(), x0, us, tilqr.ILQRConfig(iterations=5))
    _hold_solve(res_sm, res_native)
