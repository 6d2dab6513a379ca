"""Nested loops in the port's exported programs, on the CPU.

The JAX package writes every solver loop as a ``lax.scan``: the horizon
loops, the iLQR iterations of ``solve`` and ``solve_batched``, the inner
iLQR and outer SQP loops of ``solve_constrained``, the ticks of
``closed_loop`` and ``rti_closed_loop``; ``jax.export`` keeps each one a
loop, nested where they nest.  The port writes them as
``models.scan.scan``, and ``utils.graphs.Scan`` is one inside an export's
trace, so its programs do the same: each exported program has the same
nodes at two iteration, SQP or tick counts and gives the port's eager bits
at both, and the artifact at the second count, saved and loaded back,
gives the JAX package's own loaded export at the solver twins' tolerance:
costs ``rtol=1e-4``; every other array ``rtol=1e-3``, ``atol=1e-4`` times
its largest value (tests/test_torch_export_loops.py).  ``closed_loop``
runs at ``noise_std=0``: the two packages draw noise from different
generators.

The RTI tick's batched products take another path under a dispatch mode,
which rounds differently (tests/torch_standin.py), and a trace records
them under one: the loaded RTI loop is held to the eager loop run under a
pass-through mode, as the stand-in graph's tests hold the compiled one.

Sizes: the pendulum at H=8 (``solve``, ``closed_loop``), the cartpole at
batch 4, H=6 (``solve_batched``), the quadrotor at H=8
(``solve_constrained``, ``rti_closed_loop``) and the coupled quadrotor of
tests/test_torch_psd.py (``MPCController.plan``); 1 to 3 iterations and
ticks.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree

import simplemath_tpu.utils.export as jexport
import simplemath_tpu_torch as sm
import torch_standin
from simplemath_tpu import models as jm
from simplemath_tpu.models import ilqr as jilqr
from simplemath_tpu.models import rti as jrti
from simplemath_tpu.models import simulate as jsim
from simplemath_tpu.models import sqp_mpc as jsqp
from simplemath_tpu_torch import models as tm
from simplemath_tpu_torch.models import ilqr, rti, simulate, sqp_mpc
from simplemath_tpu_torch.models.scan import scan
from simplemath_tpu_torch.ops import library
from simplemath_tpu_torch.utils import export as smx
from simplemath_tpu_torch.utils import graphs
from test_torch_psd import coupled

BOX = (np.array([-5.0, -1.0, -1.0, -1.0], np.float32), np.array([5.0, 1.0, 1.0, 1.0], np.float32))


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    old = sm.config.device
    sm.configure(device="cpu")
    yield
    sm.configure(device=old)


def _rng_inputs(seed, *shapes, scale=0.1):
    rng = np.random.default_rng(seed)
    return tuple((scale * rng.standard_normal(s)).astype(np.float32) for s in shapes)


def _solve(n):
    """``ilqr.solve`` of the pendulum, ``n`` iterations."""
    x0, = _rng_inputs(1, (2,))
    us = np.zeros((8, 1), np.float32)
    return (lambda x, u: tuple(ilqr.solve(tm.make_pendulum(), x, u, ilqr.ILQRConfig(iterations=n))[:3]),
            lambda x, u: tuple(jilqr.solve(jm.make_pendulum(), x, u, jilqr.ILQRConfig(iterations=n))[:3]),
            (x0, us), ("xs", "us", "cost"))


def _solve_batched(n):
    """``ilqr.solve_batched`` of the cartpole, batch 4, H=6."""
    x0s, = _rng_inputs(2, (4, 4), scale=0.2)
    us = np.zeros((4, 6, 1), np.float32)
    cfg, jcfg = ilqr.ILQRConfig(iterations=n), jilqr.ILQRConfig(iterations=n)
    return (lambda x, u: tuple(ilqr.solve_batched(tm.make_cartpole(), x, u, cfg)[:3]),
            lambda x, u: tuple(jilqr.solve_batched(jm.make_cartpole(), x, u, jcfg)[:3]),
            (x0s, us), ("xs", "us", "cost"))


def _constrained(n):
    """``solve_constrained`` of the quadrotor, H=8, ``n`` SQP and ``n``
    inner iLQR iterations, a box on the controls."""
    x0, = _rng_inputs(3, (12,))
    us = np.zeros((8, 4), np.float32)
    cfg = sqp_mpc.SQPConfig(sqp_iterations=n, ilqr_iterations=n)
    jcfg = jsqp.SQPConfig(sqp_iterations=n, ilqr_iterations=n)
    return (lambda x, u, lo, hi: tuple(sqp_mpc.solve_constrained(
                tm.make_quadrotor(), x, u, lo, hi, cfg))[:4],
            lambda x, u, lo, hi: tuple(jsqp.solve_constrained(
                jm.make_quadrotor(), x, u, lo, hi, jcfg))[:4],
            (x0, us, *BOX), ("xs", "us", "cost", "us"))


def _replan(n):
    """``MPCController.plan`` of the coupled quadrotor (``psd="eigh"``),
    H=8, ``n`` iterations, the box clamped."""
    x0, = _rng_inputs(4, (12,))
    us = np.zeros((8, 4), np.float32)
    ctrl = sqp_mpc.MPCController(coupled(tm.make_quadrotor()), 8, *BOX, replan_iters=n)
    jctrl = jsqp.MPCController(coupled(jm.make_quadrotor()), 8, *BOX, replan_iters=n)
    return ctrl.plan, jctrl._replan, (x0, us), ("us", "us", "cost")


def _closed_loop(n):
    """``closed_loop`` of the pendulum, H=8, ``n`` ticks, no noise."""
    x0 = np.array([np.pi - 0.3, 0.0], np.float32)
    cfg, jcfg = ilqr.ILQRConfig(iterations=2), jilqr.ILQRConfig(iterations=2)
    return (lambda x: tuple(simulate.closed_loop(tm.make_pendulum(), x, 8, n, cfg)),
            lambda x: tuple(jsim.closed_loop(jm.make_pendulum(), x, 8, n, jcfg)),
            (x0,), ("xs", "us", "cost"))


def _rti(n):
    """``rti_closed_loop`` of the quadrotor, H=8, ``n`` ticks."""
    x0, = _rng_inputs(5, (12,))
    return (lambda x: tuple(rti.rti_closed_loop(tm.make_quadrotor(), x, 8, n)),
            lambda x: tuple(jrti.rti_closed_loop(jm.make_quadrotor(), x, 8, n)),
            (x0,), ("xs", "us", "cost", "us"))


# name -> (case maker, two counts, loop levels): the artifact at the
# second count is held to the JAX package's.  The levels: the iterations
# around the horizon loops; the SQP loop around the inner iLQR loop around
# those; the ticks around a solve; the RTI ticks, whose tick holds no loop
# (its Riccati and forward passes are associative scans).
CASES = {"solve": (_solve, (1, 3), 2), "solve_batched": (_solve_batched, (1, 2), 2),
         "solve_constrained": (_constrained, (1, 2), 3), "replan": (_replan, (1, 2), 2),
         "closed_loop": (_closed_loop, (1, 2), 3), "rti_closed_loop": (_rti, (1, 2), 1)}


def _torch(args):
    return tuple(torch.from_numpy(a) for a in args)


@pytest.fixture(scope="module")
def artifacts():
    """name -> count -> (the port's function, the program's nodes before
    serialization, the program).  The program at the second count is the
    artifact saved and loaded back; at the first, to spare a round trip of
    some 15 s, the exported program's module, its ``scan`` nodes run as
    ``load_step`` runs them."""
    old = sm.config.device
    sm.configure(device="cpu")
    try:
        out = {}
        for name, (case, counts, _) in CASES.items():
            for n in counts:
                fn, _, args, _ = case(n)
                program = smx.export_program(fn, *_torch(args))
                nodes = smx.program_nodes(program.module())
                if n == counts[-1]:
                    buf = io.BytesIO()
                    torch.export.save(program, buf)
                    loaded = smx.load_step(buf.getvalue())
                else:
                    loaded = smx._scans_as_loops(program.module())
                out.setdefault(name, {})[n] = fn, nodes, loaded
        return out
    finally:
        sm.configure(device=old)


def _leaves(tree):
    return _pytree.tree_leaves(tree)


def _same_bits(got, want):
    got, want = _leaves(got), _leaves(want)
    return len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))


def _scan_bodies(module, depth=0):
    """(depth, body) of every loop body of a loaded program, outermost
    first: its ``scan`` nodes run ``export._scan_loop`` over a submodule."""
    out = []
    for node in module.graph.nodes:
        if node.op == "call_function" and node.target is smx._scan_loop:
            body = getattr(module, node.args[0].target)
            out += [(depth + 1, body)] + _scan_bodies(body, depth + 1)
    return out


# ------------------------------------------------------- models.scan.scan

@pytest.mark.parametrize("reverse", [False, True])
def test_scan_without_xs_runs_length_steps_as_the_loop(reverse):
    """``scan(body, carry, None, length=n)``, the form of every iteration
    and tick loop, runs ``n`` steps with the Python loop's bits; a body
    may return None for ``y``, as ``lax.scan``'s may."""
    c0 = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32))

    def body(c, x):
        assert x is None
        return torch.tanh(c) * 1.1 + 0.3, c.sum(-1)

    got = scan(body, c0, None, length=4, reverse=reverse)
    c, ys = c0, []
    for _ in range(4):
        c, y = body(c, None)
        ys.append(y)
    want = (c, torch.stack(ys[::-1] if reverse else ys))
    assert _same_bits(got, want)
    carry, y = scan(lambda c, _: (c * 2.0, None), c0, None, length=3)
    assert y is None and torch.equal(carry, c0 * 8.0)
    with pytest.raises(ValueError):
        scan(body, c0, None)


def _inner(c, x, k):
    return torch.tanh(c) * 0.9 + x * k, c.sum(-1)


def _nested(levels, reverse):
    """A scan of ``levels`` levels; each outer step runs the next level
    over its row and sums what it stacked."""
    if levels == 1:
        return lambda c, xs, k: scan(_inner, c, xs, consts=(k,), reverse=reverse)
    below = _nested(levels - 1, reverse)

    def body(c, x, k):
        c, ys = below(c, x, k)
        return c * 1.01, ys.sum(0)

    return lambda c, xs, k: scan(body, c, xs, consts=(k,), reverse=reverse)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("mapped", [False, True])
@pytest.mark.parametrize("levels", [2, 3])
def test_nested_scans_export_as_nested_scan_nodes(levels, mapped, reverse):
    """A scan whose body holds a scan exports as nested ``scan`` nodes,
    one a level, under ``vmap`` too, whatever the lengths; the loaded
    program gives the Python loops' bits."""
    fn = _nested(levels, reverse)
    if mapped:
        fn = torch.vmap(fn, in_dims=(0, levels, None))
    nodes = []
    for n in (2, 5):
        shape = (n,) * levels + (3, 4)
        c, xs, k = _torch(_rng_inputs(n, (3, 4), shape, (4,), scale=1.0))
        if mapped:  # the mapped dim leads the carry and follows the steps in xs
            c, xs = torch.stack([c, -c]), torch.stack([xs, xs * 0.5], dim=levels)
        program = smx.load_step(smx.export_step(fn, c, xs, k))
        assert [d for d, _ in _scan_bodies(program)] == list(range(1, levels + 1))
        nodes.append(smx.program_nodes(program))
        assert _same_bits(program(c, xs, k), fn(c, xs, k))
    assert nodes[0] == nodes[1]


# ---------------------------------------------------------- the solvers

@pytest.mark.parametrize("name", list(CASES))
def test_solver_program_does_not_grow_with_its_loops(artifacts, name):
    """The artifact has the same nodes at both counts, and its loops are
    ``scan`` nodes nested as deep as the function's loops."""
    _, counts, levels = CASES[name]
    first, second = (artifacts[name][n] for n in counts)
    assert first[1] == second[1]
    assert max(d for d, _ in _scan_bodies(second[2])) == levels


@pytest.mark.parametrize("name,n", [(name, n) for name, (_, counts, _) in CASES.items()
                                    for n in counts])
def test_loaded_solver_program_has_the_eager_bits(artifacts, name, n):
    fn, _, program = artifacts[name][n]
    args = _torch(CASES[name][0](n)[2])
    got = program(*args)
    if name == "rti_closed_loop":
        with torch_standin._Passthrough():
            want = fn(*args)
    else:
        want = fn(*args)
    assert _same_bits(got, want)


@pytest.mark.parametrize("name", list(CASES))
def test_loaded_solver_program_against_the_jax_packages_export(artifacts, name):
    """The JAX package's ``export_step`` and ``load_step`` of the same
    function on the same numpy inputs, on the CPU."""
    case, counts, _ = CASES[name]
    n = counts[-1]
    _, jfn, args, kinds = case(n)
    got = [t.numpy() for t in _leaves(artifacts[name][n][2](*_torch(args)))]
    want = [np.asarray(w) for w in _leaves(
        jexport.load_step(jexport.export_step(jfn, *args))(*(jnp.asarray(a) for a in args)))]
    assert len(got) == len(want) == len(kinds)
    for g, w, kind in zip(got, want, kinds):
        assert g.shape == w.shape and np.isfinite(g).all()
        if kind == "cost":
            np.testing.assert_allclose(g, w, rtol=1e-4)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-4 * max(1.0, float(np.abs(w).max())))


def test_coupled_replan_projects_inside_its_iteration_loop(artifacts):
    """The coupled quadrotor's replan runs ``psd="eigh"``: its artifact
    holds ``sm::psd_project`` inside the iteration loop's body, around
    the horizon loops nested in it, and nowhere else."""
    program = artifacts["replan"][2][2]
    psd = torch.ops.sm.psd_project.default
    where = [d for d, body in _scan_bodies(program) if any(n.target is psd for n in body.graph.nodes)]
    assert where == [1]
    assert not any(n.target is psd for n in program.graph.nodes)


def test_sm_pendulum_solve_batched_runs_its_kernels_in_the_nested_body():
    """The ``sm``-written pendulum's whole ``solve_batched`` as one
    program: its ops are ``sm::ew_flat``/``sm::ew_strided`` nodes in the
    iteration loop's body and the horizon loops' bodies nested in it
    (``ew_flat`` in those too), and the loaded program has the eager
    bits."""
    system, cfg = tm.make_sm_pendulum(), ilqr.ILQRConfig(iterations=2)

    def fn(x, u):
        return tuple(ilqr.solve_batched(system, x, u, cfg)[:3])

    x0s, = _rng_inputs(9, (4, 2), scale=0.2)
    args = _torch((x0s, np.zeros((4, 6, 1), np.float32)))
    program = smx.load_step(smx.export_step(fn, *args))
    (iteration,) = [body for d, body in _scan_bodies(program) if d == 1 and _scan_bodies(body)]
    inner = {op for _, body in _scan_bodies(iteration) for op in library.sm_nodes(body.graph)}
    ops = set(library.sm_nodes(iteration.graph)) | inner
    assert {"sm.ew_flat.default", "sm.ew_strided.default"} <= ops, ops
    assert "sm.ew_flat.default" in inner, inner
    assert _same_bits(program(*args), fn(*args))


_JIT = graphs.Jit(lambda static, x: x * static[0] + 1.0)
_SCAN = graphs.Scan(lambda static, carry, x_t, consts: (
    (carry[0] * static[0] + x_t[0] * consts[0],), (carry[0].sum(),)))


def test_compiled_programs_capture_nothing_inside_an_export():
    """On the stand-in graph a ``graphs.Jit`` and a ``graphs.Scan`` called
    outside an export capture; inside one they capture nothing and cache
    nothing: the ``Jit`` is its function, traced, the ``Scan`` one
    ``scan`` node, and the loaded program has their bits."""
    x, xs, k = _torch(_rng_inputs(11, (3,), (4, 3), (3,), scale=1.0))

    def fn(x, xs, k):
        carry, (sums,) = _SCAN((0.5,), (_JIT((2.0,), x),), 4, xs=(xs,), consts=(k,))
        return carry[0], sums

    with torch_standin.installed((_JIT, _SCAN)) as standin:
        program = smx.load_step(smx.export_step(fn, x, xs, k))
        assert standin.captures == 0 and not _JIT.cached() and not _SCAN.cached()
        assert len(_scan_bodies(program)) == 1
        compiled = fn(x, xs, k)
        assert standin.captures == 2
    with graphs.eager():
        want = fn(x, xs, k)
    assert _same_bits(program(x, xs, k), want) and _same_bits(compiled, want)
