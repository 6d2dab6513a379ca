"""Loops in the port's exported programs, on the CPU: ``models.scan.scan``
(the counterpart of ``jax.lax.scan``) and the served iLQR solve of
``utils.export.export_solver_step``.

Eagerly ``scan`` is a Python loop, bit for bit.  While ``utils.export``
traces, it is one node of torch's ``scan`` operator over its body, so the
solver's programs (the initial rollout and one iteration) have the same
nodes at every horizon and iteration count, as the JAX package's export
of ``lax.scan`` loops does.  The served step is held to the port's
``solve_batched`` bit for bit, and to the JAX package's own served step
(its ``export_solver_step`` and ``load_step``) at the solver twins'
tolerance: costs ``rtol=1e-4``; controls ``rtol=1e-3``, ``atol=1e-4`` times
the largest (tests/test_torch_utils.py).  The loaded iteration also runs
through ``graphs.Scan`` on the stand-in graph (tests/torch_standin.py):
the route it takes on the card.  Sizes: cartpole batch 4, H 5 and 12, 1
and 3 iterations; the ``sm``-written pendulum at batch 4, H=6, 2
iterations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplemath_tpu.utils.export as jexport
import simplemath_tpu_torch as sm
import torch_standin
from simplemath_tpu.models import ilqr as jilqr
from simplemath_tpu.models import make_cartpole as jax_cartpole
from simplemath_tpu_torch.models import ILQRConfig, make_cartpole, make_sm_pendulum
from simplemath_tpu_torch.models.ilqr import solve_batched
from simplemath_tpu_torch.models.scan import scan
from simplemath_tpu_torch.ops import library
from simplemath_tpu_torch.utils import export as smx

BATCH = 4
ARTIFACTS = {"h5_it1": (5, 1), "h12_it1": (12, 1), "h5_it3": (5, 3)}


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    old = sm.config.device
    sm.configure(device="cpu")
    yield
    sm.configure(device=old)


@pytest.fixture(scope="module")
def served():
    """The cartpole's served step at each of ``ARTIFACTS``' (horizon,
    iterations): name -> (blob, loaded step)."""
    old = sm.config.device
    sm.configure(device="cpu")
    try:
        out = {}
        for name, (horizon, iters) in ARTIFACTS.items():
            blob = smx.export_solver_step(make_cartpole(), ILQRConfig(iterations=iters),
                                          batch=BATCH, horizon=horizon)
            out[name] = blob, smx.load_step(blob)
        return out
    finally:
        sm.configure(device=old)


def _inputs(horizon, nx=4, seed=5):
    x0s = (0.2 * np.random.default_rng(seed).standard_normal((BATCH, nx))).astype(np.float32)
    return x0s, np.zeros((BATCH, horizon, 1), np.float32)


def _loop(body, carry, xs, reverse=False):
    ys = [None] * xs.shape[0]
    for t in (reversed(range(xs.shape[0])) if reverse else range(xs.shape[0])):
        carry, ys[t] = body(carry, xs[t])
    return carry, torch.stack(ys)


def _step(carry, x):
    a, b = carry
    a = torch.tanh(a) * 0.9 + x @ b
    return (a, b * 1.01), a.sum(-1)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_eagerly_is_the_python_loop(reverse):
    rng = np.random.default_rng(0)
    a, b, xs = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in ((3, 4), (4, 4), (7, 3, 4)))
    got = scan(_step, (a, b), xs, reverse=reverse)
    want = _loop(_step, (a, b), xs, reverse=reverse)
    for g, w in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(g, w)


def _scan_nodes(program):
    return [n for n in program.graph.nodes
            if n.op == "call_function" and n.target is torch.ops.higher_order.scan]


@pytest.mark.parametrize("reverse", [False, True])
def test_exported_scan_is_one_node_with_the_loops_bits(reverse):
    """An exported ``scan`` is one node whatever its length, under ``vmap``
    too, and the loaded program gives the Python loop's bits."""
    rng = np.random.default_rng(1)

    def fn(a, b, xs):
        return torch.vmap(lambda a, xs: scan(_step, (a, b), xs, reverse=reverse))(a, xs)

    nodes = []
    for n in (3, 9):
        a, b, xs = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                    for s in ((2, 3, 4), (4, 4), (2, n, 3, 4)))
        program = smx.export_program(fn, a, b, xs)
        assert len(_scan_nodes(program)) == 1
        nodes.append(len(program.graph.nodes))
        got = smx.load_step(smx.export_step(fn, a, b, xs))(a, b, xs)
        want = torch.vmap(lambda a, xs: _loop(_step, (a, b), xs, reverse=reverse))(a, xs)
        for g, w in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
            assert torch.equal(g, w)
    assert nodes[0] == nodes[1]


def test_a_host_read_inside_a_scanned_body_raises():
    def body(c, x):
        return (c + x if float(x.sum()) > 0 else c - x), c

    with pytest.raises(smx.DataDependentError):
        smx.export_program(lambda c, xs: scan(body, c, xs), torch.zeros(3), torch.ones(4, 3))


def test_solver_programs_do_not_grow_with_horizon_or_iterations(served):
    nodes = {name: step.nodes for name, (_, step) in served.items()}
    assert nodes["h5_it1"] == nodes["h12_it1"] == nodes["h5_it3"], nodes
    assert nodes["h5_it1"]["iteration"] < 10_000, nodes


@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_served_step_has_solve_batched_bits(served, name):
    horizon, iters = ARTIFACTS[name]
    _, step = served[name]
    x0s, us0 = (torch.from_numpy(a) for a in _inputs(horizon))
    us, cost = step(x0s, us0)
    ref = solve_batched(make_cartpole(), x0s, us0, ILQRConfig(iterations=iters))
    assert torch.equal(us, ref.us) and torch.equal(cost, ref.cost)


def test_served_step_against_the_jax_packages_served_step(served):
    """The JAX package's own export and load of the same solve, on the
    CPU, at the solver twins' tolerance."""
    horizon, iters = ARTIFACTS["h5_it3"]
    _, step = served["h5_it3"]
    x0s, us0 = _inputs(horizon)
    us, cost = step(torch.from_numpy(x0s), torch.from_numpy(us0))
    jrun = jexport.load_step(jexport.export_solver_step(
        jax_cartpole(), jilqr.ILQRConfig(iterations=iters), batch=BATCH, horizon=horizon))
    jus, jcost = (np.asarray(v) for v in jrun(jnp.asarray(x0s), jnp.asarray(us0)))
    np.testing.assert_allclose(cost.numpy(), jcost, rtol=1e-4)
    np.testing.assert_allclose(us.numpy(), jus, rtol=1e-3,
                               atol=1e-4 * max(1.0, float(np.abs(jus).max())))


def test_served_iteration_replays_through_graphs_scan(served):
    """On the stand-in graph the served step captures its rollout once
    and its iteration once, replays the iteration once an iteration, and
    gives the eager bits at its first call and at the next."""
    horizon, iters = ARTIFACTS["h5_it3"]
    _, step = served["h5_it3"]
    x0s, us0 = (torch.from_numpy(a) for a in _inputs(horizon, seed=8))
    with torch_standin.eager_reference():
        want = step(x0s, us0)
    programs = (smx._SERVED_INIT, smx._SERVED_ITERATIONS)
    with torch_standin.installed(programs) as standin:
        first = step(x0s, us0)
        again = step(x0s, us0)
        replays = [e.graph.graph.replays for p in programs for e in p.cached()]
        captures = standin.captures
    assert captures == 2 and replays == [2, 2 * iters]
    for got in (first, again):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_sm_pendulum_served_on_its_kernels():
    """The ``sm``-written pendulum (config 2 as the north star writes it)
    served: its ops are ``sm::*`` nodes inside the programs' loop bodies,
    and the served step has ``solve_batched``'s bits."""
    system, cfg = make_sm_pendulum(), ILQRConfig(iterations=2)
    step = smx.load_step(smx.export_solver_step(system, cfg, batch=BATCH, horizon=6))
    ops = {name: [n for m in program.modules() if isinstance(m, torch.fx.GraphModule)
                  for n in library.sm_nodes(m.graph)]
           for name, program in (("init", step.init), ("iteration", step.iteration))}
    assert ops["init"] and ops["iteration"], ops
    x0s, us0 = (torch.from_numpy(a) for a in _inputs(6, nx=2, seed=9))
    us, cost = step(x0s, us0)
    ref = solve_batched(system, x0s, us0, cfg)
    assert torch.equal(us, ref.us) and torch.equal(cost, ref.cost)
