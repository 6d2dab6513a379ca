"""The port's horizon-sharded Riccati scan (``parallel/horizon.py``)
against the JAX package's and against the one-device associative and
sequential passes: twins of tests/test_horizon.py.

The JAX side builds each problem (a cartpole linearization, as
tests/test_horizon.py does) and runs its sharded pass on the 8 virtual CPU
devices; the port runs the same numpy inputs in gloo worlds
(tests/torch_world.py): one of 2 ranks, and one of 4 for the padding cases
(H = 37: 38 elements over 4 ranks; H = 21 on a (2 scenario x 2 horizon)
mesh: 22 over 2).

Tolerances: the JAX tests' own (rtol 2e-4, atol 2e-5; against the
sequential pass rtol 1e-3, atol 1e-4), against the port's one-device pass
as against the JAX package's passes: the blocked scan re-brackets the
combines, and on these linearizations the JAX package's own sharded pass
is up to 7e-6 beyond rtol 1e-5 + atol 1e-6 of its one-device pass.  The
multichip dryrun's problem (``__graft_entry__.dryrun_multichip``: the
cartpole at rest, 0.01 controls, H = 2 x ranks + 1) is held at its own
rtol 1e-5, atol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from simplemath_tpu.models import dynamics as dyn
from simplemath_tpu.models import ilqr
from simplemath_tpu.parallel import horizon
from simplemath_tpu.parallel.mesh import make_mesh

from torch_world import results, run_world

pytestmark = pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple (virtual) devices")

_NAMES = ("A", "B", "lx", "lu", "lxx", "luu", "lux", "Vx_T", "Vxx_T")

_SCRIPT = """
import torch
from simplemath_tpu_torch.models import ilqr
from simplemath_tpu_torch.parallel import horizon
from simplemath_tpu_torch.parallel.mesh import make_mesh

NAMES = ("A", "B", "lx", "lu", "lxx", "luu", "lux", "Vx_T", "Vxx_T")


def problem(tag):
    return [torch.from_numpy(INPUTS[f"{tag}_{n}"]) for n in NAMES]


for tag in [k[:-len("_reg")] for k in INPUTS if k.endswith("_reg")]:
    reg = torch.tensor(float(INPUTS[f"{tag}_reg"]))
    args = problem(tag)

    @part(tag)
    def _():
        if tag.startswith("batched"):
            mesh = make_mesh((2, WORLD // 2), ("scenario", "h"))
            ks, Ks = horizon.backward_associative_sharded_batched(
                mesh, "h", *args, reg, scenario_axis="scenario")
            ref = torch.func.vmap(lambda *a: ilqr.backward_associative(*a, reg))(*args)
            return {"ks": ks, "Ks": Ks, "ks_ref": ref[0], "Ks_ref": ref[1]}
        mesh = make_mesh((WORLD,), ("h",))
        ks, Ks, Vx, Vxx = horizon.backward_associative_sharded(
            mesh, "h", *args, reg, return_values=True)
        ref = ilqr.backward_associative(*args, reg, return_values=True)
        out = {"ks": ks, "Ks": Ks, "Vx": Vx, "Vxx": Vxx}
        out.update({k + "_ref": v for k, v in zip(("ks", "Ks", "Vx", "Vxx"), ref)})
        return out
"""


@jax.jit
def _linearized(x0, us):
    """tests/test_horizon.py's problem, jitted (eager it takes seconds)."""
    system = dyn.make_cartpole()
    xs = ilqr.rollout(system.step, x0, us)
    A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T = ilqr.linearize(system, xs, us)
    lxx, luu, lux, Vxx_T = ilqr.psd_cost_hessians(lxx, luu, lux, Vxx_T, "clamp_diag", 1e-6)
    return A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T


def _linearized_problem(H=37, seed=0):
    key = jax.random.PRNGKey(seed)
    x0 = 0.1 * jax.random.normal(key, (4,), jnp.float32)
    us = 0.05 * jax.random.normal(key, (H, 1), jnp.float32)
    return tuple(np.asarray(x) for x in _linearized(x0, us))


def _dryrun_problem(n):
    """``__graft_entry__.dryrun_multichip``'s: H = 2n + 1 forces padding."""
    us = 0.01 * jnp.ones((2 * n + 1, 1), jnp.float32)
    return tuple(np.asarray(x) for x in _linearized(jnp.zeros((4,), jnp.float32), us))


def _batched_problem():
    H, Bb = 21, 6
    keys = jax.random.split(jax.random.PRNGKey(7), Bb)
    probs = [_linearized_problem(H=H, seed=int(k[0]) % 1000) for k in keys]
    return tuple(np.stack([p[i] for p in probs]) for i in range(9))


_CASES = {  # tag: (world, problem, reg)
    "two_16": (2, lambda: _linearized_problem(H=16), 1e-6),
    "sequential_24": (2, lambda: _linearized_problem(H=24, seed=3), 1e-5),
    "padded_37": (4, lambda: _linearized_problem(H=37), 1e-6),
    "batched_21": (4, _batched_problem, 1e-6),
    "dryrun_2": (2, lambda: _dryrun_problem(2), 1e-6),
    "dryrun_4": (4, lambda: _dryrun_problem(4), 1e-6),
}


def _world(n):
    inputs = {}
    for tag, (world, make, reg) in _CASES.items():
        if world == n:
            inputs.update({f"{tag}_{k}": v for k, v in zip(_NAMES, make())})
            inputs[f"{tag}_reg"] = np.float32(reg)
    return inputs, run_world(n, _SCRIPT, inputs)


@pytest.fixture(scope="module")
def world2():
    return _world(2)


@pytest.fixture(scope="module")
def world4():
    return _world(4)


def _args(inputs, tag):
    return tuple(inputs[f"{tag}_{n}"] for n in _NAMES)


def _own(got, keys, rtol=2e-4, atol=2e-5):
    for k in keys:
        np.testing.assert_allclose(got[k], got[k + "_ref"], rtol=rtol, atol=atol, err_msg=k)


def _ranks_agree(ranks, tag):
    first = results(ranks, tag, 0)
    for r in range(1, len(ranks)):
        for k, v in results(ranks, tag, r).items():
            np.testing.assert_array_equal(v, first[k], err_msg=f"rank {r} {k}")
    return first


@pytest.mark.parametrize("world_name,tag,n_dev", [
    ("world2", "two_16", 2), ("world4", "padded_37", 8),
])
def test_sharded_backward_matches_single_device(request, world_name, tag, n_dev):
    inputs, ranks = request.getfixturevalue(world_name)
    got = _ranks_agree(ranks, tag)
    _own(got, ("ks", "Ks", "Vx", "Vxx"))
    args = _args(inputs, tag)
    reg = jnp.float32(_CASES[tag][2])
    want = jax.jit(functools.partial(ilqr.backward_associative, return_values=True))(*args, reg)
    mesh = make_mesh((n_dev,), ("h",), devices=jax.devices()[:n_dev])
    sharded = jax.jit(functools.partial(horizon.backward_associative_sharded, mesh, "h",
                                        return_values=True))(*args, reg)
    for k, w, s in zip(("ks", "Ks", "Vx", "Vxx"), want, sharded):
        np.testing.assert_allclose(got[k], np.asarray(w), rtol=2e-4, atol=2e-5, err_msg=k)
        np.testing.assert_allclose(got[k], np.asarray(s), rtol=2e-4, atol=2e-5, err_msg=k)


def test_sharded_backward_matches_sequential(world2):
    inputs, ranks = world2
    got = _ranks_agree(ranks, "sequential_24")
    _own(got, ("ks", "Ks"))
    ks_seq, Ks_seq = jax.jit(ilqr.backward_sequential)(*_args(inputs, "sequential_24"),
                                                       jnp.float32(1e-5))
    np.testing.assert_allclose(got["ks"], np.asarray(ks_seq), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got["Ks"], np.asarray(Ks_seq), rtol=1e-3, atol=1e-4)


def test_batched_2d_mesh_scenario_x_horizon(world4):
    """Scenario batch over one mesh axis, the horizon over the other (H+1 =
    22 over 2 time shards forces padding; Bb = 6 over 2)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    inputs, ranks = world4
    got = _ranks_agree(ranks, "batched_21")
    _own(got, ("ks", "Ks"))
    args = _args(inputs, "batched_21")
    reg = jnp.float32(1e-6)
    ks_ref, Ks_ref = jax.jit(jax.vmap(lambda *a: ilqr.backward_associative(*a, reg)))(*args)
    mesh = make_mesh((2, 4), ("scenario", "h"), devices=jax.devices()[:8])
    ks, Ks = jax.jit(functools.partial(horizon.backward_associative_sharded_batched, mesh, "h",
                                       scenario_axis="scenario"))(*args, reg)
    for g, w in ((got["ks"], ks_ref), (got["Ks"], Ks_ref), (got["ks"], ks), (got["Ks"], Ks)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("world_name,tag", [("world2", "dryrun_2"), ("world4", "dryrun_4")])
def test_dryrun_problem_matches_single_device(request, world_name, tag):
    """The multichip dryrun's horizon check (``__graft_entry__.py``):
    horizon-sharded gains equal to the one-device associative pass."""
    inputs, ranks = request.getfixturevalue(world_name)
    got = _ranks_agree(ranks, tag)
    _own(got, ("ks", "Ks"), rtol=1e-5, atol=1e-6)
    ks, Ks = jax.jit(ilqr.backward_associative)(*_args(inputs, tag), jnp.float32(1e-6))
    np.testing.assert_allclose(got["ks"], np.asarray(ks), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["Ks"], np.asarray(Ks), rtol=1e-5, atol=1e-6)
