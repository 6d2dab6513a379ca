"""The port's closed-loop simulation (models/simulate.py) against the JAX
package.  Twins of tests/test_simulate.py:14-40.  The noise comes from a
``torch.Generator``, whose bits are not JAX's: the noise-free loop is held
to JAX's (states within ``rtol=1e-3, atol=1e-4``, as every tick feeds its
rounding into the next), the noisy one to the properties the JAX test
checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplemath_tpu_torch as sm
from simplemath_tpu import models as jm
from simplemath_tpu.models import simulate as jsim
from simplemath_tpu_torch.models import make_pendulum
from simplemath_tpu_torch.models.ilqr import ILQRConfig
from simplemath_tpu_torch.models.simulate import closed_loop


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    old = sm.config.device
    sm.configure(device="cpu")
    yield
    sm.configure(device=old)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _against_jax(result, x0, horizon, ticks, **kw):
    js = jm.make_pendulum()
    want = jax.jit(lambda x: jsim.closed_loop(js, x, horizon, ticks, **kw))(jnp.asarray(x0))
    for g, w in zip(result, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-3, atol=1e-4)


def test_closed_loop_stabilizes():
    x0 = np.array([np.pi - 0.3, 0.0], np.float32)
    result = closed_loop(make_pendulum(), torch.from_numpy(x0), horizon=20, ticks=30,
                         ilqr_config=ILQRConfig(iterations=2))
    assert result.xs.shape == (31, 2)
    assert result.us.shape == (30, 1)
    assert abs(float(result.xs[-1, 0]) - np.pi) < 0.3
    from simplemath_tpu.models.ilqr import ILQRConfig as JConfig

    _against_jax(result, x0, 20, 30, ilqr_config=JConfig(iterations=2))


def test_closed_loop_with_noise_and_bounds():
    system = make_pendulum()
    x0 = np.array([np.pi - 0.2, 0.0], np.float32)
    kw = dict(horizon=15, ticks=20, u_min=-4.0, u_max=4.0)
    noisy = closed_loop(system, torch.from_numpy(x0), noise_std=0.01,
                        generator=torch.Generator().manual_seed(1), **kw)
    assert float(torch.max(torch.abs(noisy.us))) <= 4.0 + 1e-6
    assert np.isfinite(_np(noisy.costs)).all()
    again = closed_loop(system, torch.from_numpy(x0), noise_std=0.01,
                        generator=torch.Generator().manual_seed(1), **kw)
    assert torch.equal(noisy.xs, again.xs)  # the generator fixes the noise
    quiet = closed_loop(system, torch.from_numpy(x0), **kw)
    assert not torch.equal(noisy.xs, quiet.xs)
    _against_jax(quiet, x0, **kw)
