"""The port's promotion table against ``jnp.result_type`` (x64 on, as
tests/conftest.py sets it), weak Python scalars included, and the port's
package rules: no jax imported, a dtype spec canonicalizes as in JAX."""

import itertools
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplemath_tpu_torch as sm
from simplemath_tpu_torch import dtypes

@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    old = sm.config.device
    sm.configure(device="cpu")
    yield
    sm.configure(device=old)


_ARRAY_DTYPES = [
    "bool", "uint8", "uint16", "uint32", "int8", "int16", "int32", "int64",
    "bfloat16", "float16", "float32", "float64", "complex64", "complex128",
]
_WEAK = [True, 2, 1.5, 1j]


def _jnp(x):
    return jnp.dtype(x) if isinstance(x, str) else x


def _port(x):
    return dtypes.canonicalize(x) if isinstance(x, str) else x


_PAIRS = list(itertools.combinations_with_replacement(_ARRAY_DTYPES, 2)) + [
    (d, w) for d in _ARRAY_DTYPES for w in _WEAK
] + list(itertools.combinations_with_replacement(_WEAK, 2))


@pytest.mark.parametrize("a,b", _PAIRS, ids=[f"{a!r}-{b!r}" for a, b in _PAIRS])
def test_result_dtype_matches_jnp(a, b):
    want = jnp.result_type(_jnp(a), _jnp(b))
    got = dtypes.result_dtype(_port(a), _port(b))
    assert dtypes.name(got) == jnp.dtype(want).name


@pytest.mark.parametrize("spec", [float, int, complex, bool, "float32", "int32",
                                  np.float64, np.int16, "bfloat16"])
def test_canonicalize_matches_jax_package(spec):
    from simplemath_tpu import dtypes as jd

    assert dtypes.name(dtypes.canonicalize(spec)) == jnp.dtype(jd.canonicalize(spec)).name


def test_numpy_scalars_are_strong():
    assert dtypes.result_dtype(torch.float32, np.float64(1.0)) == torch.float64
    assert dtypes.result_dtype(torch.float32, 1.0) == torch.float32
    assert jnp.result_type(jnp.float32, np.float64(1.0)) == jnp.float64


def test_port_imports_no_jax():
    """Importing the port loads no jax and nothing of the JAX package (run
    in a fresh interpreter; modules loaded before the import don't count)."""
    code = (
        "import sys; before = set(sys.modules)\n"
        "import simplemath_tpu_torch, simplemath_tpu_torch.ops.fusion\n"
        "import simplemath_tpu_torch.models, simplemath_tpu_torch.entry\n"
        "import simplemath_tpu_torch.ops.soa, simplemath_tpu_torch.ops.linalg_small\n"
        "import simplemath_tpu_torch.utils.precision\n"
        "from simplemath_tpu_torch.models import dynamics, ilqr, rti, scan, simulate, sqp_mpc\n"
        "new = set(sys.modules) - before\n"
        "bad = [m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'simplemath_tpu')]\n"
        "assert not bad, bad\n"
    )
    root = pathlib.Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)


def test_port_sources_never_name_jax():
    pkg = pathlib.Path(__file__).resolve().parent.parent / "simplemath_tpu_torch"
    for path in pkg.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "simplemath_tpu"), (path, line)
