"""Ahead-of-time export / serving: solver steps as ``torch.export`` artifacts.

Counterpart of ``simplemath_tpu/utils/export.py``.  A serving process wants
a solve step traced once, serialized, and run without tracing or Python
model code.  This module wraps ``torch.export``:

* ``export_step(fn, *example_args)`` traces ``fn`` at the example
  arguments' shapes and dtypes and returns the bytes of
  ``torch.export.save``;
* ``save_step(path, fn, *example_args)`` / ``load_step(path_or_bytes)``
  round-trip it through disk; the loaded callable is
  ``ExportedProgram.module()``, and a call at other shapes raises;
* ``export_solver_step(system, config, batch, horizon)`` is the
  convenience wrapper for the batched iLQR solve.

The hand-written kernels appear in an artifact as ``sm::*`` ops
(ops/library.py): loading one needs ``import simplemath_tpu_torch``, which
registers them, and nothing of the model code.  An artifact runs on the
device it was exported on.

Tracing runs in two steps.  ``make_fx`` first runs ``fn`` once on the
example arguments (real tensors) and records the ATen and ``sm::*`` ops it
dispatches; the ``torch.func`` transforms the solvers use are recorded as
the ops they run.  ``torch.export`` then exports that graph.  Exporting
``fn`` directly fails in the solvers: ``torch.export`` runs the autograd
engine of ``torch.func.grad`` over fake tensors, and the backward of a
product with a Python scalar (``0.5 * cost`` in every cost function) reads
the scalar's storage, which a fake tensor has not ("Cannot access data
pointer of Tensor that doesn't have storage").  Python loops are unrolled:
the cartpole solve is a few hundred nodes a horizon step and iteration.

A real-tensor trace would fix a branch on a tensor's value (``.item()``,
``bool(x)``, ``if x.sum() > 0``) at the example's value, and the artifact
would then give wrong answers for inputs that take the other branch.  So
the trace raises ``DataDependentError`` at the first read of a tensor's
value on the host, as JAX's export raises on a tracer's conversion to a
Python value.
"""

from __future__ import annotations

import io

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils._python_dispatch import TorchDispatchMode

from ..config import config

PLATFORMS = (None, ("cuda",), ("cpu",))


class DataDependentError(RuntimeError):
    """The traced function read a tensor's value on the host."""


class _NoHostReads(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # The op of every host read: ``.item()``, ``bool(x)``, ``int(x)``.
        if func is torch.ops.aten._local_scalar_dense.default:
            raise DataDependentError(
                f"export: the function reads a tensor's value on the host ({func}); a "
                "branch on it would be fixed at the example's value")
        return func(*args, **(kwargs or {}))


class _Traced(torch.nn.Module):
    """A traced graph as the module ``torch.export`` takes."""

    def __init__(self, graph_module):
        super().__init__()
        self.graph_module = graph_module

    def forward(self, *args):
        return self.graph_module(*args)


def _device(platforms, example_args):
    key = tuple(platforms) if platforms is not None else None
    if key not in PLATFORMS:
        raise ValueError(f"platforms must be one of {PLATFORMS}, got {platforms!r}")
    if key is None:
        return None
    want = torch.device(key[0])
    for x in example_args:
        if isinstance(x, torch.Tensor) and x.device.type != want.type:
            raise ValueError(f"an example argument is on {x.device}, not {want.type}")
    return want


def export_program(fn, *example_args, platforms=None) -> torch.export.ExportedProgram:
    """``fn`` traced at the example arguments (tensors, or pytrees of
    them) as a ``torch.export.ExportedProgram``.  ``platforms`` (None,
    ``("cuda",)`` or ``("cpu",)``) only checks the example arguments'
    device: the artifact runs where it was traced.  Raises
    ``DataDependentError`` where ``fn`` reads a tensor's value on the
    host."""
    _device(platforms, example_args)

    def guarded(*args):
        with _NoHostReads():
            return fn(*args)

    graph_module = make_fx(guarded, tracing_mode="real")(*example_args)
    graph_module.graph.eliminate_dead_code()
    graph_module.recompile()
    program = torch.export.export(_Traced(graph_module), tuple(example_args), strict=False)
    # The artifact carries no example inputs (the 64M sum's would be 256 MB).
    program.example_inputs = None
    return program


def export_step(fn, *example_args, platforms=None) -> bytes:
    """Serialize ``fn`` traced at the example arguments' shapes and dtypes.
    Returns bytes."""
    buf = io.BytesIO()
    torch.export.save(export_program(fn, *example_args, platforms=platforms), buf)
    return buf.getvalue()


def save_step(path, fn, *example_args, platforms=None) -> None:
    blob = export_step(fn, *example_args, platforms=platforms)
    with open(path, "wb") as f:
        f.write(blob)


def load_step(path_or_bytes):
    """Deserialize an exported step; returns ``ExportedProgram.module()``,
    a callable that runs the recorded graph."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        src = io.BytesIO(bytes(path_or_bytes))
    else:
        src = path_or_bytes
    return torch.export.load(src).module()


def export_solver_step(system, ilqr_config, batch: int, horizon: int,
                       path=None, platforms=None):
    """Export the batched iLQR solve step (the flagship serving artifact):
    ``step(x0_batch, us_batch) -> (us, cost)``, traced on ``platforms``'
    device (``config.device`` when None).  Returns bytes, or writes to
    ``path``."""
    from ..models.ilqr import solve_batched

    def step(x0s, us):
        result = solve_batched(system, x0s, us, ilqr_config)
        return result.us, result.cost

    device = _device(platforms, ()) or torch.device(config.device)
    x0s = torch.zeros((batch, system.nx), dtype=torch.float32, device=device)
    us = torch.zeros((batch, horizon, system.nu), dtype=torch.float32, device=device)
    if path is not None:
        save_step(path, step, x0s, us, platforms=platforms)
        return None
    return export_step(step, x0s, us, platforms=platforms)
