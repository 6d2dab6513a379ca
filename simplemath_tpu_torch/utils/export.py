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
* ``export_solver_step(system, config, batch, horizon)`` exports the
  batched iLQR solve as two programs, the initial rollout and one
  iteration, in one blob with the iteration count; ``load_step`` of it
  returns a :class:`ServedSolver`, which runs them as
  ``models.ilqr.solve_batched_jit`` runs its own: on the card the
  rollout as one CUDA graph and the iteration as another, captured at the
  first call per shapes and replayed ``iterations`` times
  (utils/graphs.py); on the CPU the same loop eagerly.

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
pointer of Tensor that doesn't have storage").  A ``models.scan.scan``
inside ``fn`` becomes one node of torch's ``scan`` operator over its body,
traced once (models/scan.py), as a ``lax.scan`` stays a loop in a JAX
export; a ``scan`` inside a traced body is a node of that body, so nested
loops stay nested.  Every loop that the JAX package writes as a
``lax.scan`` is one in the port: the solvers' horizon loops, the iLQR and
SQP iterations, the closed loops' ticks (``utils.graphs.Scan`` is a
``scan`` inside a trace, and a ``graphs.Jit`` its function, traced; no
CUDA graph is captured during an export).  Python loops over a static
count that the JAX package unrolls too are unrolled here: the loops over
the state and control dims of ``linearize_soa`` (a Jacobian's columns) and
``forward_linesearch_soa``, the levels of ``associative_scan``.
``sqp_mpc.scenario_mpc_solve`` reads each iteration's cost on the host and
does not export, in either package.

A real-tensor trace would fix a branch on a tensor's value (``.item()``,
``bool(x)``, ``if x.sum() > 0``) at the example's value, and the artifact
would then give wrong answers for inputs that take the other branch.  So
the trace raises ``DataDependentError`` at the first read of a tensor's
value on the host, as JAX's export raises on a tracer's conversion to a
Python value.
"""

from __future__ import annotations

import contextlib
import io
import json
import zipfile

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils._python_dispatch import TorchDispatchMode

from ..config import config
from . import graphs
from .precision import exact_float32

PLATFORMS = (None, ("cuda",), ("cpu",))
# The entry of an export_solver_step blob that holds its iteration count.
_SOLVER = "solver.json"


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


@contextlib.contextmanager
def _no_stack_traces():
    """No Python stack trace recorded on each node of the program: a third
    of ``torch.export``'s time on a solver's program on the CPU with torch
    2.13.  Torch 2.11 has no such switch, and records them."""
    cfg = getattr(torch.fx, "config", None)
    if not hasattr(cfg, "do_not_emit_stack_traces"):
        yield
        return
    old, cfg.do_not_emit_stack_traces = cfg.do_not_emit_stack_traces, True
    try:
        yield
    finally:
        cfg.do_not_emit_stack_traces = old


def export_program(fn, *example_args, platforms=None) -> torch.export.ExportedProgram:
    """``fn`` traced at the example arguments (tensors, or pytrees of
    them) as a ``torch.export.ExportedProgram``.  ``platforms`` (None,
    ``("cuda",)`` or ``("cpu",)``) only checks the example arguments'
    device: the artifact runs where it was traced.  Raises
    ``DataDependentError`` where ``fn`` reads a tensor's value on the
    host."""
    _device(platforms, example_args)

    from ..models.scan import tracing

    def guarded(*args):
        with _NoHostReads():
            return fn(*args)

    with _no_stack_traces():
        with tracing():
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
    """Deserialize an exported step.  An ``export_solver_step`` blob gives
    a :class:`ServedSolver`; any other artifact ``ExportedProgram.module()``,
    a callable that runs the recorded graph."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        src = io.BytesIO(bytes(path_or_bytes))
    else:
        src = path_or_bytes
    if zipfile.is_zipfile(src):
        with zipfile.ZipFile(src) as z:
            if _SOLVER in z.namelist():
                meta = json.loads(z.read(_SOLVER))
                init, iteration = (_scans_as_loops(torch.export.load(io.BytesIO(z.read(name))).module())
                                   for name in ("init.pt2", "iteration.pt2"))
                return ServedSolver(init, iteration, meta["iterations"])
    if isinstance(src, io.BytesIO):
        src.seek(0)
    return _scans_as_loops(torch.export.load(src).module())


def _scan_loop(body, init, xs, consts):
    """torch's ``scan`` operator as a loop that stacks each output once at
    the end, where the operator's own eager kernel writes each step's
    outputs into their rows (two kernels an output a step: a tenth of a
    served `sm` pendulum iteration's kernels).  The same values."""
    carry, ys = list(init), []
    for t in range(xs[0].shape[0]):
        out = body(*carry, *[x[t] for x in xs], *consts)
        carry = out[:len(init)]
        ys.append(out[len(init):])
    return (*carry, *(torch.stack(y) for y in zip(*ys)))


def _scans_as_loops(module):
    """A loaded program with its ``scan`` nodes run by :func:`_scan_loop`."""
    for m in module.modules():
        if not isinstance(m, torch.fx.GraphModule):
            continue
        nodes = [n for n in m.graph.nodes
                 if n.op == "call_function" and n.target is torch.ops.higher_order.scan]
        for node in nodes:
            node.target = _scan_loop
        if nodes:
            m.recompile()
    return module


def program_nodes(module) -> int:
    """Nodes of a loaded program's graph and of its ``scan`` bodies, at
    every level of nesting."""
    return sum(len(m.graph.nodes) for m in module.modules()
               if isinstance(m, torch.fx.GraphModule))


class ServedSolver:
    """A loaded ``export_solver_step`` artifact: ``step(x0s, us) -> (us,
    cost)`` with ``models.ilqr.solve_batched``'s bits.  ``init`` and
    ``iteration`` are the loaded programs; on the card the first call per
    shapes captures ``init`` as one CUDA graph and ``iteration`` as another
    (utils/graphs.py, entries held as long as this object), later calls
    replay them; on the CPU they run eagerly."""

    def __init__(self, init, iteration, iterations: int):
        self.init, self.iteration, self.iterations = init, iteration, iterations
        self.nodes = {"init": program_nodes(init), "iteration": program_nodes(iteration)}

    def __call__(self, x0s, us):
        with exact_float32():
            carry = _SERVED_INIT((self,), x0s, us)
            carry, _ = _SERVED_ITERATIONS((self,), carry, self.iterations)
        return carry[1], carry[2]


def _served_init(static, x0s, us):
    return tuple(static[0].init(x0s, us))


def _served_iteration(static, carry, x_t=(), consts=()):
    carry, y = static[0].iteration(*carry)
    return tuple(carry), tuple(y)


_SERVED_INIT = graphs.Jit(_served_init)
_SERVED_ITERATIONS = graphs.Scan(_served_iteration)


def export_solver_step(system, ilqr_config, batch: int, horizon: int,
                       path=None, platforms=None):
    """Export the batched iLQR solve step (the flagship serving artifact),
    ``step(x0_batch, us_batch) -> (us, cost)``, traced on ``platforms``'
    device (``config.device`` when None): the initial rollout and one
    iteration as two programs, their horizon loops ``scan`` nodes, so that
    neither grows with the horizon or the iteration count.  Returns bytes,
    or writes to ``path``."""
    from ..models.ilqr import _batched_init, _batched_iteration

    static = (system, ilqr_config)
    device = _device(platforms, ()) or torch.device(config.device)
    x0s = torch.zeros((batch, system.nx), dtype=torch.float32, device=device)
    us = torch.zeros((batch, horizon, system.nu), dtype=torch.float32, device=device)
    with exact_float32():
        carry = _batched_init(static, x0s, us)  # the iteration's example carry
        init = export_program(lambda x, u: _batched_init(static, x, u), x0s, us,
                              platforms=platforms)
        iteration = export_program(lambda *c: _batched_iteration(static, c), *carry,
                                   platforms=platforms)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for name, program in (("init.pt2", init), ("iteration.pt2", iteration)):
            part = io.BytesIO()
            torch.export.save(program, part)
            z.writestr(name, part.getvalue())
        z.writestr(_SOLVER, json.dumps({"iterations": ilqr_config.iterations}))
    if path is None:
        return buf.getvalue()
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    return None
