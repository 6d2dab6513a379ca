"""A stand-in for ``torch.cuda.CUDAGraph`` on the CPU, for the tests of the
compiled entry points (utils/graphs.py): tests/test_torch_graphs.py, and
the ranks of tests/test_torch_parallel_compiled.py's worlds, which import
it from this directory.  It imports no jax.

The stand-in records the ATen ops that run between ``capture_begin`` and
``capture_end`` (a ``TorchDispatchMode``) and re-runs them at ``replay``
on the tensors they were recorded with, writing each result into the
tensor recorded as that op's output: what a CUDA graph does with its
kernels and their addresses.  A collective is an op of the dispatcher too
(``c10d.allreduce_``, ``c10d._allgather_base_``): a replay issues it again
and waits for it, as a graph's replay runs its NCCL kernels.  (gloo
finishes a ``reduce_scatter`` with copies out of a buffer of its own after
its op returns; the stand-in records those from the capture's buffer, so it
does not replay a gloo ``reduce_scatter``.  No compiled program uses one.)  Python is
not re-run, so a call that works under it keeps its state in the static
tensors as a graph needs; a read of a value on the host during capture
raises, as global capture mode refuses it: ``.item()`` and the like
(``aten._local_scalar_dense``) and the info check of ``torch.linalg``'s
solvers (``aten._linalg_check_errors``).
"""

import contextlib

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from simplemath_tpu_torch.utils import graphs

_HOST_READS = (torch.ops.aten._local_scalar_dense.default,
               torch.ops.aten._linalg_check_errors.default)


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _HOST_READS:
            raise RuntimeError(f"a value was read on the host during capture ({func})")
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


class StandInGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: records the ops of the capture
    and re-runs them on the same tensors at replay."""

    captures = 0
    fail_at_capture_end = False

    def __init__(self, keep_graph=False):
        self.ops = None
        self.instantiated = False
        self.replays = 0

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "global"
        self._mode = _Recorder()
        self._mode.__enter__()

    def capture_end(self):
        self._mode.__exit__(None, None, None)
        self.ops = self._mode.ops
        if StandInGraph.fail_at_capture_end:
            raise RuntimeError("stand-in capture failed")
        StandInGraph.captures += 1

    def instantiate(self):
        self.instantiated = True

    def reset(self):
        self.ops = None
        self.instantiated = False

    def replay(self):
        assert self.instantiated
        self.replays += 1
        with torch.no_grad():
            for func, args, kwargs, out in self.ops:
                new = func(*args, **kwargs)
                for o, n in zip(_pytree.tree_leaves(out), _pytree.tree_leaves(new)):
                    if isinstance(n, torch.ScriptObject):  # a collective's work
                        n.wait()
                    # In place (the op's own output) and views of recorded
                    # tensors hold their values already; zero tensors have
                    # no storage.
                    elif (isinstance(o, torch.Tensor) and o is not n and not o._is_zerotensor()
                          and o.untyped_storage().data_ptr() != n.untyped_storage().data_ptr()):
                        o.copy_(n)


def patches():
    """``(object, name, value)``: entry points on CPU tensors captured into
    the stand-in."""
    return [(torch.cuda, "CUDAGraph", StandInGraph),
            (graphs, "captures", lambda device: not graphs._EAGER.get()),
            (graphs, "_side_stream", lambda device: contextlib.nullcontext())]


@contextlib.contextmanager
def installed(programs=()):
    """The stand-in in place, outside pytest: ``programs``' caches are
    cleared on entry and on exit, and the capture count starts at 0."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches()]
    for obj, name, value in patches():
        setattr(obj, name, value)
    StandInGraph.captures = 0
    for p in programs:
        p.entries.clear()
    try:
        yield StandInGraph
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)
        for p in programs:
            p.entries.clear()


class _Passthrough(TorchDispatchMode):
    """Runs every op as it is.  Under a dispatch mode torch takes other
    paths for a few composite ops (the batched products of the RTI tick
    among them), which round differently; the stand-in records under one,
    so the eager reference runs under one too."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def eager_reference():
    with graphs.eager(), _Passthrough():
        yield
