"""Compiled solver programs: the port's counterpart of ``jax.jit`` over a
``lax.scan`` for the solver entry points (``ilqr.solve_batched_jit``,
``MPCController.replan``, ``simulate.closed_loop``,
``rti.rti_closed_loop``, ``entry()``'s step).

The JAX package runs each of them as one device program per call.  Eager
torch dispatches every small op from Python, and on the card the host's
dispatch is most of the time (a cartpole Riccati step: 78 kernels, the card
busy about 15 % of the step).  Here each program is a CUDA graph
(``torch.cuda.CUDAGraph``), captured once per static arguments and replayed:

* :class:`Jit` runs a function of tensors as one graph: ``jax.jit(fn)``.
  A call copies its tensors into the entry's static inputs, replays, and
  returns clones of the outputs (JAX's results never alias, so a later
  call must not overwrite an earlier call's result).
* :class:`Scan` is ``lax.scan`` inside a jitted program.  The scan BODY (one
  iLQR iteration, one MPC tick) is captured once and replayed ``length``
  times, the carry in static tensors that the graph overwrites in place,
  so the graph's size and its capture time do not grow with the count.
  The per-step outputs go into preallocated slots, at the row a
  device-side step counter names (``index_copy_``), and the per-step
  inputs are read at that row (``index_select``): one replay a step and
  no launch from the host between replays.

An entry is keyed as JAX keys its traces: the static arguments (the system
object, the config dataclass, a horizon or tick count) and every tensor's
shape, dtype and device.  It lives as long as its owner, the first static
argument (the system), which the cache holds weakly: a dropped system
takes its graphs and their memory pools with it (a cartpole 8192 x H=100
iteration's pool is about 750 MB).  While the owner lives, each key keeps
its pool, as ``jax.jit`` keeps an executable a shape.  Entries whose first
static argument cannot be weakly referenced live as long as the program.

Before capture, one eager warm-up call on a side stream builds the kernel
library, compiles every NVRTC signature, fills the constant caches and
initialises the libraries' handles; capture then runs in
``capture_error_mode="global"``.  What a capture refuses raises
(:class:`CaptureError` from this package, CUDA's error otherwise): there
is no fallback to the eager path on the card.  A graph also addresses what
the port's caches handed out during its build, the constants of
``models.dynamics._constant`` and the modules of ``ops.codegen``'s
generated kernels; each cache reports them (:func:`hold`) and the graph
keeps them, so that a constant evicted from its cache stays allocated and
a module stays loaded while a graph that reads it lives.

A graph may hold NCCL collectives (``parallel/collectives.py``): the
sharded train step and the scenario-consensus step capture their ``psum``s,
``pmax``es and gathers with their kernels.  The first collective on a group
creates its communicator, so the warm-up call does that too, and the card
is synchronized before the capture so that no eager collective is still in
flight.  A gloo group copies card tensors through the host, which a graph
cannot hold: the compiled entry points refuse one before their warm-up.
A process that has captured collectives calls :func:`release` before
``torch.distributed.destroy_process_group()``: live graphs hold the
resources of the communicators whose kernels they captured.

On the CPU, or inside :func:`eager` (``jax.disable_jit``'s counterpart),
the same functions run the body loop eagerly: the same ops in the same
order, so the results have the captured program's bits.

Inside an export's trace (``models.scan.tracing()``, which
``utils.export`` enters) nothing is captured: a :class:`Jit` is its
function, traced, and a :class:`Scan` is one ``models.scan.scan`` over its
body, which the trace records as one ``scan`` node, as ``jax.export`` of a
``jax.jit`` that holds a ``lax.scan`` keeps the loop.
"""

from __future__ import annotations

import contextlib
import contextvars
import gc
import time
import weakref
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree

_EAGER: contextvars.ContextVar = contextvars.ContextVar("graphs_eager", default=False)
# True while this module captures a graph.  A capture in "global" mode is
# the whole process's business, so the flag is the process's, not a
# thread's: the autograd engine runs backward passes on its own threads.
_capturing = False
# While a graph is built (its warm-up and its capture): what the port's
# caches handed out to it, by id.  The process's, for the same reason.
_held: Optional[Dict[int, object]] = None
# Every Jit and Scan, for release().
_PROGRAMS: "weakref.WeakSet[_Program]" = weakref.WeakSet()


class CaptureError(RuntimeError):
    """Work that a CUDA graph cannot hold was asked for during capture: a
    constant's first copy to the card, an NVRTC compile, a value read on
    the host.  The warm-up call should have done it; the message names it."""


def capturing() -> bool:
    """True while a graph is captured: by this module, or on the current
    CUDA stream by anyone."""
    if _capturing:
        return True
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def building() -> bool:
    """True while this module builds a graph: its warm-up and its capture."""
    return _held is not None


def hold(obj) -> None:
    """Keep ``obj`` alive as long as the graph being built, if one is.  The
    port's caches call it with each device buffer or kernel pin they hand
    out, so that evicting it from the cache frees nothing a graph reads."""
    if _held is not None:
        _held[id(obj)] = obj


@contextlib.contextmanager
def eager():
    """Run the compiled entry points' body loops eagerly on every device,
    as ``jax.disable_jit()`` does: the reference a captured call is held to."""
    token = _EAGER.set(True)
    try:
        yield
    finally:
        _EAGER.reset(token)


def captures(device: torch.device) -> bool:
    """Whether a compiled entry point on ``device`` runs as a graph: on the
    card, unless inside :func:`eager`."""
    return device.type == "cuda" and not _EAGER.get()


def _exporting() -> bool:
    """Inside an export's trace (``models.scan.tracing()``): no capture."""
    from ..models.scan import in_tracing

    return in_tracing()


@contextlib.contextmanager
def _side_stream(device):
    """Run the block on a side stream ordered after the current stream's
    work, and order the current stream after the block."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        yield
    current.wait_stream(side)


def _reserved(device) -> int:
    return torch.cuda.memory_reserved(device) if device.type == "cuda" else 0


def _kernel_launches() -> Dict[str, int]:
    from ..ops import elementwise, linalg_small, matmul, reduction

    return {**elementwise.LAUNCHES, **reduction.LAUNCHES, **matmul.LAUNCHES,
            **linalg_small.LAUNCHES}


def _collectives() -> Dict[str, int]:
    from ..parallel import collectives

    return dict(collectives.COUNTS)


def _recorded(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def _device(tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"a compiled program takes tensors on one device, not {devices}")
    return devices.pop()


def _meta(tensors) -> Tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)


class Graph:
    """``fn()`` captured once on ``device``; :meth:`replay` runs its kernels
    again on the same memory.  ``fn`` reads and writes tensors it closes
    over; what it returns stays alive as ``outputs``, and what the port's
    caches handed out during the build as ``held`` (:func:`hold`).

    ``stats``: warm-up, capture and instantiation seconds, the memory the
    graph's pool reserved (MB), and the port's kernel launches and the
    collectives (``parallel.collectives.COUNTS``) that the capture
    recorded, which each replay repeats (both count in Python, at capture,
    never at replay)."""

    def __init__(self, fn: Callable, device: torch.device):
        global _held
        outer, _held = _held, {}
        try:
            self._build(fn, device)
        finally:
            self.held, _held = list(_held.values()), outer

    def _build(self, fn, device):
        global _capturing
        t0 = time.perf_counter()
        with _side_stream(device):
            fn()
        t1 = time.perf_counter()
        reserved, launches, collectives = _reserved(device), _kernel_launches(), _collectives()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        if device.type == "cuda":
            # No eager work, collectives above all, still in flight when
            # the capture begins.
            torch.cuda.synchronize(device)
        # An unreachable graph that the cycle collector frees during the
        # capture destroys its executable there, which global capture mode
        # refuses (it invalidates the capture): collect first, as
        # torch.cuda.graph does, and hold the collector off until the end.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        with _side_stream(device):
            _capturing = True
            try:
                self.graph.capture_begin(capture_error_mode="global")
                try:
                    self.outputs = fn()
                except BaseException:
                    # End the broken capture so that the stream is usable
                    # again; the error that broke it is the one raised.
                    with contextlib.suppress(RuntimeError):
                        self.graph.capture_end()
                    raise
                self.graph.capture_end()
            finally:
                _capturing = False
                if collecting:
                    gc.enable()
        t2 = time.perf_counter()
        self.graph.instantiate()
        t3 = time.perf_counter()
        self.stats = {
            "warmup_s": t1 - t0, "capture_s": t2 - t1, "instantiate_s": t3 - t2,
            "pool_mb": (_reserved(device) - reserved) / 2**20,
            "launches": _recorded(launches, _kernel_launches()),
            "collectives": _recorded(collectives, _collectives()),
        }

    def replay(self) -> None:
        self.graph.replay()


def release() -> int:
    """Free the graphs of every compiled program in the process and their
    memory pools; a later call builds its graph again.  Call it before
    ``torch.distributed.destroy_process_group()`` where graphs hold NCCL
    collectives (``parallel.make_sharded_train_step``,
    ``scenario_mpc_solve``): a graph keeps what its captured collectives
    use of their communicator, and four ranks over NCCL hung in the
    teardown while such graphs lived.  Waits for the card's work first.
    Returns the number of graphs freed."""
    entries = [e for p in list(_PROGRAMS) for e in p.cached()]
    for p in list(_PROGRAMS):
        p.entries.clear()
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    if cuda:
        torch.cuda.synchronize()
    for entry in entries:
        # Reset here, not when the last reference goes: a caller may still
        # hold an entry (an entry's graph is not replayed once released).
        entry.graph.graph.reset()
        entry.graph.held.clear()
    freed = len(entries)
    del entries
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return freed


def _clone(tree):
    return _pytree.tree_map_only(torch.Tensor, torch.clone, tree)


class _Program:
    """The cache that :class:`Jit` and :class:`Scan` share: ``entries`` maps
    each owner (the first static argument, held weakly; else the program
    itself) to its entries by key, and :meth:`cached` lists them all."""

    def __init__(self):
        self.entries = weakref.WeakKeyDictionary()
        _PROGRAMS.add(self)

    def cached(self) -> list:
        return [e for per in list(self.entries.values()) for e in per.values()]

    def _entry(self, static, key, build):
        first = static[0] if isinstance(static, tuple) and static else None
        try:
            weakref.ref(first)
            owner, key = first, (static[1:], key)
        except TypeError:
            owner, key = self, (static, key)
        entry = self.entries.get(owner, {}).get(key)
        if entry is None:
            entry = build()
            self.entries.setdefault(owner, {})[key] = entry
        return entry


class _JitEntry(NamedTuple):
    inputs: list
    graph: Graph


class Jit(_Program):
    """``jax.jit`` of ``fn(static, *tensors)`` with ``static`` hashable
    (JAX's static arguments).  ``fn`` is a function of its arguments and
    updates no state; an entry holds its static inputs and its graph."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def __call__(self, static, *tensors):
        device = _device(tensors)
        if _exporting() or not captures(device):
            return self.fn(static, *tensors)

        def build():
            inputs = [t.clone() for t in tensors]
            return _JitEntry(inputs, Graph(lambda: self.fn(static, *inputs), device))

        entry = self._entry(static, _meta(tensors), build)
        for s, t in zip(entry.inputs, tensors):
            s.copy_(t)
        entry.graph.replay()
        return _clone(entry.graph.outputs)


class _ScanEntry(NamedTuple):
    carry: list
    xs: list
    consts: list
    counter: torch.Tensor
    slots: list
    graph: Graph


class Scan(_Program):
    """``lax.scan`` of ``body(static, carry, x_t, consts) -> (carry, y)``:
    ``carry`` and ``y`` tuples of tensors, ``x_t`` the step's row of each
    of ``xs`` (tensors with ``length`` leading rows), ``consts`` tensors
    read by every step.  A call returns the final carry and each of ``y``
    stacked over the steps, as clones.  An entry holds its static tensors,
    slots and graph."""

    def __init__(self, body: Callable):
        super().__init__()
        self.body = body

    def __call__(self, static, carry, length: int, xs=(), consts=()):
        from ..models.scan import scan

        carry, xs, consts = tuple(carry), tuple(xs), tuple(consts)
        if length < 1:
            raise ValueError(f"a scan runs at least one step, not {length}")
        device = _device(carry + xs + consts)
        if _exporting() or not captures(device):
            # Eagerly the body loop; in an export's trace one scan node.
            return scan(lambda c, x, *k: self.body(static, c, x, k), carry, xs, length,
                        consts=consts)
        key = (length, len(carry), len(xs), _meta(carry + xs + consts))
        entry = self._entry(static, key,
                            lambda: self._build(static, carry, length, xs, consts, device))
        for s, t in zip(entry.carry + entry.xs + entry.consts, carry + xs + consts):
            s.copy_(t)
        entry.counter.zero_()
        for _ in range(length):
            entry.graph.replay()
        return _clone(tuple(entry.carry)), _clone(tuple(entry.slots))

    def _build(self, static, carry, length, xs, consts, device) -> _ScanEntry:
        s_carry = [t.clone() for t in carry]
        s_xs = [t.clone() for t in xs]
        s_consts = [t.clone() for t in consts]
        counter = torch.zeros((1,), dtype=torch.int64, device=device)
        slots = []

        def step():
            x_t = tuple(x.index_select(0, counter)[0] for x in s_xs)
            new, y = self.body(static, tuple(s_carry), x_t, tuple(s_consts))
            # A new carry that shares memory with the static carry is read
            # before the copies below overwrite it.
            storages = {s.untyped_storage().data_ptr() for s in s_carry}
            new = [n if n is s or n.untyped_storage().data_ptr() not in storages else n.clone()
                   for n, s in zip(new, s_carry)]
            if not slots:  # the warm-up call: the slots take y's shapes
                slots.extend(torch.empty((length,) + v.shape, dtype=v.dtype, device=device)
                             for v in y)
            for slot, v in zip(slots, y):
                slot.index_copy_(0, counter, v.unsqueeze(0))
            for s, n in zip(s_carry, new):
                if n is not s:
                    s.copy_(n)
            counter.add_(1)

        graph = Graph(step, device)
        return _ScanEntry(s_carry, s_xs, s_consts, counter, slots, graph)
