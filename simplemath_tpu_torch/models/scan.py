"""Scans for the solvers: ``scan``, the counterpart of ``jax.lax.scan``,
and ``associative_scan``, that of ``jax.lax.associative_scan``.

``scan(body, carry, xs)`` runs ``body`` once a step, carrying ``carry``
and stacking what each step returns.  Eagerly it is a Python loop.  While
``utils.export`` traces (:func:`tracing`), it is one node of torch's
``scan`` operator over ``body`` traced once, so an exported program's size
does not grow with the number of steps, as a ``lax.scan`` in a JAX export
does not.

``associative_scan`` pairs elements as JAX's implementation does: combine
adjacent pairs, scan the half-size sequence recursively (the odd
positions), then fill the even positions from it.  With the same tree,
float32 results agree with the JAX package's up to rounding inside the
combine, not up to a different order of composition.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Sequence, Tuple

import torch
from torch.utils import _pytree

_TRACING: contextvars.ContextVar = contextvars.ContextVar("scan_tracing", default=False)


@contextlib.contextmanager
def tracing():
    """Inside: :func:`scan` under a ``make_fx`` trace records torch's
    ``scan`` operator over its body instead of unrolling its loop.
    ``utils.export`` enters it while it traces."""
    token = _TRACING.set(True)
    try:
        yield
    finally:
        _TRACING.reset(token)


def in_tracing() -> bool:
    """Whether the caller runs inside :func:`tracing`, in an export's
    trace."""
    return _TRACING.get()


def scan(body: Callable, carry, xs=None, length=None, *, consts=(), reverse=False):
    """``jax.lax.scan``: ``body(carry, x_t, *consts) -> (carry, y_t)`` for
    each row ``x_t`` of ``xs`` (a tensor or a pytree of tensors with the
    same leading length; None with ``length`` steps), last row first if
    ``reverse``.  Returns the final carry and the ``y_t`` stacked along a
    new dim 0 in the rows' order.

    ``body`` takes every tensor it reads that depends on the function's
    inputs as an argument (``carry``, ``xs`` or ``consts``), as
    ``graphs.Scan`` requires; constants of the model (``_constant``) may be
    closed over.  Traced, the body's tensors that are not arguments become
    inputs of the ``scan`` node."""
    xs_leaves, xs_spec = _flatten(xs)
    if length is None and not xs_leaves:
        raise ValueError("scan: without xs, give the number of steps as length")
    n = length if length is not None else xs_leaves[0].shape[0]
    if any(x.shape[0] != n for x in xs_leaves):
        raise ValueError(f"scan: every xs needs {n} rows, got {[tuple(x.shape) for x in xs_leaves]}")
    if n < 1:
        raise ValueError(f"scan: a scan runs at least one step, not {n}")
    if _TRACING.get():
        from torch.fx.experimental.proxy_tensor import get_proxy_mode

        if get_proxy_mode() is not None:
            return _traced(body, carry, xs_leaves, xs_spec, n, tuple(consts), reverse)
    return _loop(body, carry, xs_leaves, xs_spec, n, tuple(consts), reverse)


def _flatten(tree):
    """``tree``'s leaves and spec, where None has no leaf, as in
    ``lax.scan`` (torch's pytree counts None a leaf in some versions)."""
    return ([], None) if tree is None else _pytree.tree_flatten(tree)


def _unflatten(leaves, spec):
    return None if spec is None else _pytree.tree_unflatten(leaves, spec)


def _loop(body, carry, xs_leaves, xs_spec, n, consts, reverse):
    """The eager scan: a Python loop, each leaf of ``y`` stacked once."""
    ys = [None] * n
    for t in (reversed(range(n)) if reverse else range(n)):
        x_t = _unflatten([x[t] for x in xs_leaves], xs_spec)
        carry, ys[t] = body(carry, x_t, *consts)
    leaves = [_flatten(y)[0] for y in ys]
    spec = _flatten(ys[0])[1]
    return carry, _unflatten([torch.stack(v) for v in zip(*leaves)], spec)


def _traced(body, carry, xs_leaves, xs_spec, n, consts, reverse):
    """The scan under a ``make_fx`` trace, as torch's ``scan`` operator.
    Under ``vmap`` the batch dims are taken off, one level at a time, and
    the body is mapped inside the operator's body: the same batched ops a
    step as the eager loop under ``vmap``."""
    from torch._C._functorch import (
        TransformType, _add_batch_dim, _unwrap_batched, peek_interpreter_stack,
    )
    from torch._functorch.pyfunctorch import coerce_cinterpreter

    if peek_interpreter_stack() is None:
        return _emit(body, carry, xs_leaves, xs_spec, n, consts, reverse)
    interp = coerce_cinterpreter(peek_interpreter_stack())
    if interp.key() != TransformType.Vmap:
        raise NotImplementedError(f"scan: a traced scan under {interp.key()} is not supported")
    level, size = interp.level(), interp.batch_size()
    carry_leaves, carry_spec = _pytree.tree_flatten(carry)
    with interp.lower():
        low_carry = []
        for c in carry_leaves:
            v, b = _unwrap_batched(c, level)
            low_carry.append(v.movedim(b, 0) if b is not None else v.expand((size,) + v.shape))
        low_xs, x_dims = [], []
        for x in xs_leaves:
            v, b = _unwrap_batched(x, level)
            # A batched row's batch dim leads it: (n, size, ...).
            low_xs.append(v.movedim(b, 1) if b is not None else v)
            x_dims.append(0 if b is not None else None)
        low_consts, c_dims = zip(*(_unwrap_batched(c, level) for c in consts)) if consts else ((), ())
        mapped = torch.vmap(
            lambda c, x, *k: body(_pytree.tree_unflatten(c, carry_spec), _unflatten(x, xs_spec), *k),
            in_dims=(0, x_dims, *c_dims), randomness=interp.randomness())

        def low_body(c, x, *k):
            new, y = mapped(list(c), list(x or ()), *k)
            return tuple(_pytree.tree_flatten(new)[0]), y

        new, ys = _traced(low_body, tuple(low_carry), low_xs, _pytree.tree_flatten(low_xs)[1], n,
                          tuple(low_consts), reverse)
        # A stacked y has the steps before the batch dim.  The eager loop
        # stacks batched rows batch dim first, so it is laid out so here
        # too: a reduction over the steps then sums in the same order.
        y_leaves, y_spec = _flatten(ys)
        y_leaves = [y.movedim(1, 0).contiguous() for y in y_leaves]
    # The mapped body's outputs lead with the batch dim.
    new = [_add_batch_dim(t, 0, level) for t in new]
    ys = _unflatten([_add_batch_dim(t, 0, level) for t in y_leaves], y_spec)
    return _pytree.tree_unflatten(new, carry_spec), ys


def _emit(body, carry, xs_leaves, xs_spec, n, consts, reverse):
    """Record ``scan_op`` over ``body`` traced once with ``make_fx`` on
    real tensors.  The loop does not run: the values that flow on in the
    outer trace are the traced step's, its carry and each of its outputs
    repeated ``n`` times.  They have the loop's shapes, dtypes and strides,
    and nothing in an export's trace depends on a value (a host read raises,
    ``utils.export``), so the recorded program is the same; a nested scan
    runs one step a level, not the loops inside loops."""
    from torch._higher_order_ops.scan import scan_op
    from torch._higher_order_ops.utils import unique_graph_id
    from torch.fx.experimental.proxy_tensor import (
        disable_proxy_modes_tracing, get_proxy_mode, make_fx, track_tensor_tree,
    )

    tracer = get_proxy_mode().tracer
    carry_leaves, carry_spec = _pytree.tree_flatten(carry)
    # torch's scan holds the carry's strides fixed: it enters and leaves
    # each step contiguous.
    carry_leaves = [c.contiguous() for c in carry_leaves]
    has_xs = bool(xs_leaves)
    if not has_xs:  # torch's operator takes its length from an xs
        xs_leaves = [torch.zeros((n,), device=carry_leaves[0].device)]
    if reverse:
        xs_leaves = [torch.flip(x, [0]) for x in xs_leaves]
    n_carry, n_xs = len(carry_leaves), len(xs_leaves)
    step = []  # the traced step's outputs and the spec of its y

    def flat(*args):
        c = _pytree.tree_unflatten(list(args[:n_carry]), carry_spec)
        x = _unflatten(list(args[n_carry:n_carry + n_xs]) if has_xs else [], xs_spec)
        new, y = body(c, x, *args[n_carry + n_xs:])
        new_leaves, new_spec = _pytree.tree_flatten(new)
        if new_spec != carry_spec:
            raise ValueError(f"scan: the body returns a carry {new_spec}, not {carry_spec}")
        # torch's scan takes no output that aliases an input or another output.
        seen = {a.untyped_storage().data_ptr() for a in args}
        outs = []
        for o in [c.contiguous() for c in new_leaves] + _flatten(y)[0]:
            ptr = o.untyped_storage().data_ptr()
            outs.append(o.clone() if ptr in seen else o)
            seen.add(ptr)
        step[:] = [outs, _flatten(y)[1]]
        return outs

    with disable_proxy_modes_tracing():
        samples = [t.clone() for t in carry_leaves] + [x[0].clone() for x in xs_leaves]
        graph = make_fx(flat, tracing_mode="real")(*samples, *consts)
    consts = consts + _lift_constants(graph)
    _, name = unique_graph_id(get_proxy_mode(), prefix="scan_body")
    tracer.root.register_module(name, graph)
    args = (graph, list(carry_leaves), list(xs_leaves), list(consts))
    proxy = tracer.create_proxy("call_function", scan_op,
                                _pytree.tree_map(tracer.unwrap_proxy, args), {}, name="scan")
    outs, y_spec = step
    with disable_proxy_modes_tracing():
        # Stacked as the loop stacks them: contiguous, whatever n (an
        # expanded clone keeps a stride of 0 where n is 1).
        values = outs[:n_carry] + [y.repeat((n,) + (1,) * y.dim()) for y in outs[n_carry:]]
    out = track_tensor_tree(values, proxy, constant=None, tracer=tracer)
    new, ys = out[:n_carry], out[n_carry:]
    if reverse:
        ys = [torch.flip(y, [0]) for y in ys]
    return _pytree.tree_unflatten(list(new), carry_spec), _unflatten(list(ys), y_spec)


def _lift_constants(graph) -> tuple:
    """Turn the tensors that ``graph`` holds as attributes into inputs after
    its own, and return them: an exported program lifts the constants of
    its top graph, not those of a body of torch's ``scan``.  A tensor of
    the outer trace that the body closed over then becomes an input of the
    ``scan`` node, and the traced program keeps its dependence."""
    last = [n for n in graph.graph.nodes if n.op == "placeholder"][-1]
    lifted = {}  # attribute -> (its value, its placeholder)
    for node in list(graph.graph.nodes):
        if node.op != "get_attr" or not isinstance(getattr(graph, node.target, None), torch.Tensor):
            continue
        if node.target not in lifted:
            with graph.graph.inserting_after(last):
                last = graph.graph.placeholder(f"const_{len(lifted)}")
            lifted[node.target] = (getattr(graph, node.target), last)
        node.replace_all_uses_with(lifted[node.target][1])
        graph.graph.erase_node(node)
    for target in lifted:
        delattr(graph, target)
    graph.recompile()
    return tuple(value for value, _ in lifted.values())


def _interleave(a, b):
    """a[0], b[0], a[1], b[1], ... along dim 0; ``a`` is as long as ``b`` or
    one longer."""
    n = b.shape[0]
    pairs = torch.stack([a[:n], b], dim=1).reshape((2 * n,) + tuple(b.shape[1:]))
    return torch.cat([pairs, a[n:]]) if a.shape[0] > n else pairs


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Inclusive scan of the associative ``fn`` along dim 0.

    ``elems`` is a tuple of tensors with one length along dim 0; ``fn(a,
    b)`` takes and returns such tuples and combines them elementwise along
    dim 0.  ``out[k] = fn(...fn(fn(e[0], e[1]), e[2])..., e[k])``."""
    elems = tuple(elems)
    n = elems[0].shape[0]
    if any(e.shape[0] != n for e in elems):
        raise ValueError(
            "associative_scan: every input needs the same length along dim 0, "
            f"got {[tuple(e.shape) for e in elems]}"
        )
    if n < 2:
        return elems
    reduced = fn(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems))
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
    return tuple(_interleave(a, b) for a, b in zip(even, odd))
