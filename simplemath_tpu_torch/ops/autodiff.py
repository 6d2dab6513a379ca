"""``sm`` ops under ``torch.func`` transforms, on the kernels.

An sm op whose operand is a tensor under a ``torch.func`` transform
(``grad``, ``vjp``, ``jvp``, ``vmap``, ``jacrev``, ``jacfwd``,
``hessian``), or a tensor that requires grad (which a kernel would
otherwise detach), runs through one of three ``torch.autograd.Function``s:
``Elementwise`` over the lowered elementwise program, ``Reduce`` over a
sum/max/min of it, ``Product`` over a matmul with its epilogue.  Each
kernel family has one route to them: ``engine.run`` for the elementwise
kernel, ``reduction.run`` for the map-reduce kernel, ``matmul.matmul`` for
the matmul kernel.  Their forwards run what those routes run outside a
transform, on the unwrapped tensors: ``ew_flat`` or ``ew_strided``'s
generated kernel (``elementwise.elementwise``), ``rd_full`` or ``rd_axis``,
``mm`` or ``bmm``; CPU tensors take the kernels' plain versions, so the CPU
tests exercise the derivative rules the card runs.

Derivatives are programs on the same IR (ops/program.py), built per op by
``_rule`` and run through the same Functions: a backward or a tangent is
itself differentiable and batchable (forward-over-reverse, reverse over
reverse, nested ``vmap``), and stays on the kernels.

* ``backward``: for each operand that needs a gradient, one program of its
  cotangent, evaluated at the expression's shape; where the operand was
  broadcast, the result is summed over the broadcast dims with
  ``torch.sum``, which is how JAX transposes a broadcast (an XLA reduce,
  not a Pallas kernel).
* ``jvp``: one program, the sum over operands of d out/d operand times its
  tangent.
* ``vmap``: each batched operand's batch dim moved to the front, the same
  program run once at the batched shape (``out_dims=0``).  A full reduction
  under ``vmap`` reduces the rows of the (batch, elements) expression with
  ``rd_axis`` (a 1-D expression in the same pass); a product becomes one
  ``bmm`` over the batch.
* A product's derivatives are products (``g @ b^T``, ``a^T @ g``,
  ``t_a @ b + a @ t_b``, the sum in the second product's epilogue) and the
  epilogue's derivative programs over the recomputed accumulator.
* The elementwise kernel computes in no float16: the derivatives of a
  float16 reduction run on its operands widened to float32 by torch, and
  autograd casts the cotangent back.  An int32 sum (the integer 1-D dot)
  wraps mod 2**32 and carries no derivative.

The JAX package has no counterpart module: there an sm op on a tracer goes
through the same engine, and JAX derives derivatives and batching from the
traced operations (``pallas_call``'s own rules where an op reaches a Pallas
kernel).  The rules here are JAX's (``jax._src.lax``): ``maximum`` and
``minimum`` share the cotangent at ties, ``abs`` has derivative 1 at 0 and
``sqrt`` inf, ``pow``'s derivative in the exponent takes the log of the
base with 0 replaced by 1, a max/min reduction shares the cotangent among
the positions equal to its result, ``where`` passes it to the taken branch
alone (no NaN of the other branch leaks); comparisons, ``sign``, casts from
integers and integer ops carry none.  The derivatives of the crafted
transcendentals are written with the crafted functions (``exp`` -> ``exp``,
``sin`` -> ``cos``, ``tanh`` -> its result, ...); ``log``'s is ``1/x``,
where ``jax.grad`` of the JAX package's crafted ``log`` gives 0 (its
derivative dies in the bitcast that splits off the exponent).
"""

from __future__ import annotations

import functools
import math

import torch

from .. import dtypes as _dt
from ..array import Array
from . import dispatch, elementwise, matmul, program, reduction

_LN2 = math.log(2.0)


def transformed(x) -> bool:
    """Whether ``x`` (an Array, a tensor or a kernel operand) is a tensor
    under a ``torch.func`` transform, or one that requires grad where grad
    mode is on: an sm op on it runs through this module."""
    if isinstance(x, Array):
        if x._storage is None:  # a pending lazy expression: never transformed
            return False
        x = x._storage.buf
    if isinstance(x, elementwise.View):
        x = x.base
    if not isinstance(x, torch.Tensor):
        return False
    return bool(torch._C._functorch.is_functorch_wrapped_tensor(x)
                or (x.requires_grad and torch.is_grad_enabled()))


def takes(prog, shape) -> bool:
    """Whether the elementwise kernel takes ``prog`` over a ``shape``
    expression: its types have kernel opcodes, it reads and writes the
    kernel's types, and the expression is not empty.  A 0-d expression
    qualifies: under a transform its logical shape is not the one
    launched."""
    return (prog.kernel_codes is not None and math.prod(shape) > 0
            and elementwise.supported((1,), prog.leaf_dtypes, prog.dtype))


# ------------------------------------------------------------------ rules
def _regs(prog, shapes):
    """The register nodes of ``prog`` over operand leaves of ``shapes``."""
    regs = [program.leaf(s, dt) for s, dt in zip(shapes, prog.leaf_dtypes)]
    regs += [program.const(v, dt) for v, dt in prog.consts]
    for op, ctype, dtype, *src in prog.insts:
        args = [regs[r] for r in src if r >= 0]
        regs.append(program.Node(op, args, dtype, program.broadcast_all(*args), ctype=ctype))
    return regs


def _where(c, x, y):
    from . import fusion

    return fusion.ternary_node("where", c, x, y)


def _balanced_eq(x, ans, y):
    """JAX's share of a max/min cotangent for ``x``: 1 where ``x`` is the
    result, halved where ``y`` is too (constants of the result's type: weak
    ones alone would make a float64 program)."""
    one, two, zero = (program.const(v, ans.dtype) for v in (1.0, 2.0, 0.0))
    return _where(x == ans, one, zero) / _where(y == ans, two, one)


def _rule(n, k, t):
    """``t`` times the derivative of node ``n`` in its argument ``k`` (a
    node), or None where there is none.  Every rule is a product by a
    value of ``n``'s position, so the same rule pushes a tangent forward
    and pulls a cotangent back."""
    op, args = n.op, n.args
    x = args[0]
    y = args[1] if len(args) > 1 else None
    if op == "add":
        return t
    if op == "subtract":
        return t if k == 0 else -t
    if op == "multiply":
        return t * y if k == 0 else x * t
    if op == "divide":
        return t / y if k == 0 else (-t * x) * (1.0 / (y * y))
    if op in ("maximum", "minimum"):
        return t * _balanced_eq(args[k], n, args[1 - k])
    if op == "negative":
        return -t
    if op == "abs":
        return _where(x >= 0.0, t, -t)
    if op == "sqrt":
        return t * (0.5 / n)
    if op == "square":
        return t * (2.0 * x)
    if op == "exp":
        return t * n
    if op == "exp2":
        return t * (_LN2 * n)
    if op == "log":
        return t / x
    if op == "log2":
        return (t / x) / _LN2
    if op == "tanh":
        return (t + t * n) * (1.0 - n)
    if op == "sin":
        return t * program.apply("cos", x)
    if op == "cos":
        return -(t * program.apply("sin", x))
    if op == "tan":
        return t * (1.0 + n * n)
    if op == "pow":
        if k == 0:
            ym1 = y - 1.0
            return t * (y * program.Node("pow", (x, ym1), n.dtype,
                                         program.broadcast_all(x, ym1)))
        return t * (program.apply("log", _where(x == 0.0, 1.0, x)) * n)
    if op == "where":
        return None if k == 0 else (_where(x, t, 0.0) if k == 1 else _where(x, 0.0, t))
    return None  # sign, comparisons, integer ops


def _flows(n, k) -> bool:
    """Whether a derivative flows through argument ``k`` of node ``n``."""
    return n.dtype.is_floating_point and n.args[k].dtype.is_floating_point


def _push(n, k, t):
    """The tangent of ``n`` from the tangent ``t`` of its argument ``k``."""
    if n.op == "cast":
        return program.cast(t, n.dtype)
    return _rule(n, k, t)


def _pull(n, k, t):
    """The cotangent of argument ``k`` of ``n`` from ``n``'s cotangent."""
    if n.op == "cast":
        return program.cast(t, n.args[0].dtype)
    return _rule(n, k, t)


def _tangent(prog, regs, tangents):
    """The tangent node of ``prog``'s result, from ``tangents`` (register ->
    tangent node); None where none reaches it."""
    tan = dict(tangents)
    base = len(prog.leaf_dtypes) + len(prog.consts)
    for k, (_, _, _, *src) in enumerate(prog.insts):
        n = regs[base + k]
        acc = None
        for j, r in enumerate(s for s in src if s >= 0):
            if r in tan and _flows(n, j):
                c = _push(n, j, tan[r])
                if c is not None:
                    acc = c if acc is None else acc + c
        if acc is not None:
            tan[base + k] = acc
    return tan.get(prog.result)


def _cotangents(prog, regs, seed):
    """The cotangent node of each operand (None where none reaches it),
    from ``seed``, the result's cotangent."""
    n_ops = len(prog.leaf_dtypes)
    base = n_ops + len(prog.consts)
    adj = {prog.result: seed}
    for k in reversed(range(len(prog.insts))):
        a = adj.get(base + k)
        if a is None:
            continue
        n = regs[base + k]
        for j, r in enumerate(s for s in prog.insts[k][3:] if s >= 0):
            if (r < n_ops or r >= base) and _flows(n, j):
                c = _pull(n, j, a)
                if c is not None:
                    adj[r] = c if r not in adj else adj[r] + c
    return [adj.get(i) for i in range(n_ops)]


def _floats(prog, present=None):
    """The operand positions that carry a derivative (float, and with a
    tangent where ``present`` says which have one)."""
    return tuple(i for i, dt in enumerate(prog.leaf_dtypes)
                 if dt.is_floating_point and (present is None or present[i]))


@functools.lru_cache(maxsize=1024)
def tangent_program(prog, shapes, present):
    """``(program, tangent operands)``: the tangent of ``prog``'s result
    over (operands..., the tangents of the operands listed), or None where
    no tangent reaches the result."""
    regs = _regs(prog, shapes)
    which = _floats(prog, present)
    leaves = {i: program.leaf(shapes[i], prog.leaf_dtypes[i]) for i in which}
    root = _tangent(prog, regs, leaves)
    if root is None:
        return None
    return program.lower(program.cast(root, prog.dtype),
                         regs[:len(shapes)] + list(leaves.values())), which


@functools.lru_cache(maxsize=1024)
def cotangent_programs(prog, shapes, g_shape, g_dtype):
    """Per operand, the program of its cotangent over (operands..., g),
    ``g`` the result's cotangent (None where none reaches it)."""
    regs = _regs(prog, shapes)
    g = program.leaf(g_shape, g_dtype)
    leaves = regs[:len(shapes)] + [g]
    return tuple(None if a is None else program.lower(program.cast(a, prog.dtype), leaves)
                 for a in _cotangents(prog, regs, program.cast(g, prog.dtype)))


# ---------------------------------------------- max/min reductions (chooser)
@functools.lru_cache(maxsize=256)
def _chooser(prog, shapes, ans_shape):
    """(the register nodes, the ``ans`` leaf) of a max/min reduction's
    expression: what its derivative programs share."""
    regs = _regs(prog, shapes)
    return regs, program.leaf(ans_shape, torch.float32)


@functools.lru_cache(maxsize=256)
def indicator_program(prog, shapes, ans_shape):
    """1.0 where the expression equals the reduction's result ``ans``: the
    positions that share a max/min cotangent (summed, their count)."""
    regs, ans = _chooser(prog, shapes, ans_shape)
    root = program.cast(regs[prog.result] == ans, torch.float32)
    return program.lower(root, regs[:len(shapes)] + [ans])


@functools.lru_cache(maxsize=256)
def chooser_cotangent_programs(prog, shapes, ans_shape, g_shape):
    """Per operand, its cotangent under a max/min reduction over
    (operands..., ans, g / count): the reduction's cotangent shared among
    the positions equal to its result, JAX's chooser rule."""
    regs, ans = _chooser(prog, shapes, ans_shape)
    share = program.leaf(g_shape, torch.float32)
    seed = program.cast(_where(regs[prog.result] == ans, share, 0.0), prog.dtype)
    leaves = regs[:len(shapes)] + [ans, share]
    return tuple(None if a is None else program.lower(program.cast(a, prog.dtype), leaves)
                 for a in _cotangents(prog, regs, seed))


@functools.lru_cache(maxsize=256)
def chooser_tangent_program(prog, shapes, present, ans_shape):
    """The tangent of the expression where it equals ``ans``, 0 elsewhere,
    over (operands..., tangents..., ans); summed and divided by the count,
    the tangent of a max/min reduction."""
    regs, ans = _chooser(prog, shapes, ans_shape)
    which = _floats(prog, present)
    leaves = {i: program.leaf(shapes[i], prog.leaf_dtypes[i]) for i in which}
    t = _tangent(prog, regs, leaves)
    if t is None:
        return None
    root = _where(regs[prog.result] == ans, program.cast(t, torch.float32), 0.0)
    return program.lower(root, regs[:len(shapes)] + list(leaves.values()) + [ans]), which


# ------------------------------------------------------------- helpers
def _shapes(tensors) -> tuple:
    return tuple(tuple(t.shape) for t in tensors)


def _unbroadcast(t, shape):
    """``t`` summed over the dims where ``shape`` was broadcast to t's."""
    shape = tuple(shape)
    lead = t.ndim - len(shape)
    dims = tuple(range(lead)) + tuple(
        lead + d for d, s in enumerate(shape) if s == 1 and t.shape[lead + d] != 1)
    if dims:
        t = torch.sum(t, dims, keepdim=True)
    return t.reshape(shape) if lead or t.shape != shape else t


def _batched(t, dim, rank):
    """``t`` with its batch dim ``dim`` in front and size-1 dims after it,
    so that it broadcasts against (batch, *shape) of rank ``rank`` + 1; an
    unbatched ``t`` as it is (numpy broadcasting gives it the leading 1)."""
    if dim is None:
        return t
    t = torch.movedim(t, dim, 0)
    pad = rank - (t.ndim - 1)
    return t[(slice(None),) + (None,) * pad] if pad else t


def _as(t, dtype):
    return t if t.dtype == dtype else t.to(dtype)


def _zeros(shape, dtype, like):
    return torch.zeros(shape, dtype=dtype, device=like.device)


def _is_identity(prog) -> bool:
    return not prog.insts and prog.result < len(prog.leaf_dtypes)


# -------------------------------------------------------- the Functions
class Elementwise(torch.autograd.Function):
    """``prog`` over ``operands`` broadcast to ``shape``: the elementwise
    kernel, with derivative and batching rules."""

    @staticmethod
    def forward(prog, shape, name, *operands):
        return elementwise.elementwise(prog, shape, prog.dtype, *operands, name=name)

    @staticmethod
    def setup_context(ctx, inputs, output):
        prog, shape, name, *operands = inputs
        ctx.prog, ctx.shape, ctx.name = prog, shape, name
        ctx.save_for_backward(*operands)
        ctx.save_for_forward(*operands)

    @staticmethod
    def backward(ctx, g):
        operands = ctx.saved_tensors
        g = _as(g, ctx.prog.dtype)
        progs = cotangent_programs(ctx.prog, _shapes(operands), tuple(g.shape), g.dtype)
        grads = []
        for i, (o, p) in enumerate(zip(operands, progs)):
            if p is None or not ctx.needs_input_grad[3 + i]:
                grads.append(None)
                continue
            full = run(p, ctx.shape, "vjp", [*operands, g])
            grads.append(_unbroadcast(full, o.shape))
        return (None, None, None, *grads)

    @staticmethod
    def jvp(ctx, _prog, _shape, _name, *tangents):
        operands = ctx.saved_tensors
        present = tuple(t is not None for t in tangents)
        hit = tangent_program(ctx.prog, _shapes(operands), present)
        if hit is None:
            return _zeros(ctx.shape, ctx.prog.dtype, operands[0])
        prog_t, which = hit
        ts = [_as(tangents[i], operands[i].dtype) for i in which]
        return run(prog_t, ctx.shape, "jvp", [*operands, *ts])

    @staticmethod
    def vmap(info, in_dims, prog, shape, name, *operands):
        rank = len(shape)
        ops = [_batched(o, d, rank) for o, d in zip(operands, in_dims[3:])]
        return run(prog, (info.batch_size, *shape), name, ops), 0


class Reduce(torch.autograd.Function):
    """The sum/max/min (``kind``) of ``prog`` over ``operands`` broadcast to
    ``shape``, full (``axis`` None) or along axis 0 or 1 of a 2-D
    expression: the map-reduce kernel, a float32 result (an int32 one,
    wrapping, where ``int_acc``), with derivative and batching rules."""

    @staticmethod
    def forward(prog, kind, axis, shape, int_acc, *operands):
        return reduction.run(prog, kind, axis, shape, operands, int_acc)

    @staticmethod
    def setup_context(ctx, inputs, output):
        prog, kind, axis, shape, _, *operands = inputs
        ctx.prog, ctx.kind, ctx.axis, ctx.shape = prog, kind, axis, shape
        ctx.save_for_backward(*operands, output)
        ctx.save_for_forward(*operands, output)

    @staticmethod
    def _spread(ctx, t):
        """A reduction-shaped tensor broadcast over the expression."""
        return t if ctx.axis is None else t.unsqueeze(ctx.axis)

    @staticmethod
    def _count(ctx, prog, operands, ans):
        """How many positions equal the max/min, spread."""
        p = indicator_program(prog, _shapes(operands), tuple(ans.shape))
        return Reduce._spread(ctx, reduce(p, "sum", ctx.axis, ctx.shape, [*operands, ans]))

    @staticmethod
    def backward(ctx, g):
        *operands, ans = ctx.saved_tensors
        prog, wide = _widened(ctx.prog, operands)
        shapes = _shapes(wide)
        g = Reduce._spread(ctx, _as(g, torch.float32))
        if ctx.kind == "sum":
            progs = cotangent_programs(prog, shapes, tuple(g.shape), g.dtype)
            extra = [g]
        else:
            ans = Reduce._spread(ctx, ans)
            share = g / Reduce._count(ctx, prog, wide, ans)
            progs = chooser_cotangent_programs(prog, shapes, tuple(ans.shape),
                                               tuple(share.shape))
            extra = [ans, share]
        grads = []
        for i, (o, p) in enumerate(zip(operands, progs)):
            if p is None or not ctx.needs_input_grad[5 + i]:
                grads.append(None)
                continue
            full = run(p, ctx.shape, "vjp", [*wide, *extra])
            grads.append(_unbroadcast(full, o.shape))
        return (None, None, None, None, None, *grads)

    @staticmethod
    def jvp(ctx, _prog, _kind, _axis, _shape, _int_acc, *tangents):
        *operands, ans = ctx.saved_tensors
        prog, wide = _widened(ctx.prog, operands)
        shapes = _shapes(wide)
        present = tuple(t is not None for t in tangents)
        if ctx.kind == "sum":
            hit = tangent_program(prog, shapes, present)
        else:
            ans = Reduce._spread(ctx, ans)
            hit = chooser_tangent_program(prog, shapes, present, tuple(ans.shape))
        out_shape = () if ctx.axis is None else (ctx.shape[1 - ctx.axis],)
        if hit is None:
            return _zeros(out_shape, torch.float32, operands[0])
        prog_t, which = hit
        ts = [_as(tangents[i], wide[i].dtype) for i in which]
        if ctx.kind == "sum":
            return reduce(prog_t, "sum", ctx.axis, ctx.shape, [*wide, *ts])
        total = reduce(prog_t, "sum", ctx.axis, ctx.shape, [*wide, *ts, ans])
        count = Reduce._count(ctx, prog, wide, ans)
        return total / (count if ctx.axis is None else count.squeeze(ctx.axis))

    @staticmethod
    def vmap(info, in_dims, prog, kind, axis, shape, int_acc, *operands):
        batch, rank = info.batch_size, len(shape)
        ops = [_batched(o, d, rank) for o, d in zip(operands, in_dims[5:])]
        if axis is None and rank == 1:
            # The rows of the (batch, n) expression, in one rd_axis pass.
            return reduce(prog, kind, 1, (batch, *shape), ops, int_acc), 0
        full = (batch, *shape)
        if _is_identity(prog) and len(ops) == 1 and tuple(ops[0].shape) == full:
            mapped = ops[0]
        else:
            prog, ops = _widened(prog, ops)
            mapped = run(prog, full, "vmap", ops)
        if axis is None:
            rows = mapped.reshape(batch, -1)
        elif axis == 1:
            rows = mapped.reshape(batch * shape[0], shape[1])
        else:
            rows = mapped.transpose(1, 2).reshape(batch * shape[1], shape[0])
        out = reduce(reduction.identity(mapped.dtype), kind, 1, tuple(rows.shape), [rows],
                     int_acc)
        return out.reshape(batch, -1) if axis is not None else out, 0


def _widened(prog, operands):
    """``(prog, operands)`` with float16 operands widened to float32 by
    torch, the program reading them as float32: what derivative programs
    run on, as the elementwise kernel computes in no float16.  A program
    with kernel opcodes reads a float16 operand only as its result (no
    instruction takes a float16 register), so widening changes no value."""
    if torch.float16 not in prog.leaf_dtypes:
        return prog, list(operands)
    return _widen16(prog), [_as(o, torch.float32) if o.dtype == torch.float16 else o
                            for o in operands]


@functools.lru_cache(maxsize=64)
def _widen16(prog):
    """``prog`` with its float16 operands read as float32."""
    f32 = torch.float32
    regs = _regs(prog, [()] * len(prog.leaf_dtypes))
    leaves = [program.leaf((), f32) if dt == torch.float16 else regs[i]
              for i, dt in enumerate(prog.leaf_dtypes)]
    root = leaves[prog.result] if prog.result < len(leaves) else regs[prog.result]
    return program.lower(root, leaves)


# -------------------------------------------------------------- products
@functools.lru_cache(maxsize=1)
def _sum_epilogue():
    """The accumulator plus a float32 extra: how ``a @ t_b`` adds ``t_a @ b``."""
    acc, extra = program.leaf((), torch.float32), program.leaf((), torch.float32)
    return program.lower(program.apply("add", acc, extra), [acc, extra])


def _stack(t, dim, batch, lead):
    """``t`` with its batch dim ``dim`` (None: unbatched) in front, its
    leading dims broadcast to (``batch``, *``lead``) and merged into one:
    a (batch * prod(lead), rows, cols) operand of ``bmm``."""
    if dim is None:
        t = t.unsqueeze(0)
    else:
        t = torch.movedim(t, dim, 0)
    pad = 1 + len(lead) + 2 - t.ndim
    if pad:
        t = t.reshape(t.shape[:1] + (1,) * pad + t.shape[1:])
    t = t.expand(batch, *lead, *t.shape[-2:])
    return t.reshape(-1, *t.shape[-2:])


class Product(torch.autograd.Function):
    """``a @ b`` ((M, K) @ (K, N) or (B, M, K) @ (B, K, N)) through the
    matmul kernel, ``epilogue`` (None: the product alone) applied to the
    accumulator and ``extras`` at the store, stored as ``out_dtype`` (None:
    the kernel's choice): with derivative and batching rules.  An integer
    product carries no derivative."""

    @staticmethod
    def forward(epilogue, out_dtype, a, b, *extras):
        return matmul.matmul(a, b, out_dtype, epilogue=epilogue, extras=extras)

    @staticmethod
    def setup_context(ctx, inputs, output):
        epilogue, _, a, b, *extras = inputs
        ctx.epilogue, ctx.out_dtype = epilogue, output.dtype
        ctx.save_for_backward(a, b, *extras)
        ctx.save_for_forward(a, b, *extras)

    @staticmethod
    def _accumulator(a, b, extras):
        """The float32 accumulator, recomputed, and the extras as the
        epilogue reads them (a bfloat16 one widened)."""
        wide = [_as(e, torch.float32) if e.dtype == torch.bfloat16 else e for e in extras]
        return product(None, torch.float32, a, b), wide

    @staticmethod
    def backward(ctx, g):
        a, b, *extras = ctx.saved_tensors
        g = _as(g, torch.float32)
        g_extras = [None] * len(extras)
        if ctx.epilogue is None:
            g_acc = g
        else:
            acc, wide = Product._accumulator(a, b, extras)
            ops = [acc, *wide]
            progs = cotangent_programs(ctx.epilogue, _shapes(ops), tuple(g.shape), g.dtype)
            shape = tuple(acc.shape)
            g_acc = None if progs[0] is None else run(progs[0], shape, "vjp", [*ops, g])
            for i, (e, p) in enumerate(zip(extras, progs[1:])):
                if p is not None and ctx.needs_input_grad[4 + i]:
                    g_extras[i] = _unbroadcast(run(p, shape, "vjp", [*ops, g]), e.shape)
        g_a = g_b = None
        if g_acc is not None and ctx.needs_input_grad[2]:
            g_a = product(None, torch.float32, g_acc, b.transpose(-1, -2))
        if g_acc is not None and ctx.needs_input_grad[3]:
            g_b = product(None, torch.float32, a.transpose(-1, -2), g_acc)
        return (None, None, g_a, g_b, *g_extras)

    @staticmethod
    def jvp(ctx, _epilogue, _out_dtype, t_a, t_b, *t_extras):
        a, b, *extras = ctx.saved_tensors
        t_acc = None
        if t_a is not None:
            t_acc = product(None, torch.float32, _as(t_a, a.dtype), b)
        if t_b is not None:
            t_b = _as(t_b, b.dtype)
            t_acc = (product(None, torch.float32, a, t_b) if t_acc is None
                     else product(_sum_epilogue(), torch.float32, a, t_b, t_acc))
        if ctx.epilogue is None:
            return _as(t_acc, ctx.out_dtype)
        acc, wide = Product._accumulator(a, b, extras)
        ops = [acc, *wide]
        present = (t_acc is not None, *(t is not None for t in t_extras))
        hit = tangent_program(ctx.epilogue, _shapes(ops), present)
        if hit is None:
            return _zeros(tuple(acc.shape), ctx.out_dtype, a)
        prog_t, which = hit
        given = [t_acc, *(None if t is None else _as(t, torch.float32) for t in t_extras)]
        tan = run(prog_t, tuple(acc.shape), "jvp", [*ops, *(given[i] for i in which)])
        return _as(tan, ctx.out_dtype)

    @staticmethod
    def vmap(info, in_dims, epilogue, out_dtype, a, b, *extras):
        batch = info.batch_size
        d_a, d_b, *d_extras = in_dims[2:]
        a_shape = a.shape if d_a is None else a.shape[:d_a] + a.shape[d_a + 1:]
        b_shape = b.shape if d_b is None else b.shape[:d_b] + b.shape[d_b + 1:]
        out_shape = tuple(a_shape[:-1]) + (b_shape[-1],)
        lead = out_shape[:-2]
        stacked = [_stack(x, d, batch, lead) for x, d in zip((a, b, *extras), (d_a, d_b, *d_extras))]
        out = product(epilogue, out_dtype, *stacked)
        return out.reshape(batch, *out_shape), 0


# ---------------------------------------------------------------- entries
def run(prog, shape, name, tensors) -> torch.Tensor:
    """``prog`` over ``tensors`` broadcast to ``shape``, through
    ``Elementwise``.  The program must be one the kernels take, on the CPU
    too: a derivative rule that strays from the kernel's types fails here
    first."""
    elementwise.check_program(prog, name)
    dispatch.record("transform", name)
    return Elementwise.apply(prog, tuple(int(s) for s in shape), name, *tensors)


def reduce(prog, kind, axis, shape, tensors, int_acc=False) -> torch.Tensor:
    """The ``kind`` reduction of ``prog`` over ``tensors``, through
    ``Reduce`` (a float32 tensor; int32 where ``int_acc``)."""
    elementwise.check_program(prog, kind, _dt.KERNEL_DTYPES | reduction.FLOAT_INPUTS)
    dispatch.record("transform", f"reduce_{kind}")
    return Reduce.apply(prog, kind, axis, tuple(int(s) for s in shape), int_acc, *tensors)


def product(epilogue, out_dtype, a, b, *extras) -> torch.Tensor:
    """``a @ b`` with ``epilogue`` over ``extras``, through ``Product``."""
    dispatch.record("transform", "matmul")
    return Product.apply(epilogue, out_dtype, a, b, *extras)
