"""The kernels generated for ``ew_flat``'s programs and for the map-reduce
kernel's evaluator, on the CPU.

A program of more than one instruction on ``ew_flat`` runs a kernel that
ops/codegen.py writes for its signature (kind ``"flat"``): quads of four
elements, each full-size operand at the constant width of its type,
scalars and constants splatted once, the tail and unaligned operands
element by element in the same kernel.  The map-reduce kernel's launches
that would interpret a program run an evaluator generated for the
program, the reduction and the walk (kind ``"reduce"``).  Held here: the
flat kernels' sources and signatures (the evaluators' are
tests/test_torch_codegen.py's), every opcode by name in both kinds, the
routes that ``elementwise.flat_path`` and ``reduction.path`` choose, that
the CPU never generates, and the port's plain versions of the slice's programs against
the JAX package's Pallas kernels (``_build_call_1d``,
``_build_map_reduce_1d/_2d``, ``_build_reduce_axis``) in interpret mode, as
the JAX package's own tests run them, on the same numpy inputs from a seed.
The generated kernels run, against the interpreters bit for bit, on the
card (tests/test_torch_kernel_cuda.py).

Tolerances: float32 elementwise results within 8 ulp of the JAX package's
(both round each operation once; the crafted transcendentals may differ);
sums within 2e-5 * sum|x| (both accumulate in float32, in other orders);
bfloat16 results within one bfloat16 ulp.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import simplemath_tpu_torch as sm
from simplemath_tpu.config import config as jconfig
from simplemath_tpu.ops import dispatch as jdispatch
from simplemath_tpu_torch.config import config
from simplemath_tpu_torch.ops import codegen, dispatch, elementwise, program, reduction, registry


@pytest.fixture(autouse=True)
def _reference_setup():
    old = (jconfig.kernel_backend, jconfig.transcendental_impl, config.device)
    jconfig.kernel_backend = "pallas"
    jconfig.transcendental_impl = "crafted"
    config.device = "cpu"  # the port's default device is the card
    dispatch.reset()
    jdispatch.reset()
    yield
    jconfig.kernel_backend, jconfig.transcendental_impl, config.device = old


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def _lowered(fn, *operands):
    leaves = [program.leaf(tuple(o.shape), o.dtype) for o in operands]
    return program.lower(fn(*leaves), leaves)


def _flat_sig(fn, *operands, iterations=1, carry=0):
    prog = _lowered(fn, *operands)
    shape = max((tuple(o.shape) for o in operands), key=len)
    return prog, elementwise.signature(prog, prog.kernel_codes, shape, list(operands),
                                       iterations, carry, flat=True)


# ------------------------------------------------- the flat kernel's source
def test_flat_source_of_the_chain():
    """The 16M chain's kernel: three 16-byte loads a quad, the three
    instructions on the four lanes by name, one 16-byte store; the tail
    element by element; no register file."""
    n = 1001
    _, sig = _flat_sig(lambda a, b, c: a * b + c - a, _t(n), _t(n), _t(n))
    src = codegen.source(sig)
    assert "SM_MAX_REGS" not in src and "sm_run" not in src and "p.insts" not in src
    assert src.count("__ldcs(static_cast<const uint4*>(p.ops[") == 3
    for name in ("MUL_F", "ADD_F", "SUB_F"):
        assert src.count(f"sm_exec_lanes({name}, ") == 1 and src.count(f"sm_exec({name}, ") == 1
    assert "static_cast<uint4*>(out)[q] = res;" in src and "sm_store(out, i, SM_F32, res);" in src
    assert "if (p.vec) {" in src and "for (int i = done + t; i < n; i += step) {" in src
    assert src.count("{") == src.count("}") and src.count("(") == src.count(")")


def test_flat_source_widths_scalars_and_rounding():
    """A bfloat16 operand is one 8-byte load widened (``sm_load_quad2``), a
    float32 one a 16-byte load, each width a constant; a scalar operand and
    a constant are loaded and splatted once, before the loops; an
    instruction whose result is bfloat16 rounds on each lane
    (``sm_bf16r4``) and in the tail (``sm_bf16r``); the result is packed
    into one 8-byte store."""
    n = 64
    prog, sig = _flat_sig(lambda b, s, f: (b * s + 2.5) * b + program.cast(f, torch.bfloat16),
                          _t(n, dtype=torch.bfloat16), _t(dtype=torch.bfloat16), _t(n))
    assert sig.scalars == (False, True, False) and sig.operands == (3, 3, 0)
    src = codegen.source(sig)
    assert "sm_load_quad2(p.ops[0].ptr, q, SM_BF16)" in src
    assert "__ldcs(static_cast<const uint4*>(p.ops[2].ptr) + q)" in src
    head = src[:src.index("if (p.vec)")]
    assert "const uint32_t s1 = sm_load(p.ops[1].ptr, 0, SM_BF16);" in head
    assert "const uint32_t s3 = p.consts[0];" in head
    assert "p.ops[1].ptr" not in src[src.index("if (p.vec)"):]
    rounds = sum(prog.kernel_rounds)
    assert rounds >= 1 and src.count("sm_bf16r4(") == rounds and src.count("sm_bf16r(") == rounds
    assert "sm_store_quad(out, q, SM_BF16, res);" in src and "sm_store(out, i, SM_BF16, res);" in src


def test_flat_source_without_quads_for_bool_and_iterated():
    """A bool result or operand allows no quads: the kernel is the element
    loop alone.  An iterated program loops over p.iterations on both paths
    and feeds the carry."""
    n = 64
    _, sig = _flat_sig(lambda a, b: (a * b) > b, _t(n), _t(n))
    assert not codegen.quads_allowed(sig)
    src = codegen.source(sig)
    assert "p.vec" not in src and "sm_store(out, i, SM_BOOL, res);" in src
    _, sig = _flat_sig(lambda c, x: c * 0.5 + x, _t(n), _t(n), iterations=16, carry=0)
    src = codegen.source(sig)
    assert src.count("for (int it = 0; it < p.iterations; ++it) {") == 2
    assert "v0 = res;" in src and "r0 = res;" in src


def test_flat_source_32_bit_index_only_where_it_fits():
    _, sig = _flat_sig(lambda a, b: a * b + a, _t(8), _t(8))
    assert "for (int q = t; q < n4; q += step)" in codegen.source(sig)
    wide = codegen.Signature(**{**sig.__dict__, "narrow": False})
    assert "for (long long q = t; q < n4; q += step)" in codegen.source(wide)


def _program_per_opcode():
    """A program for each kernel opcode, as tests/test_torch_codegen.py
    builds them, over float32, int32, uint32 and (casts) bfloat16 and bool."""
    progs = {}
    ops = list(registry.registered_ops().items()) + list(registry.INTERNAL.items())
    for name, op in ops:
        for dt in (torch.float32, torch.int32, torch.uint32):
            if dt not in op.opcodes:
                continue
            leaves = [program.leaf((3, 5), dt) for _ in range(op.arity)]
            if name == "where":
                leaves[0] = program.leaf((3, 5), torch.bool)
            node = (program.Node(name, leaves, dt, (3, 5)) if name in ("pow", "ipow")
                    else program.apply(name, *leaves))
            prog = program.lower(node, leaves)
            progs.setdefault(program.OPCODES[prog.kernel_codes[-1]], prog)
    for src, dst in program._CASTS:
        leaf = program.leaf((3, 5), torch.bfloat16 if src == dst else src)
        prog = program.lower(program.cast(leaf, dst), [leaf])
        progs.setdefault(program.OPCODES[prog.kernel_codes[-1]], prog)
    return progs


_PER_OPCODE = _program_per_opcode()


@pytest.mark.parametrize("name", program.OPCODES)
def test_flat_and_reduce_sources_call_every_opcode_by_name(name):
    """Each opcode is ``sm_exec_lanes(<OPCODE>, ...)`` on the quads of both
    kinds (and ``sm_exec(<OPCODE>, ...)`` in the flat kernel's tail): no
    opcode is read at run time."""
    prog = _PER_OPCODE[name]
    operands = [_t(3, 5, dtype=d) for d in prog.leaf_dtypes]
    flat = elementwise.signature(prog, prog.kernel_codes, (3, 5), operands, flat=True)
    src = codegen.source(flat)
    dst = len(prog.leaf_dtypes) + len(prog.consts) + len(prog.insts) - 1
    args = ", ".join(f"r{r}" if r >= 0 else "0u" for r in prog.insts[-1][3:])
    assert f"const uint32_t r{dst} = sm_exec({name}, {args});" in src
    assert f"sm_exec({name}, " in src
    if codegen.quads_allowed(flat):
        assert f"sm_exec_lanes({name}, " in src
    if program.register_type(prog.dtype) in (torch.float32, torch.int32, torch.uint32, torch.bool):
        red = reduction.signature(prog, prog.kernel_codes, 0, (3, 5), operands)
        rsrc = codegen.source(red)
        assert f"const uint4 v{dst} = " in rsrc and f"sm_exec_lanes({name}, " in rsrc
    for s in (src,):
        assert "SM_MAX_REGS" not in s and "p.insts" not in s


# ------------------------------------------------ what the signature keeps
def test_flat_signature_leaves_out_constants_and_shape():
    a = _flat_sig(lambda x, y: x * y + 2.0, _t(8), _t(8))[1]
    assert _flat_sig(lambda x, y: x * y + 3.0, _t(8), _t(8))[1] == a
    assert _flat_sig(lambda x, y: x * y + 2.0, _t(4096), _t(4096))[1] == a
    assert _flat_sig(lambda x, y: x * y + 2.0, _t(4, 8), _t(4, 8))[1] == a  # flat: no rank
    others = [
        _flat_sig(lambda x, y: x * y + 2.0, _t(8), _t())[1],                         # a scalar
        _flat_sig(lambda x, y: x * y + 2.0, _t(8, dtype=torch.bfloat16), _t(8))[1],  # a dtype
        _flat_sig(lambda x, y: x * y - 2.0, _t(8), _t(8))[1],                        # an opcode
        _flat_sig(lambda x, y: x * y + 2.0, _t(8), _t(8), iterations=4)[1],          # iterated
        codegen.Signature(**{**a.__dict__, "narrow": False}),
        elementwise.signature(*(lambda p: (p, p.kernel_codes))(
            _lowered(lambda x, y: x * y + 2.0, _t(8), _t(8))), (8,), [_t(8), _t(8)]),  # strided
    ]
    assert a.kind == "flat" and a.scalars == (False, False)
    assert len({a, *others}) == len(others) + 1


# ---------------------------------------------------------- the routes
_FLAT_ROUTES = {
    # (program, operands, iterations, flat_path)
    "add": (lambda a, b: a + b, "ab", 1, "wide"),
    "add, 4 bytes off": (lambda a, b: a + b, "ob", 1, "element"),
    "add iterated": (lambda a, b: a + b, "ab", 3, "generated"),
    "chain": (lambda a, b: a * b + a, "ab", 1, "generated"),
    "chain, 4 bytes off": (lambda a, b: a * b + a, "ob", 1, "generated"),
    "chain with a scalar": (lambda a, s: a * s + a, "as", 1, "generated"),
    "scalar - a": (lambda s, a: s - a, "sa", 1, "wide"),
    "identity": (lambda a: a, "a", 1, "generated"),
    "compare": (lambda a, b: a > b, "ab", 1, "element"),
}


@pytest.mark.parametrize("case", sorted(_FLAT_ROUTES))
def test_flat_path_routes_programs(case):
    """One-instruction programs stay on the compiled kernel (``wide`` or
    ``element``); any other runs its generated kernel; the CPU tensors take
    the plain version and count nothing."""
    fn, names, iterations, want = _FLAT_ROUTES[case]
    n = 1003
    base = torch.arange(n + 4, dtype=torch.float32)
    skip = (-base.data_ptr() // 4) % 4
    pool = {"a": base[skip:skip + n], "b": torch.linspace(-1, 1, n), "s": torch.tensor(0.5),
            "o": base[skip + 1:skip + 1 + n]}
    operands = [pool[c] for c in names]
    prog = _lowered(fn, *operands)
    assert elementwise.flat_path(prog, (n,), elementwise.layout(operands), iterations) == want
    assert elementwise.single(prog, iterations) is (want != "generated")
    elementwise.reset_launches()
    carry = {"carry": 0} if iterations > 1 else {}
    got = elementwise.elementwise(prog, (n,), prog.dtype, *operands, iterations=iterations, **carry)
    assert torch.equal(got, program.run_plain(prog, operands, (n,), iterations, 0))
    assert not any(elementwise.FLAT_PATHS.values()) and not any(elementwise.LAUNCHES.values())


def test_the_cpu_never_generates():
    """Flat chains and map-reduces on CPU tensors take the plain versions:
    no compile, no launch, no signature loaded; ``reduction.interpret`` is
    the plain version there too."""
    stats, seen = dict(codegen.STATS), set(codegen.SEEN)
    elementwise.reset_launches()
    reduction.reset_launches()
    x, y = torch.linspace(-2, 2, 1001), torch.linspace(1, 3, 1001)
    chain = _lowered(lambda a, b: a * b + a, x, y)
    elementwise.elementwise(chain, (1001,), torch.float32, x, y)
    got = reduction.map_reduce(chain, "sum", (1001,), x, y)
    ref = reduction.interpret(chain, "sum", None, (1001,), [x, y])
    assert torch.equal(got, ref)
    assert codegen.STATS == stats and codegen.SEEN == seen
    assert not any(elementwise.FLAT_PATHS.values()) and not any(reduction.PATHS.values())
    assert not any(reduction.LAUNCHES.values())


# ------------------------------------------- against the JAX package
# (label, entry, the expression on sm leaves, the same on jnp tiles, operand
# shapes, axis).  "flat": ``pallas_elementwise`` (``_build_call_1d``), the
# rest ``pallas_map_reduce`` (``_build_map_reduce_1d``, ``_2d`` for a 2-D
# expression) and ``pallas_map_reduce_axis`` (``_build_reduce_axis``).
_N, _R, _C = 4099, 37, 70
_PARITY = {
    "chain a*b+c-a": ("flat", lambda a, b, c: a * b + c - a, lambda a, b, c: a * b + c - a,
                      [(_N,)] * 3, None),
    "bf16 x*x+x": ("flat", lambda a: a * a + a, lambda a: a * a + a, [(_N,)], None),
    "distance": ("reduce", lambda a, b, e: sm.square(a + e - b),
                 lambda a, b, e: jnp.square(a + e - b), [(_N,), (_N,), ()], None),
    "m*row-col": ("reduce", lambda a, r, c: a * r - c, lambda a, r, c: a * r - c,
                  [(_R, _C), (1, _C), (_R, 1)], None),
    "thresholded axis 0": ("reduce", lambda a, s: sm.where(a > s, a, 0.0),
                           lambda a, s: jnp.where(a > s, a, 0.0), [(_R, _C), (1, 1)], 0),
    "thresholded axis 1": ("reduce", lambda a, s: sm.where(a > s, a, 0.0),
                           lambda a, s: jnp.where(a > s, a, 0.0), [(_R, _C), (1, 1)], 1),
    "bf16 sum(x*x+x)": ("reduce", lambda a: a * a + a, lambda a: a * a + a, [(_N,)], None),
}


@pytest.mark.parametrize("case", sorted(_PARITY))
def test_generated_programs_match_jax(rng, case):
    """The slice's programs: the port's plain versions (what the generated
    kernels are held to on the card, bit for bit, through the interpreters)
    against the JAX package's Pallas kernels in interpret mode, on the same
    inputs; the port routes each to its generated kernel.  A float32
    elementwise result within 8 ulp of the largest term's magnitude (XLA
    may contract ``a * b + c`` into one rounding), a bfloat16 one within
    one bfloat16 ulp, a sum within 2e-5 * sum|x|."""
    from simplemath_tpu.ops import elementwise as jelementwise
    from simplemath_tpu.ops import reduction as jreduction

    kind, port_fn, jax_fn, shapes, axis = _PARITY[case]
    half = case.startswith("bf16")
    data = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    dt, jdt = (torch.bfloat16, jnp.bfloat16) if half else (torch.float32, jnp.float32)
    ports = [torch.from_numpy(d).to(dt) for d in data]
    jaxes = [jnp.asarray(d, dtype=jdt) for d in data]
    shape = max((tuple(s) for s in shapes), key=len)
    leaves = [program.leaf(tuple(o.shape), dt) for o in ports]
    prog = program.lower(port_fn(*leaves), leaves)
    where = elementwise.layout(ports)
    if kind == "flat":
        assert elementwise.flat_path(prog, shape, where) == "generated"
        got = elementwise.elementwise(prog, shape, prog.dtype, *ports)
        want = jelementwise.pallas_elementwise(jax_fn, shape, jdt, *jaxes)
        g64 = got.double().numpy()
        w64 = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
        if half:
            assert np.all(np.abs(g64 - w64) <= np.abs(w64) * 2.0 ** -8)
        else:
            a, b, c = (np.abs(d).astype(np.float64) for d in data)
            scale = np.maximum(np.maximum(a * b, a * b + c), np.abs(w64)).astype(np.float32)
            assert np.all(np.abs(g64 - w64) <= 8 * np.spacing(scale).astype(np.float64))
        return
    assert reduction.path(prog, "sum", shape, where, axis) == "generated"
    jdispatch.reset()
    if axis is None:
        got = reduction.map_reduce(prog, "sum", shape, *ports)
        want = jreduction.pallas_map_reduce(jax_fn, "sum", shape, *jaxes)
        assert jdispatch.count("reduce_fused", "sum") == 1
    else:
        got = reduction.map_reduce_axis(prog, "sum", axis, shape, *ports)
        want = jreduction.pallas_map_reduce_axis(jax_fn, "sum", axis, shape, *jaxes)
    assert want is not None
    vals = reduction.values(prog, shape, ports, torch.device("cpu")).double().numpy()
    scale = np.abs(vals).sum(axis=axis)
    g64, w64 = got.double().numpy(), np.asarray(want, np.float64)
    assert g64.shape == w64.shape
    assert np.all(np.abs(g64 - w64) <= 2e-5 * scale)
