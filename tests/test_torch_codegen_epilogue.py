"""The matmul kernels generated per epilogue, on the CPU.

On the card every launch of the matmul kernel with an epilogue runs a
kernel that ops/codegen.py writes for the launch's signature (kind
``"matmul"``): the variant's own kernel body (csrc/matmul_wgmma.cuh,
matmul_wgmma_s8.cuh, matmul_fma.cuh) with the epilogue's instructions as
code, as the TPU kernels are built once per epilogue
(``simplemath_tpu/ops/matmul.py::_build_matmul``/``_build_bmm``).  Held
here: what the signature keeps and leaves out, the generated sources (every
opcode by name, no register file, the stored type, the bfloat16 rounding),
that the CPU never generates, and the port's plain fused root (what the
generated kernel is held to, through the interpreter, on the card:
tests/test_torch_kernel_cuda.py) against the JAX package's
``pallas_matmul(..., epilogue=...)`` and ``int8_matmul(scale=)`` in
interpret mode, on the same numpy inputs from a seed, for every stored type,
each shape of extra, rank 2 and 3, and the dequantizing epilogue.

Tolerances, those of tests/test_torch_matmul.py: float32 ``rtol=1e-5,
atol=1e-4`` (two float32 sums in different orders, then the epilogue);
bfloat16 within 2e-2 of the largest value (a bfloat16 rounding on top);
integers and booleans exact (integer products are exact in any order).
"""

import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplemath_tpu_torch as sm
from simplemath_tpu.config import config as jconfig
from simplemath_tpu.ops import matmul as jmatmul
from simplemath_tpu_torch.ops import codegen, dispatch, matmul, program, registry


@pytest.fixture(autouse=True)
def _reference_setup():
    """The JAX side on its Pallas kernels (interpret mode on the CPU), the
    port on the CPU: its default device is the card."""
    old = (jconfig.kernel_backend, sm.config.device)
    jconfig.kernel_backend = "pallas"
    sm.configure(device="cpu")
    dispatch.reset()
    matmul.reset_launches()
    yield
    jconfig.kernel_backend = old[0]
    sm.configure(device=old[1])


_F32, _BF16, _I32 = torch.float32, torch.bfloat16, torch.int32


def _z(*shape, dtype=_F32):
    return torch.zeros(shape, dtype=dtype)


def _epilogue(fn, acc_shape, acc_dtype, extras):
    acc = program.leaf(acc_shape, acc_dtype)
    leaves = [program.leaf(tuple(e.shape), e.dtype) for e in extras]
    return program.lower_epilogue(fn(acc, *leaves), acc, leaves)


def _sig(fn, a, b, out_dtype, extras):
    """The signature of ``fn``'s epilogue on ``a @ b`` stored as ``out_dtype``."""
    shape = tuple(a.shape[:-1]) + (b.shape[-1],)
    epi = _epilogue(fn, shape, matmul.accumulator(a.dtype, b.dtype), extras)
    return matmul.launch_signature(a, b, out_dtype, epi, extras)


def _relu_times(c):
    return lambda acc, e: sm.maximum(acc + e, 0.0) * c


# ----------------------------------------------- what the signature keeps
def test_signature_leaves_out_constants_shapes_and_addresses():
    """``relu(acc + b) * 2.0`` and ``* 3.0`` share a kernel, at any size
    whose rows keep the layout; the constants' values are read at run time."""
    a, b, bias = _z(64, 32), _z(32, 48), _z(1, 48)
    sig = _sig(_relu_times(2.0), a, b, _F32, [bias])
    assert sig.kind == "matmul" and sig.variant == "fma_f32" and sig.rank == 3
    assert _sig(_relu_times(3.0), a, b, _F32, [bias]) == sig
    assert _sig(_relu_times(2.0), _z(256, 128), _z(128, 512), _F32, [_z(1, 512)]) == sig
    assert _sig(_relu_times(2.0), _z(64, 32), _z(32, 48), _F32, [_z(1, 48)]) == sig
    # mm and bmm share it too: the batch is a grid dimension, as in the
    # compiled kernel.
    assert _sig(_relu_times(2.0), _z(2, 64, 32), _z(2, 32, 48), _F32, [_z(1, 1, 48)]) == sig


@pytest.mark.parametrize("other", [
    "variant bf16", "variant int8", "variant int32", "stored bf16", "stored bool", "scalar extra",
    "column extra", "full extra", "bf16 extra", "transposed B", "element path", "program",
    "int8 way in",
])
def test_signature_differs_across_what_the_code_depends_on(other):
    """The variant, the stored type, which extras are one value a block, a
    row or a column group, the extras' types, the operands' staging
    (template arguments) and the program each give another kernel."""
    a, b, bias = _z(64, 32), _z(32, 48), _z(1, 48)
    base = _sig(_relu_times(2.0), a, b, _F32, [bias])
    relu = _relu_times(2.0)
    got = {
        "variant bf16": lambda: _sig(relu, a.to(_BF16), b.to(_BF16), _F32, [bias]),
        "variant int8": lambda: _sig(lambda acc, e: program.cast(acc, _F32) * e,
                                     a.to(torch.int8), b.to(torch.int8), _F32, [bias]),
        "variant int32": lambda: _sig(lambda acc, e: program.cast(acc, _F32) * e,
                                      a.to(_I32), b.to(_I32), _F32, [bias]),
        "stored bf16": lambda: _sig(relu, a, b, _BF16, [bias]),
        "stored bool": lambda: _sig(lambda acc, e: acc > e, a, b, torch.bool, [bias]),
        "scalar extra": lambda: _sig(relu, a, b, _F32, [_z()]),
        "column extra": lambda: _sig(relu, a, b, _F32, [_z(64, 1)]),
        "full extra": lambda: _sig(relu, a, b, _F32, [_z(64, 48)]),
        "bf16 extra": lambda: _sig(relu, a, b, _F32, [bias.to(_BF16)]),
        "transposed B": lambda: _sig(relu, a, _z(48, 32).T, _F32, [bias]),
        "element path": lambda: _sig(relu, _z(64, 33)[:, 1:], b, _F32, [bias]),
        "program": lambda: _sig(lambda acc, e: sm.minimum(acc + e, 0.0) * 2.0, a, b, _F32, [bias]),
        "int8 way in": lambda: (
            _sig(lambda acc, e: program.cast(acc, _F32) * e, a.to(torch.int8), b.to(torch.int8),
                 _F32, [bias]),
            _sig(lambda acc, e: program.cast(acc, _F32) * e, a.to(torch.int8),
                 _z(48, 32, dtype=torch.int8).T, _F32, [bias])),
    }[other]()
    if other == "int8 way in":  # a transposed B is copied, a row-major one transposed
        base, got = got
    assert got != base and got.kind == "matmul"


def test_signature_fields_of_each_variant():
    """The variant and its template arguments, and how each extra varies."""
    bias, col, s, full = _z(1, 48), _z(64, 1), _z(), _z(64, 48)
    sig = _sig(lambda acc, b_, c, s_, f: acc * b_ + c * s_ - f, _z(64, 32).to(_BF16),
               _z(48, 32).to(_BF16).T, _F32, [bias, col, s, full])
    assert (sig.variant, sig.layout) == ("wgmma_bf16", (True, True))
    assert sig.varies == ("mn", "n", "m", "", "mn")
    u8 = _sig(lambda acc, e: program.cast(acc, _F32) * e, _z(64, 32, dtype=torch.uint8),
              _z(32, 48, dtype=torch.int8), _F32, [bias])
    # Signedness, then each operand's way in: A copied, B transposed.
    assert (u8.variant, u8.layout) == ("wgmma_s8", (False, True, 0, 1))
    byte = _sig(lambda acc, e: program.cast(acc, _F32) * e, _z(64, 33, dtype=torch.int8)[:, 1:],
                _z(48, 32, dtype=torch.int8).T, _F32, [bias])
    assert byte.layout == (True, True, 2, 0)  # A byte by byte, B (K-major) copied
    i32 = _sig(lambda acc, e: acc > e, _z(64, 32, dtype=_I32), _z(32, 48, dtype=torch.int8),
               torch.bool, [_z(64, 1, dtype=_I32)])
    # An int8 operand beside an int32 one is read element by element.
    assert (i32.variant, i32.layout, i32.out_dtype) == ("imad_i32", (True, False, True), 2)


# ------------------------------------------------------- the sources
_VARIANTS = {
    # variant: (a, b, header, the body's call)
    "wgmma_bf16": (_z(64, 32, dtype=_BF16), _z(32, 48, dtype=_BF16), "matmul_wgmma.cuh",
                   "mm_wgmma_body<true, false, MmGenerated>(q, out);"),
    "wgmma_s8": (_z(64, 32, dtype=torch.int8), _z(32, 48, dtype=torch.uint8), "matmul_wgmma_s8.cuh",
                 "mm_wgmma_s8_body<true, false, 0, 1, MmGenerated>(q, out);"),
    "fma_f32": (_z(64, 32), _z(32, 48), "matmul_fma.cuh",
                "mm_body<kF32, true, false, false, MmGenerated>(q, out);"),
    "imad_i32": (_z(64, 32, dtype=_I32), _z(32, 48, dtype=_I32), "matmul_fma.cuh",
                 "mm_body<kI32, true, false, false, MmGenerated>(q, out);"),
}


# Each variant with each type its accumulator can be stored as: a float32
# result as float32 or bfloat16, an int32 one as int32, a comparison as bool.
_STORES = [(v, s) for v in sorted(_VARIANTS)
           for s in (("int32", "bool") if v in ("wgmma_s8", "imad_i32") else
                     ("float32", "bfloat16", "bool"))]


@pytest.mark.parametrize("variant,stored", _STORES)
def test_source_of_each_variant_and_stored_type(variant, stored):
    """The variant's kernel body at its template arguments, the epilogue
    as ``MmGenerated``: the stored type a constant, each extra held from
    where it stops varying, every instruction ``sm_exec_lanes`` of a named
    opcode on registers that are local variables, no register file."""
    a, b, header, call = _VARIANTS[variant]
    acc = matmul.accumulator(a.dtype, b.dtype)
    out = {"float32": _F32, "bfloat16": _BF16, "int32": _I32, "bool": torch.bool}[stored]
    row, col, s = _z(1, 48, dtype=acc), _z(64, 1, dtype=acc), _z(dtype=acc)
    if out == torch.bool:
        fn = lambda x, r, c, s_: (x + r) * c > s_  # noqa: E731
    else:
        fn = lambda x, r, c, s_: (x + r) * c - s_  # noqa: E731
    sig = _sig(fn, a, b, out, [row, col, s])
    src = codegen.source(sig)
    assert src.startswith(f'#include "{header}"')
    assert f"  {call}" in src
    assert f"static constexpr int32_t kOut = {codegen.DTYPE_NAMES[sig.out_dtype]};" in src
    kind = "SM_F32" if acc == _F32 else "SM_I32"
    assert f"e1 = mm_load4(q.p.ops[1], bz, 0, n, count, {kind});" in src  # once a column group
    assert f"e2 = sm_splat(sm_load(q.p.ops[2].ptr, bz * q.p.ops[2].strides[0] + m * " in src  # a row
    assert f"e3 = sm_splat(sm_load(q.p.ops[3].ptr, bz * q.p.ops[3].strides[0], {kind}));" in src
    ops = ("ADD_I", "MUL_I", "GT_I" if out == torch.bool else "SUB_I") if acc == _I32 else \
        ("ADD_F", "MUL_F", "GT_F" if out == torch.bool else "SUB_F")
    for op in ops:
        assert f"sm_exec_lanes({op}, " in src
    assert "SM_MAX_REGS" not in src and "p.insts" not in src and "sm_run" not in src
    assert 'extern "C" __global__ void __launch_bounds__(256, 1) sm_generated(' in src


def test_source_full_extras_load_a_quad_a_call_and_bf16_extras_widen():
    a, b = _z(64, 32), _z(32, 48)
    sig = _sig(lambda acc, f, g: acc * f + g, a, b, _F32, [_z(64, 48), _z(1, 48, dtype=_BF16)])
    src = codegen.source(sig)
    assert "const uint4 v1 = mm_load4(q.p.ops[1], bz, m, n, count, SM_F32);" in src
    assert "e2 = mm_load4(q.p.ops[2], bz, 0, n, count, SM_BF16);" in src


def test_source_rounds_to_bfloat16_where_an_instruction_does():
    """An instruction whose result is bfloat16 is ``sm_bf16r4`` of its
    value (the interpreter's rounding step); the flag is part of the
    signature."""
    sig = _sig(_relu_times(2.0), _z(64, 32), _z(32, 48), _F32, [_z(1, 48)])
    rounded = dataclasses.replace(sig, rounds=(False, True) + sig.rounds[2:])
    assert rounded != sig
    src = codegen.source(rounded)
    assert src.count("sm_bf16r4(sm_exec_lanes(") == 1
    assert "sm_bf16r4" not in codegen.source(sig)


def _program_per_opcode():
    """A program for each kernel opcode, over float32, int32, uint32 and
    (casts) bfloat16 and bool, as tests/test_torch_codegen_flat.py builds them."""
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


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
@pytest.mark.parametrize("name", program.OPCODES)
def test_every_opcode_by_name_in_each_variant(name, variant):
    """Each opcode is ``sm_exec_lanes(<OPCODE>, ...)`` with its operands'
    registers: no opcode is read at run time."""
    prog = _PER_OPCODE[name]
    codes = [codegen.DTYPE_NAMES.index("SM_F32")] * len(prog.leaf_dtypes)
    layout = {"fma_f32": (True, False, False), "imad_i32": (True, False, False),
              "wgmma_s8": (True, False, 0, 1)}.get(variant, (True, False))
    sig = codegen.signature(prog, prog.kernel_codes, codes, 0, 3, 1, -1, False, kind="matmul",
                            variant=variant, layout=layout,
                            varies=("mn",) * len(prog.leaf_dtypes))
    src = codegen.source(sig)
    dst = len(prog.leaf_dtypes) + len(prog.consts) + len(prog.insts) - 1
    args = ", ".join(f"v{r}" if r >= 0 else "z" for r in prog.insts[-1][3:])
    assert f"const uint4 v{dst} = sm_exec_lanes({name}, {args});" in src
    assert "SM_MAX_REGS" not in src


# ------------------------------------------------- the CPU never generates
def test_the_cpu_never_generates():
    """Fused roots and ``matmul.interpret`` on CPU tensors take the plain
    version: no compile, no launch, no signature loaded, no epilogue path
    counted."""
    stats, seen = dict(codegen.STATS), set(codegen.SEEN)
    a, b, bias = torch.randn(40, 24), torch.randn(24, 36), torch.randn(1, 36)
    epi = _epilogue(_relu_times(0.5), (40, 36), _F32, [bias])
    got = matmul.matmul(a, b, _F32, epilogue=epi, extras=[bias])
    ref = matmul.interpret(a, b, _F32, epilogue=epi, extras=[bias])
    fused = sm.fuse(lambda x, w, c: sm.maximum(x @ w + c, 0.0) * 0.5)(a, b, bias).torch()
    assert torch.equal(got, ref) and torch.equal(fused, ref)
    deq = sm.int8_matmul(a.to(torch.int8), b.to(torch.int8), scale=bias.abs()).torch()
    assert deq.dtype == _F32
    assert codegen.STATS == stats and codegen.SEEN == seen
    assert matmul.EPILOGUE_PATHS == {"generated": 0, "interp": 0}
    assert matmul.LAUNCHES == {"mm": 0, "bmm": 0}


# ---------------------------------------------- against the JAX package
_B, _M, _K, _N = 2, 40, 24, 36
# stored type: (operand dtype, numpy epilogue extra dtype, the port's
# epilogue, the JAX package's, out dtype)
_STORED = {
    "float32": (np.float32, np.float32, lambda acc, e: sm.maximum(acc + e, 0.0) * 0.5 - 0.25,
                lambda acc, e: jnp.maximum(acc + e, 0.0) * 0.5 - 0.25, _F32),
    "bfloat16": ("bfloat16", "bfloat16", lambda acc, e: sm.maximum(acc + e, 0.0) * 0.5 - 0.25,
                 lambda acc, e: jnp.maximum(acc + e.astype(jnp.float32), 0.0) * 0.5 - 0.25, _BF16),
    "int32": (np.int8, np.int32, lambda acc, e: (acc + e) * 3, lambda acc, e: (acc + e) * 3, _I32),
    "bool": (np.int8, np.int32, lambda acc, e: acc > e, lambda acc, e: acc > e, torch.bool),
}
_EXTRA = {  # rank: extra kind -> shape
    2: {"scalar": (1, 1), "row": (1, _N), "column": (_M, 1), "full": (_M, _N)},
    3: {"scalar": (_B, 1, 1), "row": (1, 1, _N), "column": (_B, _M, 1), "full": (_B, _M, _N)},
}


def _numpy(shape, dtype, rng):
    if dtype == np.int8:
        return rng.integers(-127, 128, shape).astype(np.int8)
    if dtype == np.int32:
        return rng.integers(-5000, 5000, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def _to_jax(x, dtype):
    return jnp.asarray(x).astype(jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(x)


def _to_port(x, dtype):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(_BF16) if dtype == "bfloat16" else t


@pytest.mark.parametrize("rank", [2, 3])
@pytest.mark.parametrize("extra", ["scalar", "row", "column", "full"])
@pytest.mark.parametrize("stored", sorted(_STORED))
def test_fused_root_matches_jax_pallas_matmul(stored, extra, rank):
    """The port's plain fused root (``matmul.matmul`` with an epilogue, on
    the CPU) against ``pallas_matmul(..., epilogue=...)`` in interpret
    mode, for each stored type, shape of extra and rank."""
    op_dtype, extra_dtype, port_fn, jax_fn, out = _STORED[stored]
    rng = np.random.default_rng(zlib.crc32(f"{stored} {extra} {rank}".encode()))
    lead = (_B,) if rank == 3 else ()
    a = _numpy(lead + (_M, _K), np.float32 if op_dtype == "bfloat16" else op_dtype, rng)
    b = _numpy(lead + (_K, _N), np.float32 if op_dtype == "bfloat16" else op_dtype, rng)
    e = _numpy(_EXTRA[rank][extra], np.float32 if extra_dtype == "bfloat16" else extra_dtype, rng)
    jout = {_F32: jnp.float32, _BF16: jnp.bfloat16, _I32: jnp.int32, torch.bool: jnp.bool_}[out]
    want = jmatmul.pallas_matmul(_to_jax(a, op_dtype), _to_jax(b, op_dtype), jout,
                                 precision="highest", epilogue=jax_fn,
                                 extras=[_to_jax(e, extra_dtype)])
    pa, pb, pe = _to_port(a, op_dtype), _to_port(b, op_dtype), _to_port(e, extra_dtype)
    shape = lead + (_M, _N)
    epi = _epilogue(port_fn, shape, matmul.accumulator(pa.dtype, pb.dtype), [pe])
    got = matmul.matmul(pa, pb, out, epilogue=epi, extras=[pe])
    assert got.dtype == out and tuple(got.shape) == shape
    w = np.asarray(want.astype(jnp.float32) if out == _BF16 else want)
    g = got.float().numpy() if out == _BF16 else got.numpy()
    if out == _F32:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)
    elif out == _BF16:
        assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max()
    else:
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("rank", [2, 3])
@pytest.mark.parametrize("scale", ["scalar", "row"])
def test_dequant_epilogue_matches_jax_int8_matmul(scale, rank):
    """``int8_matmul(scale=)``: the dequantizing epilogue (the int32
    accumulator cast to float32, times the scale) exact against the JAX
    package's ``_dequant_epi`` on its int8 Pallas kernel."""
    rng = np.random.default_rng(7 + rank)
    lead = (_B,) if rank == 3 else ()
    a, b = _numpy(lead + (_M, _K), np.int8, rng), _numpy(lead + (_K, _N), np.int8, rng)
    s = np.abs(_numpy((1,) * rank if scale == "scalar" else (1,) * (rank - 1) + (_N,),
                      np.float32, rng)) * 1e-3
    want = jmatmul.int8_matmul(jnp.asarray(a), jnp.asarray(b), scale=jnp.asarray(s))
    got = sm.int8_matmul(torch.from_numpy(a), torch.from_numpy(b), scale=torch.from_numpy(s)).torch()
    assert got.dtype == _F32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sig = matmul.launch_signature(torch.from_numpy(a), torch.from_numpy(b), _F32,
                                  matmul._dequant_epilogue(rank), [torch.from_numpy(s)])
    assert (sig.variant, sig.varies[1]) == ("wgmma_s8", "" if scale == "scalar" else "n")
