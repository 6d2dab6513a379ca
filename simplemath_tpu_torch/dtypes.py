"""Dtype canonicalization and the promotion table.

Counterpart of ``simplemath_tpu/dtypes.py``.  The JAX package promotes with
``jnp.result_type``; the port must give the same result types, and torch's
own promotion differs (int32 + 1.5 is float32 in torch, float64 in JAX;
a bfloat16 array plus a float32 0-d array is bfloat16 in torch, float32 in
JAX).  So promotion here is an explicit table: JAX's type lattice, with
Python scalars as the weak types ``i*``/``f*``/``c*``, and a weak result
widened to the 64-bit default (the JAX package runs with x64 enabled).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Dtypes the hand-written elementwise kernel takes (ops/elementwise.py):
# the JAX package's PALLAS_NATIVE_DTYPES (float32, bfloat16, int32,
# uint32), and bool, which comparisons write.  Every other dtype runs as
# plain torch.
KERNEL_DTYPES = frozenset([torch.float32, torch.bfloat16, torch.int32, torch.uint32,
                           torch.bool])

_NAMES = {
    torch.bool: "bool",
    torch.uint8: "uint8",
    torch.uint16: "uint16",
    torch.uint32: "uint32",
    torch.uint64: "uint64",
    torch.int8: "int8",
    torch.int16: "int16",
    torch.int32: "int32",
    torch.int64: "int64",
    torch.bfloat16: "bfloat16",
    torch.float16: "float16",
    torch.float32: "float32",
    torch.float64: "float64",
    torch.complex64: "complex64",
    torch.complex128: "complex128",
}
_BY_NAME = {v: k for k, v in _NAMES.items()}

# JAX's promotion lattice: each type -> the types directly above it.
_UP = {
    "bool": ("i*",),
    "i*": ("uint8", "int8"),
    "uint8": ("int16", "uint16"),
    "uint16": ("int32", "uint32"),
    "uint32": ("int64", "uint64"),
    "uint64": ("f*",),
    "int8": ("int16",),
    "int16": ("int32",),
    "int32": ("int64",),
    "int64": ("f*",),
    "f*": ("c*", "float16", "bfloat16"),
    "bfloat16": ("float32",),
    "float16": ("float32",),
    "float32": ("float64", "complex64"),
    "float64": ("complex128",),
    "c*": ("complex64",),
    "complex64": ("complex128",),
    "complex128": (),
}
# A weak result takes the 64-bit default type (x64 semantics).
_WEAK_DEFAULT = {"i*": "int64", "f*": "float64", "c*": "complex128"}


@functools.lru_cache(maxsize=None)
def _upper(t: str) -> frozenset:
    out = {t}
    for u in _UP[t]:
        out |= _upper(u)
    return frozenset(out)


@functools.lru_cache(maxsize=None)
def _join(keys: tuple) -> str:
    common = frozenset.intersection(*(_upper(k) for k in keys))
    for t in common:
        if _upper(t) == common:
            return t
    raise TypeError(f"no common dtype for {keys}")  # pragma: no cover


def name(dtype: torch.dtype) -> str:
    """numpy-style name of a torch dtype ("float32", ...)."""
    return _NAMES[dtype]


def canonicalize(dtype) -> torch.dtype:
    """Canonicalize a user dtype spec (python type / numpy / torch / str)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype in (float, "float"):
        return torch.float32
    if dtype in (int, "int"):
        return torch.int32
    if dtype in (complex, "complex"):
        return torch.complex64
    if dtype in (bool, "bool"):
        return torch.bool
    if isinstance(dtype, str) and dtype in _BY_NAME:
        return _BY_NAME[dtype]
    return _BY_NAME[np.dtype(dtype).name]


def from_numpy(dtype) -> torch.dtype:
    return _BY_NAME[np.dtype(dtype).name]


def to_numpy(dtype: torch.dtype) -> np.dtype:
    if dtype == torch.bfloat16:
        raise TypeError("numpy has no bfloat16")
    return np.dtype(_NAMES[dtype])


def key(x) -> str:
    """Promotion key of one operand: a torch dtype (strong), a numpy
    scalar (strong, its own dtype), or a Python scalar (weak)."""
    if isinstance(x, torch.dtype):
        return _NAMES[x]
    if isinstance(x, np.generic):
        return np.dtype(type(x)).name
    if isinstance(x, bool):
        return "bool"
    if isinstance(x, int):
        return "i*"
    if isinstance(x, float):
        return "f*"
    if isinstance(x, complex):
        return "c*"
    raise TypeError(f"not a dtype or scalar: {x!r}")


def join_keys(*keys: str) -> str:
    """Least upper bound of promotion keys; may be weak ("f*", ...)."""
    return _join(tuple(keys))


def weak_to_dtype(k: str) -> torch.dtype:
    return _BY_NAME[_WEAK_DEFAULT.get(k, k)]


def result_dtype(*xs) -> torch.dtype:
    """``jnp.result_type`` under x64, over torch dtypes and scalars."""
    return weak_to_dtype(join_keys(*(key(x) for x in xs)))


def is_integer(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex and dtype != torch.bool


def to_inexact(dtype: torch.dtype) -> torch.dtype:
    """The float type an int/bool input computes in for true division and
    sqrt (JAX: 64-bit ints -> float64, narrower ints and bool -> float32)."""
    if dtype.is_floating_point or dtype.is_complex:
        return dtype
    if dtype in (torch.int64, torch.uint64):
        return torch.float64
    return torch.float32


def holds(dtype: torch.dtype, value: int) -> bool:
    """Whether the integer type ``dtype`` holds the Python int ``value``."""
    info = torch.iinfo(dtype)
    return info.min <= value <= info.max


UNSIGNED = frozenset([torch.uint8, torch.uint16, torch.uint32, torch.uint64])


def reduction_dtype(dtype: torch.dtype, kind: str) -> torch.dtype:
    """The result type of ``jnp.<kind>`` over ``dtype`` under x64: integer
    and bool sums and products widen to int64 (unsigned ones to uint64), a
    mean is inexact (``to_inexact``), max and min keep the type."""
    if kind in ("sum", "prod") and (dtype == torch.bool or is_integer(dtype)):
        return torch.uint64 if dtype in UNSIGNED else torch.int64
    if kind == "mean":
        return to_inexact(dtype)
    return dtype
