"""The ``Array`` container.

Counterpart of ``simplemath_tpu/array.py``: an N-D array with NumPy
broadcasting and aliasing views.  The buffer is a contiguous torch tensor
held in a shared ``_Storage`` cell and a view is a ``ViewSpec`` over that
cell, so writes through a view are visible to the parent and to every
sibling view, negative steps included (torch itself has no negative-step
view).  Writes go into the buffer in place.

Arrays are created on ``config.device`` and never moved; an Array built
from a torch tensor stays on that tensor's device.  Python lists and
scalars default to float32/int32 whatever the width of their elements;
numpy arrays keep their dtype (the JAX package runs with x64 enabled).

Reductions (``sum/max/min/mean``) and the 1-D ``dot``/``@`` run the
map-reduce kernel (ops/reduction.py) where the JAX package runs its Pallas
reduction kernels, and plain torch elsewhere.  ``dot``/``@`` of rank >= 2
follow ``numpy.dot`` (ops/engine.py::dot).

Advanced indexing (integer arrays, boolean masks) reads a copy and writes
through the view, as in the JAX package (its XLA gather and scatter are
torch indexing here).
"""

from __future__ import annotations

from typing import Any, Tuple, Union

import numpy as np
import torch
from torch.utils import _pytree

from . import dtypes as _dtypes
from .config import config
from .slicing import Slice, process_index
from .viewspec import ViewSpec


class _Storage:
    """Shared mutable cell holding the base tensor.

    ``frozen`` is set when a deferred op (ops/lazy.py) has snapshotted the
    buffer by reference: the next write then copies the buffer first, so a
    recorded op keeps the values it saw."""

    __slots__ = ("buf", "frozen")

    def __init__(self, buf):
        self.buf = buf
        self.frozen = False

    def thaw(self):
        if self.frozen:
            self.buf = self.buf.clone()
            self.frozen = False


def _normalize_key(key, ndim: int) -> list:
    """Expand a user key (scalar / tuple with Ellipsis / Slice objects) into
    a list of int|slice over the array's dims."""
    if not isinstance(key, tuple):
        key = (key,)
    n_explicit = sum(1 for k in key if k is not Ellipsis and k is not None)
    out = []
    seen_ellipsis = False
    for k in key:
        if k is Ellipsis:
            if seen_ellipsis:
                raise IndexError("an index can only have a single ellipsis")
            seen_ellipsis = True
            out.extend([slice(None)] * (ndim - n_explicit))
        else:
            out.append(process_index(k))
    return out


def _split_newaxes(key, ndim: int):
    """Split ``None`` (np.newaxis) entries out of a key: ``(base_key,
    newaxis_positions)`` with positions as output-dim indices."""
    if not isinstance(key, tuple):
        key = (key,)
    if not any(k is None for k in key):
        return key, ()
    n_explicit = sum(1 for k in key if k is not Ellipsis and k is not None)
    expanded = []
    for k in key:
        if k is Ellipsis:
            expanded.extend([slice(None)] * (ndim - n_explicit))
        else:
            expanded.append(k)
    expanded += [slice(None)] * (ndim - sum(1 for k in expanded if k is not None))
    base_key, positions, out_dim = [], [], 0
    for k in expanded:
        if k is None:
            positions.append(out_dim)
            out_dim += 1
        else:
            base_key.append(k)
            is_int = not isinstance(k, (slice, Slice)) and (
                isinstance(k, int) or hasattr(k, "__index__")
            )
            if not is_int:
                out_dim += 1
    return tuple(base_key), tuple(positions)


def _is_advanced_key(key) -> bool:
    """Whether a key uses NumPy advanced indexing (integer arrays or
    sequences, boolean masks) rather than basic ints and slices."""
    ks = key if isinstance(key, tuple) else (key,)
    return any(
        isinstance(k, (list, np.ndarray, torch.Tensor, Array, bool, np.bool_))
        for k in ks
    )


def _advanced_key(key, device):
    """The key with its arrays as tensors on ``device`` (torch indexes with
    NumPy's advanced-indexing rules: negative indices, broadcast index
    arrays, int arrays beside slices, boolean masks)."""
    ks = key if isinstance(key, tuple) else (key,)

    def conv(k):
        if isinstance(k, Array):
            k = k.torch()
        elif isinstance(k, (list, np.ndarray)):
            k = torch.as_tensor(np.asarray(k))
        if isinstance(k, torch.Tensor):
            return k.to(device) if k.dtype == torch.bool else k.to(device, torch.int64)
        return k

    out = tuple(conv(k) for k in ks)
    return out if isinstance(key, tuple) else out[0]


def _tensor_from(data, dtype) -> torch.Tensor:
    """Build the base tensor of a new Array from user data."""
    dt = _dtypes.canonicalize(dtype) if dtype is not None else None
    if isinstance(data, torch.Tensor):
        buf = data.contiguous()
        return buf if dt is None else buf.to(dt)
    explicit = isinstance(data, np.ndarray)
    arr = np.asarray(data)
    if arr.dtype.name == "bfloat16":
        # numpy's bfloat16 is an extension dtype torch does not read; the
        # same 16 bits through uint16 keep the values and the dtype.
        bits = np.array(arr, order="C", copy=True).view(np.uint16)
        buf = torch.from_numpy(bits).view(torch.bfloat16).to(config.device)
        return buf if dt is None else buf.to(dt)
    if arr.dtype == object:
        raise ValueError(f"cannot build an Array from {type(data).__name__}")
    if dt is None and not explicit:
        # Lists and scalars default to the 32-bit types; pass dtype= or a
        # numpy array for 64-bit.
        if arr.dtype == np.float64:
            dt = torch.float32
        elif arr.dtype == np.int64:
            dt = torch.int32
    # A copy: the Array never aliases the caller's numpy buffer.
    buf = torch.from_numpy(np.array(arr, order="C", copy=True)).to(config.device)
    return buf if dt is None else buf.to(dt)


class Array:
    """N-dimensional array with NumPy broadcasting and aliasing views."""

    __slots__ = ("_storage", "_spec")

    def __init__(self, data: Any = None, dtype=None, *, _storage=None, _spec=None):
        if _storage is not None:
            self._storage = _storage
            self._spec = _spec
            return
        if isinstance(data, Array):
            buf = data.torch().clone()
            if dtype is not None:
                buf = buf.to(_dtypes.canonicalize(dtype))
        else:
            buf = _tensor_from(data, dtype)
        self._storage = _Storage(buf)
        self._spec = ViewSpec.identity(buf.shape)

    # ------------------------------------------------------------ metadata
    @property
    def shape(self) -> Tuple[int, ...]:
        return self._spec.shape

    @property
    def ndim(self) -> int:
        return self._spec.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self._storage.buf.dtype

    @property
    def device(self) -> torch.device:
        return self._storage.buf.device

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def total_size(self) -> int:
        return self.size

    totalSize = total_size

    @property
    def strides(self) -> Tuple[int, ...]:
        """Element strides over the base buffer (signed for negative steps)."""
        return self._spec.strides()

    @property
    def is_view(self) -> bool:
        return not self._spec.is_identity

    isView = is_view

    # --------------------------------------------------------- conversion
    def torch(self) -> torch.Tensor:
        """This array's values as a tensor: the buffer itself, or an
        aliasing torch view (a copy for negative steps)."""
        return self._spec.read(self._storage.buf)

    def _operand(self):
        """This array as a kernel operand: the base tensor, or a view read
        in place through (base, offset, signed strides)."""
        if self._spec.is_identity:
            return self._storage.buf
        from .ops import autodiff
        from .ops.elementwise import View

        if autodiff.transformed(self._storage.buf):
            return self.torch()  # a functorch wrapper is read through torch's views
        return View(self._storage.buf, self._spec.offset(), self.shape,
                    self._spec.strides())

    def _snapshot(self):
        """``_operand()`` for an op recorded now and computed later: the
        next write to the storage copies the buffer first."""
        self._storage.frozen = True
        return self._operand()

    def numpy(self) -> np.ndarray:
        t = self.torch().detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def item(self):
        return self.torch().item()

    def tolist(self):
        return self.numpy().tolist()

    def astype(self, dtype) -> "Array":
        return Array(self.torch().to(_dtypes.canonicalize(dtype), copy=True))

    def copy(self) -> "Array":
        return Array(self.torch().clone())

    # ----------------------------------------------------------- indexing
    def __getitem__(self, key) -> "Array":
        if _is_advanced_key(key):
            # NumPy advanced indexing returns a copy, never a view.  A
            # gather outside any kernel, as the JAX package's XLA gather.
            return Array(self.torch()[_advanced_key(key, self.device)].clone())
        key, newaxes = _split_newaxes(key, self.ndim)
        spec = self._spec.compose(_normalize_key(key, self.ndim))
        if newaxes:
            # np.newaxis inserts dims the view machinery cannot express; as
            # with ``reshape``, the result is a new array, not an alias.
            out = spec.read(self._storage.buf)
            for p in newaxes:
                out = out.unsqueeze(p)
            return Array(out.clone())
        return Array(_storage=self._storage, _spec=spec)

    def __setitem__(self, key, value) -> None:
        if _is_advanced_key(key):
            # The scatter runs on the view's values, which are then written
            # back through the view, so the update is visible to the parent
            # and to sibling views (NumPy's in-place semantics).
            if isinstance(value, Array):
                value = value.torch()
            cur = self.torch().clone()
            cur[_advanced_key(key, self.device)] = torch.as_tensor(
                value, device=self.device).to(cur.dtype)
            self._storage.thaw()
            self._spec.write(self._storage.buf, cur)
            return
        key, newaxes = _split_newaxes(key, self.ndim)
        spec = self._spec.compose(_normalize_key(key, self.ndim))
        if isinstance(value, Array):
            value = value.torch()
        if newaxes:
            value = torch.as_tensor(value)
            for p in reversed(newaxes):
                if value.ndim > len(spec.shape) and value.shape[p] == 1:
                    value = value.squeeze(p)
        self._storage.thaw()
        spec.write(self._storage.buf, value)

    def __call__(self, *args) -> Union["Array", Any]:
        """Reference-style access: all-int full index -> Python scalar;
        anything else -> aliasing view."""
        if (
            len(args) == self.ndim
            and args
            and all(isinstance(a, int) and not isinstance(a, bool) for a in args)
        ):
            return self[args].item()
        return self[tuple(args)] if args else self[...]

    def set(self, index, value) -> None:
        """Reference-style element assignment ``a(i,j) = v``."""
        self[index if isinstance(index, tuple) else (index,)] = value

    def fill(self, value) -> None:
        self[...] = value

    # --------------------------------------------------------- reshaping
    def transpose(self, *axes) -> "Array":
        """View-producing transpose over arbitrary axes."""
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        spec = self._spec.transpose(axes if axes else None)
        return Array(_storage=self._storage, _spec=spec)

    @property
    def T(self) -> "Array":
        return self.transpose()

    def reshape(self, *shape) -> "Array":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return Array(self.torch().clone().reshape(shape))

    def flatten(self) -> "Array":
        return Array(self.torch().clone().reshape(-1))

    def repeat(self, n: int, axis: int = None) -> "Array":
        """NumPy-semantics repeat (flat when ``axis`` is None)."""
        t = self.torch()
        if axis is None:
            t = t.reshape(-1)
            axis = 0
        return Array(torch.repeat_interleave(t, n, dim=axis))

    # --------------------------------------------------------- arithmetic
    def _binary(self, name: str, other, reverse: bool = False) -> "Array":
        from .ops import engine

        a, b = (other, self) if reverse else (self, other)
        return engine.binary(name, a, b)

    def __add__(self, o):
        return self._binary("add", o)

    def __radd__(self, o):
        return self._binary("add", o, True)

    def __sub__(self, o):
        return self._binary("subtract", o)

    def __rsub__(self, o):
        return self._binary("subtract", o, True)

    def __mul__(self, o):
        return self._binary("multiply", o)

    def __rmul__(self, o):
        return self._binary("multiply", o, True)

    def __truediv__(self, o):
        return self._binary("divide", o)

    def __rtruediv__(self, o):
        return self._binary("divide", o, True)

    def __floordiv__(self, o):
        return self._binary("floor_divide", o)

    def __rfloordiv__(self, o):
        return self._binary("floor_divide", o, True)

    def __mod__(self, o):
        return self._binary("remainder", o)

    def __rmod__(self, o):
        return self._binary("remainder", o, True)

    def __pow__(self, o):
        from .ops import engine

        return engine.pow(self, o)

    def __rpow__(self, o):
        from .ops import engine

        return engine.pow(o, self)

    def __neg__(self):
        from .ops import engine

        return engine.unary("negative", self)

    def __abs__(self):
        from .ops import engine

        return engine.unary("abs", self)

    def __matmul__(self, o):
        return self.dot(o)

    def __rmatmul__(self, o):
        from .ops import engine

        return engine.dot(o, self)

    def dot(self, other):
        """Dot product with ``numpy.dot`` semantics for every rank; views
        are read through their strides (ops/engine.py::dot)."""
        from .ops import engine

        return engine.dot(self, other)

    def __eq__(self, o):
        return self._binary("equal", o)

    def __ne__(self, o):
        return self._binary("not_equal", o)

    def __lt__(self, o):
        return self._binary("less", o)

    def __le__(self, o):
        return self._binary("less_equal", o)

    def __gt__(self, o):
        return self._binary("greater", o)

    def __ge__(self, o):
        return self._binary("greater_equal", o)

    def __hash__(self):
        return id(self)

    # --------------------------------------------------------- reductions
    def _reduce(self, kind: str, axis, keepdims):
        """``kind`` in sum/max/min/mean.  The map-reduce kernel takes full
        reductions and single-axis reductions of 2-D arrays of float32,
        bfloat16 and float16, as the JAX package sends every float type but
        float64 to its Pallas kernels: it accumulates in float32 and the
        result is cast to the input's type; a mean is the kernel's float32
        sum divided by the count in float32, then cast, as there.  Every other call runs as plain
        torch (``torch_path:<kind>``), where the JAX package runs XLA.  An
        array under a ``torch.func`` transform reduces through
        ``autodiff.Reduce``, the same kernel with derivative and batching
        rules (``reduction.run``)."""
        from .ops import reduction

        full = axis is None and not keepdims
        single = self.ndim == 2 and isinstance(axis, int) and -2 <= axis < 2
        if (self.dtype not in reduction.FLOAT_INPUTS or self.size == 0
                or not (full or single)):
            t = self.torch()
            if kind == "mean":
                return Array(reduction.torch_mean(t, axis, keepdims))
            return Array(reduction.torch_reduce(t, kind, axis, keepdims))
        op = "sum" if kind == "mean" else kind
        ax = None if full else axis % 2
        if full:
            out = reduction.reduce(self._operand(), op)
        else:
            out = reduction.reduce_axis(self._operand(), op, ax)
        count = self.size if full else self.shape[ax]
        if kind == "mean":
            out = reduction.divide(out, count)
        if keepdims:
            out = out.unsqueeze(ax)
        return Array(out.to(self.dtype))

    def sum(self, axis=None, keepdims=False):
        return self._reduce("sum", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce("mean", axis, keepdims)

    # ------------------------------------------------------------ display
    def to_string(self) -> str:
        return np.array2string(self.numpy(), separator=", ")

    def __str__(self) -> str:
        return self.to_string()

    def __repr__(self) -> str:
        return f"Array({self.to_string()}, dtype={_dtypes.name(self.dtype)})"

    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of unsized Array")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        return bool(self.item())

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())


def _flatten(a: Array):
    # Pytree protocol, as the JAX package's: the leaf is the materialized
    # buffer, and unflattening builds a fresh identity view, so a
    # transformed function sees value semantics.
    return [a.torch()], None


def _unflatten(children, _context) -> Array:
    return Array(children[0])


_pytree.register_pytree_node(Array, _flatten, _unflatten,
                             serialized_type_name="simplemath_tpu_torch.Array")


def asarray(x, dtype=None) -> Array:
    return x if isinstance(x, Array) and dtype is None else Array(x, dtype=dtype)
