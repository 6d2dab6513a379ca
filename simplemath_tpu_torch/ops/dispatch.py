"""Kernel-dispatch observability.

Counterpart of ``simplemath_tpu/ops/dispatch.py`` with the same counter
names, so tests can compare the two packages' counts for the same program:

* ``"engine:<op>"``, ``"elementwise:<op>"``, ``"elementwise:fused"``: the
  engine and the elementwise kernel's wrapper;
* ``"reduce:<kind>"``, ``"dot1d"``, ``"reduce_fused:<kind>"``,
  ``"reduce_axis:<kind><axis>"``: the map-reduce kernel's wrapper;
* ``"matmul:mm"``, ``"matmul:bmm"`` (a rank-2 or rank-3 product),
  ``"matmul:mm_epilogue"``, ``"matmul:bmm_epilogue"`` (recorded beside the
  former when the call carries an epilogue) and ``"matmul:int8"``
  (``int8_matmul``): the matmul kernel's wrapper.

The port adds one kind: ``"torch_path:<name>"`` records a call that ran as
plain PyTorch because no kernel takes its signature (float64, int64,
bfloat16 elementwise, a float ``dot``/``matmul``, ``matmul_epilogue`` of a
fused root the kernel does not take, ...), so no such call is silent.

Counting happens per call: one increment per eager op, per flushed lazy
chain and per fused call.  The wrappers' launch counts (kernel launches on
the card only) are ``LAUNCHES`` in ``ops.elementwise``, ``ops.reduction``,
``ops.matmul`` and ``ops.linalg_small``.

``INTERPRET`` is true only inside ``utils.debug.interpret_kernels()``:
every kernel wrapper then runs its plain version on CUDA tensors too,
counted as ``"interpret:<family>"``.  It is not a ``config`` field, so no
setting of the process can send card tensors to the plain versions.
"""

from __future__ import annotations

import collections
import contextvars
from typing import Dict

_COUNTS: collections.Counter = collections.Counter()
INTERPRET: contextvars.ContextVar = contextvars.ContextVar("interpret_kernels", default=False)


def record(kind: str, name: str = "") -> None:
    """Record one dispatch, e.g. record("elementwise", "add")."""
    _COUNTS[f"{kind}:{name}" if name else kind] += 1


def counts() -> Dict[str, int]:
    """Snapshot of dispatch counts since the last reset."""
    return dict(_COUNTS)


def count(kind: str, name: str = "") -> int:
    return _COUNTS[f"{kind}:{name}" if name else kind]


def reset() -> None:
    _COUNTS.clear()
