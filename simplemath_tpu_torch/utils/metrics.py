"""Structured solver metrics / logging.

Counterpart of ``simplemath_tpu/utils/metrics.py``: a lightweight recorder
of per-iteration solver statistics (cost, step size, KKT residual) with
JSONL export.  Host-side: a tensor on the card is copied to the host at
the logging point, which is the one sync a log call costs.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List

import numpy as np
import torch


def _host(v):
    """``v`` as a numpy value: a tensor (on any device) is copied to the
    host first, since ``np.asarray`` of a CUDA tensor raises."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class MetricsLogger:
    def __init__(self, name: str = "solver"):
        self.name = name
        self.records: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()

    def log(self, step: int, **metrics) -> None:
        rec = {"name": self.name, "step": step, "t": time.perf_counter() - self._t0}
        for k, v in metrics.items():
            if hasattr(v, "item"):
                arr = _host(v)
                v = arr.item() if arr.ndim == 0 else arr.tolist()
            rec[k] = v
        self.records.append(rec)

    def log_ilqr_result(self, step: int, result) -> None:
        """Record an ILQRResult's convergence trace."""
        trace = _host(result.cost_trace)
        self.log(
            step,
            cost=float(np.min(trace[-1])) if trace.ndim else float(trace),
            cost_trace=trace.tolist() if trace.ndim == 1 else None,
            grad_norm=float(np.max(_host(result.grad_norm))),
        )

    def summary(self) -> Dict[str, Any]:
        if not self.records:
            return {}
        last = self.records[-1]
        return {k: v for k, v in last.items() if k not in ("name", "t")}

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec) + "\n")

    def __len__(self) -> int:
        return len(self.records)
