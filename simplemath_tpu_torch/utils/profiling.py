"""Profiling / tracing utilities.

Counterpart of ``simplemath_tpu/utils/profiling.py``: wall timers with a
device sync, ``torch.profiler`` trace capture (Chrome / Perfetto format),
and roofline math that scores a call against the device memory's rate.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Optional

import torch

from ..config import config

# Device memory bandwidth (bytes/s) for roofline scoring, by device name
# (lower case).  H100 SXM: 3.35 TB/s (NVIDIA's data sheet), the figure
# PERF.md and chip_smoke.py use.  The CPU entry is a nominal host figure.
HBM_BANDWIDTH = {
    "h100 80gb hbm3": 3.35e12,
    "cpu": 50e9,
}


def hbm_bandwidth_bytes_per_s(device=None) -> float:
    """The memory rate of ``device`` (``config.device`` by default): the
    card's by its name, 50e9 for the CPU.  A card not in
    ``HBM_BANDWIDTH`` raises: its rate is not known here."""
    dev = torch.device(device if device is not None else config.device)
    if dev.type == "cpu":
        return HBM_BANDWIDTH["cpu"]
    name = torch.cuda.get_device_name(dev).lower()
    for key, bw in HBM_BANDWIDTH.items():
        if key in name:
            return bw
    raise ValueError(f"no memory bandwidth known for {name!r}; add it to HBM_BANDWIDTH")


@dataclasses.dataclass
class BenchResult:
    median_s: float
    best_s: float
    times_s: list
    bytes_moved: Optional[int] = None
    flops: Optional[int] = None

    @property
    def gbps(self) -> Optional[float]:
        if self.bytes_moved is None:
            return None
        return self.bytes_moved / self.median_s / 1e9

    @property
    def roofline_fraction(self) -> Optional[float]:
        """Fraction of the memory's speed of light achieved (memory-bound
        calls)."""
        if self.bytes_moved is None:
            return None
        return (self.bytes_moved / self.median_s) / hbm_bandwidth_bytes_per_s()

    @property
    def tflops(self) -> Optional[float]:
        if self.flops is None:
            return None
        return self.flops / self.median_s / 1e12


def _sync() -> None:
    if torch.device(config.device).type == "cuda":
        torch.cuda.synchronize()


def benchmark(
    fn: Callable,
    *args,
    warmup: int = 2,
    repeats: int = 5,
    bytes_moved: Optional[int] = None,
    flops: Optional[int] = None,
) -> BenchResult:
    """Time fn(*args), each call ended by a device synchronize (none on the
    CPU); median of the repeats."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    st = sorted(times)
    return BenchResult(
        median_s=st[len(st) // 2],
        best_s=st[0],
        times_s=times,
        bytes_moved=bytes_moved,
        flops=flops,
    )


@contextlib.contextmanager
def trace(log_dir: str = "sm_trace"):
    """Capture a ``torch.profiler`` trace of the CPU and, where there is a
    card, the CUDA activity; on exit it is written to ``log_dir`` as a
    Chrome trace (``trace.json``; open it in Perfetto).  Yields the
    profiler, whose ``key_averages()`` sums the time by op and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region that shows up in profiler traces (and, with a card, as
    an NVTX range)."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield
