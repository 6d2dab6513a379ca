"""Failure detection and elastic (checkpoint/resume) execution of long runs.

Counterpart of ``simplemath_tpu/utils/elastic.py``, line for line: long
batched-MPC / solver runs must survive the loss of the device or the
process and detect silent state corruption.

Design (host-side driver, device-side compute):

- The run is split into *segments* of ``checkpoint_every`` steps.  Each
  segment runs on the device; at segment boundaries the state is synced
  once, validated, and checkpointed via :mod:`.checkpoint` with atomic
  latest-marker rotation, so a kill at any instant leaves a consistent
  resumable state.
- **Failure detection** covers two failure classes:
  (1) *device/runtime failure* (a CUDA error, out of memory, an injected
  preemption) surfaces as a ``RuntimeError`` from the step call; it is
  caught, counted, and retried from the last good checkpoint up to
  ``max_restarts`` times;
  (2) *state corruption* (NaN/inf from a diverging solver or flaky memory)
  is caught by a finiteness sweep over the state pytree at each boundary;
  a corrupt segment is rolled back and re-run, and if corruption repeats
  deterministically it is reported as :class:`StateCorruption` rather than
  silently re-looped.
- **Fault injection** for tests: ``inject_fault(step) -> None`` may raise
  (simulated preemption) or return a corrupting transform (simulated bad
  memory); the determinism contract is that a faulted+resumed run produces
  bitwise the same final state as an uninterrupted one.

Resume across *processes* works the same way: call :func:`resume_state`
with the checkpoint dir, get ``(state, step)`` back, and continue with
``run_elastic(..., start_step=step, init_state=state)``.
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch
from torch.utils import _pytree

from . import checkpoint as ckpt


class StateCorruption(RuntimeError):
    """State failed the finiteness sweep twice at the same step — the
    corruption is deterministic (a solver divergence, not a transient)."""


class RestartBudgetExceeded(RuntimeError):
    """More device failures than ``max_restarts`` — give up, checkpoint is
    intact on disk for an out-of-process resume."""


@dataclass
class ElasticConfig:
    directory: str
    checkpoint_every: int = 10
    max_restarts: int = 3
    keep: int = 2  # checkpoint rotation depth


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:012d}")


def _latest_marker(directory: str) -> str:
    return os.path.join(directory, "LATEST.json")


def save_state(directory: str, state: Any, step: int, keep: int = 2) -> None:
    """Checkpoint ``state`` at ``step`` with an atomic latest marker.

    The marker is written to a temp file and ``os.replace``d so a crash
    mid-save never leaves LATEST pointing at a half-written checkpoint."""
    path = _ckpt_path(directory, step)
    ckpt.save(path, state, metadata={"step": step})
    tmp = _latest_marker(directory) + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": step, "path": path}, f)
    os.replace(tmp, _latest_marker(directory))
    # Rotate: drop everything but the newest `keep` checkpoints.
    steps = sorted(
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and os.path.isdir(os.path.join(directory, d))
    )
    for old in steps[:-keep]:
        shutil.rmtree(_ckpt_path(directory, old), ignore_errors=True)


def resume_state(directory: str, like: Any) -> Optional[Tuple[Any, int]]:
    """Load the latest valid checkpoint, or None if none exists."""
    marker = _latest_marker(directory)
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        info = json.load(f)
    state = ckpt.restore(info["path"], like=like)
    return state, int(info["step"])


def _tensors(state):
    return [x for x in _pytree.tree_leaves(state) if isinstance(x, torch.Tensor)]


def synchronize(state: Any) -> Any:
    """Wait for the cards that hold ``state``'s tensors; returns ``state``."""
    for dev in {t.device for t in _tensors(state) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return state


def state_is_finite(state: Any) -> bool:
    """Finiteness sweep over every floating leaf (one host sync)."""
    flags = [torch.isfinite(t).all().cpu() for t in _tensors(state)
             if t.is_floating_point() or t.is_complex()]
    return not flags or bool(torch.stack(flags).all())


def run_elastic(
    step_fn: Callable[[Any, int], Any],
    init_state: Any,
    n_steps: int,
    config: ElasticConfig,
    start_step: int = 0,
    inject_fault: Optional[Callable[[int], Optional[Callable[[Any], Any]]]] = None,
    on_segment: Optional[Callable[[int, Any], None]] = None,
) -> Any:
    """Run ``state = step_fn(state, step)`` for steps [start_step, n_steps)
    with checkpointing, failure detection, and automatic restart.

    ``step_fn`` is pure, so re-running a segment after a failure is exact.
    Returns the final state.  Raises :class:`RestartBudgetExceeded` or
    :class:`StateCorruption`; in both cases the last good checkpoint is on
    disk and :func:`resume_state` picks it up."""
    os.makedirs(config.directory, exist_ok=True)
    resumed = resume_state(config.directory, like=init_state)
    if resumed is not None and resumed[1] > start_step:
        state, step = resumed
        if step > n_steps:
            raise ValueError(
                f"checkpoint in {config.directory} is at step {step}, beyond "
                f"the requested n_steps={n_steps}; refusing to return an "
                f"overshot state — pass a larger n_steps or a fresh directory"
            )
    else:
        state, step = init_state, start_step
        save_state(config.directory, state, step, keep=config.keep)

    restarts = 0
    corrupt_at: Optional[int] = None
    while step < n_steps:
        seg_end = min(step + config.checkpoint_every, n_steps)
        good_state, good_step = state, step
        try:
            s = state
            for i in range(step, seg_end):
                if inject_fault is not None:
                    corrupter = inject_fault(i)
                    if corrupter is not None:
                        s = corrupter(s)
                s = step_fn(s, i)
            # One sync point per segment: synchronize + validate + checkpoint.
            s = synchronize(s)
            if not state_is_finite(s):
                if corrupt_at == step:
                    raise StateCorruption(
                        f"non-finite state at step {seg_end} twice in a row "
                        f"(deterministic divergence); last good checkpoint "
                        f"at step {good_step}"
                    )
                corrupt_at = step
                state, step = good_state, good_step  # roll back, re-run
                continue
            corrupt_at = None
            state, step = s, seg_end
            save_state(config.directory, state, step, keep=config.keep)
            if on_segment is not None:
                on_segment(step, state)
        except StateCorruption:
            raise
        except RuntimeError as e:
            # Device/runtime failure (a CUDA error, out of memory, or an
            # injected fault).  Resume from the last on-disk checkpoint —
            # NOT from `good_state`, which may live on the failed device.
            # The restart resets the corruption-attempt history: a transient
            # corruption seen after the restart is a fresh first detection,
            # not a repeat of one seen before the failure.
            corrupt_at = None
            restarts += 1
            if restarts > config.max_restarts:
                raise RestartBudgetExceeded(
                    f"{restarts - 1} restarts exhausted (last error: {e}); "
                    f"resume from {config.directory}"
                ) from e
            resumed = resume_state(config.directory, like=init_state)
            if resumed is None:  # pragma: no cover - save happens first
                raise
            state, step = resumed
    return state
