"""Runtime configuration for simplemath_tpu_torch.

Counterpart of ``simplemath_tpu/config.py``.  What the TPU needed and the
card does not is gone: the Pallas interpret flag, the VMEM tile sizes, the
complex64 tunnel probe, and the ``pallas_min_elements`` size gate with its
``"xla"``/``"pallas"`` routing (those were measured on a TPU; on a CUDA
tensor every signature the kernel takes launches the kernel, whatever its
size).  New here is ``device``: arrays are created on it and never moved.
It is the card by default.
"""

from __future__ import annotations

import dataclasses
import os


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


@dataclasses.dataclass
class Config:
    # Kernel routing.  Only "auto": the hand-written kernels for every
    # signature they take on a CUDA tensor, their plain PyTorch versions on
    # a CPU tensor, plain PyTorch for the dtypes the kernels do not take.
    kernel_backend: str = "auto"

    # Transcendental implementation: "auto" and "crafted" both resolve to
    # the crafted fdlibm-style f32 implementations (ops/transcendental.py).
    # The JAX package's per-op "auto" table was chosen by accuracy measured
    # on a TPU, so the port starts crafted everywhere.
    transcendental_impl: str = dataclasses.field(
        default_factory=lambda: _env_str("SM_TRANSCENDENTAL", "auto")
    )

    # Deferred-eager elementwise queue (ops/lazy.py): eager op chains record
    # an expression and flush as ONE kernel launch on materialization.
    deferred_eager: bool = dataclasses.field(
        default_factory=lambda: _env_str("SM_DEFERRED_EAGER", "1") not in ("", "0")
    )

    # Debug-mode numerical guards: the solvers' unrolled inverses
    # (ops/linalg_small.py, ops/soa.py) raise FloatingPointError on a
    # non-finite result instead of letting NaN propagate.  Off, they add
    # no work and no host sync.
    debug_checks: bool = dataclasses.field(
        default_factory=lambda: _env_str("SM_DEBUG_CHECKS", "") not in ("", "0")
    )

    # Device new arrays are created on ("cuda", "cuda:1", "cpu", ...): the
    # card, unless the caller asks for the CPU (SM_DEVICE=cpu, or
    # ``configure(device="cpu")``).  Nothing probes for a card: without one,
    # creating an array on the default device raises torch's own error.
    device: str = dataclasses.field(
        default_factory=lambda: _env_str("SM_DEVICE", "cuda")
    )

    # Default mesh axis name of the distributed layer (parallel/): the
    # scenario axis of the batched solvers.
    data_axis: str = "scenario"

    def __post_init__(self):
        _check(self)


def _check(cfg: Config) -> None:
    if cfg.kernel_backend != "auto":
        raise ValueError(
            f"kernel_backend must be 'auto', got {cfg.kernel_backend!r}"
        )
    if cfg.transcendental_impl not in ("auto", "crafted"):
        raise ValueError(
            "transcendental_impl must be 'auto' or 'crafted', got "
            f"{cfg.transcendental_impl!r}"
        )


config = Config()


def update(**kwargs) -> Config:
    """Update global config fields; returns the config for chaining."""
    for k, v in kwargs.items():
        if not hasattr(config, k):
            raise AttributeError(f"unknown config field {k!r}")
        setattr(config, k, v)
    _check(config)
    return config
