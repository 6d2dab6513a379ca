"""Utilities of the port.  Counterpart of ``simplemath_tpu/utils/``, with its
public names: profiling and tracing (``benchmark``, ``trace``,
``annotate``), metrics (``MetricsLogger``), ``checkpoint``, ``export``
(``torch.export`` artifacts with the kernels as ``sm::*`` ops), elastic
execution (``run_elastic``), plus ``debug``, the solvers' float32 matmul
pin (``precision.f32_matmuls``) and their compiled programs as CUDA graphs
(``graphs``: ``jax.jit`` and ``lax.scan``'s counterparts)."""

from .precision import f32_matmuls  # noqa: F401
from .profiling import BenchResult, annotate, benchmark, trace  # noqa: F401
from .metrics import MetricsLogger  # noqa: F401
from . import checkpoint  # noqa: F401
from . import debug  # noqa: F401
from . import export  # noqa: F401
from . import graphs  # noqa: F401
from .elastic import (  # noqa: F401
    ElasticConfig,
    RestartBudgetExceeded,
    StateCorruption,
    resume_state,
    run_elastic,
)
