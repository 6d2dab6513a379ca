#!/usr/bin/env python3
"""Time the port's tensor-core matmul kernels beside the library's calls on
one CUDA card.

    python3 tools/time_torch_matmul.py [--root DIR] [extra nvcc flags ...]

Builds the kernels of ``simplemath_tpu_torch`` (with any extra ``nvcc`` flags
given, for example a ``-D`` switch put into a source while trying a variant:
the loads-only, multiplies-only and store-only builds are made that way),
holds the bf16 product to its tolerance and the int8 product to exactness at
a few shapes, and prints device times (CUDA events, as
``chip_smoke.py::time_ms`` takes them) of the bare and the fused bf16 product
at 2048^3, (8, 1024, 1024) and 4096^3 beside ``torch.matmul``'s, and of the
int8 product (row-major, each operand a transposed view, one byte off, with
``scale=``, rank 3, 4096^3) beside ``torch._int_mm``'s, with the card's name
and power limit.  ``--root DIR`` takes the package and ``chip_smoke.py`` from
another checkout (the parent commit, unpacked beside this one), so that two
versions are timed in one call on one card.  It is a workbench for trying one
change to ``csrc/matmul_wgmma*.cu`` at a time; ``chip_smoke.py`` is the
check.  A build that compiles a part of a kernel out gives wrong products:
pass ``--no-check`` with it.  Imports no jax.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ARGS = sys.argv[1:]
ROOT = pathlib.Path(__file__).resolve().parent.parent
if "--root" in ARGS:
    i = ARGS.index("--root")
    ROOT = pathlib.Path(ARGS[i + 1]).resolve()
    del ARGS[i:i + 2]
CHECK = "--no-check" not in ARGS
ARGS = [a for a in ARGS if a != "--no-check"]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import simplemath_tpu_torch as sm  # noqa: E402
from simplemath_tpu_torch import _build  # noqa: E402
from simplemath_tpu_torch.ops import matmul, program  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("time_torch_matmul: no CUDA device is visible", file=sys.stderr)
        return 1
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + tuple(ARGS)
    _build.library()
    for line in _build.BUILD_LOG.splitlines():
        if "mm_wgmma" in line or ("Used" in line and "registers" in line) or "spill" in line:
            print("ptxas:", line.strip()[:160])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    dev, rng = torch.device("cuda"), np.random.default_rng(0)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev).bfloat16()

    def error(a, b):
        """Largest error against float64, in units of 2e-5 * (|A| @ |B|)."""
        k = matmul.matmul(a, b, torch.float32).double()
        a64, b64 = a.double(), b.double()
        return float(((k - a64 @ b64).abs() / (2e-5 * (a64.abs() @ b64.abs()))).max())

    errors = {
        "16-byte copies, ragged": error(bf16(300, 272)[:, :270], bf16(270, 520)[:, :515]),
        "transposed views": error(bf16(270, 304).T[:300], bf16(515, 270).T),
        "element by element": error(bf16(300, 270), bf16(270, 515)),
        "2048^3": error(bf16(2048, 2048), bf16(2048, 2048)),
    }
    def i8(dtype, *shape):
        info = np.iinfo(dtype)
        return torch.from_numpy(rng.integers(info.min, info.max + 1, shape).astype(dtype)).to(dev)

    def wrong(a, b):
        """Elements of the int8 product that differ from the exact one."""
        return int((matmul.matmul(a, b, torch.int32) != matmul.int_product(a, b)).sum())

    errors.update({
        "int8 @ uint8, 16-byte reads, ragged": wrong(i8("int8", 300, 272)[:, :270],
                                                     i8("uint8", 270, 528)[:, :515]),
        "uint8 @ int8, transposed views": wrong(i8("uint8", 270, 304).T[:300], i8("int8", 515, 272).T[:270]),
        "int8, byte by byte": wrong(i8("int8", 300, 270), i8("int8", 270, 515)),
        "int8 2048^3": wrong(i8("int8", 2048, 2048), i8("int8", 2048, 2048)),
    })
    if CHECK and max(errors.values()) > 1.0:
        print(f"time_torch_matmul: beyond tolerance: {errors}", file=sys.stderr)
        return 1

    n = 2048
    x, w = bf16(n, n), bf16(n, n)
    x3, w3 = bf16(8, 1024, 1024), bf16(8, 1024, 1024)
    x4, w4 = bf16(4096, 4096), bf16(4096, 4096)
    bias = bf16(1, n)
    bias3 = bias.reshape(1, 1, n)[:, :, :1024]

    def relu_bias(shape, extra):
        acc, leaf = program.leaf(shape, torch.float32), program.leaf(extra, torch.bfloat16)
        return program.lower_epilogue(sm.maximum(acc + leaf, 0.0) * (1.0 / n) - 0.5, acc, [leaf])

    epi, epi3 = relu_bias((n, n), (1, n)), relu_bias((8, 1024, 1024), (1, 1, 1024))
    t = chip_smoke.time_ms
    times = {
        "mm_ms": t(lambda: matmul.matmul(x, w, torch.bfloat16), n=20),
        "mm_library_ms": t(lambda: torch.matmul(x, w), n=20),
        "mm_f32_out_ms": t(lambda: matmul.matmul(x, w, torch.float32), n=20),
        "mm_a_transposed_ms": t(lambda: matmul.matmul(x.T, w, torch.bfloat16), n=20),
        "mm_b_transposed_ms": t(lambda: matmul.matmul(x, w.T, torch.bfloat16), n=20),
        "mm_fused_ms": t(lambda: matmul.matmul(x, w, torch.bfloat16, epilogue=epi, extras=[bias]), n=10),
        "bmm_ms": t(lambda: matmul.matmul(x3, w3, torch.bfloat16), n=20),
        "bmm_library_ms": t(lambda: torch.matmul(x3, w3), n=20),
        "bmm_fused_ms": t(lambda: matmul.matmul(x3, w3, torch.bfloat16, epilogue=epi3, extras=[bias3]), n=10),
        "mm_4096_ms": t(lambda: matmul.matmul(x4, w4, torch.bfloat16), n=5),
        "mm_4096_library_ms": t(lambda: torch.matmul(x4, w4), n=5),
    }
    q, w8 = i8("int8", n, n), i8("int8", n, n)
    q3, w83 = i8("int8", 8, 1024, 1024), i8("int8", 8, 1024, 1024)
    q4, w84 = i8("int8", 4096, 4096), i8("int8", 4096, 4096)
    scale = torch.from_numpy(np.abs(rng.standard_normal((1, n))).astype(np.float32)).to(dev)
    int_mm = getattr(torch, "_int_mm", None)
    times.update({
        "int8_ms": t(lambda: matmul.matmul(q, w8, torch.int32), n=20),
        "int8_library_ms": t(lambda: int_mm(q, w8), n=20) if int_mm else None,
        "int8_b_transposed_ms": t(lambda: matmul.matmul(q, w8.T, torch.int32), n=20),
        "int8_a_transposed_ms": t(lambda: matmul.matmul(q.T, w8, torch.int32), n=20),
        "int8_one_byte_off_ms": t(lambda: matmul.matmul(q[:, 1:], w8[1:], torch.int32), n=5),
        "int8_scaled_ms": t(lambda: matmul.int8_matmul(q, w8, scale=scale), n=20),
        "int8_bmm_ms": t(lambda: matmul.matmul(q3, w83, torch.int32), n=20),
        "int8_4096_ms": t(lambda: matmul.matmul(q4, w84, torch.int32), n=5),
        "int8_4096_library_ms": t(lambda: int_mm(q4, w84), n=5) if int_mm else None,
    })
    print(f"{card}: " + json.dumps({"root": str(ROOT), "flags": ARGS,
                                    "errors_of_tolerance": errors, **times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
