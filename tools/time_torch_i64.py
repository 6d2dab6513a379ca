#!/usr/bin/env python3
"""Time variants of the 64-bit product's kernel source on one CUDA card.

    python3 tools/time_torch_i64.py [VARIANT ...]

A VARIANT is ``[SOURCE][|FLAG,FLAG...]``: a copy of
``simplemath_tpu_torch/csrc/matmul_wgmma_i64.cu`` (the package's own when
empty) and extra ``nvcc`` flags, for example a ``-D`` switch put into the
source while trying a change (its loads or its multiplies compiled out)::

    python3 tools/time_torch_i64.py "" "|-DSOME_SWITCH" "build/old_i64.cu|"

Each variant's source is compiled alone (a few seconds; all side by side)
into a library of its own with the package's ``nvcc`` flags, and driven
through its C entry point with the wrapper's parameter block.  Each is held
to the CPU's int64 product at 2048^3, 512^3, (130, 200) @ (200, 129), rank
3 and all-ones at K = 40,000 (a variant with ``-D..._NO_`` in its flags
compiles a part out and is not held), then timed at 2048^3 and 512^3 on
full-range int64 operands, in turns (1, 2, .., 2, 1, twice; the medians,
CUDA events as ``chip_smoke.py::time_ms`` takes them, split passes
included), and each kernel's device time per call at 2048^3 from
``torch.profiler``.  Prints ptxas' registers and spills of every kernel and
the card's name and power limit.  Imports no jax.
"""

import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))


def main():
    import torch

    import chip_smoke
    from simplemath_tpu_torch import _build
    from simplemath_tpu_torch.ops import matmul

    if not torch.cuda.is_available():
        print("time_torch_i64: no CUDA device is visible", file=sys.stderr)
        return 1
    variants = []
    for v in sys.argv[1:] or [""]:
        path, _, flags = v.partition("|")
        variants.append((path or str(_build.CSRC / "matmul_wgmma_i64.cu"),
                         [f for f in flags.split(",") if f]))
    out_dir = HERE / "build" / "i64_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for i, (path, flags) in enumerate(variants):
        so = out_dir / f"variant_{i}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(_build.CSRC), "-shared",
               "-o", str(so), path]
        procs.append((so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True)))
    libs = []
    for i, (so, proc) in enumerate(procs):
        log = proc.communicate()[0]
        print(f"variant {i} {variants[i]}: nvcc exit {proc.returncode} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        for name, props in _build.ptxas(log).items():
            print(f"  ptxas {name[-48:]}: {props}")
        for line in log.splitlines():
            if "error" in line.lower() or "warning" in line.lower() or "Performance Loss" in line:
                print("  " + line[:240])
        if proc.returncode != 0:
            return 1
        lib = ctypes.CDLL(str(so))
        lib.sm_mm_wgmma_i64_launch.argtypes = [ctypes.c_void_p] * 4
        lib.sm_mm_wgmma_i64_launch.restype = ctypes.c_int
        lib.sm_mm_wgmma_i64_scratch.argtypes = [ctypes.c_longlong] * 4
        lib.sm_mm_wgmma_i64_scratch.restype = ctypes.c_longlong
        libs.append(lib)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda")

    def launcher(lib, a, b):
        """A call of the variant's product of ``a`` and ``b``, as the wrapper
        makes it (ops/matmul.py::_launch)."""
        B, M, N, K = matmul.product_shape(a.shape, b.shape)
        batched = len(a.shape) == 3
        out = torch.empty((B, M, N) if batched else (M, N), dtype=torch.int64, device=dev)
        q = matmul._MmParams()
        matmul._set_operand(q.a, a, batched, 2, "wgmma_i64")
        matmul._set_operand(q.b, b, batched, 1, "wgmma_i64")
        q.B, q.M, q.N, q.K = B, M, N, K
        q.int_acc, q.out_dtype = matmul._ACC_CODE[torch.int64], matmul._DTYPE_CODE[torch.int64]
        planes = torch.empty(lib.sm_mm_wgmma_i64_scratch(B, M, N, K), dtype=torch.uint8, device=dev)

        def run():
            rc = lib.sm_mm_wgmma_i64_launch(ctypes.byref(q), out.data_ptr(), planes.data_ptr(),
                                            torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: cudaError {rc}")
            return out
        return run

    rng = np.random.default_rng(1)

    def r64(*shape):
        return torch.from_numpy(rng.integers(-2**63, 2**63 - 1, shape, dtype=np.int64)).to(dev)

    big, small = (r64(2048, 2048), r64(2048, 2048)), (r64(512, 512), r64(512, 512))
    ones = (torch.full((5, 40000), -1, dtype=torch.int64, device=dev),
            torch.full((40000, 7), -1, dtype=torch.int64, device=dev))
    cases = [big, small, (r64(130, 200), r64(200, 129)), (r64(3, 70, 33), r64(3, 33, 136)), ones]
    wants = [torch.matmul(a.cpu(), b.cpu()) for a, b in cases]
    for i, lib in enumerate(libs):
        exact = all(torch.equal(launcher(lib, a, b)().cpu(), w) for (a, b), w in zip(cases, wants))
        held = not any("_NO_" in f for f in variants[i][1])
        print(f"variant {i}: exact {exact}{'' if held else ' (not held)'}", flush=True)
        if held and not exact:
            return 1
    times = {i: {"2048": [], "512": []} for i in range(len(libs))}
    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    for _ in range(2):
        for i in order:
            times[i]["2048"].append(chip_smoke.time_ms(launcher(libs[i], *big), n=5))
            times[i]["512"].append(chip_smoke.time_ms(launcher(libs[i], *small), n=20))
    from torch.profiler import ProfilerActivity, profile

    for i, lib in enumerate(libs):
        run = launcher(lib, *big)
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                run()
            torch.cuda.synchronize()
        kernels = {(re.search(r"\w+_kernel", e.key) or re.search(r"\w+", e.key)).group(0):
                   e.device_time_total / e.count
                   for e in prof.key_averages() if e.device_time_total > 0}
        print(json.dumps({"variant": i, "source": variants[i][0], "flags": variants[i][1],
                          "ms_2048": statistics.median(times[i]["2048"]),
                          "ms_512": statistics.median(times[i]["512"]),
                          "kernel_us_2048": kernels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
