"""Build and load the CUDA kernels.

The kernels are compiled by ``nvcc`` at first use into ``build/kernels/``
beside the package (a directory ``.gitignore`` lists), as a shared library
with a plain C interface loaded with ``ctypes``: one ``nvcc -c`` per source,
all started together, then one link.  The library's name carries a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is reused.  A failed build raises with nvcc's output.  The library links
NVRTC (``csrc/nvrtc.cu``), which compiles the kernels that
``ops/codegen.py`` generates at run time; their CUBINs are cached under
``build/kernels/generated/``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("elementwise.cu", "reduction.cu", "reduction_full.cu", "reduction_cols.cu",
           "reduction_rows.cu", "matmul.cu", "matmul_elem.cu", "matmul_wgmma.cu",
           "matmul_wgmma_s8.cu", "nvrtc.cu")
HEADERS = ("tiles.cuh", "program.cuh", "reduction.cuh", "matmul.cuh", "matmul_fma.cuh",
           "wgmma.cuh")
# sm_90a: Hopper.  No --use_fast_math (it flushes subnormals to zero, and
# the crafted exp/log handle them); --fmad=false so each float operation
# rounds once, as the plain torch version does (the matmul kernel's inner
# product asks for its fused multiply-add by name).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas=-v",
)

# What the last build printed (register and spill counts from -Xptxas -v)
# and how long it took; empty/None when the library was already built.
BUILD_LOG = ""
BUILD_SECONDS = None


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [pathlib.Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(pathlib.Path(found))
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built if needed."""
    global BUILD_LOG, BUILD_SECONDS
    path = BUILD_DIR / f"libsm_kernels_{_digest()}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            objs = [os.path.join(tmpdir, f"{s}.o") for s in SOURCES]
            procs = [
                (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
                for cmd in (
                    [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj, str(CSRC / s)]
                    for s, obj in zip(SOURCES, objs)
                )
            ]
            logs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
            so = os.path.join(tmpdir, "lib.so")
            # NVRTC from the toolkit beside nvcc, found there at run time too.
            lib64 = pathlib.Path(nvcc()).resolve().parent.parent / "lib64"
            link = [nvcc(), "-shared", *NVCC_FLAGS[:2], "-o", so, *objs, "-lnvrtc",
                    "-Xlinker", f"-rpath,{lib64}"]
            if all(rc == 0 for _, _, rc in logs):
                proc = subprocess.run(link, capture_output=True, text=True)
                logs.append((link, proc.stdout + proc.stderr, proc.returncode))
            for cmd, out, rc in logs:
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
            BUILD_SECONDS = time.perf_counter() - t0
            BUILD_LOG = "".join(out for _, out, _ in logs)
            os.replace(so, path)  # atomic: a concurrent build never sees half a file
    lib = ctypes.CDLL(str(path))
    void_p, c_int = ctypes.c_void_p, ctypes.c_int
    for name, args in (
        ("sm_ew_launch", [void_p, void_p, c_int, void_p]),
        ("sm_rd_full_launch", [void_p, void_p, void_p, void_p]),
        ("sm_rd_axis_launch", [void_p, void_p, void_p, void_p]),
        ("sm_mm_launch", [void_p, void_p, void_p]),
        ("sm_mm_wgmma_launch", [void_p, void_p, void_p]),
        ("sm_mm_wgmma_s8_launch", [void_p, void_p, void_p]),
        ("sm_ew_launch_kernel", [void_p, void_p, void_p, void_p]),
        ("sm_rtc_compile", [ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p), c_int,
                            ctypes.c_char_p, c_int, ctypes.POINTER(void_p),
                            ctypes.POINTER(ctypes.c_size_t)]),
        ("sm_rtc_load", [void_p, ctypes.c_char_p, ctypes.POINTER(void_p),
                         ctypes.POINTER(void_p)]),
        ("sm_rtc_unload", [void_p]),
        ("sm_ew_params_size", []),
        ("sm_rd_params_size", []),
        ("sm_mm_params_size", []),
    ):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = c_int
    lib.sm_rtc_free.argtypes = [void_p]
    lib.sm_rtc_free.restype = None
    return lib
