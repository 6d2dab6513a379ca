"""Build and load the CUDA kernels.

The kernels are compiled by ``nvcc`` at first use into ``build/kernels/``
beside the package (a directory ``.gitignore`` lists), as a shared library
with a plain C interface loaded with ``ctypes``: one ``nvcc -c`` per unit
(``units``: a source, or a group of the PSD projection's thread-path
instantiations), all started together, then one link.  The library's name carries a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is reused.  A failed build raises with nvcc's output.  The library opens
the NVRTC of nvcc's toolkit by its path (``csrc/nvrtc.cu``), which compiles
the kernels that ``ops/codegen.py`` generates at run time; their CUBINs are
cached under ``build/kernels/generated/``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("elementwise.cu", "reduction.cu", "reduction_full.cu", "reduction_cols.cu",
           "reduction_rows.cu", "matmul.cu", "matmul_elem.cu", "matmul_wgmma.cu",
           "matmul_wgmma_s8.cu", "matmul_wgmma_i64.cu", "nvrtc.cu", "psd_project.cu",
           "psd_thread.cu")
HEADERS = ("tiles.cuh", "program.cuh", "reduction.cuh", "matmul.cuh", "matmul_fma.cuh",
           "wgmma.cuh", "matmul_wgmma.cuh", "matmul_wgmma_s8.cuh", "psd_project.cuh")
# Built for groups of the PSD projection's thread-path instantiations: the n
# below PSD_ALONE of a type in one unit (each takes nvcc seconds, most of
# them the same for any n), each larger n, whose ptxas takes the longest, in
# a unit of its own.
PER_INSTANTIATION = "psd_thread.cu"
PSD_ALONE = 8
# sm_90a: Hopper.  No --use_fast_math (it flushes subnormals to zero, and
# the crafted exp/log handle them); --fmad=false so each float operation
# rounds once, as the plain torch version does (the matmul kernel's inner
# product asks for its fused multiply-add by name).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas=-v",
)

# What the last build printed (register and spill counts from -Xptxas -v),
# how long it took, and each unit's seconds (its nvcc, started beside the
# others); empty/None when the library was already built.  The log is also
# kept beside the library (``log()``).
BUILD_LOG = ""
BUILD_SECONDS = None
UNIT_SECONDS: dict = {}
# The version of the NVRTC that compiles the generated kernels
# (``major * 1000 + minor * 10``, as cudaRuntimeGetVersion gives CUDA's),
# set when the library is loaded.
NVRTC_VERSION = None


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


def _psd_nreg(flags) -> dict:
    """The thread path's largest n of each type: ``-DPSD_NREG_F32=`` and
    ``-DPSD_NREG_F64=`` among ``flags``, else psd_project.cuh's defaults."""
    text = (CSRC / "psd_project.cuh").read_text()
    out = {}
    for name in ("PSD_NREG_F32", "PSD_NREG_F64"):
        given = [f.split("=", 1)[1] for f in flags if f.startswith(f"-D{name}=")]
        out[name] = int(given[-1] if given else re.search(rf"#define {name} (\d+)", text).group(1))
    return out


def units(flags=None) -> list:
    """(name, source, defines) of each ``nvcc -c`` of the library: every
    source once, but ``PER_INSTANTIATION``, which is built once for each
    group of a type's thread-path instantiations (``-DPSD_UNIT_T=float
    -DPSD_UNIT_FROM=1 -DPSD_UNIT_TO=7``): n from 1 to ``PSD_ALONE`` - 1,
    then each n up to the type's ``N_REG`` alone."""
    out = [(s[:-3], s, ()) for s in SOURCES if s != PER_INSTANTIATION]
    nreg = _psd_nreg(NVCC_FLAGS if flags is None else flags)
    for code, typ, key in (("f32", "float", "PSD_NREG_F32"), ("f64", "double", "PSD_NREG_F64")):
        top = nreg[key]
        groups = [(1, min(top, PSD_ALONE - 1))] + [(n, n) for n in range(PSD_ALONE, top + 1)]
        for lo, hi in groups:
            out.append((f"psd_thread_{code}_{lo}" + (f"_{hi}" if hi > lo else ""), PER_INSTANTIATION,
                        (f"-DPSD_UNIT_T={typ}", f"-DPSD_UNIT_FROM={lo}", f"-DPSD_UNIT_TO={hi}")))
    return out


def compile_units(todo, out_dir, flags=None, csrc=CSRC) -> list:
    """``nvcc -c`` of each (name, source, defines) of ``todo`` into
    ``out_dir/<name>.o``, all started together: [(command, output, return
    code, seconds)], the seconds each took beside the others."""
    from concurrent.futures import ThreadPoolExecutor

    flags = NVCC_FLAGS if flags is None else flags

    def one(unit):
        name, source, defines = unit
        cmd = [nvcc(), *flags, *defines, "-I", str(csrc), "-c", "-o",
               os.path.join(out_dir, f"{name}.o"), str(pathlib.Path(csrc) / source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return cmd, proc.stdout, proc.returncode, time.perf_counter() - t0

    with ThreadPoolExecutor(max(len(todo), 1)) as pool:
        return list(pool.map(one, todo))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _path() -> pathlib.Path:
    return BUILD_DIR / f"libsm_kernels_{_digest()}.so"


def log() -> str:
    """What nvcc and ptxas printed when the library of these sources was
    built, whether by this process or an earlier one."""
    library()
    return _path().with_suffix(".log").read_text()


def ptxas(text: str) -> dict:
    """ptxas' ``-v`` report per kernel: {mangled name: {"registers",
    "stack", "spill_stores", "spill_loads"}}."""
    out, name, props = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props in out:  # an entry's, not a called function's
            out[props].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def _open_nvrtc(lib) -> None:
    """Opens, for ``lib``'s generated kernels, the NVRTC of the toolkit
    whose nvcc built it (``csrc/nvrtc.cu`` says why by its path)."""
    global NVRTC_VERSION
    path = pathlib.Path(nvcc()).resolve().parent.parent / "lib64" / "libnvrtc.so"
    err, version = ctypes.create_string_buffer(1024), ctypes.c_int()
    lib.sm_rtc_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_int)]
    lib.sm_rtc_open.restype = ctypes.c_int
    if lib.sm_rtc_open(str(path).encode(), err, len(err), ctypes.byref(version)) != 0:
        raise RuntimeError(f"cannot open NVRTC at {path}: {err.value.decode(errors='replace')}")
    NVRTC_VERSION = version.value


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built if needed."""
    global BUILD_LOG, BUILD_SECONDS
    path = _path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            todo = units()
            objs = [os.path.join(tmpdir, f"{name}.o") for name, _, _ in todo]
            done = compile_units(todo, tmpdir)
            UNIT_SECONDS.update({name: s for (name, _, _), (_, _, _, s) in zip(todo, done)})
            logs = [(cmd, out, rc) for cmd, out, rc, _ in done]
            so = os.path.join(tmpdir, "lib.so")
            link = [nvcc(), "-shared", *NVCC_FLAGS[:2], "-o", so, *objs, "-ldl"]
            if all(rc == 0 for _, _, rc in logs):
                proc = subprocess.run(link, capture_output=True, text=True)
                logs.append((link, proc.stdout + proc.stderr, proc.returncode))
            for cmd, out, rc in logs:
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
            BUILD_SECONDS = time.perf_counter() - t0
            BUILD_LOG = "".join(out for _, out, _ in logs)
            path.with_suffix(".log").write_text(BUILD_LOG)
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
        ("sm_mm_wgmma_i64_launch", [void_p, void_p, void_p, void_p]),
        ("sm_mm_launch_kernel", [void_p, void_p, void_p, c_int, void_p]),
        ("sm_ew_launch_kernel", [void_p, void_p, void_p, void_p]),
        ("sm_ew_launch_flat_kernel", [void_p, void_p, void_p, ctypes.c_longlong, void_p]),
        ("sm_rd_launch_kernel", [void_p, void_p, c_int, void_p, void_p, void_p]),
        ("sm_rtc_compile", [ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p), c_int,
                            ctypes.c_char_p, c_int, ctypes.POINTER(void_p),
                            ctypes.POINTER(ctypes.c_size_t)]),
        ("sm_rtc_load", [void_p, ctypes.c_char_p, c_int, ctypes.POINTER(void_p),
                         ctypes.POINTER(void_p), ctypes.POINTER(ctypes.c_int64)]),
        ("sm_rtc_unload", [void_p]),
        ("sm_psd_project_launch", [void_p, void_p, ctypes.c_longlong, c_int, c_int,
                                   ctypes.c_double, void_p]),
        ("sm_ew_params_size", []),
        ("sm_rd_params_size", []),
        ("sm_mm_params_size", []),
    ):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = c_int
    lib.sm_rtc_free.argtypes = [void_p]
    lib.sm_rtc_free.restype = None
    _open_nvrtc(lib)
    c_ll = ctypes.c_longlong
    lib.sm_mm_wgmma_i64_scratch.argtypes = [c_ll, c_ll, c_ll, c_ll]
    lib.sm_mm_wgmma_i64_scratch.restype = c_ll
    return lib
