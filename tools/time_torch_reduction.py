#!/usr/bin/env python3
"""Time the port's map-reduce kernel (``rd_full``, ``rd_axis``) beside the
PyTorch calls that compute the same functions, on one CUDA card.

    python3 tools/time_torch_reduction.py [--root DIR] [--no-check] [extra nvcc flags ...]

Compiles the ``csrc/reduction*.cu`` sources first, started together and
timed each, and prints what ptxas says of every ``rd_*`` kernel (registers,
stack, spills; the whole log goes to ``build/logs/``).  Then builds the
kernels of ``simplemath_tpu_torch`` (with any extra ``nvcc`` flags given, for
example a ``-D`` switch put into the source while trying a variant), holds the kernel against its plain
version on a few ragged cases (sums within 2e-5 * sum|x|, max exact, the
bits repeating; skipped with ``--no-check``), and prints device times (CUDA
events, as ``chip_smoke.py::time_ms`` takes them: runs of 20 calls over
256 MB, past the 50 MB L2) with the card's name and power limit:

- ``Array.sum()``'s reduction of 64M floats beside ``torch.sum``, the same
  sum as ``x * 1.0`` (one instruction) and of a view 4 bytes off (gathered
  element by element), and the max beside ``torch.amax``;
- the dot of two 32M vectors beside ``torch.dot``, and the int32 dot;
- the fused squared distance ``sum(square(a + eps - b))`` with a 0-d operand;
- on (8192, 8192): the identity sums along axis 0 and 1 beside
  ``torch.sum(dim)``, the thresholded sums ``sum(where(a > s, a, 0), axis)``
  and the map-reduce ``a * row - col`` along both axes and in full, the
  thresholded sums beside their plain version; the axis-0 sum of a
  transposed view;
- in bfloat16 (the same 64M values, 128 MiB): ``Array.sum()``'s reduction
  beside ``torch.sum``, and of the values 2 bytes past a 16-byte boundary
  (the element path), the sums along axis 0 and 1 of (8192, 8192) beside
  ``torch.sum(dim)``; the float16 sum beside ``torch.sum``; checked first
  against their plain versions, the 2-bytes-off sum bit for bit against
  the aligned one.

Where the package generates its evaluators (ops/codegen.py, kind
``"reduce"``), the four map-reduces (the distance, ``a * row - col`` in
full, the thresholded sums along both axes) and two gathered sums (4 bytes
off; a transposed view along axis 0) are also timed on the
interpreter (``reduction.interpret``), held to it bit for bit, with ptxas'
registers and spills of each generated kernel, and again with each count of
quads a thread asks for at once in ``--batches B,...`` (default 1,2,4).

``--root DIR`` takes the package and ``chip_smoke.py`` from another checkout
(the parent commit, unpacked beside this one), so that two versions are
timed in one call on one card.  Imports no jax.
"""

import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

ARGS = sys.argv[1:]
HERE = pathlib.Path(__file__).resolve().parent.parent
ROOT = HERE
if "--root" in ARGS:
    i = ARGS.index("--root")
    ROOT = pathlib.Path(ARGS[i + 1]).resolve()
    del ARGS[i:i + 2]
CHECK = "--no-check" not in ARGS
ARGS = [a for a in ARGS if a != "--no-check"]
BATCHES = (1, 2, 4)
if "--batches" in ARGS:
    i = ARGS.index("--batches")
    BATCHES = tuple(int(b) for b in ARGS[i + 1].split(","))
    del ARGS[i:i + 2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import simplemath_tpu_torch as sm  # noqa: E402
from simplemath_tpu_torch import _build  # noqa: E402
from simplemath_tpu_torch.ops import elementwise, program, reduction  # noqa: E402

N_SUM = 64 * 1024 * 1024
N_DOT = 32 * 1024 * 1024
N_AXIS = 8192


def two_bytes_off(t):
    """A contiguous copy of the 2-byte tensor ``t`` 2 bytes past a 16-byte
    boundary: the same values on the element path."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    at = (-buf.data_ptr() // 2) % 8 + 1
    return buf[at:at + t.numel()].view(t.shape).copy_(t)


def compile_alone(tag):
    """Seconds of ``nvcc -c`` for each ``reduction*.cu`` (all started
    together, as the build starts them), the wall time of the slowest, and
    ptxas' lines for the rd_* kernels as {kernel: "regs/stack/spill"}."""
    out_dir = HERE / "build" / "logs"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = sorted(_build.CSRC.glob("reduction*.cu"))
    t0 = time.perf_counter()
    procs = []
    for src in sources:
        obj = out_dir / f"{src.stem}_{tag}.o"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-c", "-o", str(obj),
               str(src)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    seconds, log = {}, ""
    pending = {src.name: (obj, p) for src, obj, p in procs}
    while pending:
        for name, (obj, p) in list(pending.items()):
            if p.poll() is not None:
                seconds[name] = round(time.perf_counter() - t0, 1)
                out = p.stdout.read()
                log += out
                obj.unlink(missing_ok=True)
                del pending[name]
                if p.returncode != 0:
                    print(out[-6000:], file=sys.stderr)
                    raise SystemExit(f"nvcc failed on {name} ({p.returncode})")
        time.sleep(0.05)
    (out_dir / f"reduction_{tag}_nvcc.log").write_text(log)
    return seconds, {k: f"regs {r.get('registers')} stack {r.get('stack')} spill {r.get('spill_stores')}"
                     for k, r in _build.ptxas(log).items() if "rd_" in k}


def generated(t, workloads):
    """The generated evaluators of ``workloads`` (key, program, axis, shape,
    operands; sums) against the interpreter: bits, both times, ptxas'
    report, and the time with each count of quads in ``BATCHES``."""
    from simplemath_tpu_torch.ops import codegen

    out = {}

    def call(prog, axis, shape, ops):
        if axis is None:
            return reduction.map_reduce(prog, "sum", shape, *ops)
        return reduction.map_reduce_axis(prog, "sum", axis, shape, *ops)

    for key, prog, axis, shape, ops in workloads:
        g, i = call(prog, axis, shape, ops), reduction.interpret(prog, "sum", axis, shape, ops)
        if not torch.equal(g.view(torch.int32), i.view(torch.int32)):
            raise SystemExit(f"time_torch_reduction: {key}'s generated evaluator differs from "
                             "the interpreter")
        out[f"{key}_interp_ms"] = t(lambda: reduction.interpret(prog, "sum", axis, shape, ops))
        sig = reduction.signature(prog, prog.kernel_codes, 0, shape, ops, axis)
        out[f"{key}_ptxas"] = codegen.ptxas(sig)
    default = codegen.REDUCE_BATCH
    for batch in BATCHES:
        codegen.REDUCE_BATCH = batch
        codegen._evict(reduction._library())  # the next calls compile this batch's kernels
        for key, prog, axis, shape, ops in workloads:
            out[f"{key}_batch{batch}_ms"] = t(lambda: call(prog, axis, shape, ops))
            sig = reduction.signature(prog, prog.kernel_codes, 0, shape, ops, axis)
            out[f"{key}_batch{batch}_ptxas"] = codegen.ptxas(sig)
    codegen.REDUCE_BATCH = default
    codegen._evict(reduction._library())
    return out


def main():
    if not torch.cuda.is_available():
        print("time_torch_reduction: no CUDA device is visible", file=sys.stderr)
        return 1
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + tuple(ARGS)
    tag = re.sub(r"\W+", "_", ROOT.name + "_" + "_".join(ARGS)).strip("_")
    seconds, kernels = compile_alone(tag)
    print(f"nvcc -c of the reduction sources, started together: {seconds} s ({ROOT})")
    for name, what in sorted(kernels.items()):
        print(f"ptxas {name[:60]}: {what}")
    _build.library()
    print(f"whole build: {_build.BUILD_SECONDS and round(_build.BUILD_SECONDS, 1)} s")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    dev, rng = torch.device("cuda"), np.random.default_rng(0)
    sm.configure(device="cuda")

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    def lowered(fn, *ts):
        leaves = [program.leaf(tuple(t.shape), t.dtype) for t in ts]
        root = fn(*leaves)
        return program.lower(getattr(root, "expr", root), leaves)

    def plain(prog, ops, shape, kind="sum", dim=None):
        return reduction._plain(program.run_plain(prog, ops, shape), kind, dim)

    def thresholded(ax):
        return lambda a, s: sm.sum(sm.where(a > s, a, 0.0), axis=ax)

    if CHECK:
        n = 4096 * 5 + 3
        x, y, s0 = f32(n), f32(n), f32(1).reshape(())
        m, row, col = f32(301, 260), f32(1, 260), f32(301, 1)
        cases = [
            ("sum", lambda: reduction.reduce(x, "sum"), reduction._plain(x, "sum"), x.abs().sum()),
            ("max", lambda: reduction.reduce(x, "max"), reduction._plain(x, "max"), None),
            ("dot", lambda: reduction.dot1d(x, y), (x * y).sum(), (x * y).abs().sum()),
        ]
        p_dist = lowered(lambda a, b, e: sm.square(a + e - b), x, y, s0)
        cases.append(("distance", lambda: reduction.map_reduce(p_dist, "sum", (n,), x, y, s0),
                      plain(p_dist, [x, y, s0], (n,)), plain(p_dist, [x, y, s0], (n,))))
        p_map = lowered(lambda a, r, c: a * r - c, m, row, col)
        vals = program.run_plain(p_map, [m, row, col], m.shape)
        for ax in (0, 1):
            cases.append((f"axis {ax}", lambda ax=ax: reduction.reduce_axis(m, "sum", ax),
                          m.sum(ax), m.abs().sum(ax)))
            cases.append((f"map axis {ax}",
                          lambda ax=ax: reduction.map_reduce_axis(p_map, "sum", ax, m.shape, m, row, col),
                          vals.sum(ax), vals.abs().sum(ax)))
            cases.append((f"max axis {ax}", lambda ax=ax: reduction.reduce_axis(m, "max", ax),
                          m.amax(ax), None))
        xb = x.bfloat16()
        xb_off = two_bytes_off(xb)
        mb = m.bfloat16()
        cases += [
            ("bf16 sum", lambda: reduction.reduce(xb, "sum"), reduction._plain(xb, "sum"),
             xb.float().abs().sum()),
            ("bf16 sum 2 bytes off", lambda: reduction.reduce(xb_off, "sum"),
             reduction._plain(xb, "sum"), xb.float().abs().sum()),
            ("f16 sum", lambda: reduction.reduce(x.half(), "sum"), reduction._plain(x.half(), "sum"),
             x.half().float().abs().sum()),
            ("bf16 axis 0", lambda: reduction.reduce_axis(mb, "sum", 0), reduction._plain(mb, "sum", 0),
             mb.float().abs().sum(0)),
            ("bf16 max axis 1", lambda: reduction.reduce_axis(mb, "max", 1),
             reduction._plain(mb, "max", 1), None),
        ]
        if not torch.equal(reduction.reduce(xb, "sum").view(torch.int32),
                           reduction.reduce(xb_off, "sum").view(torch.int32)):
            print("time_torch_reduction: the bf16 sum 2 bytes off differs from the aligned one",
                  file=sys.stderr)
            return 1
        for label, fn, want, scale in cases:
            k1, k2 = fn(), fn()
            torch.cuda.synchronize()
            same = torch.equal(k1.view(torch.int32), k2.view(torch.int32))
            if scale is None:
                ok = torch.equal(k1, want)
            else:
                ok = bool(((k1.double() - want.double()).abs() <= 2e-5 * scale.double() + 1e-6).all())
            if not (ok and same):
                print(f"time_torch_reduction: {label} differs from its plain version "
                      f"(agrees {ok}, bits repeat {same})", file=sys.stderr)
                return 1
        print("checks passed: " + ", ".join(c[0] for c in cases))

    x = f32(N_SUM)
    a, b = x[:N_DOT], x[N_DOT:]
    eps = torch.full((), 1e-3, device=dev)
    mat = x.reshape(N_AXIS, N_AXIS)
    thr = torch.full((1, 1), 0.25, device=dev)
    row, col = f32(1, N_AXIS), f32(N_AXIS, 1)
    off = torch.empty(N_SUM + 4, device=dev)[1:N_SUM + 1].copy_(x)
    ia = torch.from_numpy(rng.integers(-1000, 1000, N_DOT).astype(np.int32)).to(dev)
    sq = (N_AXIS, N_AXIS)
    p_one = lowered(lambda t: t * 1.0, x)
    p_dist = lowered(lambda p, q, e: sm.sum(sm.square(p + e - q)), a, b, eps)
    p_thr = {ax: lowered(thresholded(ax), mat, thr) for ax in (0, 1)}
    p_map = lowered(lambda t, r, c: t * r - c, mat, row, col)
    view_t = elementwise.View(mat, 0, sq, (1, N_AXIS))
    t = lambda fn: chip_smoke.time_ms(fn, n=20)  # noqa: E731
    if hasattr(reduction, "PATHS"):
        reduction.reset_launches()
    times = {
        "sum_ms": t(lambda: reduction.reduce(x, "sum")),
        "sum_library_ms": t(lambda: torch.sum(x)),
        "sum_x_times_one_ms": t(lambda: reduction.map_reduce(p_one, "sum", (N_SUM,), x)),
        "sum_4_bytes_off_ms": t(lambda: reduction.reduce(off, "sum")),
        "max_ms": t(lambda: reduction.reduce(x, "max")),
        "max_library_ms": t(lambda: torch.amax(x)),
        "dot_ms": t(lambda: reduction.dot1d(a, b)),
        "dot_library_ms": t(lambda: torch.dot(a, b)),
        "dot_int32_ms": t(lambda: reduction.dot1d(ia, ia)),
        "dist_ms": t(lambda: reduction.map_reduce(p_dist, "sum", (N_DOT,), a, b, eps)),
        "dist_plain_ms": t(lambda: plain(p_dist, [a, b, eps], (N_DOT,))),
    }
    for ax in (0, 1):
        times[f"axis{ax}_identity_ms"] = t(lambda: reduction.reduce_axis(mat, "sum", ax))
        times[f"axis{ax}_identity_library_ms"] = t(lambda: torch.sum(mat, ax))
        times[f"axis{ax}_max_ms"] = t(lambda: reduction.reduce_axis(mat, "max", ax))
        times[f"axis{ax}_thresholded_ms"] = t(
            lambda: reduction.map_reduce_axis(p_thr[ax], "sum", ax, sq, mat, thr))
        times[f"axis{ax}_thresholded_plain_ms"] = t(lambda: plain(p_thr[ax], [mat, thr], sq, "sum", ax))
        times[f"axis{ax}_map_ms"] = t(
            lambda: reduction.map_reduce_axis(p_map, "sum", ax, sq, mat, row, col))
    times["full_map_ms"] = t(lambda: reduction.map_reduce(p_map, "sum", sq, mat, row, col))
    times["axis0_transposed_view_ms"] = t(lambda: reduction.reduce_axis(view_t, "sum", 0))
    x16, xh = x.bfloat16(), x.half()
    x16_off, m16 = two_bytes_off(x16), x16.reshape(N_AXIS, N_AXIS)
    times.update({
        "sum_bf16_ms": t(lambda: reduction.reduce(x16, "sum")),
        "sum_bf16_library_ms": t(lambda: torch.sum(x16)),
        "sum_bf16_2_bytes_off_ms": t(lambda: reduction.reduce(x16_off, "sum")),
        "sum_f16_ms": t(lambda: reduction.reduce(xh, "sum")),
        "sum_f16_library_ms": t(lambda: torch.sum(xh)),
        "bound_128MiB_ms": chip_smoke.bound(2 * N_SUM, N_SUM)[0],
    })
    for ax in (0, 1):
        times[f"axis{ax}_bf16_ms"] = t(lambda: reduction.reduce_axis(m16, "sum", ax))
        times[f"axis{ax}_bf16_library_ms"] = t(lambda: torch.sum(m16, ax))
    for key in ("sum_bf16", "sum_f16", "axis0_bf16", "axis1_bf16"):
        times[f"{key}_over_library"] = times[f"{key}_ms"] / times[f"{key}_library_ms"]
    times["bound_256MB_ms"] = chip_smoke.bound(4 * N_SUM, N_SUM)[0]
    times["dot_over_library"] = times["dot_ms"] / times["dot_library_ms"]
    times["axis0_over_library"] = times["axis0_identity_ms"] / times["axis0_identity_library_ms"]
    times["axis1_over_library"] = times["axis1_identity_ms"] / times["axis1_identity_library_ms"]
    times["sum_over_library"] = times["sum_ms"] / times["sum_library_ms"]
    if hasattr(reduction, "PATHS"):
        times["paths"] = dict(reduction.PATHS)
    if hasattr(reduction, "interpret"):
        ident = reduction.identity(torch.float32)
        times.update(generated(t, [
            ("dist", p_dist, None, (N_DOT,), [a, b, eps]),
            ("full_map", p_map, None, sq, [mat, row, col]),
            ("axis0_thresholded", p_thr[0], 0, sq, [mat, thr]),
            ("axis1_thresholded", p_thr[1], 1, sq, [mat, thr]),
            ("sum_4_bytes_off", ident, None, (N_SUM,), [off]),
            ("axis0_transposed_view", ident, 0, sq, [view_t])]))
    print(f"{card}: " + json.dumps({"root": str(ROOT), "flags": ARGS,
                                    "nvcc_reduction_s": seconds, **times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
