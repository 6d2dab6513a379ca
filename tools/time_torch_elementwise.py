#!/usr/bin/env python3
"""Time the port's elementwise kernels (``ew_flat`` beside ``torch.add``, and
``ew_strided`` with its generated kernels and its interpreter) on one CUDA
card.

    python3 tools/time_torch_elementwise.py [--root DIR] [--flat] [--host [--n N]] [extra nvcc flags ...]

Builds the kernels of ``simplemath_tpu_torch`` (with any extra ``nvcc`` flags
given, for example a ``-D`` switch put into a source while trying a variant),
holds ``ew_flat`` bit for bit against the plain interpreter on a
one-instruction program, a chain, a scalar operand on either side and a
ragged tail, and prints device times (CUDA events, as
``chip_smoke.py::time_ms`` takes them) with the card's name and power limit:

- the 1M-float add, the same three arrays again and again (12 MB: hot in the
  50 MB L2) and over a ring of operands and results of 192 MB (past the L2),
  each beside ``torch.add`` timed the same way;
- a launch on 1024 elements, beside ``torch.add``'s (what a launch costs);
- the add and the chain ``a * b + c - a`` on 16M floats (192 and 256 MB:
  device memory), the chain beside its plain version (three torch kernels),
  the interpreter (``elementwise.interpret``, where the package has it) and
  its bound by bytes; then chains of 2 to 128 instructions over two 16M
  operands on ``ew_flat``'s kernel generated for each, on quads and with an
  operand 4 bytes off (an element a thread), beside the interpreter, with
  ptxas' registers and spills of each generated kernel (where the package
  generates them);
- the bfloat16 add: 1M elements hot in the L2 and over a ring past it, and
  16M (96 MiB), each beside ``torch.add``, and the 1M ring once more with
  every operand 2 bytes past a 16-byte boundary (``ew_flat``'s element
  path), held bit for bit against the plain version first;
- ``ew_strided``: the BASELINE recurrence ``acc * 1e-3 + exp(pow(a + acc *
  1e-6, e_row))`` on 2048x2048 with a (1, 2048) row at L = 1, 2, 4, 8, 16
  and 400, and one-pass programs of 1 to 64 instructions over the same
  operands, each on the interpreter and (where the package has them) on the
  kernel generated for the program, the two held bit for bit, with the
  NVRTC milliseconds of each new kernel: the measurement that sends every
  program to a generated kernel.

``--flat`` times ``ew_flat`` alone (no ``ew_strided`` section).

``--root DIR`` takes the package and ``chip_smoke.py`` from another checkout
(the parent commit, unpacked beside this one), so that two versions are timed
in one call on one card.  ``--host`` times the public API's host cost alone:
``sm.add`` of two arrays and of a view, a lazy chain and ``Array.sum()`` on
4096 floats (device work of microseconds; ``--n N`` for another length, as
the 1M add of BASELINE config 0), beside ``torch.add`` and the
elementwise wrapper called directly on the same add, each as the median wall time of
one call ending in a synchronize (``chip_smoke.host_ms``), as the wall
time per call of 2000 calls issued back to back, and as the least of 20
runs of 100 such calls (the run the shared host disturbed least).  Imports
no jax.
"""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ARGS = sys.argv[1:]
HOST = "--host" in ARGS
FLAT = "--flat" in ARGS
ARGS = [a for a in ARGS if a not in ("--host", "--flat")]
HOST_N = 4096
if "--n" in ARGS:
    i = ARGS.index("--n")
    HOST_N = int(ARGS[i + 1])
    del ARGS[i:i + 2]
ROOT = pathlib.Path(__file__).resolve().parent.parent
if "--root" in ARGS:
    i = ARGS.index("--root")
    ROOT = pathlib.Path(ARGS[i + 1]).resolve()
    del ARGS[i:i + 2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from simplemath_tpu_torch import _build  # noqa: E402
from simplemath_tpu_torch.ops import elementwise, program  # noqa: E402

N_ADD = 1_000_000
N_BIG = 16 * 1024 * 1024
RING = 16  # sets of (a, b, result) of the 1M add: 192 MB (96 MB in bfloat16)


def add16(n):
    """The bfloat16 add of two n-element operands."""
    leaves = [program.leaf((n,), torch.bfloat16) for _ in range(2)]
    return program.lower(leaves[0] + leaves[1], leaves)


def two_bytes_off(t):
    """A contiguous copy of the 2-byte tensor ``t`` 2 bytes past a 16-byte
    boundary: the same values on the element path."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    at = (-buf.data_ptr() // 2) % 8 + 1
    return buf[at:at + t.numel()].view(t.shape).copy_(t)


def strided(run, f32, t):
    """ew_strided's times with the generated kernels and with the
    interpreter (the interpreter alone where the package has no generated
    kernels)."""
    sq = (2048, 2048)
    acc, a = torch.zeros(sq, device="cuda"), f32(sq[0] * sq[1]).reshape(sq).abs() + 0.5
    e = f32(2048).reshape(1, 2048).clamp(-2, 2)
    leaves = [program.leaf(sq, torch.float32), program.leaf(sq, torch.float32),
              program.leaf((1, 2048), torch.float32)]
    chain = program.lower(leaves[0] * np.float32(1e-3) + program.apply(
        "exp", program.Node("pow", [leaves[1] + leaves[0] * np.float32(1e-6), leaves[2]],
                            torch.float32, sq)), leaves)
    def interp(prog, operands, L):
        return elementwise.elementwise(prog, sq, torch.float32, *operands, iterations=L, carry=0)

    kernels = {"interp": interp}
    if hasattr(elementwise, "interpret"):
        kernels = {"interp": lambda prog, operands, L: elementwise.interpret(
                       prog, sq, *operands, iterations=L, carry=0),
                   "generated": interp}

    times = {}
    cases = [(f"recurrence{L}", chain, [acc, a, e], L) for L in (1, 2, 4, 8, 16, 400)]
    for k in (1, 2, 4, 8, 16, 32, 64):
        x, row = program.leaf(sq, torch.float32), program.leaf((1, 2048), torch.float32)
        root = x
        while len(program.lower(root, [x, row]).insts) < k:
            root = root * row + 0.5 if len(program.lower(root, [x, row]).insts) + 2 <= k else -root
        cases.append((f"onepass{k}", program.lower(root, [x, row]), [a, e], 1))
    for label, prog, operands, L in cases:
        outs = [run(prog, operands, L) for run in kernels.values()]
        if not all(torch.equal(o.view(torch.int32), outs[0].view(torch.int32)) for o in outs):
            raise AssertionError(f"{label}: the kernels differ")
        for name, run in kernels.items():
            times[f"{label}_{name}_ms"] = t(lambda: run(prog, operands, L), n=1 if L == 400 else 4,
                                            reps=3 if L == 400 else 5)
    if len(kernels) > 1:
        from simplemath_tpu_torch.ops import codegen

        times["nvrtc_ms"] = codegen.COMPILE_MS
        times["generated_stats"] = codegen.STATS
    return times


def flat_chains(run, big, t):
    """Chains ``x * y + 0.5`` of k instructions over two 16M operands on
    ew_flat: the kernel the package runs for each (on quads, and with x 4
    bytes off: an element a thread), the interpreter's time, and ptxas'
    registers and spills of the generated kernel where there is one."""
    from simplemath_tpu_torch.ops import codegen

    x, y = big[0], big[1]
    off = torch.empty(N_BIG + 4, device="cuda")[1:N_BIG + 1].copy_(x)
    times = {}
    for k in (2, 8, 32, 128):
        lx, ly = program.leaf((N_BIG,), torch.float32), program.leaf((N_BIG,), torch.float32)
        root = lx
        while len(program.lower(root * ly + 0.5, [lx, ly]).insts) <= k:
            root = root * ly + 0.5
        prog = program.lower(root, [lx, ly])
        times[f"chain{k}_ms"] = t(lambda: run(prog, x, y), n=10)
        times[f"chain{k}_4_bytes_off_ms"] = t(lambda: run(prog, off, y), n=10)
        if hasattr(elementwise, "interpret"):
            times[f"chain{k}_interp_ms"] = t(lambda: elementwise.interpret(prog, (N_BIG,), x, y), n=10)
        if hasattr(codegen, "ptxas") and not elementwise.single(prog):
            sig = elementwise.signature(prog, prog.kernel_codes, (N_BIG,), [x, y], flat=True)
            times[f"chain{k}_ptxas"] = codegen.ptxas(sig)
    return times


def host_times(f32):
    """Host milliseconds of public-API calls whose device work is a few
    microseconds."""
    import simplemath_tpu_torch as sm

    n = HOST_N
    x, y = sm.Array(f32(n)), sm.Array(f32(n))
    xt, yt = x.torch(), y.torch()
    view = sm.Array(f32(2 * n))[::2]
    leaves = [program.leaf((n,), torch.float32) for _ in range(2)]
    add = program.lower(leaves[0] + leaves[1], leaves)
    calls = {
        # The same add by the library and by the kernel's wrapper alone:
        # the first is the same code in both trees (the host's own drift).
        "torch_add": lambda: torch.add(xt, yt),
        "wrapper_add": lambda: elementwise.elementwise(add, (n,), torch.float32, xt, yt),
        "add": lambda: sm.add(x, y).torch(),
        "add_view": lambda: sm.add(view, y).torch(),
        "chain": lambda: (x * y + x - y).torch(),
        "sum": lambda: x.sum().torch(),
    }
    out = {}
    for name, fn in calls.items():
        out[f"{name}_host_ms"] = chip_smoke.host_ms(fn, reps=21)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        torch.cuda.synchronize()
        out[f"{name}_ms_per_call"] = (time.perf_counter() - t0) / 2000 * 1e3
        runs = []  # the least disturbed of 20 runs of 100 calls: the host's own cost
        for _ in range(20):
            t0 = time.perf_counter()
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) / 100 * 1e3)
        out[f"{name}_best_ms_per_call"] = min(runs)
    return out


def main():
    if not torch.cuda.is_available():
        print("time_torch_elementwise: no CUDA device is visible", file=sys.stderr)
        return 1
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + tuple(ARGS)
    _build.library()
    print(f"whole build: {_build.BUILD_SECONDS and round(_build.BUILD_SECONDS, 1)} s ({ROOT})")
    kernel = None  # ptxas' registers, stack and spills of ew_flat and ew_strided
    for line in _build.BUILD_LOG.splitlines():
        if "Compiling entry function" in line:
            kernel = line if "ew_" in line else None
        if kernel and ("Compiling entry" in line or "stack" in line or "registers" in line):
            print("ptxas:", line.strip()[:160])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    dev, rng = torch.device("cuda"), np.random.default_rng(0)

    def f32(n):
        return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)

    if HOST:
        print(f"{card}: " + json.dumps({"root": str(ROOT), **host_times(f32)}))
        return 0

    def run(prog, *operands):
        shape = max((tuple(o.shape) for o in operands), key=len)
        return elementwise.elementwise(prog, shape, prog.dtype, *operands)

    def lowered(fn, *shapes):
        leaves = [program.leaf(s, torch.float32) for s in shapes]
        return program.lower(fn(*leaves), leaves)

    n = 4096 * 5 + 3
    x, y, z, s0 = f32(n), f32(n), f32(n), f32(1).reshape(())
    cases = {
        "add": (lowered(lambda a, b: a + b, (n,), (n,)), [x, y]),
        "chain": (lowered(lambda a, b, c: a * b + c - a, (n,), (n,), (n,)), [x, y, z]),
        "scalar right": (lowered(lambda a, s: a / s, (n,), ()), [x, s0]),
        "scalar left": (lowered(lambda s, a: s - a, (), (n,)), [s0, x]),
        "constant": (lowered(lambda a: a * 2.5, (n,)), [x]),
    }
    xb, yb = x.bfloat16(), y.bfloat16()
    cases["bf16 add"] = (add16(n), [xb, yb])
    cases["bf16 add, 2 bytes off"] = (add16(n), [two_bytes_off(xb), yb])
    for label, (prog, operands) in cases.items():
        k = run(prog, *operands)
        want = program.run_plain(prog, operands, (n,))
        bits = torch.int16 if k.dtype == torch.bfloat16 else torch.int32
        if not torch.equal(k.view(bits), want.view(bits)):
            print(f"time_torch_elementwise: {label} differs from the plain interpreter",
                  file=sys.stderr)
            return 1

    add = lowered(lambda a, b: a + b, (N_ADD,), (N_ADD,))
    a, b = f32(N_ADD), f32(N_ADD)
    ring = [(f32(N_ADD), f32(N_ADD)) for _ in range(RING)]
    kept = [None] * RING  # results stay alive, so each call writes other memory
    turn = [0]

    def rotated(fn):
        def call():
            i = turn[0] = (turn[0] + 1) % RING
            kept[i] = fn(*ring[i])
        return call

    small = lowered(lambda p, q: p + q, (1024,), (1024,))
    sa, sb = f32(1024), f32(1024)
    big = [f32(N_BIG) for _ in range(3)]
    add_big = lowered(lambda p, q: p + q, (N_BIG,), (N_BIG,))
    chain = lowered(lambda p, q, r: p * q + r - p, (N_BIG,), (N_BIG,), (N_BIG,))
    ring16 = [(f32(N_ADD).bfloat16(), f32(N_ADD).bfloat16()) for _ in range(RING)]
    ring16_off = [(two_bytes_off(p), two_bytes_off(q)) for p, q in ring16]
    big16 = [t.bfloat16() for t in big[:2]]
    add_1m16, add_big16 = add16(N_ADD), add16(N_BIG)
    a16, b16 = a.bfloat16(), b.bfloat16()

    def rotated16(pairs, fn):
        def call():
            i = turn[0] = (turn[0] + 1) % RING
            kept[i] = fn(*pairs[i])
        return call

    t = chip_smoke.time_ms
    times = {
        "add_hot_ms": t(lambda: run(add, a, b), n=100),
        "add_hot_library_ms": t(lambda: torch.add(a, b), n=100),
        "add_past_l2_ms": t(rotated(lambda p, q: run(add, p, q)), n=100),
        "add_past_l2_library_ms": t(rotated(torch.add), n=100),
        "launch_1024_ms": t(lambda: run(small, sa, sb), n=100),
        "launch_1024_library_ms": t(lambda: torch.add(sa, sb), n=100),
        "add_16m_ms": t(lambda: run(add_big, big[0], big[1]), n=10),
        "add_16m_library_ms": t(lambda: torch.add(big[0], big[1]), n=10),
        "chain_16m_ms": t(lambda: run(chain, *big), n=10),
        "chain_16m_plain_ms": t(lambda: program.run_plain(chain, big, (N_BIG,)), n=10),
        "chain_16m_bound_ms": chip_smoke.bound(16 * N_BIG, 3 * N_BIG)[0],
        "add_bf16_hot_ms": t(lambda: run(add_1m16, a16, b16), n=100),
        "add_bf16_hot_library_ms": t(lambda: torch.add(a16, b16), n=100),
        "add_bf16_past_l2_ms": t(rotated16(ring16, lambda p, q: run(add_1m16, p, q)), n=100),
        "add_bf16_past_l2_library_ms": t(rotated16(ring16, torch.add), n=100),
        "add_bf16_past_l2_2_bytes_off_ms": t(rotated16(ring16_off, lambda p, q: run(add_1m16, p, q)),
                                             n=100),
        "add_bf16_16m_ms": t(lambda: run(add_big16, *big16), n=10),
        "add_bf16_16m_library_ms": t(lambda: torch.add(*big16), n=10),
        "add_bf16_bound_ms": chip_smoke.bound(6 * N_ADD, N_ADD)[0],
        "add_bf16_16m_bound_ms": chip_smoke.bound(6 * N_BIG, N_BIG)[0],
    }
    if hasattr(elementwise, "interpret"):
        times["chain_16m_interp_ms"] = t(lambda: elementwise.interpret(chain, (N_BIG,), *big), n=10)
    times.update(flat_chains(run, big, t))
    if hasattr(elementwise, "FLAT_PATHS"):
        elementwise.reset_launches()
        run(add_1m16, a16, b16)
        run(add_1m16, *ring16_off[0])
        times["flat_paths_of_aligned_then_off"] = dict(elementwise.FLAT_PATHS)
    for key in ("add_bf16_hot", "add_bf16_past_l2", "add_bf16_16m"):
        times[f"{key}_over_library"] = times[f"{key}_ms"] / times[f"{key}_library_ms"]
    if not FLAT:
        times.update(strided(run, f32, t))
    times["add_hot_over_library"] = times["add_hot_ms"] / times["add_hot_library_ms"]
    times["add_past_l2_over_library"] = times["add_past_l2_ms"] / times["add_past_l2_library_ms"]
    print(f"{card}: " + json.dumps({"root": str(ROOT), "flags": ARGS, **times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
