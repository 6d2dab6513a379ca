#!/usr/bin/env python3
"""Time the port's matmul kernels beside the library's calls on one CUDA
card.

    python3 tools/time_torch_matmul.py [--root DIR] [--no-check] [extra nvcc flags ...]

Builds the kernels of ``simplemath_tpu_torch`` (with any extra ``nvcc`` flags
given, for example a ``-D`` switch put into a source while trying a variant:
the loads-only, multiplies-only and store-only builds are made that way),
holds the bf16 product to its tolerance and the int8 product to exactness at
a few shapes, and prints device times (CUDA events, as
``chip_smoke.py::time_ms`` takes them), with the card's name and power
limit, of:

- the CUDA-core kernel (csrc/matmul.cu): the float32 product at 2048^3
  bare, through the fused ``relu(x @ W + bias) * s - c`` and with A a
  transposed view or 4 bytes off (read element by element), the batched
  float32 product at (8, 1024, 1024), each beside ``torch.matmul`` (TF32
  off); the int32 product at 2048^3; the mixed pairs f32 @ bf16 and int32 @
  int8 at 2048^3 (the narrow operand read element by element);
- the 64-bit product (csrc/matmul_wgmma_i64.cu, on the int8 tensor cores;
  the CUDA cores' ``imad_i64`` in a checkout older than it) at 2048^3 and at
  512^3 on full-range int64 operands, its split passes included, the 512^3
  one held to the CPU's int64 product;
- the tensor-core kernels: the bare and the fused bf16 product at 2048^3,
  (8, 1024, 1024) and 4096^3 beside ``torch.matmul``'s, and the int8
  product (row-major, each operand a transposed view, one byte off, with
  ``scale=``, rank 3, 4096^3) beside ``torch._int_mm``'s.

``--epilogue`` times the five fused calls of ``chip_smoke.py``'s phase 7
instead (``relu(x @ W + bias) * s - c`` at 2048^3 in bf16 and f32, at (8,
1024, 1024) in bf16 and f32, and ``int8_matmul(scale=)`` at 2048^3), each
on its kernel generated per epilogue, on the compiled kernel's interpreter
(``matmul.interpret``, where the checkout has it) and as the bare product,
with the NVRTC milliseconds and ptxas' report of each generated kernel;
with ``--root`` the parent's fused calls (its interpreter) in the same
turns, and the fused products of both checkouts must be ``torch.equal``.

``--root DIR`` compares this checkout with another one (the parent commit,
unpacked beside this one) in one call on one card: each is timed in a
process of its own, in the order DIR, this, this, DIR, and the float32,
fused float32, int32 and mixed products of the two on the same inputs must
be ``torch.equal``, and so must the 64-bit products.  It is a workbench for trying one change to
``csrc/matmul*.cu`` at a time; ``chip_smoke.py`` is the check.  A build that
compiles a part of a kernel out gives wrong products: pass ``--no-check``
with it.  Imports no jax.
"""

import json
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent.parent


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def epilogue_worker(root, save):
    """``--epilogue``: the five fused calls of checkout ``root``, timed
    generated, interpreted and bare; saves the fused products to ``save``;
    prints one JSON line."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke
    import simplemath_tpu_torch as sm
    from simplemath_tpu_torch import _build
    from simplemath_tpu_torch.ops import codegen, matmul, program

    _build.library()
    dev, rng = torch.device("cuda"), np.random.default_rng(0)
    n, (bb, bm, bn) = chip_smoke.N_MM, chip_smoke.BMM

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    def relu_bias(shape, extra, dtype):
        acc, leaf = program.leaf(shape, torch.float32), program.leaf(extra, dtype)
        return program.lower_epilogue(sm.maximum(acc + leaf, 0.0) * (1.0 / n) - 0.5, acc, [leaf])

    x, w, bias = f32(n, n), f32(n, n), f32(1, n)
    x3, w3, bias3 = f32(bb, bm, bn), f32(bb, bn, bn), f32(1, 1, bn)
    q = torch.from_numpy(rng.integers(-127, 128, (n, n)).astype(np.int8)).to(dev)
    qw = torch.from_numpy(rng.integers(-127, 128, (n, n)).astype(np.int8)).to(dev)
    scale = f32(1, n).abs() * 1e-3
    calls = {  # name: (a, b, stored type, epilogue, extras)
        "fused_bf16": (x.bfloat16(), w.bfloat16(), torch.bfloat16,
                       relu_bias((n, n), (1, n), torch.bfloat16), [bias.bfloat16()]),
        "int8_scaled": (q, qw, torch.float32, matmul._dequant_epilogue(2), [scale]),
        "fused_f32": (x, w, torch.float32, relu_bias((n, n), (1, n), torch.float32), [bias]),
        "bmm_fused_bf16": (x3.bfloat16(), w3.bfloat16(), torch.bfloat16,
                           relu_bias((bb, bm, bn), (1, 1, bn), torch.bfloat16), [bias3.bfloat16()]),
        "bmm_fused_f32": (x3, w3, torch.float32, relu_bias((bb, bm, bn), (1, 1, bn), torch.float32),
                          [bias3]),
    }
    t = chip_smoke.time_ms
    times, products, ptxas = {}, {}, {}
    interp = getattr(matmul, "interpret", None)
    with matmul.exact_float32():
        for name, (a, b, out, epi, extras) in calls.items():
            bare_out = torch.int32 if a.dtype == torch.int8 else out
            products[name] = matmul.matmul(a, b, out, epilogue=epi, extras=extras).cpu()
            reps = 5 if a.dtype == torch.float32 else 20
            times[f"{name}_ms"] = t(lambda: matmul.matmul(a, b, out, epilogue=epi, extras=extras), n=reps)
            times[f"{name}_bare_ms"] = t(lambda: matmul.matmul(a, b, bare_out), n=reps)
            if interp is not None:
                ref = interp(a, b, out, epilogue=epi, extras=extras).cpu()
                times[f"{name}_bits_equal_interp"] = torch.equal(ref, products[name])
                times[f"{name}_interp_ms"] = t(lambda: interp(a, b, out, epilogue=epi, extras=extras),
                                               n=reps)
                sig = matmul.launch_signature(a, b, out, epi, extras)
                ptxas[name] = codegen.ptxas(sig)
    times["nvrtc_ms"] = list(getattr(codegen, "COMPILE_MS", []))
    torch.save(products, save)
    print(f"{card()}: " + json.dumps({"root": str(root), "epilogue": True, **times,
                                      "ptxas": ptxas}), flush=True)
    return 0


def worker(root, save, check, flags):
    """Times the package of checkout ``root``; saves its products on the
    fixed inputs to ``save``; prints one JSON line."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke
    import simplemath_tpu_torch as sm
    from simplemath_tpu_torch import _build
    from simplemath_tpu_torch.ops import matmul, program

    _build.NVCC_FLAGS = _build.NVCC_FLAGS + tuple(flags)
    _build.library()
    for line in _build.BUILD_LOG.splitlines():
        if "mm_" in line or ("Used" in line and "registers" in line) or "spill" in line:
            print("ptxas:", line.strip()[:160], file=sys.stderr)
    dev, rng = torch.device("cuda"), np.random.default_rng(0)

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    def bf16(*shape):
        return f32(*shape).bfloat16()

    def i8(dtype, *shape):
        info = np.iinfo(dtype)
        return torch.from_numpy(rng.integers(info.min, info.max + 1, shape).astype(dtype)).to(dev)

    def i64(*shape):
        return torch.from_numpy(rng.integers(-2**63, 2**63 - 1, shape, dtype=np.int64)).to(dev)

    def error(a, b):
        """Largest error against float64, in units of 2e-5 * (|A| @ |B|)."""
        k = matmul.matmul(a, b, torch.float32).double()
        a64, b64 = a.double(), b.double()
        return float(((k - a64 @ b64).abs() / (2e-5 * (a64.abs() @ b64.abs()))).max())

    def wrong(a, b):
        """Elements of the int8 product that differ from the exact one."""
        return int((matmul.matmul(a, b, torch.int32) != matmul.int_product(a, b)).sum())

    n = 2048
    # The CUDA-core kernel's inputs first, so both checkouts draw the same.
    x, w, bias = f32(n, n), f32(n, n), f32(1, n)
    ra, rb = f32(300, 270), f32(270, 515)
    x3, w3 = f32(8, 1024, 1024), f32(8, 1024, 1024)
    ia, ib = i8("int8", n, n).int(), i8("int8", n, n).int()
    la, lb = i64(n, n), i64(n, n)  # full range: every limb varies
    la5, lb5 = i64(512, 512), i64(512, 512)
    acc, leaf = program.leaf((n, n), torch.float32), program.leaf((1, n), torch.float32)
    epi = program.lower_epilogue(sm.maximum(acc + leaf, 0.0) * (1.0 / n) - 0.5, acc, [leaf])
    w16, ib8 = w.bfloat16(), ib.to(torch.int8)  # the narrow operand of a mixed pair
    products = {
        "f32": matmul.matmul(x, w, torch.float32),
        "f32_ragged": matmul.matmul(ra, rb, torch.float32),
        "f32_a_transposed": matmul.matmul(x.T, w, torch.float32),
        "f32_four_bytes_off": matmul.matmul(x[:, 1:], w[1:], torch.float32),
        "fused_f32": matmul.matmul(x, w, torch.float32, epilogue=epi, extras=[bias]),
        "bmm_f32": matmul.matmul(x3, w3, torch.float32),
        "int32": matmul.matmul(ia, ib, torch.int32),
        "f32_bf16": matmul.matmul(x, w16, torch.float32),
        "int32_int8": matmul.matmul(ia, ib8, torch.int32),
        "int64": matmul.matmul(la, lb, torch.int64),
        "int64_512": matmul.matmul(la5, lb5, torch.int64),
    }
    torch.save({k: v.cpu() for k, v in products.items()}, save)

    errors = {
        "f32 2048^3": error(x, w),
        "16-byte copies, ragged": error(bf16(300, 272)[:, :270], bf16(270, 520)[:, :515]),
        "transposed views": error(bf16(270, 304).T[:300], bf16(515, 270).T),
        "element by element": error(bf16(300, 270), bf16(270, 515)),
        "2048^3": error(bf16(2048, 2048), bf16(2048, 2048)),
        "int8 @ uint8, 16-byte reads, ragged": wrong(i8("int8", 300, 272)[:, :270],
                                                     i8("uint8", 270, 528)[:, :515]),
        "uint8 @ int8, transposed views": wrong(i8("uint8", 270, 304).T[:300],
                                                i8("int8", 515, 272).T[:270]),
        "int8, byte by byte": wrong(i8("int8", 300, 270), i8("int8", 270, 515)),
        "int8 2048^3": wrong(i8("int8", 2048, 2048), i8("int8", 2048, 2048)),
        "int64 512^3": int((products["int64_512"].cpu() != la5.cpu() @ lb5.cpu()).sum()),
    }
    if check and (max(errors.values()) > 1.0 or errors["int64 512^3"]):
        print(f"time_torch_matmul: beyond tolerance: {errors}", file=sys.stderr)
        return 1

    t = chip_smoke.time_ms
    times = {}
    with matmul.exact_float32():
        times.update({
            "mm_f32_ms": t(lambda: matmul.matmul(x, w, torch.float32), n=5),
            "mm_f32_library_ms": t(lambda: torch.matmul(x, w), n=5),
            "fused_f32_ms": t(lambda: matmul.matmul(x, w, torch.float32, epilogue=epi, extras=[bias]), n=5),
            "mm_f32_a_transposed_ms": t(lambda: matmul.matmul(x.T, w, torch.float32), n=5),
            "mm_f32_four_bytes_off_ms": t(lambda: matmul.matmul(x[:, 1:], w[1:], torch.float32), n=3),
            "bmm_f32_ms": t(lambda: matmul.matmul(x3, w3, torch.float32), n=5),
            "bmm_f32_library_ms": t(lambda: torch.matmul(x3, w3), n=5),
            "mm_int32_ms": t(lambda: matmul.matmul(ia, ib, torch.int32), n=3),
            "mm_f32_bf16_ms": t(lambda: matmul.matmul(x, w16, torch.float32), n=3),
            "mm_int32_int8_ms": t(lambda: matmul.matmul(ia, ib8, torch.int32), n=3),
        })
    times["mm_int64_ms"] = t(lambda: matmul.matmul(la, lb, torch.int64), n=1, reps=5)
    times["mm_int64_512_ms"] = t(lambda: matmul.matmul(la5, lb5, torch.int64), n=10)
    times["mm_int64_variant"] = next(k for k in matmul.VARIANTS if k.endswith("i64"))
    times["mm_f32_over_library"] = times["mm_f32_ms"] / times["mm_f32_library_ms"]
    times["bmm_f32_over_library"] = times["bmm_f32_ms"] / times["bmm_f32_library_ms"]

    xb, wb = bf16(n, n), bf16(n, n)
    xb3, wb3 = bf16(8, 1024, 1024), bf16(8, 1024, 1024)
    xb4, wb4 = bf16(4096, 4096), bf16(4096, 4096)
    bias_b = bf16(1, n)
    bias_b3 = bias_b.reshape(1, 1, n)[:, :, :1024]

    def relu_bias(shape, extra):
        acc, leaf = program.leaf(shape, torch.float32), program.leaf(extra, torch.bfloat16)
        return program.lower_epilogue(sm.maximum(acc + leaf, 0.0) * (1.0 / n) - 0.5, acc, [leaf])

    epi_b, epi_b3 = relu_bias((n, n), (1, n)), relu_bias((8, 1024, 1024), (1, 1, 1024))
    times.update({
        "mm_ms": t(lambda: matmul.matmul(xb, wb, torch.bfloat16), n=20),
        "mm_library_ms": t(lambda: torch.matmul(xb, wb), n=20),
        "mm_f32_out_ms": t(lambda: matmul.matmul(xb, wb, torch.float32), n=20),
        "mm_a_transposed_ms": t(lambda: matmul.matmul(xb.T, wb, torch.bfloat16), n=20),
        "mm_b_transposed_ms": t(lambda: matmul.matmul(xb, wb.T, torch.bfloat16), n=20),
        "mm_fused_ms": t(lambda: matmul.matmul(xb, wb, torch.bfloat16, epilogue=epi_b,
                                               extras=[bias_b]), n=10),
        "bmm_ms": t(lambda: matmul.matmul(xb3, wb3, torch.bfloat16), n=20),
        "bmm_library_ms": t(lambda: torch.matmul(xb3, wb3), n=20),
        "bmm_fused_ms": t(lambda: matmul.matmul(xb3, wb3, torch.bfloat16, epilogue=epi_b3,
                                                extras=[bias_b3]), n=10),
        "mm_4096_ms": t(lambda: matmul.matmul(xb4, wb4, torch.bfloat16), n=5),
        "mm_4096_library_ms": t(lambda: torch.matmul(xb4, wb4), n=5),
    })
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
    print(f"{card()}: " + json.dumps({"root": str(root), "flags": flags,
                                      "errors_of_tolerance": errors, **times}), flush=True)
    return 0


def main():
    args = sys.argv[1:]
    check = "--no-check" not in args
    args = [a for a in args if a != "--no-check"]
    if args[:1] == ["--worker"]:
        import torch

        if not torch.cuda.is_available():
            print("time_torch_matmul: no CUDA device is visible", file=sys.stderr)
            return 1
        if "--epilogue" in args:
            return epilogue_worker(pathlib.Path(args[1]), args[2])
        return worker(pathlib.Path(args[1]), args[2], check, args[3:])
    other = None
    if "--root" in args:
        i = args.index("--root")
        other = pathlib.Path(args[i + 1]).resolve()
        del args[i:i + 2]
    runs = [HERE] if other is None else [other, HERE, HERE, other]
    with tempfile.TemporaryDirectory() as tmp:
        saved = []
        for k, root in enumerate(runs):
            save = f"{tmp}/products_{k}.pt"
            cmd = [sys.executable, __file__, "--worker", str(root), save, *args]
            if not check:
                cmd.append("--no-check")
            rc = subprocess.run(cmd).returncode
            if rc != 0:
                return rc
            saved.append(save)
        if other is not None:
            import torch

            mine, theirs = torch.load(saved[1]), torch.load(saved[0])
            same = {k: torch.equal(mine[k], theirs[k]) for k in mine}
            print(f"{card()}: products of {HERE} and {other} torch.equal: " + json.dumps(same),
                  flush=True)
            if check and not all(same.values()):
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
