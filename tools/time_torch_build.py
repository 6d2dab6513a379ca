#!/usr/bin/env python3
"""Time the build of the port's kernel library, unit by unit.

    python3 tools/time_torch_build.py [--root DIR ...] [--rounds R]

Compiles this checkout's ``simplemath_tpu_torch/csrc`` as ``_build.py``
builds it (every unit of ``_build.units``, one ``nvcc -c`` each, all
started together, then the link) into a temporary directory, and prints one
JSON line with the card's name and power limit: the seconds of the whole
build and of each unit beside the others, longest first.  ``--root DIR``
builds another checkout too (the parent commit, unpacked by ``git archive``
into a directory that ``.gitignore`` lists), in turns, DIR then this, ``R``
rounds (1); ``--root`` may be given more than once, each DIR in turn before
this: a checkout whose ``_build.py`` has no ``units`` is built a
source a unit, as its ``_build.py`` did.  Both go through this checkout's
``compile_units``, so they are timed alike.  Needs ``nvcc``; loads no
kernel and no package, so it runs without a card too (the card's name is
then not printed).
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve().parent.parent


def _module(tree, name):
    path = pathlib.Path(tree) / "simplemath_tpu_torch" / "_build.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(tree, mine):
    """The seconds of ``tree``'s build: {"total_s", "link_s", "units"}."""
    b = _module(tree, "tree_build")
    todo = b.units() if hasattr(b, "units") else [(s[:-3], s, ()) for s in b.SOURCES]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        done = mine.compile_units(todo, tmp, b.NVCC_FLAGS, b.CSRC)
        for cmd, out, rc, _ in done:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
        t1 = time.perf_counter()
        lib64 = pathlib.Path(mine.nvcc()).resolve().parent.parent / "lib64"
        link = [mine.nvcc(), "-shared", *b.NVCC_FLAGS[:2], "-o", os.path.join(tmp, "lib.so"),
                *(os.path.join(tmp, f"{name}.o") for name, _, _ in todo), "-lnvrtc",
                "-Xlinker", f"-rpath,{lib64}"]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"link failed: {proc.stderr[-2000:]}")
        t2 = time.perf_counter()
    seconds = {name: s for (name, _, _), (_, _, _, s) in zip(todo, done)}
    return {"total_s": t2 - t0, "link_s": t2 - t1, "n_units": len(todo),
            "units": dict(sorted(seconds.items(), key=lambda kv: -kv[1]))}


def main(args):
    rounds = int(args[args.index("--rounds") + 1]) if "--rounds" in args else 1
    others = [pathlib.Path(args[i + 1]).resolve() for i, a in enumerate(args) if a == "--root"]
    mine = _module(HERE, "this_build")
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        card = None
    out = {"card": card, "cpus": os.cpu_count(), "this": str(HERE), "runs": []}
    order = [*others, HERE] * rounds
    for tree in order:
        row = {"tree": "this" if tree == HERE else str(tree), **build(tree, mine)}
        out["runs"].append(row)
        print(f"build of {tree}: {row['total_s']:.2f} s, longest "
              f"{next(iter(row['units'].items()))}", file=sys.stderr, flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
