"""Fused elementwise pipelines with sm.fuse on the PyTorch port: the twin
of examples/fused_pipeline.py.

The BASELINE configs[1] workload (a broadcast + pow + exp chain) as ONE
launch of the elementwise kernel; the same chain written eagerly is
recorded by the deferred-eager queue and flushes as one launch too; an
iterated recurrence runs inside one launch with its carry in registers.

Run: python examples/torch_fused_pipeline.py [--n 512] [--device cuda|cpu]
"""

import argparse

import numpy as np

import simplemath_tpu_torch as sm
from simplemath_tpu_torch.ops import dispatch


def _elementwise_counts():
    return {k: v for k, v in dispatch.counts().items() if k.startswith("elementwise")}


def run(a_np, e_np):
    """The demo on the (n, n) base ``a_np`` and the (1, n) exponent row
    ``e_np``; prints what examples/fused_pipeline.py prints."""
    n = a_np.shape[0]
    a, e_row = sm.Array(a_np), sm.Array(e_np)

    # One fused launch: the (1, n) row is read with stride 0 inside the
    # kernel, never materialized at (n, n).
    pipeline = sm.fuse(lambda x, e: sm.exp(sm.pow(x, e)))
    dispatch.reset()
    y = pipeline(a, e_row)
    print("launches:", _elementwise_counts())

    # The same chain without sm.fuse: the deferred-eager queue records the
    # two calls and flushes them as one fused launch at materialization.
    dispatch.reset()
    y_chain = sm.exp(sm.pow(a, e_row))
    print("eager-chain launches before materialization:", _elementwise_counts())
    val = y_chain.torch()
    print("eager-chain launches after materialization:", _elementwise_counts())

    print("max |fused - chain| =", float((y.torch() - val).abs().max()))

    # Iterated recurrences run INSIDE one launch:
    ema = sm.fuse(lambda acc, x: acc * 0.9 + sm.square(x), iterations=50)
    dispatch.reset()
    z = ema(sm.zeros(n, n), a)
    print("50-iteration recurrence launches:", _elementwise_counts())
    print("ema[0,0] =", float(z[0, 0].torch()))
    return z


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=512)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sm.configure(device=args.device)
    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 2.0, (args.n, args.n)).astype(np.float32)
    e_row = rng.uniform(-2.0, 2.0, (1, args.n)).astype(np.float32)
    return run(a, e_row)


if __name__ == "__main__":
    main()
