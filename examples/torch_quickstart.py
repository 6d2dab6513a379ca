"""Quickstart on the PyTorch port: the twin of examples/quickstart.py.

Run: python examples/torch_quickstart.py [--device cuda|cpu]
"""

import argparse

import numpy as np

import simplemath_tpu_torch as sm


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sm.configure(device=args.device)

    a = sm.Array([[1, 2], [3, 4]], dtype=np.float32)
    b = sm.Array([[5, 6], [7, 8]], dtype=np.float32)

    c = a + b
    print(c)

    d = sm.Array([1, 2, 3, 4], dtype=np.int32)
    e = d * 2
    print(e)

    view = a[0, :]          # aliasing view
    view[0] = 9.0           # writes through to `a`
    print(a)

    print(sm.pow(a, 2.5))   # float pow
    print(sm.exp(a))        # crafted exp, on the elementwise kernel

    # Custom op, traced onto the elementwise kernel's program:
    sm.register_op("scaled_sum", lambda x, y: (x + y) * 2, overwrite=True)
    print(sm.apply_op("scaled_sum", a, b))


if __name__ == "__main__":
    main()
