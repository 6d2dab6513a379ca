"""Surface tour of the PyTorch port: the twin of
examples/quantized_views.py (views read inside kernels, fused matmul
epilogues, axis reductions, the int8 tensor-core path).

Run: python examples/torch_quantized_views.py [--device cuda|cpu]
"""

import argparse

import numpy as np

import simplemath_tpu_torch as sm


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sm.configure(device=args.device)
    rng = np.random.default_rng(0)

    # --- views are read INSIDE kernels: the transpose is the base buffer
    # read through its strides, never materialized.
    A = sm.array(rng.standard_normal((1024, 512)).astype(np.float32))
    B = sm.array(rng.standard_normal((512, 1024)).astype(np.float32))
    C = sm.add(A.T, B)
    print("view add:", C.shape)

    P = A.T @ sm.array(rng.standard_normal((1024, 256)).astype(np.float32))
    print("transposed matmul:", P.shape)

    # --- axis reductions (on the map-reduce kernel, fusable)
    row_norms = sm.fuse(lambda x: sm.sum(sm.square(x), axis=1))
    print("row norms:", row_norms(A).numpy().shape)

    # --- fused matmul epilogue: relu(x @ W + b) is ONE matmul launch
    X = rng.standard_normal((512, 384)).astype(np.float32)
    W = rng.standard_normal((384, 640)).astype(np.float32)
    b = rng.standard_normal((1, 640)).astype(np.float32)
    layer = sm.fuse(lambda x, w, bias: sm.maximum(x @ w + bias, 0.0))
    Y = layer(X, W, b)
    print("fused layer:", Y.shape)

    # --- quantized inference on the int8 tensor cores; scale= fuses the
    # dequantization into the kernel's epilogue.
    qx, sx = sm.quantize(X)
    qw, sw = sm.quantize(W)
    Yq = sm.int8_matmul(qx, qw, scale=float(np.asarray(sx) * np.asarray(sw)))
    ref = X @ W
    rel = np.abs(Yq.numpy() - ref).max() / np.abs(ref).max()
    print(f"int8 layer rel err vs f32: {rel:.4f}")

    # --- advanced indexing
    y_np = Y.numpy()
    hot = sm.array(y_np)[y_np.sum(axis=1).argsort()[-5:]]
    print("top-5 rows by activation:", hot.shape)
    return rel


if __name__ == "__main__":
    main()
