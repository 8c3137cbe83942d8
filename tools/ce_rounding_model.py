#!/usr/bin/env python3
"""A model of how the fused CE kernels' score arithmetic rounds, on the CPU:
the tensor cores' fp32 sum taken as the exact sum of a k16 step's products
and the accumulator, truncated to fp32 (round toward zero). For the inputs
of tests/test_torch_port_cuda.py::test_ce_train_kernels_match_plain at M =
3,201, V = 4,097 and width D, it prints, for each arithmetic, the mean
error of the row max against float64 and the largest |db - float64| with
the softmax and db taken in float64 (so that only the scores' rounding
shows):

- "one sum": each score accumulated over all of D in k16 steps from zero;
- "64-deep chunks": each 64-deep chunk's four k16 steps from zero, the
  chunks added in fp32 rounded to nearest (csrc/ce_train.cu);
- "fp32 twin": the plain twin's fp32 matmul (rounded to nearest).

    python3 tools/ce_rounding_model.py [--d 1024] [--seed SEED]

About a minute and 1 GB at D = 1,024.
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def to_zero(x):
    """float64 x rounded to fp32 toward zero, as float64."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y.astype(np.float64)


def nearest(x):
    return x.astype(np.float32).astype(np.float64)


def scores(H, E, B, chunk):
    """The model's scores: k16 steps truncated, the sum restarted from zero
    every ``chunk`` steps and the chunks added to nearest (chunk 0: one
    sum), then the bias."""
    s = np.zeros((H.shape[0], E.shape[0]))
    c = np.zeros_like(s)
    steps = H.shape[1] // 16
    for k in range(steps):
        part = H[:, 16 * k:16 * k + 16] @ E[:, 16 * k:16 * k + 16].T
        if chunk == 0:
            s = to_zero(s + part)
            continue
        c = to_zero((c if k % chunk else 0.0) + part)
        if k % chunk == chunk - 1:
            s = nearest(s + c)
    return nearest(s + B)


def db_and_max(s, T, A):
    mx = s.max(axis=1, keepdims=True)
    p = np.exp(s - mx)
    p /= p.sum(axis=1, keepdims=True)
    d = A[:, None] * p
    d[np.arange(s.shape[0]), T] -= A
    return d.sum(axis=0), mx[:, 0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=None,
                    help="the inputs' seed (default: the test's, M)")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from test_torch_port_cuda import _ce_train_args

    M, V, D = 3201, 4097, args.d
    h, emb, bias, tgt, a, _ = _ce_train_args("cpu", M, V, D, args.seed)
    H, E = h.double().numpy(), emb.double().numpy()
    B, T, A = bias.double().numpy(), tgt.numpy(), a.double().numpy()
    db64, mx64 = db_and_max(H @ E.T + B, T, A)
    twin = (h.float().numpy() @ emb.float().numpy().T
            + bias.numpy()).astype(np.float64)
    for name, s in (("one sum", lambda: scores(H, E, B, 0)),
                    ("64-deep chunks", lambda: scores(H, E, B, 4)),
                    ("fp32 twin", lambda: twin)):
        db, mx = db_and_max(s(), T, A)
        print(f"D {D}, {name}: mean max - float64 {np.mean(mx - mx64):.2e}, "
              f"max |db - float64| {np.abs(db - db64).max():.3e}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
