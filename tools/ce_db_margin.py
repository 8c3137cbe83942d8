#!/usr/bin/env python3
"""How close the fused CE's db sits to the tolerance of
tests/test_torch_port_cuda.py::test_ce_train_kernels_match_plain at M =
3,201, V = 4,097, the case where the backward's fp32 sums over the tokens
are longest.

    python3 tools/ce_db_margin.py [--root CHECKOUT]

Needs a CUDA card and nvcc. ``--root`` measures the kernels of another
checkout (a parent commit unpacked with ``git archive``) on the same
inputs; the inputs are always this checkout's ``_ce_train_args`` of that
test. For D in (512, 1,024, 2,048) and the test's own inputs (seed M) and
seeds 0-7, it prints the share of that test's db tolerance (rtol 1e-4,
atol 1e-6 / M) that the kernels use (the forward's statistics into the
dE/db kernel) against the twins (each with its own statistics), the largest
|db - float64| of each side, the float64 db computed from the same bf16 h
and E, and the mean signed error of each side's row max against float64 (a
bias of the scores' sums shows there); then, per D, the range of the
shares.
"""

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def float64_reference(torch, h, emb, bias, tgt, a, b):
    """(db, row max) in float64."""
    s = h.double() @ emb.double().t() + bias.double()
    p = torch.softmax(s, dim=1)
    d = a.double()[:, None] * p
    d[torch.arange(h.shape[0], device=h.device), tgt] += b.double()
    return d.sum(dim=0), s.max(dim=1).values


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose kernels are measured")
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.root), os.path.join(ROOT, "tests")]
    import torch
    from test_torch_port_cuda import _ce_train_args

    from bayeslms_tpu_torch.ops import ce_train_cuda as ctc

    if not torch.cuda.is_available():
        print("ce_db_margin: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"kernels of {ctc.__file__}")
    dev = torch.device("cuda")
    M, V = 3201, 4097
    for D in (512, 1024, 2048):
        shares = []
        for seed in (M, *range(8)):
            h, emb, bias, tgt, a, b = _ce_train_args(dev, M, V, D, seed)
            _, mx, se = ctc.ce_train_fwd(h, emb, bias, tgt)
            _, rmx, rse = ctc.ce_train_fwd_plain(h, emb, bias, tgt)
            _, db = ctc.ce_train_de(h, emb, bias, tgt, mx, se, a, b)
            _, rdb = ctc.ce_train_de_plain(h, emb, bias, tgt, rmx, rse, a, b)
            ref, mx64 = float64_reference(torch, h, emb, bias, tgt, a, b)
            share = float(((db - rdb).abs()
                           / (1e-6 / M + 1e-4 * rdb.abs())).max())
            shares.append(share)
            tag = "the test's inputs" if seed == M else f"seed {seed}"
            print(f"D {D}, {tag}: worst share of the db tolerance "
                  f"{share:.3f}; max |db - float64| kernel "
                  f"{float((db.double() - ref).abs().max()):.3e}, twin "
                  f"{float((rdb.double() - ref).abs().max()):.3e}; mean "
                  f"max - float64 kernel "
                  f"{float((mx.double() - mx64).mean()):.2e}, twin "
                  f"{float((rmx.double() - mx64).mean()):.2e}")
        print(f"D {D}: worst shares {min(shares):.3f} to {max(shares):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
