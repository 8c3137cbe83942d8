#!/usr/bin/env python3
"""Checksums of the outputs of kernel rows 1, 4, 5, 7 and 8 in the designs
their rules pick, on one card, from fixed seeds: row 1 (``ops/lstm_cuda.py``
``lstm2_fwd``, the 2-layer scoring recurrence) at the LSTM scoring pass's
call (T 256, B 600, H 1,024, a step mask, resets on a sixteenth of the
pairs, sources in blocks of 20 and -1 on every ninth, a carried state);
rows 7 and 8 (the fused
2-layer LSTM training forward and backward, ``ops/lstm2_train_cuda.py``)
at a training step's call (T 100, B 32, H 1,024, a step mask and a
dropout mask of rate 0.2), row 5 (``ops/lstm_train_cuda.py``
``lstm_train_fwd``) at the same call's layer 1, and row 4
(``ops/lstm_cuda.py`` ``lstm_fwd``) at an ``evaluate`` window's (T 100,
B 20, H 1,024, the fp32 state, no mask).

    python3 tools/persist_checksums.py [--root CHECKOUT]

Needs a CUDA card and nvcc. For each output it prints its float64 sum and
the SHA-256 of its bytes: a change that only moves the kernels' code (rows
7-8's GEMM into csrc/gates_gemm.cuh, the persistent forward's step of rows
4, 5 and 7 made generic over its cell, or row 1's ring and products moved
into csrc/lstm_stream.cuh) must leave every line as it was. ``--root`` runs another checkout's kernels (a parent unpacked by
``git archive``; only its ``bayeslms_tpu_torch/`` is needed) on the same
inputs.
"""

import argparse
import hashlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def digest(torch, t):
    """(float64 sum, SHA-256 of the bytes) of a tensor on the card."""
    raw = t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()
    return float(t.double().sum()), hashlib.sha256(raw).hexdigest()[:16]


def row1_flat(out):
    """Row 1's outputs (ys2, (hT1, hT2), (cT1, cT2)) as one tuple."""
    ys, (h1, h2), (c1, c2) = out
    return ys, h1, h2, c1, c2


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose bayeslms_tpu_torch/ is run")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from bayeslms_tpu_torch.ops import lstm2_train_cuda as l2c
    from bayeslms_tpu_torch.ops import lstm_cuda as lc
    from bayeslms_tpu_torch.ops import lstm_train_cuda as ltc

    if not torch.cuda.is_available():
        raise SystemExit("persist_checksums: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; kernels of {os.path.abspath(args.root)}")
    T, B, H = 100, 32, 1024
    g = torch.Generator().manual_seed(17)
    bf = torch.bfloat16

    def r(*s, sc=1.0):
        return ((torch.rand(s, generator=g) * 2 - 1) * sc).cuda()

    sw = H ** -0.5
    dm = ((torch.rand((T, B, H), generator=g) < 0.8) / 0.8).to("cuda", bf)
    mask = (torch.rand((T, B), generator=g) < 0.9).to("cuda", torch.uint8)
    fwd_args = [r(T, B, 4 * H).to(bf), dm, r(4 * H, H, sc=sw).to(bf),
                r(4 * H, sc=0.1), r(4 * H, H, sc=sw).to(bf),
                r(4 * H, H, sc=sw).to(bf), r(4 * H, sc=0.1), mask,
                *(r(B, H, sc=0.5).to(bf) for _ in range(4))]
    grads = [r(T, B, H).to(bf), r(T, B, H).to(bf),
             *(r(B, H, sc=0.5).to(bf) for _ in range(4))]
    # row 4 at an evaluate window: B 20, the fp32 state, no mask
    Be = 20
    eval_args = [r(T, Be, 4 * H).to(bf), r(4 * H, H, sc=sw).to(bf),
                 r(4 * H, sc=0.1), r(Be, H, sc=0.5), r(Be, H, sc=0.5)]
    # row 1 at the scoring pass's call
    Ts, Bs = 256, 600
    score_args = [r(Ts, Bs, 4 * H).to(bf), r(4 * H, H, sc=sw).to(bf),
                  r(4 * H, sc=0.1), r(4 * H, H, sc=sw).to(bf),
                  r(4 * H, H, sc=sw).to(bf), r(4 * H, sc=0.1),
                  *(r(Bs, H, sc=0.5).to(bf) for _ in range(4)),
                  (torch.rand((Ts, Bs), generator=g) < 0.9).to(
                      "cuda", torch.uint8),
                  (torch.rand((Ts, Bs), generator=g) < 1 / 16).to(
                      "cuda", torch.uint8)]
    src = ((torch.arange(Bs) // 20) * 20).to(torch.int32)
    src[::9] = -1
    score_args.append(src.cuda())
    with torch.no_grad():
        row1 = row1_flat(lc.lstm2_fwd(*score_args))
        fwd = l2c.lstm2_train_fwd(*fwd_args)
        bwd = l2c.lstm2_train_bwd(*fwd_args, *fwd[:4], *grads)
        row5 = ltc.lstm_train_fwd(fwd_args[0], fwd_args[2], fwd_args[3],
                                  mask, fwd_args[8], fwd_args[9])
        row4 = lc.lstm_fwd(*eval_args)
        torch.cuda.synchronize()
    print(f"designs: row 1 {dict(lc.design_launches)}, row 4 "
          f"{dict(lc.layer_design_launches)}, row 5 "
          f"{dict(ltc.fwd_design_launches)}, row 7 "
          f"{dict(l2c.fwd_design_launches)}, row 8 "
          f"{dict(l2c.design_launches)}")
    for row, names, outs in (
            (1, ("ys2", "hT1", "hT2", "cT1", "cT2"), row1),
            (4, ("ys", "hT", "cT"), row4),
            (5, ("ys", "cs", "hT", "cT"), row5),
            (7, ("ys1", "cs1", "ys2", "cs2", "hT1", "cT1", "hT2", "cT2"), fwd),
            (8, ("du1", "du2", "dh01", "dc01", "dh02", "dc02"), bwd)):
        for name, t in zip(names, outs):
            s, h = digest(torch, t)
            print(f"  row {row} {name}: sum {s!r} sha256 {h}")


if __name__ == "__main__":
    main()
