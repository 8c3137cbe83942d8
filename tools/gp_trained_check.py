#!/usr/bin/env python3
"""The GP-LSTM's gate-replacement kernels at trained weights on the card:
kernel rows 20 (the forward, both designs) and 21 (the backward, the
design its rule picks and the two-launch one) against their plain twins.

    python3 tools/gp_trained_check.py [--exp DIR] [--windows N]

Needs a CUDA card and nvcc. Loads the repository's GP-LSTM ``13``
checkpoint (``DIR/campaign/torch_lstm_gp12/model.pt``, the reference's
128/128 x 2 model, L_gauss_pos 13: gate 1 replaced, GPNN type 3) with its
weights in bf16, and runs the first N windows (default 8) of 100 tokens of
``DIR/corpus_mid/valid.txt`` at batch 20 through it, the state carried from
window to window, each window's CE through autograd. The model runs its
training route (``deterministic=False``, the standard layer on rows 5-6,
through which the gradient reaches the GP cell; ``evaluate``'s row 4 has
none) with dropout 0 and the GP unit's means (``gp_sample`` off): the
checkpoint's function, as ``evaluate`` computes it. Every call the GP
cell hands ``gpg_fwd`` and ``gpg_bwd`` is recorded and run again through
each design and through the twin; each output's worst share of
chip_smoke.py's tolerance (GP_TOL: rtol 2^-6 and 2^-12 of the largest
|plain| forward, 2^-10 backward) is printed, and row 20's ys of each
design and of the twin against the same recurrence in float64 (with the
kernels' bf16 rounding points); the worst over all calls last as one JSON
line.
Exits 1 if a share exceeds 1 or a call left the design its rule picks.
"""

import argparse
import json
import os
import subprocess
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def fwd_float64(torch, gpc, xg, gpx, w5, bih, coef, mask, h0, c0, gate):
    """``gpg_fwd_plain``'s recurrence in float64 with the kernels' rounding
    points (h rounded to bf16 for the product, ys and cs stored in bf16):
    ys, cs. What the kernels and the float32 twin are both measured
    against, to tell a sum order's rounding from a fault."""
    f64, bf = torch.float64, torch.bfloat16
    H = w5.shape[1]
    w_t = w5.to(f64).t()
    names = gpc.ACT_SETS[coef.shape[0]]
    acts = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu}
    h, c = h0.to(f64), c0.to(f64)
    ys, cs = [], []
    for t in range(xg.shape[0]):
        hw = h.to(bf).to(f64) @ w_t
        g = (xg[t].to(f64) + hw[:, :4 * H]) + bih.to(f64)
        pre = gpx[t].to(f64) + hw[:, 4 * H:]
        gp = sum(coef[a].to(f64) * acts[n](pre) for a, n in enumerate(names))
        gi, gf, gg, go = g.chunk(4, dim=-1)
        i, f, gg, o = (gp if gate == q + 1 else v for q, v in enumerate((
            torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg),
            torch.sigmoid(go))))
        cn = f * c + i * gg
        hn = o * torch.tanh(cn)
        if mask is not None:
            keep = mask[t].bool()[:, None]
            hn, cn = torch.where(keep, hn, h), torch.where(keep, cn, c)
        h, c = hn, cn
        ys.append(h.to(bf))
        cs.append(c.to(bf))
    return torch.stack(ys), torch.stack(cs)


def where(torch, got, ref, rtol, share):
    """Print the element of ys furthest outside the tolerance: its (t, b,
    j), ys and cs of the kernel and of the twin, and the twin's c at t - 1
    (the cell state carried into the step)."""
    y, r = got["ys"].float(), ref["ys"].float()
    lim = rtol * r.abs() + share * float(r.abs().max())
    t, b, j = (int(i) for i in torch.unravel_index(
        torch.argmax((y - r).abs() / lim), y.shape))
    cs, cr = got["cs"].float(), ref["cs"].float()
    prev = float(cr[t - 1, b, j]) if t > 0 else float("nan")
    print(f"    worst ys at (t {t}, b {b}, j {j}): kernel "
          f"{float(y[t, b, j]):.6f}, twin {float(r[t, b, j]):.6f}; cs kernel "
          f"{float(cs[t, b, j]):.4f}, twin {float(cr[t, b, j]):.4f}; the "
          f"twin's c at t - 1 {prev:.4f}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--exp", default=os.path.join(ROOT, "exp"),
                    help="the directory holding campaign/ and corpus_mid/")
    ap.add_argument("--windows", type=int, default=8)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke
    import bayeslms_tpu_torch as bt
    from bayeslms_tpu_torch.core import checkpoint as tck
    from bayeslms_tpu_torch.data.corpus import batchify
    from bayeslms_tpu_torch.data.vocab import Vocab
    from bayeslms_tpu_torch.models.lstm_lm import init_hidden
    from bayeslms_tpu_torch.ops import gp_lstm_cuda as gpc

    if not torch.cuda.is_available():
        print("gp_trained_check: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the twins in fp32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)

    cfg = bt.ModelConfig(model="LSTM", vocab_size=10000, emsize=128,
                         nhid=128, nlayers=2, dropout=0.0,
                         uncertainty="Gaussian", l_gauss_pos="13",
                         compute_dtype="bfloat16")
    path = os.path.join(args.exp, "campaign", "torch_lstm_gp12", "model.pt")
    model = tck.params_from_jax(bt.build_model(cfg),
                                tck.load_torch_checkpoint(path, cfg)).cuda()
    corpus = os.path.join(args.exp, "corpus_mid")
    vocab = Vocab.from_file(os.path.join(corpus, "words.txt"))
    ids = []
    with open(os.path.join(corpus, "valid.txt"), encoding="utf-8") as f:
        for line in f:
            ids.extend(vocab.encode(line.split() + ["<s>"]))
    B, T = chip_smoke.EVAL_BATCH, chip_smoke.TRAIN_SEQ
    rows = batchify(np.asarray(ids, dtype=np.int32), B)
    print(f"{path}: GP-LSTM 13, 128/128 x 2, bf16; {args.windows} windows "
          f"of {T} x {B} of valid.txt ({rows.shape[0]} rows), state carried")

    recorded = {}
    hidden = init_hidden(2, B, cfg.nhid, dtype=torch.bfloat16,
                         device="cuda")
    losses = []
    gen = torch.Generator(device="cuda").manual_seed(0)  # draws nothing
    with mock.patch.multiple(gpc, **{
            n: (lambda n, fn: lambda *a: (recorded.setdefault(n, []).append(a),
                                          fn(*a))[1])(n, getattr(gpc, n))
            for n in ("gpg_fwd", "gpg_bwd")}):
        for w in range(args.windows):
            i = w * T
            data = torch.from_numpy(rows[i:i + T]).long().cuda()
            target = torch.from_numpy(rows[i + 1:i + 1 + T]).long().cuda()
            logits, hidden = model(data, hidden, deterministic=False,
                                   generator=gen)
            loss = torch.nn.functional.cross_entropy(
                logits.float().reshape(-1, cfg.vocab_size), target.reshape(-1))
            loss.backward()
            model.zero_grad(set_to_none=True)
            hidden = tuple(h.detach() for h in hidden)
            losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    taken = {k: dict(gpc.design_launches[k]) for k in ("gpg_fwd", "gpg_bwd")}
    print("  CE per window: " + " ".join(f"{v:.4f}" for v in losses))
    print(f"  the model's calls by design: {taken}")
    n_f, n_b = len(recorded.get("gpg_fwd", [])), len(recorded.get("gpg_bwd",
                                                                  []))
    print(f"  recorded {n_f} gpg_fwd and {n_b} gpg_bwd calls")
    if n_f != args.windows or n_b != args.windows:
        print("gp_trained_check: the GP cell did not take rows 20-21 once a "
              "window", file=sys.stderr)
        return 1

    worst, bad = {}, []
    fwd_outs, bwd_outs = ("ys", "cs", "hT", "cT"), ("du5", "dcoef", "dh0",
                                                    "dc0")
    with torch.no_grad():
        for w, (fa, ba) in enumerate(zip(recorded["gpg_fwd"],
                                         recorded["gpg_bwd"])):
            print(f"window {w}: h0 |max| {float(fa[6].abs().max()):.3f}, "
                  f"c0 |max| {float(fa[7].abs().max()):.3f}")
            runs = (
                ("row 20 persistent", "gpg_fwd", fwd_outs, gpc.gpg_fwd_plain,
                 lambda *a: gpc._gpg_fwd("persistent", *a), fa),
                ("row 20 per_step", "gpg_fwd", fwd_outs, gpc.gpg_fwd_plain,
                 lambda *a: gpc._gpg_fwd("per_step", *a), fa),
                ("row 21 persistent", "gpg_bwd", bwd_outs, gpc.gpg_bwd_plain,
                 lambda *a: gpc._gpg_bwd("persistent", *a), ba),
                ("row 21 two_launch", "gpg_bwd", bwd_outs, gpc.gpg_bwd_plain,
                 lambda *a: gpc._gpg_bwd("two_launch", *a), ba))
            ys64 = fwd_float64(torch, gpc, *fa)[0]
            for tag, fn, outs, plain, run, a in runs:
                rtol, share = chip_smoke.GP_TOL[fn]
                ref = dict(zip(outs, plain(*a)))
                got = dict(zip(outs, run(*a)))
                torch.cuda.synchronize()
                for k in outs:
                    q = chip_smoke.fault_share({k: got[k]}, {k: ref[k]}, rtol,
                                               share)
                    key = f"{tag} {k}"
                    worst[key] = max(worst.get(key, 0.0), q)
                _, q = chip_smoke.check_outputs(f"  {tag}", got, ref, rtol,
                                                share)
                if q > 1:
                    bad.append(f"window {w} {tag}: {q:.3f}")
                if fn == "gpg_fwd":
                    where(torch, got, ref, rtol, share)
                    # the design and the twin against the float64 recurrence
                    for who, ys in ((tag, got["ys"]), ("twin", ref["ys"])):
                        q = chip_smoke.fault_share({"ys": ys}, {"ys": ys64},
                                                   rtol, share)
                        key = f"{who} ys against float64"
                        worst[key] = max(worst.get(key, 0.0), q)
                        print(f"    {key}: worst share {q:.3f}")
    if any(taken[k]["persistent"] != args.windows for k in taken):
        bad.append(f"the model's calls left the persistent designs: {taken}")
    out = {"device": smi, "windows": args.windows, "ce": losses,
           "worst_share": worst, "failed": bad}
    print(json.dumps(out))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
