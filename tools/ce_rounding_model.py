#!/usr/bin/env python3
"""A model of how the fused CE kernels' score arithmetic rounds, on the CPU:
the tensor cores' fp32 sum taken as the exact sum of a k16 step's products
and the accumulator, truncated to fp32 (round toward zero). For the inputs
of tests/test_torch_port_cuda.py::test_ce_train_kernels_match_plain at M =
3,201, V = 4,097 and width D, it prints, for each arithmetic, the mean
error of the row max against float64 and the largest |db - float64| with
the softmax and db taken in float64 (so that only the scores' rounding
shows):

- "one sum": each score accumulated over all of D in k16 steps from zero
  (kernel row 2's csrc/ce_fwd.cu, wmma fragments carried over all of D,
  the bias added after; rows 9-11 before their 64-deep chunks);
- "64-deep chunks": each 64-deep chunk's four k16 steps from zero, the
  chunks added in fp32 rounded to nearest (csrc/ce_train.cu: rows 9-11 and
  row 2's split route);
- "fp32 twin": the plain twin's fp32 matmul (rounded to nearest);

and, for each, the scoring CE's error against float64: the mean of ce -
float64 and the largest |ce - float64| / float64 (a hypothesis score sums
such ce values, so a bias in them is a relative bias of the score).

    python3 tools/ce_rounding_model.py [--d 1024] [--seed SEED]

About a minute and 1 GB at D = 1,024.

    python3 tools/ce_rounding_model.py --card [--m 4096]

On a CUDA card (nvcc needed): the same reading on the card's kernels at the
scoring shapes (V = 49,152, D = 512 and 1,024, M tokens of h ~ U(-1, 1)),
with E scaled for logits below ~2 (the LSTM's random init) and with
standard deviation ~5 (the trained Transformer's, up to ~20): ce of
csrc/ce_fwd.cu (called through its library, whatever the width rule
routes), of row 2's split route (``ops.ce_cuda.fused_decode_ce``) and of
the twin ``ce_plain``, each against float64 computed on the card; the last
line says whether ce_fwd.cu lies beyond the twin by more than the scores'
rtol 1e-4. A few seconds after the build.
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


def ce_errors(s, T, ce64):
    """(mean of ce - float64, max |ce - float64| / float64) of the CE from
    scores s."""
    mx = s.max(axis=1, keepdims=True)
    ce = np.log(np.exp(s - mx).sum(axis=1)) + mx[:, 0] \
        - s[np.arange(s.shape[0]), T]
    return float(np.mean(ce - ce64)), float(np.max(np.abs(ce - ce64) / ce64))


RTOL_SCORES = 1e-4  # chip_smoke.py's TRAINED_SCORE_RTOL


def card(m):
    """Row 2's kernels against float64 on the card (see the docstring)."""
    import ctypes

    import torch

    sys.path.insert(0, ROOT)
    from bayeslms_tpu_torch.ops import _build, ce_cuda

    if not torch.cuda.is_available():
        print("ce_rounding_model --card: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    lib = _build.load("ce_fwd")
    lib.ce_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    lib.ce_fwd.restype = ctypes.c_int

    def wmma(h, emb, bias, tgt):
        out = torch.empty((h.shape[0],), dtype=torch.float32, device=dev)
        err = lib.ce_fwd(h.data_ptr(), emb.data_ptr(), bias.data_ptr(),
                         tgt.data_ptr(), out.data_ptr(), h.shape[0],
                         emb.shape[0], h.shape[1],
                         torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ce_fwd: CUDA error {err}")
        return out

    def ce64(h, emb, bias, tgt):
        out = []
        for s in range(0, h.shape[0], 1024):
            lg = h[s:s + 1024].double() @ emb.double().t() + bias.double()
            out.append(torch.logsumexp(lg, 1)
                       - lg.gather(1, tgt[s:s + 1024, None].long())[:, 0])
        return torch.cat(out)

    print(f"device {torch.cuda.get_device_name(0)}; M {m}, V 49152")
    worst = {}
    for D in (512, 1024):
        for name, sd in (("logits < ~2", None), ("logits sd ~5", 5.0)):
            g = torch.Generator(device=dev).manual_seed(D)
            h = (torch.rand((m, D), generator=g, device=dev) * 2 - 1) \
                .to(torch.bfloat16)
            e = torch.rand((49152, D), generator=g, device=dev) * 2 - 1
            # |s| < ~2 as the LSTM's init, or s of sd ~5: h . e has sd
            # c sqrt(D) / 3 for e ~ U(-c, c)
            e = e * (0.3 * (256 / D) ** 0.5 if sd is None
                     else sd * 3.0 / D ** 0.5)
            emb = e.to(torch.bfloat16)
            bias = torch.rand((49152,), generator=g, device=dev) * 0.2
            tgt = torch.randint(0, 49152, (m,), generator=g, device=dev)
            ref = ce64(h, emb, bias, tgt)
            outs = {"ce_fwd.cu (one sum)": wmma(h, emb, bias.contiguous(),
                                                tgt.to(torch.int32)),
                    "split route (64-deep chunks)":
                        ce_cuda.fused_decode_ce(h, emb, bias, tgt),
                    "fp32 twin": ce_cuda.ce_plain(h, emb, bias, tgt)}
            for k, ce in outs.items():
                d = ce.double() - ref
                rel = float((d.abs() / ref.abs()).max())
                worst[(D, name, k)] = rel
                print(f"D {D}, {name} (ce mean {float(ref.mean()):.3f}): "
                      f"{k}: mean ce - float64 {float(d.mean()):.3e}, max "
                      f"|ce - float64| {float(d.abs().max()):.3e}, relative "
                      f"{rel:.3e}", flush=True)
    beyond = max(worst[k[:2] + ("ce_fwd.cu (one sum)",)]
                 - worst[k[:2] + ("fp32 twin",)] for k in worst)
    print(f"ce_fwd.cu beyond the twin by at most {beyond:.3e} relative: "
          f"{'beyond' if beyond > RTOL_SCORES else 'within'} the scores' "
          f"rtol {RTOL_SCORES:.0e}")
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=None,
                    help="the inputs' seed (default: the test's, M)")
    ap.add_argument("--card", action="store_true",
                    help="read the card's kernels at the scoring shapes")
    ap.add_argument("--m", type=int, default=4096,
                    help="tokens of the --card reading")
    args = ap.parse_args()
    if args.card:
        return card(args.m)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from test_torch_port_cuda import _ce_train_args

    M, V, D = 3201, 4097, args.d
    h, emb, bias, tgt, a, _ = _ce_train_args("cpu", M, V, D, args.seed)
    H, E = h.double().numpy(), emb.double().numpy()
    B, T, A = bias.double().numpy(), tgt.numpy(), a.double().numpy()
    db64, mx64 = db_and_max(H @ E.T + B, T, A)
    twin = (h.float().numpy() @ emb.float().numpy().T
            + bias.numpy()).astype(np.float64)
    s64 = H @ E.T + B
    m64 = s64.max(axis=1, keepdims=True)
    ce64 = np.log(np.exp(s64 - m64).sum(axis=1)) + m64[:, 0] \
        - s64[np.arange(M), T]
    for name, s in (("one sum", lambda: scores(H, E, B, 0)),
                    ("64-deep chunks", lambda: scores(H, E, B, 4)),
                    ("fp32 twin", lambda: twin)):
        sc = s()
        db, mx = db_and_max(sc, T, A)
        bias_ce, rel_ce = ce_errors(sc, T, ce64)
        print(f"D {D}, {name}: mean max - float64 {np.mean(mx - mx64):.2e}, "
              f"max |db - float64| {np.abs(db - db64).max():.3e}; ce: mean "
              f"ce - float64 {bias_ce:.2e}, max relative {rel_ce:.2e}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
