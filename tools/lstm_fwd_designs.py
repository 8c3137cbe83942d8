#!/usr/bin/env python3
"""Kernel rows 1, 3, 4, 5 and 7 (the LSTM forward recurrences) in their
designs on one card: row 1 (``lstm2_fwd``, the 2-layer scoring recurrence)
at the LSTM scoring pass's call (T 256, B 600, H 1,024) and at an
``evaluate`` window's (T 100, B 20), row 3 (``lstm_fwd`` with resets, the
GP-LSTM's standard layer in a packed-carry pass) at that pass's call (T
256, B 600, H 1,024: the streamed design with the rings its rule takes
and with 4 and 2 stages each, and the per-step design), row 5
(``lstm_train_fwd``, the training forward)
at a training step's call (T 100, B 32, H 1,024), row 4 (``lstm_fwd``
without resets, one layer of eval) at an ``evaluate`` window's call (T
100, B 20, H 1,024), row 7 (``lstm2_train_fwd``, the fused 2-layer
training forward) at a training step's call (T 100, B 32, H 1,024) with
a dropout mask of rate 0.2.

    python3 tools/lstm_fwd_designs.py [--ptxas] [--repeats 5]
                                      [--root CHECKOUT] [--rows 1,3,4,5,7]

Needs a CUDA card and nvcc. Inputs are random from fixed seeds: W scaled
by 1 / sqrt(H), a step mask that drops a tenth of the (step, column)
pairs; for row 1 resets on a sixteenth of them (an utterance of ~16
tokens), sources in blocks of 20 columns and -1 (a zero state) on every
ninth. For each design it prints the time (CUDA events around one wrapper
call, median of ``--repeats`` after a warm-up), the largest |kernel -
plain| and its largest share of the tolerance the card tests hold the
kernel to against its twin (rtol 2^-6 and, of the largest |plain|, 2^-10
for row 1, 2^-12 for row 5); for row 5 also cuDNN's one-layer
``torch.nn.LSTM`` forward (it computes x W_ih^T too). Before the timings
it runs row 1's two designs on the card test's calls and inputs
(``test_lstm2_designs_match_plain``: a fifth of the steps reset, a fifth
masked, sources in blocks of 10) and prints each one's largest share of
the test's tolerance and of chip_smoke.py's (2^-14 + 2^-6 |plain|,
elementwise). Rows 4 and 7 are held to chip_smoke.py's tolerance (rtol
2^-6, 2^-12 of the largest |plain|) and timed beside cuDNN's
``torch.nn.LSTM`` forward (one layer, and two layers with dropout 0.2);
before its timing, row 7's two designs run on the card test's calls and
inputs (``test_lstm2_train_fwd_designs_match_plain``) and at T = 100, and
print each output's share of chip_smoke.py's tolerance and of the card
test's (2^-10 of the largest |plain|). Row 3 is held to chip_smoke.py's
tolerance (rtol 2^-6, 2^-12 of the largest |plain|) on inputs as a pass
hands them (a sixteenth of the pairs reset, sources in blocks of 20, -1
on every ninth, a tenth masked) from a carried state (+-0.5);
row 5 also prints a checksum of its persistent design's outputs, which a
change that only moves its code must leave as it was. ``--ptxas`` first
compiles csrc/lstm2_fwd.cu, csrc/lstm_train.cu, csrc/lstm_fwd.cu and
csrc/lstm2_train.cu with ``-Xptxas -v`` and prints each kernel's
registers, spills and shared memory. ``--root`` measures another
checkout's kernels (a parent unpacked by ``git archive``; only its
``bayeslms_tpu_torch/`` is needed), in the designs it has.
"""

import argparse
import os
import subprocess
import sys
import tempfile
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_port_cuda.py's tolerances: rtol, share of max |plain|;
# chip_smoke.py's for row 1 (LSTM_ATOL)
RTOL, R1_SHARE, R5_SHARE = 2 ** -6, 2 ** -10, 2 ** -12
R1_ATOL = 2 ** -14
# (T, B, H) of test_lstm2_designs_match_plain
R1_TEST_CALLS = ((9, 70, 64), (6, 130, 256), (5, 20, 1024), (3, 600, 1024),
                 (7, 33, 512))


def ptxas_report():
    """nvcc's -Xptxas -v lines for the two libraries."""
    from bayeslms_tpu_torch.ops import _build

    for src in ("lstm2_fwd", "lstm_train", "lstm_fwd", "lstm2_train"):
        with tempfile.TemporaryDirectory() as tmp:
            cmd = [_build._nvcc(), *_build.FLAGS, "-Xptxas", "-v", "-o",
                   os.path.join(tmp, f"{src}.so"),
                   os.path.join(_build.CSRC, f"{src}.cu")]
            res = subprocess.run(cmd, capture_output=True, text=True)
        for line in (res.stdout + res.stderr).splitlines():
            if any(w in line for w in ("Compiling entry", "Used", "spill",
                                       "error", "warning", "wgmma")):
                print("  " + line.strip())
        if res.returncode:
            raise SystemExit(f"nvcc failed ({res.returncode})")


def cuda_ms(torch, fn, repeats):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def row1_args(torch, T, B, H, seed, keep=0.9, reset_p=1 / 16, block=20):
    """Row 1's inputs; ``keep`` of the (step, column) pairs unmasked,
    ``reset_p`` of them reset, sources in blocks of ``block`` columns (0.8,
    0.2 and 10 with the seed B + H are the card test's)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.rand(s, generator=g) * 2 - 1) * sc  # noqa: E731
    bf = torch.bfloat16
    sw = H ** -0.5
    args = [r(T, B, 4 * H), r(4 * H, H, sc=sw), r(4 * H, sc=0.1),
            r(4 * H, H, sc=sw), r(4 * H, H, sc=sw), r(4 * H, sc=0.1)]
    args += [r(B, H, sc=0.5) for _ in range(4)]
    mask = (torch.rand((T, B), generator=g) < keep).to(torch.uint8)
    reset = (torch.rand((T, B), generator=g) < reset_p).to(torch.uint8)
    src = ((torch.arange(B) // block) * block).to(torch.int32)
    src[::9] = -1
    dt = [bf, bf, None, bf, bf, None, bf, bf, bf, bf]
    out = [a.cuda() if d is None else a.to("cuda", d)
           for a, d in zip(args, dt)]
    return out + [mask.cuda(), reset.cuda(), src.cuda()]


def row5_args(torch, T, B, H, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.rand(s, generator=g) * 2 - 1) * sc  # noqa: E731
    bf = torch.bfloat16
    mask = (torch.rand((T, B), generator=g) < 0.9).to(torch.uint8).cuda()
    return [r(T, B, 4 * H).to("cuda", bf),
            r(4 * H, H, sc=H ** -0.5).to("cuda", bf),
            r(4 * H, sc=0.1).cuda(), mask,
            r(B, H, sc=0.5).to("cuda", bf), r(B, H, sc=0.5).to("cuda", bf)]


def row7_args(torch, T, B, H, seed):
    """Row 7's inputs: a training step's shapes, W scaled by 1 / sqrt(H),
    an inverted-dropout mask of rate 0.2, a tenth of the steps masked."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.rand(s, generator=g) * 2 - 1) * sc  # noqa: E731
    bf = torch.bfloat16
    sw = H ** -0.5
    dm = (torch.rand((T, B, H), generator=g) < 0.8) / 0.8
    mask = (torch.rand((T, B), generator=g) < 0.9).to(torch.uint8).cuda()
    return [r(T, B, 4 * H).to("cuda", bf), dm.to("cuda", bf),
            r(4 * H, H, sc=sw).to("cuda", bf), r(4 * H, sc=0.1).cuda(),
            r(4 * H, H, sc=sw).to("cuda", bf),
            r(4 * H, H, sc=sw).to("cuda", bf), r(4 * H, sc=0.1).cuda(), mask,
            *(r(B, H, sc=0.5).to("cuda", bf) for _ in range(4))]


# (T, B, H) of test_lstm2_train_fwd_designs_match_plain's persistent calls,
# and a training step's
R7_TEST_CALLS = ((9, 32, 1024), (9, 20, 1024), (5, 7, 544), (1, 32, 1024),
                 (100, 32, 1024))
R7_NAMES = ("ys1", "cs1", "ys2", "cs2", "hT1", "cT1", "hT2", "cT2")


def row7_test_args(torch, T, B, H, masked, dropped):
    """The card test's row-7 inputs (``_lstm2_train_args``): weights
    uniform in +-1 / sqrt(H), dropout keeping 0.8, a fifth masked."""
    g = torch.Generator().manual_seed(7 + masked + 2 * dropped)
    r = lambda *s, sc=1.0: ((torch.rand(s, generator=g) * 2 - 1) * sc)  # noqa: E731
    bf = torch.bfloat16
    sw = H ** -0.5
    dm = ((torch.rand((T, B, H), generator=g) < 0.8) / 0.8 if dropped
          else torch.ones((T, B, H)))
    mask = (torch.rand((T, B), generator=g) < 0.8).to("cuda", torch.uint8) \
        if masked else None
    return [r(T, B, 4 * H).to("cuda", bf), dm.to("cuda", bf),
            r(4 * H, H, sc=sw).to("cuda", bf), r(4 * H, sc=0.1).cuda(),
            r(4 * H, H, sc=sw).to("cuda", bf),
            r(4 * H, H, sc=sw).to("cuda", bf), r(4 * H, sc=0.1).cuda(), mask,
            *(r(B, H, sc=0.5).to("cuda", bf) for _ in range(4))]


def checksum(out):
    """The float64 sum of every output's elements: equal bits, equal sum."""
    return sum(float(a.double().sum()) for a in out)


def share(got, ref, of_max, atol=None):
    """(largest |got - ref|, its largest share of rtol |ref| + of_max
    max|ref|, or of rtol |ref| + atol where ``atol`` is given) over the
    outputs."""
    err = worst = 0.0
    for a, b in zip(got, ref):
        a, b = a.float(), b.float()
        tol = of_max * float(b.abs().max()) if atol is None else atol
        err = max(err, float((a - b).abs().max()))
        worst = max(worst, float(((a - b).abs()
                                  / (tol + RTOL * b.abs())).max()))
    return err, worst


def flat(out):
    ys, (h1, h2), (c1, c2) = out
    return ys, h1, h2, c1, c2


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose bayeslms_tpu_torch/ is measured")
    ap.add_argument("--rows", default="1,3,4,5,7",
                    help="kernel rows to measure, of 1, 3, 4, 5 and 7")
    args = ap.parse_args()
    rows = {int(r) for r in args.rows.split(",")}
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from bayeslms_tpu_torch.ops import lstm2_train_cuda as l2c
    from bayeslms_tpu_torch.ops import lstm_cuda as lc
    from bayeslms_tpu_torch.ops import lstm_train_cuda as ltc

    if not torch.cuda.is_available():
        raise SystemExit("lstm_fwd_designs: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; kernels of {os.path.abspath(args.root)}")
    if args.ptxas:
        ptxas_report()
    # the parent's wrappers have one design: the public call
    two = hasattr(lc, "_lstm2_fwd")
    with torch.no_grad():
        if 1 in rows:
            row1(torch, lc, two, args.repeats)
        if 3 in rows:
            row3(torch, lc, args.repeats)
        if 5 in rows:
            row5(torch, ltc, args.repeats)
        if 4 in rows:
            row4(torch, lc, args.repeats)
        if 7 in rows:
            row7(torch, l2c, args.repeats)


def row1(torch, lc, two, repeats):
    if two:
        print("row 1 on the card test's calls: largest share of the "
              "test's tolerance / of chip_smoke.py's")
        for T, B, H in R1_TEST_CALLS:
            a = row1_args(torch, T, B, H, seed=B + H, keep=0.8,
                          reset_p=0.2, block=10)
            ref = flat(lc.lstm2_plain(*a))
            for d in ("persistent", "per_step"):
                got = flat(lc._lstm2_fwd(d, *a))
                err, q = share(got, ref, R1_SHARE)
                _, q_tight = share(got, ref, R1_SHARE, atol=R1_ATOL)
                print(f"  T={T} B={B} H={H} {d}: max |kernel - plain| "
                      f"{err:.3e}, shares {q:.3f} / {q_tight:.3f}")
    for label, T, B in (("scoring call", 256, 600),
                        ("evaluate call", 100, 20)):
        a = row1_args(torch, T, B, 1024, seed=B)
        ref = lc.lstm2_plain(*a)
        runs = {"public": lambda: lc.lstm2_fwd(*a)}
        if two:
            plan = lc._card_design(a[0].device, T, B, 1024)
            print(f"row 1, {label} T={T} B={B} H=1024: rule "
                  f"{plan['design']}, {plan['ctas']} CTAs, "
                  f"{plan['stages']} stages, {plan['smem_bytes']} bytes")
            runs = {d: (lambda d=d: lc._lstm2_fwd(d, *a))
                    for d in ("persistent", "per_step")}
        for name, fn in runs.items():
            err, q = share(flat(fn()), flat(ref), R1_SHARE)
            _, q_tight = share(flat(fn()), flat(ref), R1_SHARE,
                               atol=R1_ATOL)
            torch.cuda.synchronize()
            ms = cuda_ms(torch, fn, repeats)
            print(f"  {name}: {ms:.3f} ms, max |kernel - plain| "
                  f"{err:.3e}, worst share of the test's tolerance "
                  f"{q:.3f}, of chip_smoke.py's {q_tight:.3f}")
        del a, ref


def row5(torch, ltc, repeats):
    a = row5_args(torch, 100, 32, 1024, seed=5)
    ref = ltc.lstm_train_fwd_plain(*a)
    runs = {"public": lambda: ltc.lstm_train_fwd(*a)}
    if hasattr(ltc, "_train_fwd"):
        rule = ltc._card_design(a[0].device, 32, 1024, 100)
        print(f"row 5, step call T=100 B=32 H=1024: rule "
              f"{rule['fwd_design']}")
        runs = {d: (lambda d=d: ltc._train_fwd(d, *a))
                for d in ("persistent", "per_step")}
    for name, fn in runs.items():
        out = fn()
        err, q = share(out, ref, R5_SHARE)
        torch.cuda.synchronize()
        print(f"  {name}: {cuda_ms(torch, fn, repeats):.3f} ms, "
              f"max |kernel - plain| {err:.3e}, worst share of the "
              f"tolerance {q:.3f}, output checksum {checksum(out)!r}")
    cudnn(torch, 1, 32, repeats)


def cudnn(torch, layers, B, repeats, dropout=0.0):
    """cuDNN's torch.nn.LSTM forward at (T 100, B, H 1,024) in bf16."""
    lstm = torch.nn.LSTM(1024, 1024, num_layers=layers, dropout=dropout,
                         device="cuda", dtype=torch.bfloat16)
    x = torch.randn((100, B, 1024), device="cuda", dtype=torch.bfloat16)
    print(f"  cuDNN torch.nn.LSTM forward ({layers} layer(s), dropout "
          f"{dropout}): {cuda_ms(torch, lambda: lstm(x), repeats):.3f} ms")


def designs(module, fn_name, private, a):
    """{design: call} in both designs where the checkout has them, else
    {"public": call}."""
    if not hasattr(module, private):
        return {"public": lambda: getattr(module, fn_name)(*a)}
    run = getattr(module, private)
    return {d: (lambda d=d: run(d, *a)) for d in ("persistent", "per_step")}


def row4(torch, lc, repeats):
    """Row 4 at an evaluate window's call, unmasked and with a tenth of the
    steps masked."""
    a = row5_args(torch, 100, 20, 1024, seed=4)
    xg, w, b, mask, h0, c0 = a
    h0, c0 = h0.float(), c0.float()  # evaluate's carries are float32
    if hasattr(lc, "_design_fwd"):
        plan = lc._design_fwd(100, 20, 1024, torch.cuda.get_device_properties(
            0).multi_processor_count)
        print(f"row 4, evaluate call T=100 B=20 H=1024: rule "
              f"{plan['design']}, {plan['ctas']} CTAs, {plan['smem_bytes']} "
              f"bytes")
    for label, m in (("unmasked", None), ("masked", mask)):
        call = [xg, w, b, h0, c0, m]
        ref = lc.lstm_fwd_plain(*call)
        for name, fn in designs(lc, "lstm_fwd", "_lstm_fwd", call).items():
            err, q = share(fn(), ref, R5_SHARE)
            torch.cuda.synchronize()
            print(f"  {label} {name}: {cuda_ms(torch, fn, repeats):.3f} ms, "
                  f"max |kernel - plain| {err:.3e}, worst share of the "
                  f"tolerance {q:.3f}")
    cudnn(torch, 1, 20, repeats)


def row3(torch, lc, repeats):
    """Row 3 at the GP packed-carry pass's call: the streamed design at
    three ring depths, then the per-step design (the parent's public
    call)."""
    T, B, H = 256, 600, 1024
    a = row1_args(torch, T, B, H, seed=3)
    call = [a[0], a[1], a[2], a[6].float(), a[7].float(), *a[10:]]
    ref = lc.lstm_fwd_plain(*call)
    runs = {"public": lambda: lc.lstm_fwd(*call)}
    if hasattr(lc, "_stream_plan"):
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        rule = lc._design_fwd(T, B, H, n_sm, resets=True)
        print(f"row 3, packed-carry call T={T} B={B} H={H}: rule "
              f"{rule['design']}, {rule.get('units')} units, "
              f"{rule.get('stages')} stages, {rule['smem_bytes']} bytes")
        runs = {}
        for stages in sorted({rule["stages"], 8, 4}, reverse=True):
            # the rule's depth, then shallower rings: its cap lowered
            def fn(cap=stages):
                with mock.patch.object(lc, "S_MAX_NST", cap):
                    return lc._lstm_fwd("streamed", *call)
            runs[f"streamed, two rings of {stages // 2} stages "
                 f"({rule['ctas']} CTAs, {lc.stream_smem(H, stages)} "
                 f"bytes)"] = fn
        runs["per_step"] = lambda: lc._lstm_fwd("per_step", *call)
    for name, fn in runs.items():
        err, q = share(fn(), ref, R5_SHARE)
        torch.cuda.synchronize()
        print(f"  {name}: {cuda_ms(torch, fn, repeats):.3f} ms, max |kernel "
              f"- plain| {err:.3e}, worst share of the tolerance {q:.3f}")
    del a, call, ref


def row7(torch, l2c, repeats):
    """Row 7 on the card test's calls, then at a training step's call,
    with its dropout and step masks."""
    if hasattr(l2c, "_train_fwd"):
        print("row 7 on the card test's calls: each output's share of "
              "chip_smoke.py's tolerance / of the card test's")
        for T, B, H in R7_TEST_CALLS:
            for masked, dropped in ((False, False), (True, True)):
                a = row7_test_args(torch, T, B, H, masked, dropped)
                ref = l2c.lstm2_train_fwd_plain(*a)
                for d in ("persistent", "per_step"):
                    got = l2c._train_fwd(d, *a)
                    shares = [(share([x], [y], R5_SHARE)[1],
                               share([x], [y], R1_SHARE)[1])
                              for x, y in zip(got, ref)]
                    print(f"  T={T} B={B} H={H} masked={masked} dropped="
                          f"{dropped} {d}: " + " ".join(
                              f"{n} {q:.3f}/{q2:.3f}"
                              for n, (q, q2) in zip(R7_NAMES, shares)))
    a = row7_args(torch, 100, 32, 1024, seed=7)
    if "fwd_design" in l2c._design(32, 1024, 132, 100):
        plan = l2c._card_design(a[0].device, 32, 1024, 100)
        print(f"row 7, step call T=100 B=32 H=1024: rule "
              f"{plan['fwd_design']}, {plan['fwd_smem_bytes']} bytes, input "
              f"GEMM grid {plan['fwd_gemm_grid']}")
    ref = l2c.lstm2_train_fwd_plain(*a)
    for name, fn in designs(l2c, "lstm2_train_fwd", "_train_fwd",
                            a).items():
        err, q = share(fn(), ref, R5_SHARE)
        torch.cuda.synchronize()
        print(f"  {name}: {cuda_ms(torch, fn, repeats):.3f} ms, max |kernel "
              f"- plain| {err:.3e}, worst share of the tolerance {q:.3f}")
    cudnn(torch, 2, 32, repeats, dropout=0.2)


if __name__ == "__main__":
    main()
