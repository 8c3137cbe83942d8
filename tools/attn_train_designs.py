#!/usr/bin/env python3
"""The causal attention kernels in both designs on one card: rows 15-17 (the
flash-attention training kernels) at one call's shape, or with ``--row14``
row 14 (the inference forward) at the shapes that call it; the tensor-core
kernels ("wgmma") and the CUDA-core kernels ("simt", which fp32, d = 256
and views TMA cannot describe take), each against the plain twin.

    python3 tools/attn_train_designs.py [--T 1024 --B 32 --heads 8 --d 64]
                                        [--rate 0.2] [--ptxas] [--row14]

Needs a CUDA card and nvcc. q, k and v are column views of one fused
(T, B, 3 E) bf16 projection, as the Transformer hands them; dO is
(T, B, E). The design rule sends the kernels on these views to the tensor
cores, and on copies of them in a (T, B, E + 4) buffer (a batch stride TMA
cannot describe) to the CUDA cores. For each design it prints each
kernel's time (CUDA events around one wrapper call, median of 10 after a
warm-up) and its largest share of the tolerance chip_smoke.py holds it to
against the twin (rows 15-17: |kernel - plain| <= 2^-7 |plain| + 2^-10
max|plain|; row 14: 2^-7 |plain| + 2^-14 max|plain|); for rows 15-17,
whether the keep bits each kernel draws equal the twin's, and the largest
|sum_c P - 1| of the P that rows 16 and 17 rebuild from row 15's (m, l),
from each wgmma kernel's debug sums. ``--row14`` times row 14's designs
beside F.scaled_dot_product_attention (is_causal, on (B, h, T, d) copies)
at the eval window (T 100, B 20), the Transformer-XL memory builds (B 1, T
32, 64, 100, 128) and T = 4,096 (B 2), 8 heads of d = 64 (``--heads``,
``--d``). ``--ptxas`` first compiles csrc/attention_train.cu and
csrc/attention_fwd.cu with ``-Xptxas -v`` and prints each kernel's
registers, spills and shared memory. ``--row14 --root CHECKOUT`` measures
another checkout's row 14 (a parent unpacked by ``git archive``; only its
``bayeslms_tpu_torch/`` is needed) on the same inputs, on the views alone
where that checkout has one design.
"""

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, SHARE = 2 ** -7, 2 ** -10
ROW14_SHARE = 2 ** -14
# row 14's (label, T, B): the eval window, the XL memory builds, long T
ROW14_SHAPES = [("eval", 100, 20), ("XL build", 32, 1), ("XL build", 64, 1),
                ("XL build", 100, 1), ("XL build", 128, 1),
                ("T=4096", 4096, 2)]


def ptxas_report():
    """nvcc's -Xptxas -v lines for the attention libraries."""
    from bayeslms_tpu_torch.ops import _build

    for src in ("attention_train", "attention_fwd"):
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


def share(torch, got, ref, share_of_max=SHARE):
    g, r = got.float(), ref.float()
    atol = share_of_max * float(r.abs().max())
    return float(((g - r).abs() / (atol + RTOL * r.abs())).max())


def unaligned(torch, *xs):
    """Copies of (T, B, E) views in a (T, B, E + 4) buffer: the same bf16
    values on a batch stride TMA cannot describe."""
    out = []
    for x in xs:
        buf = torch.empty((*x.shape[:2], x.shape[2] + 4), dtype=x.dtype,
                          device=x.device)
        buf[..., :x.shape[2]] = x
        out.append(buf[..., :x.shape[2]])
    return out


def timed(torch, fn, repeats=10):
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


def row14(torch, h, d):
    """Row 14's designs beside SDPA at ROW14_SHAPES."""
    from bayeslms_tpu_torch.ops import attention_cuda as acu

    F = torch.nn.functional
    E = h * d
    gen = torch.Generator(device="cuda").manual_seed(6)
    with torch.no_grad():
        for label, T, B in ROW14_SHAPES:
            qkv = torch.randn((T, B, 3 * E), generator=gen, device="cuda") \
                .to(torch.bfloat16)
            qkv_views = qkv.split(E, dim=-1)
            counts = getattr(acu, "design_launches", None)
            if counts is None:  # a checkout with one design
                views = {"as built": qkv_views}
            else:
                views = {"wgmma": qkv_views,
                         "simt": unaligned(torch, *qkv_views)}
            ref = acu.causal_attention_plain(*qkv_views, h)
            line = []
            for design, (q, k, v) in views.items():
                before = dict(counts or {})
                o = acu.causal_attention(q, k, v, h)
                if counts is not None and counts[design] != before[design] + 1:
                    raise SystemExit(f"row 14 at {label}: the views for "
                                     f"{design} took the other design")
                ms = timed(torch, lambda: acu.causal_attention(q, k, v, h))
                line.append(f"{design} {ms:.4f} ms (share "
                            f"{share(torch, o, ref, ROW14_SHARE):.3f})")
            heads = [x.reshape(T, B, h, d).permute(1, 2, 0, 3).contiguous()
                     for x in qkv_views]
            lib = timed(torch, lambda: F.scaled_dot_product_attention(
                *heads, is_causal=True))
            print(f"  row 14 {label} T={T} B={B}: " + ", ".join(line)
                  + f"; SDPA {lib:.4f} ms")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--T", type=int, default=1024)
    ap.add_argument("--B", type=int, default=32)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--rate", type=float, default=0.2)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--row14", action="store_true",
                    help="row 14's designs at its shapes instead of rows "
                         "15-17")
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose kernels to measure")
    args = ap.parse_args()
    if args.root != ROOT and not args.row14:
        ap.error("--root measures row 14 only (with --row14)")
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from bayeslms_tpu_torch.ops import attention_train_cuda as atc

    if not torch.cuda.is_available():
        print("attn_train_designs: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if args.ptxas:
        ptxas_report()
    print(f"kernels of {os.path.abspath(args.root)}")
    if args.row14:
        row14(torch, args.heads, args.d)
        return 0
    T, B, h, d, rate = args.T, args.B, args.heads, args.d, args.rate
    E, BH = h * d, B * h
    print(f"T={T} B={B} heads={h} d={d} bf16 dropout {rate}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    qkv = torch.randn((T, B, 3 * E), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    q, k, v = qkv.split(E, dim=-1)
    g = (torch.randn((T, B, E), generator=gen, device="cuda") * 1e-3) \
        .to(torch.bfloat16)
    seed = torch.tensor([20260], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        ro, rm, rl = atc.attn_train_fwd_plain(q, k, v, h, rate, seed)
        delta = atc.row_delta(g, ro, h)
        stats = {}
        views = {"simt": unaligned(torch, q, k, v, g),
                 "wgmma": (q, k, v, g)}
        for design in ("simt", "wgmma"):
            qd, kd, vd, gd = views[design]
            before = {n: atc.design_launches[n][design]
                      for n in atc.design_launches}
            o, m, l = atc.attn_train_fwd(qd, kd, vd, h, rate, seed)
            stats[design] = (m, l)
            args_t = (qd, kd, vd, gd, rm, rl, delta, h, rate, seed)
            dq = atc.attn_train_dq(*args_t)
            dk, dv = atc.attn_train_dkv(*args_t)
            if any(atc.design_launches[n][design] != c + 1
                   for n, c in before.items()):
                raise SystemExit(f"the views for {design} took the other "
                                 "design")
            rdq = atc.attn_train_dq_plain(*args_t)
            rdk, rdv = atc.attn_train_dkv_plain(*args_t)
            torch.cuda.synchronize()
            ms_f = timed(torch, lambda: atc.attn_train_fwd(
                qd, kd, vd, h, rate, seed))
            ms_q = timed(torch, lambda: atc.attn_train_dq(*args_t))
            ms_kv = timed(torch, lambda: atc.attn_train_dkv(*args_t))
            print(f"  {design}: row 15 {ms_f:.4f} ms (share of the "
                  f"tolerance: o {share(torch, o, ro):.3f}, m "
                  f"{float((m - rm).abs().max()):.2e}, l rel "
                  f"{float(((l - rl) / rl).abs().max()):.2e}); row 16 "
                  f"{ms_q:.4f} ms (dq {share(torch, dq, rdq):.3f}); row 17 "
                  f"{ms_kv:.4f} ms (dk {share(torch, dk, rdk):.3f}, dv "
                  f"{share(torch, dv, rdv):.3f})")
        # the backward kernels on the wgmma forward's (m, l)
        m, l = stats["wgmma"]
        args_k = (q, k, v, g, m, l, delta, h, rate, seed)
        psum = torch.zeros((BH, T), dtype=torch.float32, device="cuda")
        dk, dv = atc.attn_train_dkv(*args_k, psum_out=psum)
        psum16 = torch.zeros((BH, T), dtype=torch.float32, device="cuda")
        dq = atc.attn_train_dq(*args_k, psum_out=psum16)
        rdk, rdv = atc.attn_train_dkv_plain(*args_k)
        rdq = atc.attn_train_dq_plain(*args_k)
        print(f"  on the wgmma forward's (m, l): dq {share(torch, dq, rdq):.3f}"
              f", dk {share(torch, dk, rdk):.3f}, dv "
              f"{share(torch, dv, rdv):.3f} of the tolerance")
        print(f"  max |sum_c P - 1| against the wgmma forward's (m, l): row "
              f"17 {float((psum - 1).abs().max()):.3e}, row 16 "
              f"{float((psum16 - 1).abs().max()):.3e}")
        if rate > 0:
            tril = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
            for name in atc.launches:
                bits, _ = atc.keep_bits(name, q, k, v, h, rate, seed, g, m,
                                        l, delta)
                same = all(torch.equal(bits[b0:b0 + 16], atc.keep_plain(
                    seed, torch.arange(b0, min(BH, b0 + 16), device="cuda"),
                    T, rate) & tril) for b0 in range(0, BH, 16))
                print(f"  {name} (wgmma) keep bits equal to the twin's: "
                      f"{same}")
                del bits
    return 0


if __name__ == "__main__":
    sys.exit(main())
