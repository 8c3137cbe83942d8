#!/usr/bin/env python3
"""Rows 15-17 (the flash-attention training kernels) in both designs on one
card, at one call's shape: the tensor-core kernels of rows 15 and 17
("wgmma") and the CUDA-core kernels ("simt", which rows 15 and 17 ran
before and row 16 still runs), each against the plain twin.

    python3 tools/attn_train_designs.py [--T 1024 --B 32 --heads 8 --d 64]
                                        [--rate 0.2] [--ptxas]

Needs a CUDA card and nvcc. q, k and v are column views of one fused
(T, B, 3 E) bf16 projection, as the Transformer's step hands them; dO is
(T, B, E). The design rule sends rows 15 and 17 on these views to the
tensor cores, and on copies of them in a (T, B, E + 4) buffer (a batch
stride TMA cannot describe) to the CUDA cores. For each design it prints each kernel's time (CUDA events,
median of 10 calls after a warm-up) and its largest share of the tolerance
chip_smoke.py holds it to against the twin (|kernel - plain| <= 2^-7
|plain| + 2^-10 max|plain|); whether the keep bits each kernel draws equal
the twin's; and the largest |sum_c P - 1| of the P that rows 16 and 17
rebuild from row 15's (m, l): row 17's from the wgmma kernel's debug sums,
row 16's from the CUDA-core forward, whose scores are row 16's arithmetic
(sum_c exp(s - m) = l' exp(m' - m) with that forward's (m', l')).
``--ptxas`` first compiles csrc/attention_train.cu with ``-Xptxas -v`` and
prints each kernel's registers, spills and shared memory.
"""

import argparse
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, SHARE = 2 ** -7, 2 ** -10


def ptxas_report():
    """nvcc's -Xptxas -v lines for the attention training library."""
    from bayeslms_tpu_torch.ops import _build

    out = os.path.join(ROOT, "chiprun_out", "attention_train_ptxas.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cmd = [_build._nvcc(), *_build.FLAGS, "-Xptxas", "-v", "-o", out,
           os.path.join(_build.CSRC, "attention_train.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for line in (res.stdout + res.stderr).splitlines():
        if any(w in line for w in ("Compiling entry", "Used", "spill",
                                   "error", "warning", "wgmma")):
            print("  " + line.strip())
    if res.returncode:
        raise SystemExit(f"nvcc failed ({res.returncode})")
    os.remove(out)


def share(torch, got, ref):
    g, r = got.float(), ref.float()
    atol = SHARE * float(r.abs().max())
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--T", type=int, default=1024)
    ap.add_argument("--B", type=int, default=32)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--rate", type=float, default=0.2)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
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
                      for n in ("attn_train_fwd", "attn_train_dkv")}
            o, m, l = atc.attn_train_fwd(qd, kd, vd, h, rate, seed)
            stats[design] = (m, l)
            args_t = (qd, kd, vd, gd, rm, rl, delta, h, rate, seed)
            dk, dv = atc.attn_train_dkv(*args_t)
            if any(atc.design_launches[n][design] != c + 1
                   for n, c in before.items()):
                raise SystemExit(f"the views for {design} took the other "
                                 "design")
            rdk, rdv = atc.attn_train_dkv_plain(*args_t)
            torch.cuda.synchronize()
            ms_f = timed(torch, lambda: atc.attn_train_fwd(
                qd, kd, vd, h, rate, seed))
            ms_kv = timed(torch, lambda: atc.attn_train_dkv(*args_t))
            print(f"  {design}: row 15 {ms_f:.4f} ms (share of the "
                  f"tolerance: o {share(torch, o, ro):.3f}, m "
                  f"{float((m - rm).abs().max()):.2e}, l rel "
                  f"{float(((l - rl) / rl).abs().max()):.2e}); row 17 "
                  f"{ms_kv:.4f} ms (dk {share(torch, dk, rdk):.3f}, dv "
                  f"{share(torch, dv, rdv):.3f})")
        ms_q = timed(torch, lambda: atc.attn_train_dq(
            q, k, v, g, rm, rl, delta, h, rate, seed))
        print(f"  row 16 (simt): {ms_q:.4f} ms")
        # the backward kernels on the wgmma forward's (m, l)
        m, l = stats["wgmma"]
        args_k = (q, k, v, g, m, l, delta, h, rate, seed)
        psum = torch.zeros((BH, T), dtype=torch.float32, device="cuda")
        dk, dv = atc.attn_train_dkv(*args_k, psum_out=psum)
        rdk, rdv = atc.attn_train_dkv_plain(*args_k)
        dq = atc.attn_train_dq(*args_k)
        rdq = atc.attn_train_dq_plain(*args_k)
        print(f"  on the wgmma forward's (m, l): dq {share(torch, dq, rdq):.3f}"
              f", dk {share(torch, dk, rdk):.3f}, dv "
              f"{share(torch, dv, rdv):.3f} of the tolerance")
        ms_, ls_ = stats["simt"]
        p16 = ls_ * torch.exp(ms_ - m) / l
        print(f"  max |sum_c P - 1| against the wgmma forward's (m, l): row "
              f"17 {float((psum - 1).abs().max()):.3e}, row 16 "
              f"{float((p16 - 1).abs().max()):.3e}")
        if rate > 0:
            tril = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
            for name in ("attn_train_fwd", "attn_train_dkv"):
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
