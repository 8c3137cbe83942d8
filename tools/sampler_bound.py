#!/usr/bin/env python3
"""Kernel row 13 (the Bayesian gate-slice sampler, ``csrc/bayes_sample.cu``)
against both of its bounds on one card: the bytes it must move and the
instructions it must issue.

    python3 tools/sampler_bound.py [--out chiprun_out/bayes_sample.sass]
                                   [--root CHECKOUT]

Needs a CUDA card, nvcc and cuobjdump. It builds the kernel, disassembles
``bayes_sample_kernel`` (``cuobjdump -sass``, the listing written to
``--out``) and counts its instructions (``issue_count``): the grid-stride
loop's body (from the loop's head to the branch that closes it), less its
slow paths, is what every loop iteration issues. A slow path is the code
that a conditional forward branch in the loop jumps over where that code
calls a subroutine or touches local memory or doubles (CALL, LDL, STL,
DMUL): the accurate cosf's Payne-Hanek reduction, which arguments in [0,
2 pi) never take, sqrtf's and the 64-bit division's out-of-line cases.
The issue bound (``issue_bound_s``) is then (elements / elements an
iteration / 32) x that count warp instructions over 132 SMs x 4 issue
slots a clock x the SM clock (``nvidia-smi`` clocks.max.sm: the least
time); it counts a half-rate instruction (IMAD, on the H100) as one slot,
so it is a floor. chip_smoke.py gives row 13's ``bound_ms`` with these
functions. The bytes bound reads each lgstd and writes each sample once
(8 bytes an element) at 3.35 TB/s. Both at the Bayesian LSTM's step: four
(1,024, 1,024) float32 slices, on the kernel's table instantiation
(``bayes_sample_kernel<false>``; the one-slice one is counted too).

Then it times, by torch.profiler's device time (median of 5 profiles of 20
calls each), the step's one launch over the four slices, the same four
slices in four one-slice launches, and row 12's backward redraw (a
one-slice draw with a mean, ``sample_weights(mean, lgstd, seed)``) at the
Transformer's Bayesian FFN shapes (512, 4,096) and (4,096, 512), and
checks that the table and the one-slice launches draw the same bits.
``--root`` measures another checkout's kernel (a parent unpacked by ``git
archive``, whose kernel draws one slice a launch, a pair of elements a
loop iteration): its SASS count, its four one-slice launches and the
redraws.
"""

import argparse
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PEAK_BYTES_PER_S = 3.35e12
ISSUE_SLOTS = 4  # warp instructions a clock an SM: one per sub-partition
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
TARGET = re.compile(r"`\((\.L_x_\d+)\)|BRA(?:\.\S+)?\s+(0x[0-9a-f]+)")


def function_sass(sass, name):
    """The lines of the function whose mangled name holds ``name``."""
    out, on = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            on = name in line
            continue
        if on:
            out.append(line)
    return out


def parse(lines):
    """[(address, text)] of the instructions and {label: address}."""
    insns, labels, pending = [], {}, []
    for line in lines:
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            insns.append((addr, m.group(2).strip()))
    return insns, labels


def loops(insns, labels):
    """(head, branch) address pairs of the backward branches."""
    out = []
    for addr, text in insns:
        m = TARGET.search(text)
        if not m or "BRA" not in text:
            continue
        to = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if to is not None and to <= addr:
            out.append((to, addr))
    return out


def count(insns, lo, hi):
    return sum(1 for a, _ in insns if lo <= a <= hi)


SLOW = ("CALL", "LDL", "STL", "DMUL")


def slow_paths(insns, labels, head, tail):
    """(first, last) address ranges in [head, tail] that a conditional
    forward branch jumps over and that hold a CALL, LDL, STL or DMUL."""
    out = []
    for addr, text in insns:
        if not head <= addr <= tail or not text.startswith("@") \
                or "BRA" not in text:
            continue
        m = TARGET.search(text)
        if not m:
            continue
        to = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if to is None or to <= addr:
            continue
        skipped = [t for a, t in insns if addr < a < to]
        if any(opcode(t) in SLOW for t in skipped):
            out.append((addr + 1, to - 1))
    return out


def covered(a, ranges):
    return any(x <= a <= y for x, y in ranges)


def opcode(text):
    words = [w for w in text.split() if not w.startswith("@")]
    return words[0].split(".")[0] if words else "?"


def kernel_lines(lib, names):
    """The SASS lines of the first of ``names`` (parts of a mangled name)
    that ``cuobjdump -sass`` finds in the library ``lib``: (lines, name)."""
    from bayeslms_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    for name in names:
        lines = function_sass(sass, name)
        if lines:
            return lines, name
    raise SystemExit(f"sampler_bound: none of {names} in the SASS of {lib}")


def issue_count(lines):
    """The grid-stride loop of a kernel's SASS ``lines``: a dict of the
    function's instructions (total), the loop's body and its addresses,
    the slow paths in it, the instructions a loop iteration issues off
    them (hot) and those by opcode (hist)."""
    insns, labels = parse(lines)
    found = sorted(loops(insns, labels), key=lambda p: p[1] - p[0])
    if not found:
        raise SystemExit("sampler_bound: no loop found in the kernel's SASS")
    head, tail = found[-1]  # the widest: the grid-stride loop
    slow = slow_paths(insns, labels, head, tail)
    hot = [t for a, t in insns if head <= a <= tail and not covered(a, slow)]
    hist = {}
    for text in hot:
        hist[opcode(text)] = hist.get(opcode(text), 0) + 1
    return dict(total=len(insns), body=count(insns, head, tail), head=head,
                tail=tail, slow=len(slow), hot=len(hot), hist=hist)


def issue_bound_s(elements, per_iter, insns, clk_mhz):
    """(warp instructions, seconds to issue them) for ``elements`` drawn
    ``per_iter`` a loop iteration of ``insns`` instructions, at 132 SMs x
    ``ISSUE_SLOTS`` a clock at ``clk_mhz``."""
    warp = elements / per_iter / 32 * insns
    return warp, warp / (132 * ISSUE_SLOTS * clk_mhz * 1e6)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "bayes_sample.sass"))
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose bayeslms_tpu_torch/ is measured")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bayeslms_tpu_torch.ops import _build
    from bayeslms_tpu_torch.ops import bayes_sample_cuda as bsc

    if not torch.cuda.is_available():
        raise SystemExit("sampler_bound: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    name, limit, clk, clk_max = [s.strip() for s in smi.split(",")]
    print(f"{name}, {limit} W; SM clock {clk} MHz now, {clk_max} MHz at "
          f"most; kernel of {os.path.abspath(args.root)}")
    table = hasattr(bsc, "sample_slices")
    per_iter = 4 if table else 2  # elements a loop iteration

    lib = _build.build(["bayes_sample"])["bayes_sample"]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    n_slices, N, K = 4, 1024, 1024
    elements = n_slices * N * K
    t_bytes = elements * 8 / PEAK_BYTES_PER_S
    # the table's instantiation (the step's launch) first, then the
    # one-slice one (row 12's redraw); the parent has one kernel
    kinds = [("table", "bayes_sample_kernelILb0E"),
             ("one-slice", "bayes_sample_kernelILb1E")]
    if not table:
        kinds = [("one-slice", "bayes_sample_kernel")]
    t_issue = None
    for kind, mangled in kinds:
        lines, _ = kernel_lines(lib, [mangled])
        out = args.out if t_issue is None else args.out.replace(
            ".sass", f".{kind}.sass")
        with open(out, "w") as f:
            f.write("\n".join(lines) + "\n")
        c = issue_count(lines)
        print(f"bayes_sample_kernel ({kind}): {c['total']} SASS "
              f"instructions; the grid-stride loop's body {c['body']} "
              f"(0x{c['head']:x}-0x{c['tail']:x}), of them "
              f"{c['body'] - c['hot']} on {c['slow']} slow paths; "
              f"{c['hot']} a loop iteration of {per_iter} elements, "
              f"{c['hot'] / per_iter:.2f} an element; listing in {out}")
        print("  by opcode: " + ", ".join(
            f"{k} {v}" for k, v in sorted(c["hist"].items(),
                                          key=lambda kv: -kv[1])))
        warp, t = issue_bound_s(elements, per_iter, c["hot"], float(clk_max))
        _, t_body = issue_bound_s(elements, per_iter, c["body"],
                                  float(clk_max))
        print(f"  the step's {n_slices} ({N}, {K}) slices on it: {warp:.4g} "
              f"warp instructions, issue bound {t * 1e6:.2f} us at "
              f"{clk_max} MHz (the whole loop body, slow paths included: "
              f"{t_body * 1e6:.2f} us); bytes bound {t_bytes * 1e6:.2f} us; "
              f"binds: {'issue' if t >= t_bytes else 'bytes'}")
        if t_issue is None:
            t_issue = t

    g = torch.Generator().manual_seed(13)
    lgs = [(torch.rand((N, K), generator=g) * 3 - 3).cuda()
           for _ in range(n_slices)]
    seeds = torch.tensor([11, 22, 33, 44], dtype=torch.int32, device="cuda")
    alone = [bsc.sample_weights(None, lg, seeds[i:i + 1].clone())
             for i, lg in enumerate(lgs)]
    same = True
    if table:
        drawn = bsc.sample_slices(lgs, seeds)
        same = all(torch.equal(a, b) for a, b in zip(drawn, alone))
        print(f"one launch's slices equal the one-slice launches' bit for "
              f"bit: {same}")

    def device_us(fn, calls=20, profiles=5):
        fn()
        torch.cuda.synchronize()
        got = []
        for _ in range(profiles):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            us = sum(ev.self_device_time_total for ev in prof.key_averages()
                     if ev.device_type != DeviceType.CPU)
            got.append(us / calls)
        return (f"{np.median(got):.2f} us (profiles "
                f"{', '.join(f'{x:.2f}' for x in got)})")

    one_seeds = [seeds[i:i + 1].clone() for i in range(n_slices)]
    line = "four one-slice launches " + device_us(lambda: [
        bsc.sample_weights(None, lg, s) for lg, s in zip(lgs, one_seeds)])
    if table:
        line = ("one launch " + device_us(lambda: bsc.sample_slices(
            lgs, seeds)) + ", " + line)
    print(f"device time of the step's draw: {line}; the bound "
          f"{max(t_issue, t_bytes) * 1e6:.2f} us")
    # row 12's backward: W = mean + exp(lgstd) eps drawn again, one slice
    for shape in ((512, 4096), (4096, 512)):
        lg = (torch.rand(shape, generator=g) * 3 - 3).cuda()
        mean = (torch.rand(shape, generator=g) - 0.5).cuda()
        s = seeds[:1].clone()
        print(f"row 12's redraw, sample_weights(mean, lgstd, seed) at "
              f"{shape}: " + device_us(
                  lambda: bsc.sample_weights(mean, lg, s)))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
