#!/usr/bin/env python3
"""Where one warm rescoring pass of the PyTorch/CUDA port spends its time.

    python3 tools/port_pass_profile.py [--model Transformer] [--xl]
                                       [--l-gauss-pos S] [--repeats 3]

Needs a CUDA card and nvcc. Builds the configuration and N-best of
chip_smoke.py (the bench's 2-layer 1024/1024 LSTM LM, V = 49,152, bf16,
6,000 hypotheses; ``--model Transformer``: the recipe's Transformer of
chip_smoke.py on the same table, through the packed-nocarry layout;
``--xl``: that Transformer through the Transformer-XL layout, chains by
recording as chip_smoke.py scores them; ``--l-gauss-pos S``: the GP-LSTM of
that ``l_gauss_pos`` string through packed-carry, its GP cell on the scan
(``13``, ``63``: under resets rows 20 and 18 take no part, as in JAX) and
its standard layer on kernel row 3), runs one warm-up pass, times
``--repeats`` passes without the profiler (each and their median), then
traces one pass with torch.profiler and
prints the device time by kernel (the port's kernels named by their row of
PERF.md's kernel table), the device's busy time and its idle
share of the traced pass, the host's time by operator (self time: the
CUDA runtime calls, among them every launch and synchronisation, are rows
of their own) and the model forwards the pass made. Nothing is written to
disk. To compare two checkouts, run each one's copy of this script in one
call (a parent unpacked by ``git archive``), parent, change, change,
parent.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import argparse
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from bayeslms_tpu_torch import build_model, init_params
    from bayeslms_tpu_torch.rescore.scorer import BatchScorer

    if not torch.cuda.is_available():
        print("port_pass_profile: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("LSTM", "Transformer"),
                    default="LSTM")
    ap.add_argument("--xl", action="store_true",
                    help="the Transformer through the xl_mems layout")
    ap.add_argument("--l-gauss-pos", default="",
                    help="the GP-LSTM at this l_gauss_pos string, e.g. 13")
    ap.add_argument("--repeats", type=int, default=3,
                    help="untraced passes timed")
    args = ap.parse_args()
    cfg, rcfg, w2i, nbest = chip_smoke.bench_setup()
    if args.l_gauss_pos:
        cfg = dataclasses.replace(cfg, uncertainty="Gaussian",
                                  l_gauss_pos=args.l_gauss_pos)
    if args.model == "Transformer" or args.xl:
        cfg = chip_smoke.tm_config(cfg)
    if args.xl:
        rcfg = dataclasses.replace(rcfg, xl_mems=True)
        nbest = chip_smoke.make_synthetic_nbest(n_meetings=30)
    scorer = BatchScorer(cfg, init_params(build_model(cfg), cfg, seed=0), rcfg)

    def one_pass():
        scorer.score_nbest(nbest, w2i, stream_fn=chip_smoke.stream_of)
        torch.cuda.synchronize()

    one_pass()
    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        one_pass()
        times.append(time.perf_counter() - t0)
    plain_s = sorted(times)[len(times) // 2]
    forwards = []
    hook = scorer.model.register_forward_pre_hook(
        lambda *a: forwards.append(1))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_pass()
        traced_s = time.perf_counter() - t0
    hook.remove()
    # device-side events only (kernels, copies): an operator's row would
    # count its kernels' time a second time
    rows = [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type != DeviceType.CPU and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"passes {', '.join(f'{t * 1e3:.1f}' for t in times)} ms "
          f"untraced (median {plain_s * 1e3:.1f}), {traced_s * 1e3:.1f} ms "
          f"traced; device busy {busy_ms:.1f} ms, idle share "
          f"{1 - busy_ms / (traced_s * 1e3):.3f} of the traced pass "
          f"({torch.cuda.get_device_name(0)}; {cfg.model}, uncertainty "
          f"{cfg.uncertainty}, l_gauss_pos {cfg.l_gauss_pos})")
    print("device ms  calls  table row  name")
    for dev_us, count, key in [r for i, r in enumerate(rows)
                               if i < 15 or chip_smoke.kernel_row(r[2])]:
        print(f"{dev_us / 1e3:9.3f}  {count:5d}  "
              f"{chip_smoke.kernel_row(key):>9}  {key[:90]}")
    host = [(ev.self_cpu_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CPU and ev.self_cpu_time_total > 0]
    host.sort(reverse=True)
    print(f"host self ms by operator (of {traced_s * 1e3:.1f} ms traced; "
          f"{len(forwards)} model forwards, "
          f"{sum(n for _, n, _ in rows)} device events)")
    for cpu_us, count, key in host[:15]:
        print(f"{cpu_us / 1e3:9.3f}  {count:6d}  {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
