#!/usr/bin/env python3
"""Where one warm training step of the PyTorch/CUDA port spends its time.

    python3 tools/port_train_profile.py [--bayes-pos N | --l-gauss-pos S |
                                         --model Transformer
                                         [--t-bayes-pos FFN|MHA|EMB]]
                                        [--seq-len T] [--fused-lstm2]

Needs a CUDA card and nvcc. Builds the training configuration of
chip_smoke.py (the bench's 2-layer 1024/1024 LSTM LM, V = 49,152, bf16,
dropout 0.2; batch 32, seq_len 100, the recipe's lr, momentum and clip) on
its synthetic Markov corpus; ``--bayes-pos N`` (1-5) trains the Bayesian
gate-slice LSTM at ``l_bayes_pos=N`` instead, its KL scaled by
seq_len / rows as in ``Trainer.run_epoch``; ``--l-gauss-pos S`` the GP-LSTM
of that ``l_gauss_pos`` string (the recipes' ``13``: GP kernel rows 20-21
for the GP cell, rows 5-6 for its standard layer; the README's ``63``: rows
18-19 for the gate-6 GP cell); ``--model Transformer`` the
recipe's Transformer of chip_smoke.py (512/4096 x 6, 8 heads, lr 0.1), and
``--t-bayes-pos`` its Bayesian variant; ``--seq-len 1024`` the window at
which the Transformer's training attention takes the flash-attention
kernels (rows 15-17); ``--fused-lstm2`` sets ``BAYESLM_PALLAS_LSTM2_TRAIN=1``,
the JAX package's opt-in fused 2-layer training route (rows 7-8 in place of
two rows 5-6 calls). It runs three warm-up steps, times five steps
without the profiler, then traces three steps with torch.profiler and prints
the device time by kernel (each of the port's kernels named by its row of
PERF.md's kernel table), the device's busy time and its idle share of the
traced steps. Nothing is written to disk outside a temporary directory.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import argparse
    import dataclasses

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from bayeslms_tpu_torch import TrainConfig
    from bayeslms_tpu_torch.data.corpus import Corpus, batchify, windows
    from bayeslms_tpu_torch.models.lstm_lm import init_hidden
    from bayeslms_tpu_torch.train.loop import Trainer

    if not torch.cuda.is_available():
        print("port_train_profile: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--bayes-pos", type=int, default=0,
                    help="1-5: the Bayesian LSTM at this l_bayes_pos")
    ap.add_argument("--l-gauss-pos", default="",
                    help="the GP-LSTM at this l_gauss_pos string, e.g. 13")
    ap.add_argument("--model", choices=("LSTM", "Transformer"),
                    default="LSTM")
    ap.add_argument("--t-bayes-pos", choices=("none", "FFN", "MHA", "EMB"),
                    default="none", help="the Bayesian Transformer's position")
    ap.add_argument("--seq-len", type=int, default=chip_smoke.TRAIN_SEQ,
                    help="the training window (chip_smoke.py's: 100)")
    ap.add_argument("--fused-lstm2", action="store_true",
                    help="the fused 2-layer training route (rows 7-8)")
    args = ap.parse_args()
    if args.fused_lstm2:
        os.environ["BAYESLM_PALLAS_LSTM2_TRAIN"] = "1"
    cfg, _, _, _ = chip_smoke.bench_setup()
    lr = 5.0
    if args.model == "Transformer":
        cfg = chip_smoke.tm_config(
            cfg, t_bayes_pos=args.t_bayes_pos,
            uncertainty="none" if args.t_bayes_pos == "none" else "Bayesian")
        lr = chip_smoke.TM_LR
    elif args.bayes_pos:
        cfg = dataclasses.replace(cfg, uncertainty="Bayesian",
                                  l_bayes_pos=args.bayes_pos)
    elif args.l_gauss_pos:
        cfg = dataclasses.replace(cfg, uncertainty="Gaussian",
                                  l_gauss_pos=args.l_gauss_pos)
    B, T = chip_smoke.TRAIN_BATCH, args.seq_len
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.write_markov_corpus(tmp, cfg.vocab_size - 2,
                                       B * T * 12, 100, 100)
        corpus = Corpus(tmp)
    trainer = Trainer(cfg, TrainConfig(lr=lr, batch_size=B, seq_len=T))
    state = trainer.init_state()
    rows = batchify(corpus.train, B)
    kl_scale = T / rows.shape[0]
    data, tgt = (torch.from_numpy(a).long().cuda() for a in windows(rows, T))
    hidden = None if cfg.is_transformer else init_hidden(
        cfg.nlayers, B, cfg.nhid, device="cuda")

    def steps(first, n):
        nonlocal hidden
        for b in range(first, first + n):
            hidden, *_ = trainer.train_step(state, hidden, data[b], tgt[b],
                                            kl_scale)
        torch.cuda.synchronize()

    steps(0, 3)
    t0 = time.perf_counter()
    steps(3, 5)
    plain_ms = (time.perf_counter() - t0) * 1e3 / 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(8, 3)
        traced_ms = (time.perf_counter() - t0) * 1e3 / 3
    # device-side events only (kernels, copies): an operator's row would
    # count its kernels' time a second time
    rows = [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type != DeviceType.CPU and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / 3
    print(f"step {plain_ms:.1f} ms untraced (mean of 5), {traced_ms:.1f} ms "
          f"traced (mean of 3); device busy {busy_ms:.1f} ms a step, idle "
          f"share {1 - busy_ms / traced_ms:.3f} of the traced steps "
          f"({torch.cuda.get_device_name(0)}; {cfg.model}, uncertainty="
          f"{cfg.uncertainty}, l_bayes_pos={cfg.l_bayes_pos}, l_gauss_pos="
          f"{cfg.l_gauss_pos}, t_bayes_pos={cfg.t_bayes_pos}, batch {B} x "
          f"seq_len {T}, fused 2-layer route {args.fused_lstm2})")
    print("device ms a step  calls a step  table row  name")
    # the top 20, and every kernel of the port wherever it ranks
    for dev_us, count, key in [r for i, r in enumerate(rows)
                               if i < 20 or chip_smoke.kernel_row(r[2])]:
        print(f"{dev_us / 1e3 / 3:16.3f}  {count / 3:12.1f}  "
              f"{chip_smoke.kernel_row(key):>9}  {key[:90]}")
    return 0 if np.isfinite(busy_ms) else 1


if __name__ == "__main__":
    sys.exit(main())
