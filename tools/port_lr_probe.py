#!/usr/bin/env python3
"""One epoch of ``Trainer.fit`` per GP-LSTM configuration and learning rate,
on the kernels and on their plain twins, to tell a model's training
dynamics from a kernel's error.

    python3 tools/port_lr_probe.py 63:5 63:5:plain 63:2 73:5 13:5 00:5

Needs a CUDA card and nvcc. Each argument is ``l_gauss_pos:lr`` with an
optional ``:plain`` (the training kernels' wrappers replaced by their plain
twins); the model, corpus and settings are chip_smoke.py's training phases'
(the bench's 1024/1024 LSTM LM, V = 49,152, bf16, dropout 0.2, batch 32,
seq_len 100, momentum 0.9, clip 1.0, its synthetic Markov corpus). Prints
each step's loss and gradient norm (before the clip) and the validation
loss. Nothing is written to disk outside a temporary directory.
"""

import contextlib
import dataclasses
import os
import sys
import tempfile
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch

    import chip_smoke as cs
    from bayeslms_tpu_torch import TrainConfig
    from bayeslms_tpu_torch.data.corpus import Corpus
    from bayeslms_tpu_torch.ops import ce_train_cuda as ctc
    from bayeslms_tpu_torch.ops import gp_lstm_cuda as gpc
    from bayeslms_tpu_torch.ops import lstm_train_cuda as ltc
    from bayeslms_tpu_torch.train.loop import Trainer

    if not torch.cuda.is_available():
        print("port_lr_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, _, _, _ = cs.bench_setup()
    B, T = cs.TRAIN_BATCH, cs.TRAIN_SEQ
    wrappers = [(ltc, "lstm_train_fwd"), (ltc, "lstm_train_bwd"),
                *((gpc, n) for n in gpc.launches),
                *((ctc, n) for n in cs.CE_TRAIN)]
    with tempfile.TemporaryDirectory() as tmp:
        cs.write_markov_corpus(tmp, cfg.vocab_size - 2,
                               B * (T * cs.TRAIN_WINDOWS + 37),
                               cs.EVAL_BATCH * 230, cs.EVAL_BATCH * 150)
        corpus = Corpus(tmp)
        for arg in sys.argv[1:] or ["63:5", "63:5:plain", "63:2"]:
            pos, lr, *plain = arg.split(":")
            g = dataclasses.replace(cfg, uncertainty="Gaussian",
                                    l_gauss_pos=pos)
            trainer = Trainer(g, TrainConfig(
                lr=float(lr), batch_size=B, seq_len=T,
                eval_batch_size=cs.EVAL_BATCH, epochs=1,
                save=os.path.join(tmp, "probe.ckpt")))
            losses, gnorms = [], []
            step = trainer.train_step

            def recorded(*a, **kw):
                out = step(*a, **kw)
                gnorms.append(float(out[4]))
                return out

            trainer.train_step = recorded
            with contextlib.ExitStack() as stack:
                for m, n in wrappers if plain else ():
                    stack.enter_context(mock.patch.object(
                        m, n, getattr(m, n + "_plain")))
                _, out = trainer.fit(
                    corpus, log=lambda *a: None,
                    on_step=lambda b, loss: losses.append(float(loss)))
            print(f"l_gauss_pos {pos}, lr {lr}, "
                  f"{'plain twins' if plain else 'kernels'}: validation "
                  f"{out['history'][0]['val_loss']:.4f} "
                  f"({torch.cuda.get_device_name(0)})")
            print("  loss  " + " ".join(f"{x:.4f}" for x in losses))
            print("  gnorm " + " ".join(f"{x:.2f}" for x in gnorms))
    return 0


if __name__ == "__main__":
    sys.exit(main())
