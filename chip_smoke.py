#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (bayeslms_tpu_torch) on one H100.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc. It
builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version at the shapes of the main path, then drives both halves of
the main path with the bench's 2-layer 1024/1024 LSTM LM (V = 49,152, bf16):
packed-carry N-best rescoring through ``BatchScorer.score_nbest`` (random
weights from a fixed seed, a synthetic 6,000-hypothesis N-best), and
training through ``Trainer.fit`` with the recipe's settings (batch 32,
seq_len 100, lr 5, momentum 0.9, clip 1.0; a synthetic Markov corpus of
about 20 windows an epoch, 2 epochs), a kernel-path step against the same
step on the plain versions, and a rescoring pass from the checkpoint
``fit`` wrote. Every phase prints its result and seconds; any failure exits
non-zero before the result lines. The last two lines are a JSON object per
kernel and the device line.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import OrderedDict

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and
# device memory. A bound is the larger of operations / peak rate and
# bytes / memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# Tolerances, kernel against its plain version on the same inputs, set
# from the errors the H100 showed (PERF.md) with modest room; each check
# prints the magnitude of what it compares beside its limit, and the LSTM
# and score checks show that planted faults exceed them.
# LSTM outputs (ys2, final states) are bf16. Kernel and plain round fp32
# values that differ by ~1e-6 (order of accumulation), so an element may
# round one bf16 step the other way: at most 2^-7 of its magnitude.
# Elementwise, |kernel - plain| <= LSTM_ATOL + LSTM_RTOL * |plain|.
LSTM_RTOL, LSTM_ATOL = 2 ** -6, 2 ** -14
# CE per token (~10.8 = log V), float32 both: sums of D = 1,024 products
# and of V exponentials in different orders.
CE_ATOL = 2e-5
# Scores (sums of ~16 token CEs, ~170), kernel path against plain path,
# absolute: the LSTM's bf16 rounding steps above, through the decoder.
SCORE_ATOL = 2e-3


def make_synthetic_nbest(n_meetings=10, utts_per_meeting=10, n_hyps=20,
                         vocab_words=49150, seed=0):
    """AMI-shaped N-best (the JAX package's bench.py generator): independent
    recordings (carry-over chains) of serial utterances, 20 hypotheses
    each, Zipf words over the whole table."""
    rng = np.random.default_rng(seed)
    nbest = OrderedDict()
    for m in range(n_meetings):
        for u in range(utts_per_meeting):
            base_len = int(np.clip(rng.normal(15, 7), 1, 40))
            hyps = []
            for _ in range(n_hyps):
                L = max(1, base_len + int(rng.integers(-2, 3)))
                words = np.minimum(rng.zipf(1.3, size=L), vocab_words - 1)
                hyps.append(" ".join(f"w{w}" for w in words))
            nbest[f"meet{m}_utt{u}"] = hyps
    return nbest


def stream_of(key):
    """Carry-over chain: the recording prefix."""
    return key.split("_")[0]


def bench_setup():
    """The JAX bench's scoring configuration (bench.py:87-100) at full
    width: (ModelConfig, RescoreConfig, word2idx over the whole 49,152-word
    table, the 30-recording N-best)."""
    from bayeslms_tpu_torch import ModelConfig, RescoreConfig

    V = 49152
    cfg = ModelConfig(model="LSTM", vocab_size=V, emsize=1024, nhid=1024,
                      nlayers=2, dropout=0.2, compute_dtype="bfloat16")
    rcfg = RescoreConfig(carry_over=True, max_hyp_len=64)
    w2i = {"<s>": 0, "<unk>": 1, **{f"w{i}": 2 + i for i in range(V - 2)}}
    return cfg, rcfg, w2i, make_synthetic_nbest(n_meetings=30)


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    print(f"[{name}] start", flush=True)
    try:
        yield
    except BaseException:
        print(f"[{name}] FAIL after {time.perf_counter() - t0:.1f} s",
              flush=True)
        raise
    print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)


def cuda_ms(torch, fn, repeats):
    """Median device time of ``fn`` in ms (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def tol_ratio(got, ref, rtol, atol):
    """Largest |got - ref| / (atol + rtol * |ref|) over the elements: at
    most 1 where they agree within the tolerance."""
    g, r = got.float(), ref.float()
    return float(((g - r).abs() / (atol + rtol * r.abs())).max())


def lstm_outputs(out):
    ys2, (h1, h2), (c1, c2) = out
    return {"ys2": ys2, "hT1": h1, "hT2": h2, "cT1": c1, "cT2": c2}


# Planted faults of the LSTM kernel, made by changing its inputs: a kernel
# that ignored the reset events, ignored the step mask or dropped the
# h2 W_hh2^T product computes what the real kernel computes on these.
# fault -> (index of the argument of lstm2_fwd, value that fills it)
LSTM_FAULTS = {"resets ignored": (11, 0), "step mask ignored": (10, 1),
               "W_hh2 product dropped": (4, 0)}


def planted(args, fault):
    i, fill = LSTM_FAULTS[fault]
    a = list(args)
    a[i] = a[i].new_full(a[i].shape, fill)
    return a


# ---------------------------------------------------------------- training
# The recipe's training settings (recipes/run_nnlm_ami_lstm.sh:16-26) on the
# bench's model; the synthetic corpus gives about 20 windows an epoch.
TRAIN_BATCH, TRAIN_SEQ = 32, 100
TRAIN_WINDOWS = 20
EVAL_BATCH = 20

# Tolerances of the training kernels against their plain versions on the
# tensors one training step hands them, elementwise
#   |kernel - plain| <= rtol |plain| + share * max |plain|,
# set from the errors the H100 showed (PERF.md) with modest room; each check
# prints the magnitudes it compares, and a planted fault per kernel must
# exceed its tolerance by FAULT_MARGIN or more.
# kernel -> (rtol, share of the largest |plain|)
TRAIN_TOL = {
    # bf16 outputs of a 100-step recurrence: a bf16 step or two (2^-7 each)
    "lstm_train_fwd": (2 ** -6, 2 ** -12),
    "lstm_train_bwd": (2 ** -6, 2 ** -10),
    # float32 CE (~10.8), max and sum-exp (~2e4): sums of D products and V
    # exponentials in other orders
    "ce_train_fwd": (2 ** -19, 2 ** -19),
    # d rounded to bf16 may round the other way where s differs in its last
    # bits; dh is stored in bf16
    "ce_train_dh": (2 ** -6, 2 ** -10),
    # float32 dE and db: the same d, rounded, summed over M in fp32
    "ce_train_de": (2 ** -8, 2 ** -15),
}
FAULT_MARGIN = 10.0
# The kernel-path training step against the plain-path step (same weights,
# batch and dropout masks): loss absolute; each parameter's gradient, max
# |kernel - plain| against STEP_GRAD_SHARE of its largest |plain| entry.
STEP_LOSS_ATOL = 1e-5
STEP_GRAD_SHARE = 2 ** -6
# Scores of the trained model (kernel path against plain path), relative:
# its LSTM states are larger than the random init's, so the bf16 rounding
# steps move a score more than SCORE_ATOL allows.
TRAINED_SCORE_RTOL = 1e-4


def write_markov_corpus(root, vocab_words, n_train, n_valid, n_test, seed=0):
    """words.txt ("<s>", "<unk>", w0 .. w{n-1}) and train/valid/test text
    from a first-order Markov chain: each word has four successors drawn
    from a Zipf-like unigram law, so there is something to learn (uniform
    text has nothing)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab_words + 1) ** 1.1
    p /= p.sum()
    succ = rng.choice(vocab_words, size=(vocab_words, 4), p=p)
    with open(os.path.join(root, "words.txt"), "w") as f:
        f.write("<s> 0\n<unk> 1\n")
        f.writelines(f"w{i} {i + 2}\n" for i in range(vocab_words))
    w = int(rng.choice(vocab_words, p=p))
    for name, n in (("train", n_train), ("valid", n_valid), ("test", n_test)):
        picks = rng.integers(0, 4, size=n)
        lens = rng.integers(5, 30, size=n)
        lines, line = [], []
        for k in range(n):
            w = int(succ[w, picks[k]])
            line.append(f"w{w}")
            if len(line) >= lens[k]:
                lines.append(" ".join(line))
                line = []
        lines.append(" ".join(line))
        with open(os.path.join(root, f"{name}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def check_outputs(name, got, ref, rtol, share):
    """Print each output's magnitude, error and worst share of its
    tolerance; returns (max abs error, worst share)."""
    err, worst = 0.0, 0.0
    for k in ref:
        r = ref[k].float()
        big = float(r.abs().max())
        e = max_err(got[k], r)
        q = tol_ratio(got[k], r, rtol, share * big + 1e-30)
        err, worst = max(err, e), max(worst, q)
        print(f"  {name} {k}: |plain| max {big:.3e} mean "
              f"{float(r.abs().mean()):.3e}; max |kernel - plain| {e:.3e}, "
              f"worst share of tolerance {q:.3f}")
    return err, worst


def fault_share(got, ref, rtol, share):
    return max(tol_ratio(got[k], ref[k], rtol,
                         share * float(ref[k].float().abs().max()) + 1e-30)
               for k in ref)


def train_phases(torch, kernels, smi, cfg, rcfg):
    """The training half of the main path; adds the training kernels to
    ``kernels``. Raises on any failed check."""
    from unittest import mock

    from bayeslms_tpu_torch import TrainConfig
    from bayeslms_tpu_torch.core.checkpoint import load_checkpoint
    from bayeslms_tpu_torch.data.corpus import Corpus
    from bayeslms_tpu_torch.models.lstm_lm import (draw_dropout_masks,
                                                   init_hidden)
    from bayeslms_tpu_torch.ops import ce_train_cuda as ctc
    from bayeslms_tpu_torch.ops import lstm_cuda
    from bayeslms_tpu_torch.ops import lstm_train_cuda as ltc
    from bayeslms_tpu_torch.rescore.scorer import BatchScorer
    from bayeslms_tpu_torch.train.loop import Trainer

    V = cfg.vocab_size
    tmp = tempfile.TemporaryDirectory()
    B, T = TRAIN_BATCH, TRAIN_SEQ
    with phase("train setup"):
        n_train = B * (T * TRAIN_WINDOWS + 37)  # and a ragged final window
        write_markov_corpus(tmp.name, V - 2, n_train, EVAL_BATCH * 230,
                            EVAL_BATCH * 150)
        corpus = Corpus(tmp.name)
        tcfg = TrainConfig(lr=5.0, momentum=0.9, clip=1.0, batch_size=B,
                           seq_len=T, eval_batch_size=EVAL_BATCH, epochs=2,
                           log_interval=10,
                           save=os.path.join(tmp.name, "model.ckpt"))
        trainer = Trainer(cfg, tcfg)
        print(f"  corpus: {len(corpus.vocab)} words; {len(corpus.train)} "
              f"train, {len(corpus.valid)} valid, {len(corpus.test)} test "
              "tokens")
        # one step records the tensors it hands each kernel wrapper
        state = trainer.init_state()
        data = torch.from_numpy(corpus.train[:T * B].reshape(B, T).T.copy()
                                ).long().cuda()
        target = torch.from_numpy(corpus.train[1:T * B + 1].reshape(B, T).T
                                  .copy()).long().cuda()
        recorded = {}

        def recorder(module, name):
            fn = getattr(module, name)

            def call(*args):
                recorded.setdefault(name, []).append(args)
                return fn(*args)
            return mock.patch.object(module, name, call)

        with recorder(ltc, "lstm_train_fwd"), recorder(ltc, "lstm_train_bwd"), \
                recorder(ctc, "ce_train_fwd"), recorder(ctc, "ce_train_dh"), \
                recorder(ctc, "ce_train_de"):
            trainer.train_step(state, init_hidden(2, B, cfg.nhid,
                                                  device="cuda"),
                               data, target)
        torch.cuda.synchronize()
        del state

    H, D, M = cfg.nhid, cfg.nhid, T * B
    flops_f = 2 * T * B * H * 4 * H
    specs = {
        "lstm_train_fwd": dict(
            module=ltc, plain=ltc.lstm_train_fwd_plain, source="lstm_train.cu",
            replaces="bayeslms_tpu/ops/lstm_pallas.py:421",
            outs=("ys", "cs", "hT", "cT"),
            # W_hh zeroed: a kernel that dropped the recurrent product
            fault=("W_hh product dropped", 1),
            flops=flops_f,
            nbytes=T * B * 4 * H * 2 + 4 * H * H * 2 + 4 * H * 4
            + 4 * B * H * 2 + 2 * T * B * H * 2),
        "lstm_train_bwd": dict(
            module=ltc, plain=ltc.lstm_train_bwd_plain, source="lstm_train.cu",
            replaces="bayeslms_tpu/ops/lstm_pallas.py:461",
            outs=("du", "dh0", "dc0"),
            fault=("W_hh zeroed in the backward only", 1),
            flops=2 * flops_f,
            nbytes=T * B * 4 * H * 2 + 3 * T * B * H * 2 + 4 * H * H * 2
            + 4 * H * 4 + 6 * B * H * 2 + T * B * 4 * H * 2),
        "ce_train_fwd": dict(
            module=ctc, plain=ctc.ce_train_fwd_plain, source="ce_train.cu",
            replaces="bayeslms_tpu/ops/ce_pallas.py:291",
            outs=("ce", "max", "sumexp"),
            fault=("targets shifted", 3),
            flops=2 * M * V * D,
            nbytes=M * D * 2 + V * D * 2 + V * 4 + M * 4 + 3 * M * 4),
        "ce_train_dh": dict(
            module=ctc, plain=ctc.ce_train_dh_plain, source="ce_train.cu",
            replaces="bayeslms_tpu/ops/ce_pallas.py:320",
            outs=("dh",), fault=("targets shifted in dh only", 3),
            flops=4 * M * V * D,
            nbytes=M * D * 2 + V * D * 2 + V * 4 + 5 * M * 4 + M * D * 2),
        "ce_train_de": dict(
            module=ctc, plain=ctc.ce_train_de_plain, source="ce_train.cu",
            replaces="bayeslms_tpu/ops/ce_pallas.py:344",
            outs=("dE", "db"), fault=("targets shifted in dE only", 3),
            flops=4 * M * V * D,
            nbytes=M * D * 2 + V * D * 2 + V * 4 + 5 * M * 4 + V * D * 4
            + V * 4),
    }

    def as_dict(spec, out):
        out = out if isinstance(out, tuple) else (out,)
        return dict(zip(spec["outs"], out))

    def planted_args(args, i):
        a = list(args)
        if i == 3:  # targets
            a[3] = torch.roll(a[3], 1)
        else:
            a[i] = torch.zeros_like(a[i])
        return a

    for name, spec in specs.items():
        with phase(f"kernel {name}"), torch.no_grad():
            kernel = getattr(spec["module"], name)
            rtol, share = TRAIN_TOL[name]
            print(f"  tolerance |kernel - plain| <= {rtol:.3e} |plain| + "
                  f"{share:.3e} max|plain|, elementwise; {len(recorded[name])}"
                  " call(s) in one step")
            err, worst, fault = 0.0, 0.0, float("inf")
            for args in recorded[name]:
                ref = as_dict(spec, spec["plain"](*args))
                got = as_dict(spec, kernel(*args))
                torch.cuda.synchronize()
                e, q = check_outputs(name, got, ref, rtol, share)
                err, worst = max(err, e), max(worst, q)
                bad = as_dict(spec, kernel(*planted_args(args,
                                                         spec["fault"][1])))
                fault = min(fault, fault_share(bad, ref, rtol, share))
                del ref, got, bad
            print(f"  planted fault '{spec['fault'][0]}': worst share of "
                  f"tolerance {fault:.1f}")
            args = recorded[name][0]
            if name.startswith("ce_"):
                # ragged edges too (M and V off the 64 tiles), random bias
                Mr, Vr = M - 37, V - 77
                gen = torch.Generator(device="cuda").manual_seed(2)
                br = torch.rand((Vr,), generator=gen, device="cuda") * 2 - 1
                ra = [args[0][:Mr], args[1][:Vr], br, args[3][:Mr] % Vr]
                if name != "ce_train_fwd":
                    _, rmx, rse = ctc.ce_train_fwd_plain(*ra)
                    ra += [rmx, rse, args[6][:Mr].contiguous(),
                           args[7][:Mr].contiguous()]
                ref = as_dict(spec, spec["plain"](*ra))
                e, q = check_outputs(f"{name} ragged M={Mr} V={Vr}",
                                     as_dict(spec, kernel(*ra)), ref, rtol,
                                     share)
                err, worst = max(err, e), max(worst, q)
                del ref, ra
            ms = cuda_ms(torch, lambda: kernel(*args), 5)
            plain_ms = cuda_ms(torch, lambda: spec["plain"](*args), 3)
            with torch.enable_grad():
                library_ms = library_yardstick(torch, name, args)
            bms, bby = bound_ms(spec["flops"], spec["nbytes"])
            print(f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
                  f"{library_ms:.3f} ms, bound {bms:.3f} ms ({bby})")
            kernels[name] = dict(
                name=name, route="cuda",
                source=f"bayeslms_tpu_torch/csrc/{spec['source']}",
                replaces=spec["replaces"], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                library_ms=library_ms)
            if worst > 1:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: worst share {worst:.3f}")
            if fault < FAULT_MARGIN:
                raise AssertionError(f"{name}: the planted fault exceeds the "
                                     f"tolerance only {fault:.1f}x")
    del recorded

    with phase("train main path"):
        for module in (ltc, ctc):
            for k in module.launches:
                module.launches[k] = 0
        lstm_cuda.launches = 0
        steps = []

        def on_step(b, loss):
            torch.cuda.synchronize()
            steps.append((time.perf_counter(), float(loss)))

        t0 = time.perf_counter()
        state, out = trainer.fit(corpus, log=lambda line: print("  " + line),
                                 on_step=on_step)
        fit_s = time.perf_counter() - t0
        launches = {**ltc.launches, **ctc.launches,
                    "lstm2_fwd (evaluate)": lstm_cuda.launches}
        n = len(steps)
        print(f"  kernel launches in fit ({n} steps): {launches}")
        losses = [l for _, l in steps]
        print("  loss per step: " + " ".join(f"{l:.4f}" for l in losses))
        print("  validation loss per epoch: " + " ".join(
            f"{h['val_loss']:.4f}" for h in out["history"])
            + f"; test loss {out['test_loss']:.4f}")
        # warm steps: the first two of the run (allocator, cuBLAS) excluded
        dts = np.diff([t for t, _ in steps])[2:]
        step_ms = 1e3 * float(np.median(dts))
        print(f"  step median {step_ms:.3f} ms over {len(dts)} warm steps, "
              f"{T * B / step_ms * 1e3:.1f} tokens/s; fit {fit_s:.1f} s "
              f"on {smi}")
        per_step = {"lstm_train_fwd": 2, "lstm_train_bwd": 2,
                    "ce_train_fwd": 1, "ce_train_dh": 1, "ce_train_de": 1}
        for name, k in per_step.items():
            kernels[name]["launches"] = launches[name]
            if launches[name] != k * n:
                raise AssertionError(f"{name}: {launches[name]} launches in "
                                     f"{n} steps, {k} a step expected")
        if launches["lstm2_fwd (evaluate)"] == 0:
            raise AssertionError("evaluate never launched lstm2_fwd")
        if not all(np.isfinite(losses)) or not np.isfinite(out["test_loss"]):
            raise AssertionError("a training loss is not finite")
        if np.mean(losses[-5:]) >= np.mean(losses[:5]):
            raise AssertionError(
                f"the loss did not fall: first 5 {np.mean(losses[:5]):.4f}, "
                f"last 5 {np.mean(losses[-5:]):.4f}")
        del state

    with phase("train step against plain versions"):
        gen = torch.Generator(device="cuda").manual_seed(3)
        masks = draw_dropout_masks(cfg, T, B, gen, "cuda")

        def one_step():
            st = trainer.init_state(seed=5)
            _, loss, _, _, gnorm = trainer.train_step(
                st, init_hidden(2, B, cfg.nhid, device="cuda"), data, target,
                dropout_masks=masks)
            grads = {k: p.grad.clone() for k, p in st.params.items()}
            return float(loss), float(gnorm), grads

        k_loss, k_gn, k_grads = one_step()
        plain = [mock.patch.object(m, n, getattr(m, n + "_plain"))
                 for m, n in ((ltc, "lstm_train_fwd"), (ltc, "lstm_train_bwd"),
                              (ctc, "ce_train_fwd"), (ctc, "ce_train_dh"),
                              (ctc, "ce_train_de"))]
        with contextlib.ExitStack() as stack:
            for p in plain:
                stack.enter_context(p)
            p_loss, p_gn, p_grads = one_step()
        print(f"  loss kernel {k_loss:.6f} plain {p_loss:.6f} (tolerance "
              f"{STEP_LOSS_ATOL:.0e}); gnorm {k_gn:.6f} / {p_gn:.6f}")
        worst = 0.0
        for k, g in p_grads.items():
            big = float(g.abs().max())
            e = max_err(k_grads[k], g)
            worst = max(worst, e / (STEP_GRAD_SHARE * big + 1e-30))
            print(f"  grad {k}: |plain| max {big:.3e}; max |kernel - plain| "
                  f"{e:.3e} ({e / (big + 1e-30):.2e} of the max)")
        if abs(k_loss - p_loss) > STEP_LOSS_ATOL or worst > 1:
            raise AssertionError(f"the kernel-path step disagrees with the "
                                 f"plain path (worst share {worst:.3f})")
        del k_grads, p_grads

    with phase("rescore from the trained checkpoint"):
        params, meta = load_checkpoint(tcfg.save)
        print(f"  checkpoint of epoch {meta['epoch']}, val loss "
              f"{meta['val_loss']:.4f}")
        scorer = BatchScorer(cfg, params, rcfg)
        nbest = make_synthetic_nbest(n_meetings=2, vocab_words=V - 2)
        w2i = corpus.vocab.word2idx
        res = scorer.score_nbest(nbest, w2i, stream_fn=stream_of)
        got = np.array([s for pairs in res.values() for _, s in pairs])
        with mock.patch.object(lstm_cuda, "lstm2_fwd", lstm_cuda.lstm2_plain):
            from bayeslms_tpu_torch.ops import ce_cuda
            with mock.patch.object(ce_cuda, "fused_decode_ce",
                                   ce_cuda.ce_plain):
                ref = np.array([s for pairs in scorer.score_nbest(
                    nbest, w2i, stream_fn=stream_of).values()
                    for _, s in pairs])
        n_hyps = sum(len(h) for h in nbest.values())
        diff = float(np.abs(got - ref).max())
        rel = float((np.abs(got - ref) / np.abs(ref)).max())
        print(f"  {n_hyps} hypotheses, scores mean {got.mean():.3f}, max "
              f"{np.abs(ref).max():.3f}; max |kernel - plain| {diff:.4e}, "
              f"relative {rel:.3e} (tolerance {TRAINED_SCORE_RTOL:.0e})")
        if got.shape != (n_hyps,) or not np.all(np.isfinite(got)) \
                or rel > TRAINED_SCORE_RTOL:
            raise AssertionError("rescoring from the checkpoint failed")
    tmp.cleanup()


def library_yardstick(torch, name, args):
    """ms of one PyTorch call computing the same function (never called by
    the port): cuDNN's LSTM for the recurrence (all-ones mask, as in
    training; it also computes x W_ih^T), cuBLAS logits with
    ``F.cross_entropy`` for the CE, forward or backward."""
    F = torch.nn.functional
    if name.startswith("lstm"):
        xg = args[0]
        T, B, G = xg.shape
        H = G // 4
        lstm = torch.nn.LSTM(H, H, device="cuda", dtype=torch.bfloat16)
        x = torch.randn((T, B, H), device="cuda", dtype=torch.bfloat16,
                        requires_grad=True)
        if name == "lstm_train_fwd":
            return cuda_ms(torch, lambda: lstm(x), 5)
        out, _ = lstm(x)
        dy = torch.randn_like(out)
        return cuda_ms(torch, lambda: torch.autograd.grad(
            out, [x, *lstm.parameters()], dy, retain_graph=True), 5)
    h, emb, bias, tgt = args[:4]
    hh = h.detach().clone().requires_grad_(True)
    e = emb.detach().clone().requires_grad_(True)
    b = bias.detach().to(torch.bfloat16).requires_grad_(True)

    def fwd():
        return F.cross_entropy(hh @ e.t() + b, tgt, reduction="sum")

    if name == "ce_train_fwd":
        with torch.no_grad():
            return cuda_ms(torch, fwd, 5)
    loss = fwd()
    wrt = [hh] if name == "ce_train_dh" else [e, b]
    return cuda_ms(torch, lambda: torch.autograd.grad(loss, wrt,
                                                      retain_graph=True), 5)


def main():
    from unittest import mock

    import torch

    from bayeslms_tpu_torch import build_model, init_params
    from bayeslms_tpu_torch.ops import _build, ce_cuda, lstm_cuda
    from bayeslms_tpu_torch.rescore.scorer import BatchScorer

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    kernels = {}

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        print(smi.splitlines()[0])
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)} "
              f"count {torch.cuda.device_count()}")

    with phase("build"):
        t0 = time.perf_counter()
        for name, path in _build.build().items():
            print(f"  {name}: {path}")
        print(f"  build seconds {time.perf_counter() - t0:.1f}")

    cfg, rcfg, w2i, nbest = bench_setup()
    V = cfg.vocab_size
    n_hyps = sum(len(h) for h in nbest.values())

    # One pass of the main path records the arguments it hands each kernel
    # wrapper: the kernels are then checked on exactly those tensors.
    with phase("setup"):
        params = init_params(build_model(cfg), cfg, seed=0)
        scorer = BatchScorer(cfg, params, rcfg)
        recorded = {}

        def recorder(name, fn):
            def call(*args):
                recorded[name] = args
                return fn(*args)
            return call

        with mock.patch.object(lstm_cuda, "lstm2_fwd",
                               recorder("lstm", lstm_cuda.lstm2_fwd)), \
                mock.patch.object(ce_cuda, "fused_decode_ce",
                                  recorder("ce", ce_cuda.fused_decode_ce)):
            scorer.score_nbest(nbest, w2i, stream_fn=stream_of)
        torch.cuda.synchronize()

    with phase("kernel lstm2_fwd"):
        args = recorded["lstm"]
        xg1 = args[0]
        T, B, G = xg1.shape
        H = G // 4
        kernel = lstm_cuda.lstm2_fwd
        ref = lstm_outputs(lstm_cuda.lstm2_plain(*args))
        got = lstm_outputs(kernel(*args))
        torch.cuda.synchronize()
        print(f"  tolerance |kernel - plain| <= {LSTM_ATOL:.3e} + "
              f"{LSTM_RTOL:.3e} |plain|, elementwise")
        errs, ratio = {}, 0.0
        for k, r in ref.items():
            errs[k] = max_err(got[k], r)
            q = tol_ratio(got[k], r, LSTM_RTOL, LSTM_ATOL)
            ratio = max(ratio, q)
            print(f"  {k}: |plain| max {float(r.float().abs().max()):.3e} "
                  f"mean {float(r.float().abs().mean()):.3e}; max |kernel - "
                  f"plain| {errs[k]:.3e}, worst share of tolerance {q:.3f}")
        faults = {}
        for fault in LSTM_FAULTS:
            bad = lstm_outputs(kernel(*planted(args, fault)))
            faults[fault] = max(tol_ratio(bad[k], r, LSTM_RTOL, LSTM_ATOL)
                                for k, r in ref.items())
            print(f"  planted fault '{fault}': worst share of tolerance "
                  f"{faults[fault]:.1f}")
        del bad
        ms = cuda_ms(torch, lambda: lstm_cuda.lstm2_fwd(*args), 5)
        plain_ms = cuda_ms(torch, lambda: lstm_cuda.lstm2_plain(*args), 3)
        n_reset = int((args[11] != 0).sum())
        flops = T * 3 * 2 * B * H * G
        nbytes = (T * B * G * 2 + 3 * G * H * 2 + 2 * G * 4 + 2 * T * B
                  + B * 4 + 8 * B * H * 2 + T * B * H * 2)
        bms, bby = bound_ms(flops, nbytes)
        print(f"  shapes T={T} B={B} H={H} bf16, resets {n_reset}, "
              f"masked steps {int((args[10] == 0).sum())}")
        print(f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bms:.3f} ms ({bby}); library: none (no single PyTorch call "
              "computes a masked, resetting 2-layer LSTM)")
        kernels["lstm2_fwd"] = dict(
            name="lstm2_fwd", route="cuda",
            source="bayeslms_tpu_torch/csrc/lstm2_fwd.cu",
            replaces="bayeslms_tpu/ops/lstm_pallas.py:722",
            max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=bby, library_ms=None)
        if ratio > 1:
            raise AssertionError(f"lstm2_fwd disagrees with its plain version: {errs}")
        if min(faults.values()) <= 1:
            raise AssertionError(f"a planted fault passes the tolerance: {faults}")

    with phase("kernel ce_fwd"):
        h, emb, bias, tgt = recorded["ce"]
        M, D = h.shape
        got = ce_cuda.fused_decode_ce(h, emb, bias, tgt)
        ref = ce_cuda.ce_plain(h, emb, bias, tgt)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        print(f"  M={M} V={V} D={D} {emb.dtype}: max |kernel - plain| "
              f"{err:.3e} (tolerance {CE_ATOL:.0e}); plain CE mean "
              f"{float(ref.mean()):.4f}, max {float(ref.max()):.4f}")
        # a ragged vocabulary edge too (V' not a multiple of the 128 tile),
        # with a random bias: the model's initial bias is zero
        Vr, Mr = V - 77, 1000
        tr = tgt[:Mr] % Vr
        gen = torch.Generator(device=h.device).manual_seed(1)
        br = torch.rand((Vr,), generator=gen, device=h.device) * 2 - 1
        err_r = max_err(ce_cuda.fused_decode_ce(h[:Mr], emb[:Vr], br, tr),
                        ce_cuda.ce_plain(h[:Mr], emb[:Vr], br, tr))
        print(f"  M={Mr} V={Vr}, bias U(-1, 1): max |kernel - plain| "
              f"{err_r:.3e} (tolerance {CE_ATOL:.0e})")
        # the scorer holds the table in bf16 already (rescore/scorer.py),
        # so these times include everything the main path's call does
        ms = cuda_ms(torch, lambda: ce_cuda.fused_decode_ce(h, emb, bias, tgt), 5)
        plain_ms = cuda_ms(torch, lambda: ce_cuda.ce_plain(h, emb, bias, tgt), 3)
        b16 = bias.to(torch.bfloat16)
        rows = ce_cuda.PLAIN_ROWS

        def library():
            # yardstick only, never called by the port: bf16 logits through
            # cuBLAS and torch's cross-entropy, a chunk of tokens at a time
            for s in range(0, M, rows):
                torch.nn.functional.cross_entropy(
                    h[s:s + rows] @ emb.t() + b16, tgt[s:s + rows],
                    reduction="none")

        library_ms = cuda_ms(torch, library, 3)
        flops = 2 * M * V * D
        nbytes = M * D * 2 + V * D * 2 + V * 4 + M * 4 + M * 4
        bms, bby = bound_ms(flops, nbytes)
        print(f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
              f"{library_ms:.3f} ms, bound {bms:.3f} ms ({bby})")
        kernels["ce_fwd"] = dict(
            name="ce_fwd", route="cuda",
            source="bayeslms_tpu_torch/csrc/ce_fwd.cu",
            replaces="bayeslms_tpu/ops/ce_pallas.py:90",
            max_abs_err=max(err, err_r), ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=bby, library_ms=library_ms)
        if max(err, err_r) > CE_ATOL:
            raise AssertionError(f"ce_fwd disagrees with its plain version: "
                                 f"{err:.3e}, ragged {err_r:.3e}")
    del recorded, args, xg1, got, ref

    with phase("main path"):
        lstm_cuda.launches = 0
        ce_cuda.launches = 0
        pass_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = scorer.score_nbest(nbest, w2i, stream_fn=stream_of)
            torch.cuda.synchronize()
            pass_s.append(time.perf_counter() - t0)
        launches = {"lstm2_fwd": lstm_cuda.launches,
                    "ce_fwd": ce_cuda.launches}
        print(f"  kernel launches in 3 passes: {launches}")
        for name, n in launches.items():
            kernels[name]["launches"] = n
            if n == 0:
                raise AssertionError(f"the main path never launched {name}")
        scores = np.array([s for pairs in out.values() for _, s in pairs])
        if scores.shape != (n_hyps,) or not np.all(np.isfinite(scores)):
            raise AssertionError(f"scores: shape {scores.shape}, expected "
                                 f"({n_hyps},), all finite required")
        n_tokens = sum(len(h.split()) + 1 for hyps in nbest.values()
                       for h in hyps)
        med = float(np.median(pass_s))
        print(f"  passes {['%.4f' % s for s in pass_s]} s; median "
              f"{n_hyps / med:.1f} hyps/s, {n_tokens / med:.1f} tokens/s "
              f"({n_hyps} hyps, {n_tokens} scored tokens) on {smi}")

    def score_with(lstm_fn, ce_fn):
        with mock.patch.object(lstm_cuda, "lstm2_fwd", lstm_fn), \
                mock.patch.object(ce_cuda, "fused_decode_ce", ce_fn):
            res = scorer.score_nbest(nbest, w2i, stream_fn=stream_of)
        return np.array([s for pairs in res.values() for _, s in pairs])

    with phase("main path against plain versions"):
        ref = score_with(lstm_cuda.lstm2_plain, ce_cuda.ce_plain)
        diff = float(np.abs(scores - ref).max())
        print(f"  {n_hyps} scores, |plain| mean {np.abs(ref).mean():.3f} max "
              f"{np.abs(ref).max():.3f}: max |kernel - plain| {diff:.4e} "
              f"(tolerance {SCORE_ATOL:.0e})")
        faults = {}
        for fault in LSTM_FAULTS:
            bad = score_with(lambda *a, f=fault: kernel(*planted(a, f)),
                             ce_cuda.fused_decode_ce)
            faults[fault] = float(np.abs(bad - ref).max())
            print(f"  planted fault '{fault}': max |faulty - plain| "
                  f"{faults[fault]:.4e}")
        if diff > SCORE_ATOL:
            raise AssertionError(f"scores: kernel path {diff:.4e} from the "
                                 f"plain path, tolerance {SCORE_ATOL:.0e}")
        if min(faults.values()) <= SCORE_ATOL:
            raise AssertionError(f"a planted fault passes the score "
                                 f"tolerance: {faults}")

    train_phases(torch, kernels, smi, cfg, rcfg)

    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
