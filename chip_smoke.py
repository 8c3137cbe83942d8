#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (bayeslms_tpu_torch) on one H100.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc. It
builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version at the shapes of the main path (the fused CE backward also
runs twice there and must repeat its bits), then drives both halves of
the main path with the bench's 2-layer 1024/1024 LSTM LM (V = 49,152, bf16):
packed-carry N-best rescoring through ``BatchScorer.score_nbest`` (random
weights from a fixed seed, a synthetic 6,000-hypothesis N-best; the
scoring CE on its split route, the forward kernels of the fused CE
training), a pass of the same LSTM at width 96 (a multiple of 32 that
the split route refuses: the scoring CE on csrc/ce_fwd.cu), and
training through ``Trainer.fit`` with the recipe's settings (batch 32,
seq_len 100, lr 5, momentum 0.9, clip 1.0; a synthetic Markov corpus of
about 20 windows an epoch, 2 epochs), a kernel-path step against the same
step on the plain versions, and a rescoring pass from the checkpoint
``fit`` wrote; the 2-layer scoring recurrence in its persistent design (one
launch a call) on the pass's call and on an ``evaluate`` window's, with
its per-step design on the same calls beside it; the LSTM training forward
and backward in their persistent designs (one cooperative launch a call)
on the step's calls, the forward's per-step design on the same call and
the backward's two-launch design at a doubled batch. Then the Bayesian gate-slice LSTM (``l_bayes_pos=3``) on
the same corpus: the gate-slice sampler kernel against its twin on the
four slices a step hands it in one launch (bit-equal uniforms, moments,
correlations, the gradients, the launch's slices bit-equal to one-slice
draws, planted-fault builds), one epoch of ``Trainer.fit`` (one sampler
launch a step), a
kernel-path step against the plain path, and scoring at the posterior
mean. Then the JAX package's opt-in fused 2-layer training route
(``BAYESLM_PALLAS_LSTM2_TRAIN=1``, set inside those phases only): a few
``fit`` steps on it and on the default two-layer route, timed in the same
call, its kernels (forward, backward) against their twins on the calls one
fused step hands them (with the dropout mask, a random step mask and
dm = ones; planted faults: W_hh2 dropped and four builds with
``-DLSTM2_TRAIN_FAULT``; the forward in its persistent design, two
cooperative launches around the input GEMM, the backward in its, the gate
GEMM and one cooperative launch, their per-step designs beside them; every
call of the fused fit on both persistent designs), and a fused standard
and Bayesian step against the plain path. Then the
recipe's GP-LSTM (``l_gauss_pos`` 13: a GP cell replacing the input gate, then
a standard layer) on the same corpus: the GP gate-replacement kernels (forward,
backward) against their twins on the calls a step and an ``evaluate`` window
hand them and for gates 2-4 at a short T (planted faults: gpx dropped, and
four builds with ``-DGP_LSTM_FAULT``; the forward in its persistent design,
one cooperative launch, its per-step design on the same calls beside it, the
fourth build on the call from a carried state; the backward in its persistent
design, the hoisted GEMM and one cooperative launch, its two-launch design on
the same calls beside it, with the first two builds), the single-layer forward
kernel on the ``evaluate`` window's call (and with a random step mask) in its
persistent design, its per-step design on the same calls beside it, one epoch
of ``Trainer.fit`` (every ``evaluate`` call of row 4 and every row-20 and
row-21 call on the persistent designs), a kernel-path step against the plain
path, and a packed-carry pass of the 6,000-hypothesis N-best from that
checkpoint: the
single-layer forward kernel with resets against its twin on the pass's call,
with -1 sources and from a carried state, in the streamed design that its rule
names for resets (one launch a call), its per-step design on the same calls
beside it (planted faults: resets ignored, -1 source not zeroed, step mask
ignored, W_hh dropped, also from the carried state), the pass against the
plain path (every row-3 call on the streamed design, here, in the gate-6 pass
and in the legacy GaussLSTM's).
Then the README's gate-6 GP-LSTM (``l_gauss_pos`` 63: a GP unit in place of the
GP cell's hidden projection, then a standard layer) on the same corpus: the
gate-6 kernels (forward, backward) against their twins on the calls a step and
an ``evaluate`` window hand them, with a random step mask and with a random b'
(planted faults: b' zeroed, coef rows swapped, mask ignored, and four builds
with ``-DGP6_FAULT``; the forward and the backward in their persistent
designs, their per-step and two-launch designs beside them, as rows 20-21's),
one epoch of ``Trainer.fit`` (every forward and backward call on the
persistent designs), a kernel-path step against the plain path, and
a packed-carry pass of the 6,000-hypothesis N-best from that checkpoint against
the plain path; gate 7 (``73``): a kernel-path step (the single-layer training
kernels on the hoisted GP input) against the plain
path; GPNN2 (``14``): a few steps of ``Trainer.fit``, the loss finite and
falling; the GP-FFN Transformer (``t_gauss_pos`` 3 at the recipe's width):
a kernel-path step against the plain path; a print-only ``53`` and ``14``
step with the trainer's bf16 CE operand against a float32 CE; and a few
``fit`` steps and a scoring pass of the 6,000-hypothesis N-best against the
plain path for the variational LSTM (``l_v_pos`` 11), the legacy VLSTM
(under the fused switch), the legacy GaussLSTM (positions 1 and 6) and the
variational Transformer (``t_v_pos`` 1 and 3).
Then the recipe's Transformer (512/4096 x 6, 8 heads, the same table,
bf16; lr 0.1): the causal attention kernel against its twin on the q, k, v
that ``evaluate`` hands it and at T = 1,024 and 4,096, in both designs (the
tensor-core kernel on the views, the CUDA-core kernel on copies at a batch
stride TMA cannot describe; a planted-fault build through both), the CE
training kernels against their twins on the tensors a
step hands them at D = 512, two epochs of ``Trainer.fit`` (the CE kernels
on every step, the attention kernel in every ``evaluate``), a kernel-path
step against the plain path; the Bayesian-FFN Transformer: the fused
sample-and-matmul kernel against its twin and against x . sample_weights^T
at the FFN's and the MHA's shapes in its split design (W drawn once as
three bf16 pieces, wgmma) and its CUDA-core design (and a planted fault in
the shared Philox header), a
``use_fused`` step against the plain path and one epoch of ``fit`` with
``use_fused``; and Transformer scoring of the 6,000-hypothesis N-best
through the packed-nocarry layout (the scoring CE kernel against its twin
on the packed chunk at D = 512) against the plain path. Then the same
Transformer at long context (seq_len 1,024, batch 32, dropout 0.2, one
epoch of six windows and a padded tail): the flash-attention training
kernels (forward, dq, dk/dv) against their twins on the calls one step
hands them and alone at T = 2,048 and 4,096, in both designs, their
dropout bits against the twin's, two planted-fault builds, the CE training
kernels against
their twins on that step's 32,768 tokens (db against float64, beside a
float64 reading of the sums over the tokens), ``Trainer.fit`` (the three
attention kernels six times a step) and a kernel-path step against the
same step on their twins; and Transformer-XL scoring (``xl_mems``) of the
6,000-hypothesis N-best from the checkpoint that fit wrote: the causal
attention kernel against its twin on every call of one pass (the
CUDA-core design on copies of one call a shape), the pass
against the plain path (the attention kernel's planted fault must fail
it), and an on-card check that memories give the suffix of a
full-context forward. Every phase prints its result and seconds; any
failure exits non-zero before the result lines. The last two lines are a
JSON object per kernel (the 2-layer scoring recurrence at the pass's and
at the ``evaluate`` call, each with its design and the per-step design's
time; the single-layer forward kernel twice, as the TPU kernels it
replaces with resets and without; the gate-6 kernels from the
``63`` phases; the CE training kernels at
the LSTM's D = 1,024,
the Transformer's 512 and the long step's M = 32,768; the scoring CE at
both widths on its split route and at width 96 on csrc/ce_fwd.cu) and the
device line.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import OrderedDict
from unittest import mock

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
# The same at the Transformer's width: CE ~18-27 from logits up to ~20
# (layer-normed h against the tied table), whose fp32 sums carry ~20x the
# LSTM's absolute rounding (2.5e-5, PERF.md); a token's CE sums the errors
# of its max, its target's logit and its log-sum-exp.
TM_CE_ATOL = 1e-4
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


# The port's CUDA kernel functions and the rows of PERF.md's kernel table
# (the JAX package's pallas_call sites) they make up, for the profiles'
# kernel names (tools/port_train_profile.py, tools/port_pass_profile.py).
KERNEL_ROWS = (
    ("lstm2_persistent", "1"), ("lstm_fwd_persistent", "5"),
    ("lstm_layer_persistent", "4"), ("lstm_layer_stream", "3"),
    ("lstm_step_kernel", "1, 3, 4"),
    ("ce_fwd_kernel", "2"), ("lstm_fwd_step", "5"),
    ("lstm_bwd_persistent", "6"), ("lstm_bwd_gates", "6"),
    ("lstm_bwd_dh", "6"),
    ("ce_stats_split", "2, 9"), ("ce_stats_merge", "2, 9"),
    ("ce_bwd_kernel<false>", "10"),
    ("ce_dh_reduce", "10"), ("ce_bwd_kernel<true>", "11"),
    ("bayes_matmul_kernel", "12"),
    ("bayes_sample_kernel", "13"), ("attention_fwd_kernel", "14"),
    ("attention_fwd_wgmma", "14"),
    ("attn_train_fwd_kernel", "15"), ("attn_fwd_wgmma", "15"),
    ("attn_train_dq_kernel", "16"), ("attn_dq_wgmma", "16"),
    ("attn_train_dkv_kernel", "17"),
    ("attn_dkv_wgmma", "17"), ("gp6_fwd_persistent", "18"),
    ("gp6_fwd_step", "18"),
    ("gp6_bwd_gates", "19"), ("gp6_bwd_dh", "19"), ("gp6_dcoef_sum", "19"),
    ("gp6_bwd_gemm", "19"), ("gp6_bwd_persistent", "19"),
    ("gpg_fwd_persistent", "20"), ("gpg_fwd_step", "20"),
    ("gpg_bwd_gates", "21"), ("gpg_bwd_dh", "21"),
    ("gpg_dcoef_sum", "21"), ("gpg_bwd_gemm", "21"),
    ("gpg_bwd_persistent", "21"), ("lstm2_fwd_l1", "7"), ("lstm2_fwd_l2", "7"),
    ("lstm2_input_gemm", "7"),
    ("lstm2_dropped", "8"), ("lstm2_bwd_gates", "8"), ("lstm2_bwd_dh2", "8"),
    ("lstm2_bwd_dh1", "8"), ("lstm2_gates_gemm", "8"),
    ("lstm2_bwd_persistent", "8"), ("bmm_draw_split", "12"),
    ("bmm_split_wgmma", "12"))


def kernel_row(name):
    """'row N' of the kernel table for a device event's name, or ''."""
    return next((f"row {r}" for k, r in KERNEL_ROWS if k in name), "")


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


def device_ms(torch, fn, repeats):
    """Device time of ``fn`` in ms, per call: the sum of the device-side
    events (kernels, copies) that torch.profiler records over ``repeats``
    calls, after a warm-up. For kernels so short that the host's launch
    time, not the device, sets the time between two CUDA events. A profile
    that records no device time is taken again, three profiles in all,
    each printing the events it saw; then the phase fails: no other
    yardstick stands in for the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    attempts = 3
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(repeats):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        us = sum(ev.self_device_time_total for ev in events
                 if ev.device_type != DeviceType.CPU)
        if us > 0:
            return us / 1e3 / repeats
        print(f"  (profile {attempt} of {attempts} recorded no device time; "
              f"its events: {sorted((ev.key, ev.count) for ev in events)})")
    raise AssertionError(f"torch.profiler recorded no device time in "
                         f"{attempts} profiles of {repeats} calls")


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


def lstm2_check(torch, kernels, args, tag=""):
    """Row 1 on one recorded main-path call: the design ``_design`` picks,
    which must be the persistent one, against the twin within LSTM_RTOL /
    LSTM_ATOL elementwise, each of LSTM_FAULTS whose argument the call has
    (an ``evaluate`` call has no mask and no resets) past it; the per-step
    design on the same call against the twin within the same tolerance and
    timed beside it (``per_step_ms``). Where the call has no mask and no
    resets, cuDNN's 2-layer ``torch.nn.LSTM`` forward on the same
    weights, h0 and c0 is the library time (it also computes x W_ih1^T).
    Adds ``"lstm2_fwd" + tag`` to ``kernels``. Raises on a failed check."""
    from bayeslms_tpu_torch.ops import lstm_cuda

    name = "lstm2_fwd" + tag
    with phase(f"kernel {name}"), torch.no_grad():
        xg1 = args[0]
        T, B, G = xg1.shape
        H = G // 4
        plan = lstm_cuda._card_design(xg1.device, T, B, H)
        print(f"  T={T} B={B} H={H}: design {plan['design']}, "
              f"{plan['ctas']} CTAs, "
              f"{plan['stages']} ring stages, {plan['m_tiles']} m tiles, "
              f"{plan['smem_bytes']} bytes of shared memory a CTA")
        if plan["design"] != "persistent":
            raise AssertionError(f"_design sends {name} to {plan['design']}")
        kernel = lstm_cuda.lstm2_fwd
        per_step = lambda *a: lstm_cuda._lstm2_fwd("per_step", *a)  # noqa: E731
        ref = lstm_outputs(lstm_cuda.lstm2_plain(*args))
        print(f"  tolerance |kernel - plain| <= {LSTM_ATOL:.3e} + "
              f"{LSTM_RTOL:.3e} |plain|, elementwise")
        errs, ratio = {}, {}
        for design, fn in (("persistent", kernel), ("per_step", per_step)):
            before = dict(lstm_cuda.design_launches)
            got = lstm_outputs(fn(*args))
            torch.cuda.synchronize()
            if lstm_cuda.design_launches[design] != before[design] + 1:
                raise AssertionError(f"the call did not take the {design} "
                                     f"design: {lstm_cuda.design_launches}")
            ratio[design] = 0.0
            for k, r in ref.items():
                e = max_err(got[k], r)
                errs[design] = max(errs.get(design, 0.0), e)
                q = tol_ratio(got[k], r, LSTM_RTOL, LSTM_ATOL)
                ratio[design] = max(ratio[design], q)
                print(f"  {design} {k}: |plain| max "
                      f"{float(r.float().abs().max()):.3e} mean "
                      f"{float(r.float().abs().mean()):.3e}; max |kernel - "
                      f"plain| {e:.3e}, worst share of tolerance {q:.3f}")
            del got
        faults = {}
        for fault, (i, _) in LSTM_FAULTS.items():
            if args[i] is None:  # no mask or no resets in this call
                continue
            bad = lstm_outputs(kernel(*planted(args, fault)))
            faults[fault] = max(tol_ratio(bad[k], r, LSTM_RTOL, LSTM_ATOL)
                                for k, r in ref.items())
            print(f"  planted fault '{fault}': worst share of tolerance "
                  f"{faults[fault]:.1f}")
            del bad
        ms = cuda_ms(torch, lambda: kernel(*args), 5)
        step_ms = cuda_ms(torch, lambda: per_step(*args), 3)
        plain_ms = cuda_ms(torch, lambda: lstm_cuda.lstm2_plain(*args), 3)
        reset, mask = args[11], args[10]
        n_reset = 0 if reset is None else int((reset != 0).sum())
        n_masked = 0 if mask is None else int((mask == 0).sum())
        flops = T * 3 * 2 * B * H * G
        nbytes = (T * B * G * 2 + 3 * G * H * 2 + 2 * G * 4 + 2 * T * B
                  + B * 4 + 8 * B * H * 2 + T * B * H * 2)
        bms, bby = bound_ms(flops, nbytes)
        print(f"  shapes T={T} B={B} H={H} bf16, resets {n_reset}, "
              f"masked steps {n_masked}")
        library_ms, lib = None, ("none (no single PyTorch call computes a "
                                 "masked, resetting 2-layer LSTM)")
        if mask is None and reset is None:
            library_ms = cuda_ms(torch, lstm2_library(torch, args), 5)
            lib = (f"{library_ms:.3f} ms (torch.nn.LSTM(num_layers=2) "
                   "forward, cuDNN, bf16)")
        print(f"  persistent {ms:.3f} ms, per-step {step_ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bms:.3f} ms ({bby}); library {lib}")
        kernels[name] = dict(
            name=name, route="cuda",
            source="bayeslms_tpu_torch/csrc/lstm2_fwd.cu",
            replaces="bayeslms_tpu/ops/lstm_pallas.py:722",
            max_abs_err=errs["persistent"], ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=bby, library_ms=library_ms, launches=0,
            design="persistent", per_step_ms=step_ms,
            per_step_max_abs_err=errs["per_step"])
        if max(ratio.values()) > 1:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"worst shares {ratio}, errors {errs}")
        if min(faults.values()) <= 1:
            raise AssertionError(f"a planted fault passes the tolerance: "
                                 f"{faults}")


def lstm2_library(torch, args):
    """A no-argument call of cuDNN's bf16 2-layer ``torch.nn.LSTM`` forward
    over row 1's call without mask or resets: its W_hh1, W_ih2, W_hh2 and
    biases (b_hh1 as layer 1's, b2 as layer 2's input bias), its h0 and c0,
    and a random x of width H (the module also computes x W_ih1^T)."""
    xg1, whh1, bhh1, wih2, whh2, b2, h01, c01, h02, c02 = args[:10]
    T, B, G = xg1.shape
    H = G // 4
    bf16 = torch.bfloat16
    lstm = torch.nn.LSTM(H, H, num_layers=2, device="cuda", dtype=bf16)
    with torch.no_grad():
        lstm.weight_hh_l0.copy_(whh1)
        lstm.weight_ih_l1.copy_(wih2)
        lstm.weight_hh_l1.copy_(whh2)
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.copy_(bhh1)
        lstm.bias_ih_l1.copy_(b2)
        lstm.bias_hh_l1.zero_()
    x = torch.randn((T, B, H), device="cuda", dtype=bf16)
    h0 = torch.stack((h01, h02)).to(bf16)
    c0 = torch.stack((c01, c02)).to(bf16)
    return lambda: lstm(x, (h0, c0))


def lstm_fwd_per_step_check(torch, kernels, args):
    """Row 5's per-step design (``lstm_fwd_step``, one launch a step), which
    ``_design`` keeps for a batch past 32 columns, on the step's first
    recorded call (the persistent design's) against the twin within
    TRAIN_TOL["lstm_train_fwd"], its planted fault (W_hh zeroed) by
    FAULT_MARGIN or more; timed, and the time added to the persistent
    design's ``kernels`` entry as ``per_step_ms``. Raises on a failed
    check."""
    from bayeslms_tpu_torch.ops import lstm_train_cuda as ltc

    with phase("kernel lstm_train_fwd (per-step design)"), torch.no_grad():
        rtol, share = TRAIN_TOL["lstm_train_fwd"]
        outs = ("ys", "cs", "hT", "cT")
        before = dict(ltc.fwd_design_launches)
        got = dict(zip(outs, ltc._train_fwd("per_step", *args)))
        ref = dict(zip(outs, ltc.lstm_train_fwd_plain(*args)))
        torch.cuda.synchronize()
        if ltc.fwd_design_launches["per_step"] != before["per_step"] + 1:
            raise AssertionError("the call did not take the per-step design: "
                                 f"{ltc.fwd_design_launches}")
        err, worst = check_outputs("lstm_train_fwd (per-step)", got, ref,
                                   rtol, share)
        bad = list(args)
        bad[1] = torch.zeros_like(args[1])
        fault = fault_share(dict(zip(outs, ltc._train_fwd("per_step", *bad))),
                            ref, rtol, share)
        print(f"  planted fault 'W_hh product dropped': worst share of "
              f"tolerance {fault:.1f}")
        ms = cuda_ms(torch, lambda: ltc._train_fwd("per_step", *args), 5)
        print(f"  per-step {ms:.3f} ms (the persistent design "
              f"{kernels['lstm_train_fwd']['ms']:.3f} ms on the same call)")
        kernels["lstm_train_fwd"]["per_step_ms"] = ms
        if worst > 1:
            raise AssertionError(f"the per-step design disagrees with its "
                                 f"plain version: worst share {worst:.3f}")
        if fault < FAULT_MARGIN:
            raise AssertionError(f"the per-step design's planted fault "
                                 f"exceeds the tolerance only {fault:.1f}x")


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
# The CE kernels at the Transformer's width: its logits (layer-normed h
# against the tied table) reach ~20 where the LSTM's stay below 1, so their
# fp32 sums of D products carry ~20x the absolute rounding (2.5e-5 on the
# H100, PERF.md). exp turns a logit's absolute error into that relative
# error of the sum-exp; and d = p - onehot, rounded to bf16 as on the TPU,
# rounds the other way ~20x as often, which moves dh by up to 2^-7 of its
# largest entry (one bf16 step there) where the LSTM's moved 2^-11.
TM_TRAIN_TOL = {**TRAIN_TOL, "ce_train_fwd": (2 ** -15, 2 ** -19),
                "ce_train_dh": (2 ** -6, 2 ** -6)}
FAULT_MARGIN = 10.0
# The kernel-path training step against the plain-path step (same weights,
# batch and dropout masks): the LSTM's loss absolute; the Transformer's loss
# and KL relative (the CE kernels' float32 sums, and row 12's fp32 dot
# against the twin's, in other orders, through 6 bf16 layers); each
# parameter's gradient, max |kernel - plain| against STEP_GRAD_SHARE of its
# largest |plain| entry.
STEP_LOSS_ATOL = 1e-5
STEP_LOSS_RTOL = 2 ** -14
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


def compare_steps(torch, trainer, data, target, kl_scale, masks, plain,
                  loss_atol=0.0, loss_rtol=0.0, hidden=lambda: None,
                  prepare=lambda st: None, labels=("kernel", "plain"),
                  check=True):
    """One step on the kernel path and one with ``plain`` (mock patches of
    the kernels' wrappers with their twins), from the same weights, batch,
    ``hidden()`` state, masks and generator state; raises unless loss and
    KL agree within ``loss_atol`` + ``loss_rtol`` |plain| and every
    gradient within STEP_GRAD_SHARE of its largest entry. ``check=False``
    prints the same reading and raises nothing; ``labels`` name the two
    steps in it."""
    def one_step():
        st = trainer.init_state(seed=5)
        prepare(st)
        trainer.gen.manual_seed(11)
        _, loss, _, kl, gnorm = trainer.train_step(
            st, hidden(), data, target, kl_scale, dropout_masks=masks)
        # a parameter the loss does not reach (the GP cell's bias_hh) has
        # no gradient: zero, as the trainer's step takes it
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                 for k, p in st.params.items()}
        return float(loss), float(kl), float(gnorm), grads

    k_loss, k_kl, k_gn, k_grads = one_step()
    with contextlib.ExitStack() as stack:
        for p in plain:
            stack.enter_context(p)
        p_loss, p_kl, p_gn, p_grads = one_step()
    ka, pa = labels
    print(f"  loss {ka} {k_loss:.6f} {pa} {p_loss:.6f}; KL term "
          f"{k_kl:.6f} / {p_kl:.6f} (tolerance {loss_atol:.1e} + "
          f"{loss_rtol:.1e} |{pa}|); gnorm {k_gn:.6f} / {p_gn:.6f}")
    shares = []
    for k, g in p_grads.items():
        big = float(g.abs().max())
        e = max_err(k_grads[k], g)
        shares.append((e / (STEP_GRAD_SHARE * big + 1e-30), k, big, e))
    shares.sort(reverse=True)
    for share, k, big, e in shares[:6]:
        print(f"  grad {k}: |{pa}| max {big:.3e}; max |{ka} - {pa}| "
              f"{e:.3e} ({e / (big + 1e-30):.2e} of the max)")
    worst = shares[0][0]
    print(f"  worst gradient share of tolerance {worst:.3f} over "
          f"{len(p_grads)} parameters (the six worst printed)")
    if not check:
        return
    if abs(k_loss - p_loss) > loss_atol + loss_rtol * abs(p_loss) \
            or abs(k_kl - p_kl) > loss_atol + loss_rtol * abs(p_kl) + 1e-12 \
            or worst > 1:
        raise AssertionError(f"the kernel-path step disagrees with the "
                             f"plain path (worst share {worst:.3f})")


def recording(module, names, recorded):
    """Mock patches of ``module``'s wrappers ``names`` that append each
    call's arguments to ``recorded[name]`` and call the wrapper."""
    def patch(name):
        fn = getattr(module, name)

        def call(*args):
            recorded.setdefault(name, []).append(args)
            return fn(*args)
        return mock.patch.object(module, name, call)
    return [patch(n) for n in names]


def check_outputs(name, got, ref, rtol, share, slack=None):
    """Print each output's magnitude, error and worst share of its
    tolerance (plus ``slack[k]``, an elementwise allowance, where given);
    returns (max abs error, worst share)."""
    err, worst = 0.0, 0.0
    for k in ref:
        r = ref[k].float()
        big = float(r.abs().max())
        e = max_err(got[k], r)
        q = tol_ratio(got[k], r, rtol,
                      share * big + 1e-30 + (slack or {}).get(k, 0.0))
        err, worst = max(err, e), max(worst, q)
        print(f"  {name} {k}: |plain| max {big:.3e} mean "
              f"{float(r.abs().mean()):.3e}; max |kernel - plain| {e:.3e}, "
              f"worst share of tolerance {q:.3f}")
    return err, worst


def fault_share(got, ref, rtol, share, slack=None):
    return max(tol_ratio(got[k], ref[k], rtol,
                         share * float(ref[k].float().abs().max()) + 1e-30
                         + (slack or {}).get(k, 0.0))
               for k in ref)


CE_TRAIN = ("ce_train_fwd", "ce_train_dh", "ce_train_de")


def ce_train_specs(ctc, M, V, D):
    """Check specs of the fused CE training kernels (rows 9-11) at M
    tokens, V words and width D: twin, outputs, planted fault (argument 3,
    the targets, shifted), operations and bytes."""
    return {
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


def check_recorded(torch, kernels, specs, recorded, tag="", tol=TRAIN_TOL,
                   exact=None):
    """Each kernel of ``specs`` against its twin on every call one step
    recorded (``recorded[name]``), elementwise within ``tol``, a planted
    fault per call that must exceed it by FAULT_MARGIN, the CE kernels at
    ragged M and V too; times it and adds it to ``kernels`` as ``name`` +
    ``tag``. ``exact[name](args)`` gives float64 references that replace
    the twin's outputs of those names. Raises, once every kernel was
    checked, on any failed check."""
    from bayeslms_tpu_torch.ops import ce_train_cuda as ctc

    def as_dict(spec, out):
        out = out if isinstance(out, tuple) else (out,)
        return dict(zip(spec["outs"], out))

    def reference(name, spec, args):
        ref = as_dict(spec, spec["plain"](*args))
        if exact and name in exact:
            sub = exact[name](args)
            ref.update(sub)
            print(f"  reference: {sorted(sub)} in float64, the rest the "
                  "twin's")
        return ref

    def planted_args(args, i):
        a = list(args)
        if i == 3:  # targets
            a[3] = torch.roll(a[3], 1)
        else:
            a[i] = torch.zeros_like(a[i])
        return a

    failed = []
    for name, spec in specs.items():
        with phase(f"kernel {name}{tag}"), torch.no_grad():
            kernel = getattr(spec["module"], name)
            rtol, share = tol[name]
            args = recorded[name][0]
            print(f"  tolerance |kernel - plain| <= {rtol:.3e} |plain| + "
                  f"{share:.3e} max|plain|, elementwise; {len(recorded[name])}"
                  f" call(s) in one step; first operand {tuple(args[0].shape)}"
                  f" {args[0].dtype}")
            err, worst, fault = 0.0, 0.0, float("inf")
            for args in recorded[name]:
                ref = reference(name, spec, args)
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
            if name in CE_TRAIN:
                # ragged edges too (M and V off the 64 tiles), random bias
                M, V = args[0].shape[0] - 37, args[1].shape[0] - 77
                gen = torch.Generator(device="cuda").manual_seed(2)
                br = torch.rand((V,), generator=gen, device="cuda") * 2 - 1
                ra = [args[0][:M], args[1][:V], br, args[3][:M] % V]
                if name != "ce_train_fwd":
                    # the statistics as a step hands them, from the forward
                    # kernel, where a float64 reference (its own softmax)
                    # stands in for the twin: p is then consistent with
                    # the kernel's scores, as in training
                    fwd = ctc.ce_train_fwd if exact and name in exact \
                        else ctc.ce_train_fwd_plain
                    _, rmx, rse = fwd(*ra)
                    ra += [rmx, rse, args[6][:M].contiguous(),
                           args[7][:M].contiguous()]
                ref = reference(name, spec, ra)
                e, q = check_outputs(f"{name} ragged M={M} V={V}",
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
            if name in CE_TRAIN:
                print_ce_plan(ctc, name, args, spec["flops"], ms, bms)
            kernels[name + tag] = dict(
                name=name + tag, route="cuda",
                source=f"bayeslms_tpu_torch/csrc/{spec['source']}",
                replaces=spec["replaces"], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                library_ms=library_ms)
            if worst > 1:
                failed.append(f"{name} disagrees with its plain version: "
                              f"worst share {worst:.3f}")
            if fault < FAULT_MARGIN:
                failed.append(f"{name}: the planted fault exceeds the "
                              f"tolerance only {fault:.1f}x")
            if failed:
                print(f"  FAILED so far: {failed}")
    if CE_TRAIN[0] in specs:
        failed += ce_repeat_bits(torch, ctc, recorded, tag)
    if failed:
        raise AssertionError("; ".join(failed))


def lstm_bwd_two_launch_check(torch, kernels, args):
    """Row 6's two-launch design (``lstm_bwd_gates`` and ``lstm_bwd_dh``),
    which ``_design`` keeps for a batch past 32 columns: the step's first
    recorded call with its batch doubled (B = 64) against the twin within
    TRAIN_TOL["lstm_train_bwd"], its planted fault (W_hh zeroed in the
    backward only) by FAULT_MARGIN or more; timed, and the time added to
    the persistent design's ``kernels`` entry as ``two_launch_ms`` (B = 64:
    twice the persistent call's columns). Raises on a failed check."""
    from bayeslms_tpu_torch.ops import lstm_train_cuda as ltc

    with phase("kernel lstm_train_bwd (two-launch design, B=64)"), \
            torch.no_grad():
        xg, w, b, mask, h0, c0, ys, cs, dy, dhT, dcT = args

        def cat(x, dim):
            return torch.cat([x, x], dim=dim).contiguous()

        a2 = [cat(xg, 1), w, b, None if mask is None else cat(mask, 1),
              cat(h0, 0), cat(c0, 0), cat(ys, 1), cat(cs, 1), cat(dy, 1),
              cat(dhT, 0), cat(dcT, 0)]
        T, B, G = a2[0].shape
        plan = ltc._card_design(xg.device, B, G // 4, T)
        print(f"  T={T} B={B} H={G // 4}: design {plan['design']}, grid "
              f"{plan['grid']}, {plan['launches']} launches a call")
        if plan["design"] != "two_launch":
            raise AssertionError(f"_design sends B={B} to {plan['design']}")
        rtol, share = TRAIN_TOL["lstm_train_bwd"]
        outs = ("du", "dh0", "dc0")
        before = dict(ltc.design_launches)
        got = dict(zip(outs, ltc.lstm_train_bwd(*a2)))
        ref = dict(zip(outs, ltc.lstm_train_bwd_plain(*a2)))
        torch.cuda.synchronize()
        if ltc.design_launches["two_launch"] != before["two_launch"] + 1:
            raise AssertionError("the call did not take the two-launch "
                                 f"design: {ltc.design_launches}")
        err, worst = check_outputs("lstm_train_bwd (two-launch)", got, ref,
                                   rtol, share)
        bad = list(a2)
        bad[1] = torch.zeros_like(w)
        fault = fault_share(dict(zip(outs, ltc.lstm_train_bwd(*bad))), ref,
                            rtol, share)
        print(f"  planted fault 'W_hh zeroed in the backward only': worst "
              f"share of tolerance {fault:.1f}")
        ms = cuda_ms(torch, lambda: ltc.lstm_train_bwd(*a2), 5)
        print(f"  two-launch {ms:.3f} ms at B={B} (the persistent design "
              f"{kernels['lstm_train_bwd']['ms']:.3f} ms at B={B // 2})")
        kernels["lstm_train_bwd"]["two_launch_ms"] = ms
        if worst > 1:
            raise AssertionError(f"the two-launch design disagrees with its "
                                 f"plain version: worst share {worst:.3f}")
        if fault < FAULT_MARGIN:
            raise AssertionError(f"the two-launch design's planted fault "
                                 f"exceeds the tolerance only {fault:.1f}x")


def print_ce_plan(ctc, name, args, flops, ms, bms):
    """The launch of ``name`` at ``args``' shape (the forward: its walk's
    split S, grid and CTAs; the backward: cluster size C, dh's walk split
    S, grid, the clusters the card holds at once) and what it achieved:
    TFLOP/s of the bound's operations (2 M V D, 4 M V D), share of the
    bound."""
    h, emb = args[0], args[1]
    M, V, D = h.shape[0], emb.shape[0], h.shape[1]
    rate = (f"{flops / ms / 1e9:.1f} TFLOP/s, {bms / ms:.3f} of the "
            "bound")
    if name == "ce_train_fwd":
        plan = ctc._card_fwd_plan(h.device, M, V, D)
        print(f"  plan (forward): S {plan['S']}, grid {plan['grid']}, "
              f"{plan['ctas']} CTAs ({plan['token_tiles']} token tiles x "
              f"{plan['vocab_tiles']} vocabulary tiles), workspace "
              f"{plan['workspace_bytes']} bytes; {rate}")
        return
    plan = ctc._card_plan(h.device, M, V, D, name == "ce_train_de")
    print(f"  plan ({plan['which']}): C {plan['C']}, G {plan['G']}, S "
          f"{plan['S']}, grid {plan['grid']}, cluster {plan['cluster']}, "
          f"{plan['ctas']} CTAs in {plan['clusters']} clusters, the card "
          f"holds {plan['max_clusters']} clusters at once, workspace "
          f"{plan['workspace_bytes']} bytes; {rate}")


def ce_repeat_bits(torch, ctc, recorded, tag):
    """The CE kernels run twice on one step's call: the bits must repeat
    (no atomics; fixed orders of the partial and cluster sums). Returns
    the failures."""
    failed = []
    with phase(f"ce_train repeats its bits{tag}"), torch.no_grad():
        for name in CE_TRAIN:
            args = recorded[name][0]
            kernel = getattr(ctc, name)
            one, two = kernel(*args), kernel(*args)
            one = one if isinstance(one, tuple) else (one,)
            two = two if isinstance(two, tuple) else (two,)
            same = all(torch.equal(x, y) for x, y in zip(one, two))
            print(f"  {name}: two calls {'equal' if same else 'DIFFER'} "
                  f"bit for bit")
            if not same:
                failed.append(f"{name}: two calls gave different bits")
    return failed


def train_phases(torch, kernels, smi, cfg, rcfg):
    """The training half of the main path; adds the training kernels to
    ``kernels``. Raises on any failed check. Returns the synthetic corpus
    and the temporary directory that holds it, for the Bayesian phases."""
    from bayeslms_tpu_torch import TrainConfig
    from bayeslms_tpu_torch.core.checkpoint import load_checkpoint
    from bayeslms_tpu_torch.data.corpus import Corpus
    from bayeslms_tpu_torch.models.lstm_lm import (draw_dropout_masks,
                                                   init_hidden)
    from bayeslms_tpu_torch.ops import ce_train_cuda as ctc
    from bayeslms_tpu_torch.ops import lstm2_train_cuda as l2c
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
        with contextlib.ExitStack() as stack:
            for p in recording(ltc, ("lstm_train_fwd", "lstm_train_bwd"),
                               recorded) + recording(ctc, CE_TRAIN, recorded):
                stack.enter_context(p)
            trainer.train_step(state, init_hidden(2, B, cfg.nhid,
                                                  device="cuda"),
                               data, target)
        torch.cuda.synchronize()
        del state

    H, M = cfg.nhid, T * B
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
        **ce_train_specs(ctc, M, V, cfg.nhid),
    }
    for row, name, key in (("5", "lstm_train_fwd", "fwd_design"),
                           ("6", "lstm_train_bwd", "design")):
        designs = {ltc._card_design(a[0].device, a[0].shape[1],
                                    a[0].shape[2] // 4)[key]
                   for a in recorded[name]}
        print(f"  row {row} designs of the step's calls: {sorted(designs)}")
        if designs != {"persistent"}:
            raise AssertionError(f"the step's row-{row} calls are not all on "
                                 f"the persistent design: {designs}")
    check_recorded(torch, kernels, specs, recorded)
    kernels["lstm_train_fwd"]["design"] = "persistent"
    kernels["lstm_train_bwd"]["design"] = "persistent"
    lstm_fwd_per_step_check(torch, kernels, recorded["lstm_train_fwd"][0])
    lstm_bwd_two_launch_check(torch, kernels, recorded["lstm_train_bwd"][0])
    del recorded

    with phase("train main path"):
        for module in (ltc, ctc, l2c):
            for k in module.launches:
                module.launches[k] = 0
        ltc.design_launches.update(persistent=0, two_launch=0)
        ltc.fwd_design_launches.update(persistent=0, per_step=0)
        lstm_cuda.launches = 0
        lstm_cuda.design_launches.update(persistent=0, per_step=0)
        steps = []
        eval_call = []  # evaluate's first row-1 call, copied

        def on_step(b, loss):
            torch.cuda.synchronize()
            steps.append((time.perf_counter(), float(loss)))

        def record_eval(*a):
            if not eval_call:
                eval_call.append(tuple(None if x is None else x.clone()
                                       for x in a))
            return row1(*a)

        row1 = lstm_cuda.lstm2_fwd
        t0 = time.perf_counter()
        with mock.patch.object(lstm_cuda, "lstm2_fwd", record_eval):
            state, out = trainer.fit(corpus,
                                     log=lambda line: print("  " + line),
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
        print(f"  row 5 launches by design: {ltc.fwd_design_launches}; row "
              f"6: {ltc.design_launches}; row 1 (evaluate): "
              f"{lstm_cuda.design_launches}")
        if ltc.fwd_design_launches["persistent"] != launches["lstm_train_fwd"]:
            raise AssertionError("a row-5 call of fit left the persistent "
                                 f"design: {ltc.fwd_design_launches}")
        if ltc.design_launches["persistent"] != launches["lstm_train_bwd"]:
            raise AssertionError("a row-6 call of fit left the persistent "
                                 f"design: {ltc.design_launches}")
        if launches["lstm2_fwd (evaluate)"] == 0:
            raise AssertionError("evaluate never launched lstm2_fwd")
        if lstm_cuda.design_launches["persistent"] != lstm_cuda.launches:
            raise AssertionError("an evaluate call left row 1's persistent "
                                 f"design: {lstm_cuda.design_launches}")
        if any(l2c.launches.values()):
            raise AssertionError(f"the default route launched rows 7-8: "
                                 f"{dict(l2c.launches)}")
        if not all(np.isfinite(losses)) or not np.isfinite(out["test_loss"]):
            raise AssertionError("a training loss is not finite")
        if np.mean(losses[-5:]) >= np.mean(losses[:5]):
            raise AssertionError(
                f"the loss did not fall: first 5 {np.mean(losses[:5]):.4f}, "
                f"last 5 {np.mean(losses[-5:]):.4f}")
        del state

    lstm2_check(torch, kernels, eval_call[0], " (evaluate)")
    kernels["lstm2_fwd (evaluate)"]["launches"] = \
        launches["lstm2_fwd (evaluate)"]
    del eval_call

    with phase("train step against plain versions"):
        gen = torch.Generator(device="cuda").manual_seed(3)
        compare_steps(
            torch, trainer, data, target, 0.0,
            draw_dropout_masks(cfg, T, B, gen, "cuda"),
            [mock.patch.object(m, n, getattr(m, n + "_plain"))
             for m, n in ((ltc, "lstm_train_fwd"), (ltc, "lstm_train_bwd"),
                          *((ctc, n) for n in CE_TRAIN))],
            loss_atol=STEP_LOSS_ATOL,
            hidden=lambda: init_hidden(2, B, cfg.nhid, device="cuda"))

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
    return corpus, tmp


# ---------------------------------------------------------------- Bayesian
# The Bayesian gate-slice LSTM (Bayes2LSTM) of the paper at the bench's
# width: position 3 (the g gate's rows), as exp/campaign/torch_lstm_bayes3
# and the JAX package's ours_lstm_bayes3 runs. A step draws four (1,024,
# 1,024) float32 slices, weight_{hh,ih}_lgstd_{1,2}, in one launch of the
# sampler kernel under four seeds of one draw.
BAYES_POS = 3
SAMPLER_CALLS_PER_STEP = 1
SAMPLER_SLICES_PER_STEP = 4
PEAK_FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
# The sampler against its twin: bit-equal uniforms; eps from them within
# 8 ulps at [4, 8) (eps <= 7.5; the library's log and cos may differ by an
# ulp or two), and a sample exp(lgstd) eps within that times exp(lgstd)
# plus 2^-21 of its own magnitude (the exp).
EPS_ATOL = 8 * 2.0 ** -21
SAMPLE_RTOL = 2.0 ** -21
SIGMAS = 5.0  # moment and correlation limits, in standard errors
# Planted faults of the sampler, built from csrc/bayes_sample.cu with a
# define (see its header); each must fail one check or more.
SAMPLER_FAULTS = {
    "tile index dropped from the key":
        ("bayes_sample", ("-DBAYES_SAMPLE_FAULT=1",)),
    "u1 without its 1e-12 offset":
        ("bayes_sample", ("-DBAYES_SAMPLE_FAULT=2",)),
    "u1 from a 23-bit shift": ("bayes_sample", ("-DBAYES_SAMPLE_FAULT=3",)),
}


def tool_module(name):
    """The module tools/<name>.py of this checkout."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def corr(torch, a, b):
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    a, b = a - a.mean(), b - b.mean()
    return float((a * b).sum() / (a.norm() * b.norm()))


def sampler_checks(torch, bsc, calls):
    """The sampler's checks on the recorded (lgstd, seed) calls, each
    {name: (value, limit)}; a check passes when value <= limit (so a NaN
    fails it). Returns the checks and every eps drawn."""
    eps_all, err_share, mismatch, repeat = [], 0.0, 0, 0
    tile_r, seed_r = 0.0, 0.0
    for lg, seed in calls:
        shape = tuple(lg.shape)
        noise, u1, u2 = bsc.sample_uniforms(lg, seed)
        p1, p2 = bsc.uniforms_plain(seed, shape)
        mismatch += int((u1 != p1).sum()) + int((u2 != p2).sum())
        ref = torch.exp(lg) * bsc.normal_plain(seed, shape)
        err_share = max(err_share, float(
            ((noise - ref).abs() / (EPS_ATOL * torch.exp(lg)
                                    + SAMPLE_RTOL * ref.abs())).max()))
        repeat += int((bsc.sample_weights(None, lg, seed) != noise).sum())
        eps = (noise / torch.exp(lg)).double()
        tiles = eps.shape[0] // bsc.TILE_ROWS
        for j in range(tiles - 1):
            t = bsc.TILE_ROWS
            tile_r = max(tile_r, abs(corr(torch, eps[j * t:(j + 1) * t],
                                          eps[(j + 1) * t:(j + 2) * t])))
        for other in eps_all:
            seed_r = max(seed_r, abs(corr(torch, eps, other)))
        eps_all.append(eps)
        del noise, u1, u2, p1, p2, ref
    x = torch.cat([e.reshape(-1) for e in eps_all])
    n = x.numel()
    bad = int((~torch.isfinite(x)).sum())
    mean = float(x.mean())
    var = float(x.var())
    kurt = float(((x - mean) ** 4).mean()) / var ** 2
    n_tile = bsc.TILE_ROWS * eps_all[0].shape[1]
    return {
        "non-finite eps": (bad, 0),
        "uniforms differing from the twin's": (mismatch, 0),
        "eps error / its tolerance": (err_share, 1.0),
        "same seed: elements that differ": (repeat, 0),
        "|mean|": (abs(mean), SIGMAS / np.sqrt(n)),
        "|var - 1|": (abs(var - 1), SIGMAS * np.sqrt(2 / n)),
        "|kurtosis - 3|": (abs(kurt - 3), SIGMAS * np.sqrt(24 / n)),
        "max |corr| of neighbouring tiles": (tile_r,
                                             SIGMAS / np.sqrt(n_tile)),
        "max |corr| across seeds": (seed_r, SIGMAS / np.sqrt(
            eps_all[0].numel())),
    }, x


def grad_check(torch, bsc, lg, seed):
    """max |d/dlgstd sum(g * noise) - g * noise|: zero for the
    autograd Function's backward."""
    lgr = lg.detach().clone().requires_grad_(True)
    noise = bsc.sample_noise(lgr, seed)
    g = torch.randn(lg.shape, device=lg.device,
                    generator=torch.Generator(device=lg.device).manual_seed(4))
    (noise * g).sum().backward()
    return float((lgr.grad - g * noise.detach()).abs().max())


def table_grad_check(torch, bsc, lgs, seeds):
    """The same for the step's table (``sample_noises``, one launch): max
    over the slices of |d/dlgstd_i sum_j(g_j * noise_j) - g_i * noise_i|."""
    lgr = [lg.detach().clone().requires_grad_(True) for lg in lgs]
    noises = bsc.sample_noises(lgr, seeds)
    gen = torch.Generator(device=lgs[0].device).manual_seed(5)
    gs = [torch.randn(lg.shape, device=lg.device, generator=gen)
          for lg in lgs]
    sum((g * n).sum() for g, n in zip(gs, noises)).backward()
    return max(float((l.grad - g * n.detach()).abs().max())
               for l, g, n in zip(lgr, gs, noises))


def bayes_phases(torch, kernels, smi, cfg, rcfg, corpus, tmpdir,
                 dev="cuda"):
    """The Bayesian LSTM's training and scoring on the training phases'
    corpus; adds the sampler kernel to ``kernels``. Raises on any failed
    check."""
    import dataclasses
    from bayeslms_tpu_torch import TrainConfig
    from bayeslms_tpu_torch.core.checkpoint import load_checkpoint
    from bayeslms_tpu_torch.data.corpus import batchify
    from bayeslms_tpu_torch.models.lstm_lm import (draw_dropout_masks,
                                                   init_hidden)
    from bayeslms_tpu_torch.ops import _build
    from bayeslms_tpu_torch.ops import bayes_sample_cuda as bsc
    from bayeslms_tpu_torch.ops import ce_cuda
    from bayeslms_tpu_torch.ops import ce_train_cuda as ctc
    from bayeslms_tpu_torch.ops import lstm_cuda
    from bayeslms_tpu_torch.ops import lstm_train_cuda as ltc
    from bayeslms_tpu_torch.rescore.scorer import BatchScorer
    from bayeslms_tpu_torch.train.loop import Trainer

    bcfg = dataclasses.replace(cfg, uncertainty="Bayesian",
                               l_bayes_pos=BAYES_POS)
    B, T = TRAIN_BATCH, TRAIN_SEQ
    save = os.path.join(tmpdir, "bayes.ckpt")
    with phase("bayes setup"):
        tcfg = TrainConfig(lr=5.0, momentum=0.9, clip=1.0, batch_size=B,
                           seq_len=T, eval_batch_size=EVAL_BATCH, epochs=1,
                           log_interval=10, save=save)
        trainer = Trainer(bcfg, tcfg, device=dev)
        state = trainer.init_state()
        data = torch.from_numpy(corpus.train[:T * B].reshape(B, T).T.copy()
                                ).long().to(dev)
        target = torch.from_numpy(corpus.train[1:T * B + 1].reshape(B, T).T
                                  .copy()).long().to(dev)
        kl_scale = T / batchify(corpus.train, B).shape[0]
        tables = []
        real = bsc.sample_slices

        def record(lgstds, seeds, means=None):
            tables.append(([lg.detach().clone() for lg in lgstds],
                           seeds.clone()))
            return real(lgstds, seeds, means)

        bsc.launches = 0
        with mock.patch.object(bsc, "sample_slices", record):
            trainer.train_step(state, init_hidden(2, B, bcfg.nhid,
                                                  device=dev),
                               data, target, kl_scale)
        torch.cuda.synchronize()
        n_launch = bsc.launches
        # the slices one by one, each with its seed
        calls = [(lg, seeds[i:i + 1].clone()) for lgs, seeds in tables
                 for i, lg in enumerate(lgs)]
        print(f"  one step handed the sampler {len(tables)} table(s) of "
              f"{len(calls)} slices in {n_launch} launch(es): "
              + ", ".join(f"{tuple(lg.shape)} seed {int(s)}"
                          for lg, s in calls))
        if len(tables) != SAMPLER_CALLS_PER_STEP \
                or n_launch != SAMPLER_CALLS_PER_STEP \
                or len(calls) != SAMPLER_SLICES_PER_STEP:
            raise AssertionError(
                f"{len(tables)} sampler calls of {len(calls)} slices in "
                f"{n_launch} launches a step; {SAMPLER_CALLS_PER_STEP} of "
                f"{SAMPLER_SLICES_PER_STEP} in {SAMPLER_CALLS_PER_STEP} "
                f"expected")
        del state

    with phase("bayes_sample"):
        checks, eps = sampler_checks(torch, bsc, calls)
        failed = []
        print(f"  {eps.numel()} draws of eps = out / exp(lgstd); tolerance "
              f"{EPS_ATOL:.3e} exp(lgstd) + {SAMPLE_RTOL:.3e} |sample|")
        for name, (value, limit) in checks.items():
            print(f"  {name}: {value:.4g} (limit {limit:.4g})")
            if not value <= limit:
                failed.append(name)
        print(f"  eps: mean {float(eps.mean()):.3e}, var "
              f"{float(eps.var()):.6f}, |eps| max {float(eps.abs().max()):.4f}")
        lg, seed = calls[0]
        g_err = grad_check(torch, bsc, lg, seed)
        print(f"  gradient: max |d/dlgstd - g noise| {g_err:.3e} (limit 0)")
        if g_err > 0:
            failed.append("gradient")
        lgs, seeds = tables[0]
        t_err = table_grad_check(torch, bsc, lgs, seeds)
        print(f"  the table's gradient: max |d/dlgstd_i - g_i noise_i| "
              f"{t_err:.3e} (limit 0)")
        if t_err > 0:
            failed.append("the table's gradient")
        # the step's one launch against the same slices drawn one by one
        before = bsc.launches
        drawn = bsc.sample_slices(lgs, seeds)
        if bsc.launches != before + 1:
            failed.append("the table took more than one launch")
        differ = sum(int((d != bsc.sample_weights(None, l, s)).sum())
                     for d, (l, s) in zip(drawn, calls))
        print(f"  one launch's {len(lgs)} slices against the one-slice "
              f"draws: {differ} elements differ (limit 0)")
        if differ:
            failed.append("the table's draws differ from the one-slice ones")
        real_load = _build.load
        for fault, kernel in SAMPLER_FAULTS.items():
            with mock.patch.object(_build, "load", lambda k, v=kernel:
                                   real_load(v)):
                bad, _ = sampler_checks(torch, bsc, calls)
            caught = [k for k, (v, lim) in bad.items() if not v <= lim]
            print(f"  planted fault '{fault}': fails {len(caught)} checks: "
                  + "; ".join(f"{k} {bad[k][0]:.4g} (limit {bad[k][1]:.4g})"
                              for k in caught))
            if not caught:
                failed.append(f"fault '{fault}' passed every check")
        with mock.patch.object(bsc._SampleNoises, "backward",
                               staticmethod(lambda ctx, *g: (None, *g))):
            bad_g = grad_check(torch, bsc, lg, seed)
            bad_t = table_grad_check(torch, bsc, lgs, seeds)
        print(f"  planted fault 'gradient returns g': max |d/dlgstd - g "
              f"noise| {bad_g:.3e}, the table's {bad_t:.3e} (limit 0)")
        if bad_g == 0 or bad_t == 0:
            failed.append("the gradient fault passed")
        S = len(lgs)
        N, K = lgs[0].shape
        gen = torch.Generator(device=dev).manual_seed(6)
        stacked = torch.stack(lgs)
        kernel_fn = lambda: bsc.sample_slices(lgs, seeds)  # noqa: E731
        one_seeds = [s for _, s in calls]
        alone_fn = lambda: [bsc.sample_weights(None, l, s)  # noqa: E731
                            for l, s in zip(lgs, one_seeds)]
        plain_fn = lambda: bsc.sample_slices_plain(lgs, seeds)  # noqa: E731
        library_fn = lambda: torch.randn(  # noqa: E731
            (S, N, K), generator=gen, device=dev) * torch.exp(stacked)
        # a call's device time (profiler): the event-timed call of a ~us
        # kernel measures the host's launch path (printed beside it)
        ms = device_ms(torch, kernel_fn, 20)
        alone_ms = device_ms(torch, alone_fn, 20)
        plain_ms = device_ms(torch, plain_fn, 3)
        library_ms = device_ms(torch, library_fn, 20)
        call_ms = cuda_ms(torch, kernel_fn, 5)
        # bytes: lgstd read and the sample written, float32; operations:
        # the instructions the launch issues (Philox's integer work, the
        # accurate logf, cosf, expf, sqrtf): its built kernel's SASS count
        # a loop iteration of four elements, off the slow paths, over 132
        # SMs x 4 issue slots a clock at the SM's highest clock
        # (tools/sampler_bound.py, which PERF.md's row 13 quotes)
        sb = tool_module("sampler_bound")
        lines, _ = sb.kernel_lines(_build.build(["bayes_sample"])[
            "bayes_sample"], ["bayes_sample_kernelILb0E"])
        issue = sb.issue_count(lines)
        clk = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.split()[0])
        warp, t_ops = sb.issue_bound_s(S * N * K, 4, issue["hot"], clk)
        t_bytes = S * N * K * 8 / PEAK_BYTES_PER_S
        bms = 1e3 * max(t_bytes, t_ops)
        bby = "bytes" if t_bytes >= t_ops else "operations"
        print(f"  issue: {issue['hot']} SASS instructions a loop iteration "
              f"of 4 elements, {warp:.4g} warp instructions, "
              f"{1e3 * t_ops:.4f} ms at {clk:.0f} MHz; bytes "
              f"{1e3 * t_bytes:.4f} ms")
        print(f"  the step's {S} ({N}, {K}) float32 slices, device time: "
              f"one launch {ms:.4f} ms, the same slices in {S} one-slice "
              f"launches {alone_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{library_ms:.4f} ms (torch.randn * exp(lgstd) over the "
              f"stacked slices: three kernels, other bits), bound {bms:.4f} "
              f"ms ({bby}); one wrapper call between CUDA events "
              f"{call_ms:.4f} ms")
        max_abs = max(float((d - torch.exp(l) * bsc.normal_plain(
            s, tuple(l.shape))).abs().max()) for d, (l, s) in zip(drawn,
                                                               calls))
        kernels["bayes_sample"] = dict(
            name="bayes_sample", route="cuda",
            source="bayeslms_tpu_torch/csrc/bayes_sample.cu",
            replaces="bayeslms_tpu/ops/bayes_matmul.py:109",
            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=bby, library_ms=library_ms, slices=S,
            one_slice_launches_ms=alone_ms)
        if failed:
            raise AssertionError(f"bayes_sample failed: {failed}")
        del eps, drawn

    with phase("bayes_train"):
        for module in (ltc, ctc):
            for k in module.launches:
                module.launches[k] = 0
        ltc.design_launches.update(persistent=0, two_launch=0)
        lstm_cuda.launches = 0
        bsc.launches = 0
        steps, kls = [], []
        step = trainer.train_step

        def counted_step(*a, **kw):
            out = step(*a, **kw)
            kls.append(out[3])
            return out

        def on_step(b, loss):
            torch.cuda.synchronize()
            steps.append((time.perf_counter(), float(loss)))

        trainer.train_step = counted_step
        t0 = time.perf_counter()
        state, out = trainer.fit(corpus, log=lambda line: print("  " + line),
                                 on_step=on_step)
        fit_s = time.perf_counter() - t0
        trainer.train_step = step
        n = len(steps)
        launches = {**ltc.launches, **ctc.launches, "bayes_sample": bsc.launches,
                    "lstm2_fwd (evaluate)": lstm_cuda.launches}
        print(f"  kernel launches in fit ({n} steps): {launches}")
        losses = [l for _, l in steps]
        kl = [float(k) for k in kls]
        print("  loss per step: " + " ".join(f"{l:.4f}" for l in losses))
        print(f"  KL term (KL x seq_len / rows = x {kl_scale:.5f}) per step: "
              + " ".join(f"{k:.6f}" for k in kl))
        print(f"  validation loss {out['history'][0]['val_loss']:.4f}; test "
              f"loss {out['test_loss']:.4f}")
        dts = np.diff([t for t, _ in steps])[2:]
        step_ms = 1e3 * float(np.median(dts))
        print(f"  step median {step_ms:.3f} ms over {len(dts)} warm steps, "
              f"{T * B / step_ms * 1e3:.1f} tokens/s; fit {fit_s:.1f} s on "
              f"{smi}")
        per_step = {"lstm_train_fwd": 2, "lstm_train_bwd": 2,
                    "ce_train_fwd": 1, "ce_train_dh": 1, "ce_train_de": 1,
                    "bayes_sample": SAMPLER_CALLS_PER_STEP}
        for name, k in per_step.items():
            if launches[name] != k * n:
                raise AssertionError(f"{name}: {launches[name]} launches in "
                                     f"{n} steps, {k} a step expected")
        kernels["bayes_sample"]["launches"] = launches["bayes_sample"]
        print(f"  row 6 launches by design: {ltc.design_launches}")
        if ltc.design_launches["persistent"] != launches["lstm_train_bwd"]:
            raise AssertionError("a row-6 call of fit left the persistent "
                                 f"design: {ltc.design_launches}")
        if launches["lstm2_fwd (evaluate)"] == 0:
            raise AssertionError("evaluate never launched lstm2_fwd")
        if not all(np.isfinite(losses)) or not np.isfinite(out["test_loss"]):
            raise AssertionError("a training loss is not finite")
        if not all(np.isfinite(k) and k > 0 for k in kl):
            raise AssertionError(f"the KL term is not finite and > 0: {kl}")
        if np.mean(losses[-5:]) >= np.mean(losses[:5]):
            raise AssertionError(
                f"the loss did not fall: first 5 {np.mean(losses[:5]):.4f}, "
                f"last 5 {np.mean(losses[-5:]):.4f}")
        del state

    with phase("bayes train step against plain versions"):
        # the same weights, batch and dropout masks; the same eps: the
        # generator is reseeded before each step, so both draw the same
        # sampler seeds (kernel against twin) and the same bias noise
        gen = torch.Generator(device=dev).manual_seed(3)
        compare_steps(
            torch, trainer, data, target, kl_scale,
            draw_dropout_masks(bcfg, T, B, gen, dev),
            [mock.patch.object(m, n, getattr(m, n + "_plain"))
             for m, n in ((ltc, "lstm_train_fwd"), (ltc, "lstm_train_bwd"),
                          *((ctc, n) for n in CE_TRAIN),
                          (bsc, "sample_slices"))],
            loss_atol=STEP_LOSS_ATOL,
            hidden=lambda: init_hidden(2, B, bcfg.nhid, device=dev))

    with phase("bayes_score"):
        params, meta = load_checkpoint(save)
        print(f"  checkpoint of epoch {meta['epoch']}, val loss "
              f"{meta['val_loss']:.4f}; scored at the posterior mean")
        scorer = BatchScorer(bcfg, params, rcfg, device=dev)
        nbest = make_synthetic_nbest(n_meetings=2, vocab_words=cfg.vocab_size
                                     - 2)
        w2i = corpus.vocab.word2idx
        lstm_cuda.launches = 0
        ce_cuda.launches = 0
        res = scorer.score_nbest(nbest, w2i, stream_fn=stream_of)
        got = np.array([s for pairs in res.values() for _, s in pairs])
        torch.cuda.synchronize()
        print(f"  kernel launches: lstm2_fwd {lstm_cuda.launches}, ce_fwd "
              f"{ce_cuda.launches}")
        if lstm_cuda.launches == 0 or ce_cuda.launches == 0:
            raise AssertionError("Bayes scoring did not run kernels 1-2")
        with mock.patch.object(lstm_cuda, "lstm2_fwd", lstm_cuda.lstm2_plain), \
                mock.patch.object(ce_cuda, "fused_decode_ce", ce_cuda.ce_plain):
            ref = np.array([s for pairs in scorer.score_nbest(
                nbest, w2i, stream_fn=stream_of).values() for _, s in pairs])
        n_hyps = sum(len(h) for h in nbest.values())
        rel = float((np.abs(got - ref) / np.abs(ref)).max())
        print(f"  {n_hyps} hypotheses, scores mean {got.mean():.3f}, max "
              f"{np.abs(ref).max():.3f}; max |kernel - plain| "
              f"{float(np.abs(got - ref).max()):.4e}, relative {rel:.3e} "
              f"(tolerance {TRAINED_SCORE_RTOL:.0e})")
        if got.shape != (n_hyps,) or not np.all(np.isfinite(got)) \
                or rel > TRAINED_SCORE_RTOL:
            raise AssertionError("Bayes scoring failed")



# ---------------------------------------------------------------- Transformer
# The recipe's Transformer (recipes/run_nnlm_ami_tm.sh:12-23: emb 512, FFN
# 4,096, 6 layers, 8 heads, dropout 0.2, lr 0.1, batch 32, seq_len 100,
# clip 1.0) over the bench's 49,152-word table, tied, bf16; the Bayesian
# variant at the FFN (uncertainty="Bayesian", t_bayes_pos="FFN").
TM_WIDTH = dict(model="Transformer", emsize=512, nhid=4096, nlayers=6,
                nhead=8, dropout=0.2)
TM_LR = 0.1
# Row 14 against its twin, elementwise |kernel - plain| <= ATTN_RTOL |plain|
# + ATTN_SHARE max |plain|: both compute in fp32 and round to bf16 once, so
# an element may round one bf16 step (2^-8 of a value, at most 2^-7) the
# other way.
ATTN_RTOL, ATTN_SHARE = 2 ** -7, 2 ** -14
ATTN_LONG_T = (1024, 4096)
ATTN_FAULT = ("attention_fwd", ("-DATTENTION_FAULT=1",))
# Row 12 against its twin and against x . sample_weights^T (the sampler
# kernel's W): fp32 sums of K products in other orders, the output rounded
# to bf16 once: the same one-step rule.
BMM_RTOL, BMM_SHARE = 2 ** -7, 2 ** -14
BMM_FAULT = ("bayes_matmul", ("-DBAYES_SAMPLE_FAULT=1",))
# Scores through packed-nocarry (sums of ~17 token CEs, ~190), kernel path
# against plain path: the CE kernel's float32 sums in another order.
TM_SCORE_ATOL = 2e-3


def tm_config(cfg, **kw):
    """The recipe's Transformer on the bench's configuration ``cfg``."""
    import dataclasses

    return dataclasses.replace(cfg, **TM_WIDTH, **kw)


def causal_flops(T, BH, d):
    """Operations of causal attention: S = Q K^T and P V over the T (T + 1)
    / 2 kept (row, column) pairs, 2 d each, per batch column and head."""
    return 2 * 2 * d * T * (T + 1) // 2 * BH


def unaligned(torch, *xs):
    """Copies of (T, B, E) views in a (T, B, E + 4) buffer: a batch stride
    that TMA cannot describe, so the design rule sends rows 14-17 to their
    CUDA-core kernels on the same bf16 values."""
    out = []
    for x in xs:
        buf = torch.empty((*x.shape[:2], x.shape[2] + 4), dtype=x.dtype,
                          device=x.device)
        buf[..., :x.shape[2]] = x
        out.append(buf[..., :x.shape[2]])
    return out


def row14_design(acu, call):
    """call()'s result and the design of its one launch of row 14, from
    the counts."""
    before = dict(acu.design_launches)
    res = call()
    took = [k for k, c in acu.design_launches.items() if c != before[k]]
    if len(took) != 1:
        raise AssertionError(f"attention_fwd: one call counted {took}")
    return res, took[0]


def tm_attention_phase(torch, kernels, calls):
    """Row 14 on the q, k, v views that ``evaluate`` handed it and at T =
    1,024 and 4,096, in both designs: the tensor-core kernel on the views
    (the design the main path takes) and the CUDA-core kernel on copies of
    them at a batch stride TMA cannot describe; a planted-fault build
    through both."""
    from bayeslms_tpu_torch.ops import _build
    from bayeslms_tpu_torch.ops import attention_cuda as acu

    F = torch.nn.functional
    CORE = ", CUDA-core design"
    with phase("kernel attention_fwd"), torch.no_grad():
        q, k, v, h = calls[0]
        T, B, E = q.shape
        d = E // h
        print(f"  tolerance |kernel - plain| <= {ATTN_RTOL:.3e} |plain| + "
              f"{ATTN_SHARE:.3e} max|plain|, elementwise; {len(calls)} "
              f"call(s) in one evaluate window, T={T} B={B} heads={h} d={d} "
              f"{q.dtype}, q/k/v strides {q.stride()}")
        err, worst, fault = 0.0, 0.0, float("inf")
        real_load = _build.load
        gen = torch.Generator(device="cuda").manual_seed(8)
        cases = [("eval", a) for a in calls] + [
            (f"T={t}", [torch.randn((t, 2, E), generator=gen, device="cuda")
                        .to(torch.bfloat16) for _ in range(3)] + [h])
            for t in ATTN_LONG_T]
        long4096 = cases[-1][1]
        cases += [(label + CORE, [*unaligned(torch, *a[:3]), a[3]])
                  for label, a in (cases[0], cases[-2], cases[-1])]
        for name, args in cases:
            ref = {"o": acu.causal_attention_plain(*args)}
            got, design = row14_design(
                acu, lambda: {"o": acu.causal_attention(*args)})
            print(f"  attention {name}: design {design}")
            if design != ("simt" if CORE in name else "wgmma"):
                raise AssertionError(f"attention {name}: took {design}")
            torch.cuda.synchronize()
            e, w = check_outputs(f"attention {name}", got, ref, ATTN_RTOL,
                                 ATTN_SHARE)
            err, worst = max(err, e), max(worst, w)
            with mock.patch.object(_build, "load",
                                   lambda kk: real_load(ATTN_FAULT)):
                bad = {"o": acu.causal_attention(*args)}
            fault = min(fault, fault_share(bad, ref, ATTN_RTOL, ATTN_SHARE))
            if not all(bool(torch.isfinite(x.float()).all())
                       for x in (*got.values(), *bad.values())):
                raise AssertionError(f"attention {name}: a non-finite value")
        print(f"  planted fault 'diagonal masked' (both designs): worst "
              f"share of tolerance {fault:.1f} at its least")
        timing = {}
        for name, args in (("eval", calls[0]), ("T=4096", long4096)):
            qq, kk, vv, hh = args
            Tn, Bn, En = qq.shape
            heads = [x.reshape(Tn, Bn, hh, En // hh).permute(1, 2, 0, 3)
                     .contiguous() for x in (qq, kk, vv)]
            core = [*unaligned(torch, qq, kk, vv), hh]
            kernel_fn = lambda a=args: acu.causal_attention(*a)  # noqa: E731
            core_fn = lambda a=core: acu.causal_attention(*a)  # noqa: E731
            plain_fn = lambda a=args: acu.causal_attention_plain(*a)  # noqa: E731
            library_fn = lambda x=heads: F.scaled_dot_product_attention(  # noqa: E731
                *x, is_causal=True)
            ms = device_ms(torch, kernel_fn, 20)
            core_ms = device_ms(torch, core_fn, 20)
            plain_ms = device_ms(torch, plain_fn, 3)
            library_ms = device_ms(torch, library_fn, 20)
            # bytes: q, k, v read once and o written, bf16; operations: the
            # causal pairs' products, against the bf16 tensor-core peak
            bms, bby = bound_ms(causal_flops(Tn, Bn * hh, En // hh),
                                4 * Tn * Bn * En * 2)
            timing[name] = (ms, plain_ms, library_ms, bms, bby)
            print(f"  {name} (T={Tn} B={Bn} heads={hh}): device time a call "
                  f"kernel {ms:.4f} ms (wgmma), {core_ms:.4f} ms (the "
                  f"CUDA-core design, on the views copied to a batch stride "
                  f"of E + 4), plain {plain_ms:.4f} ms, library "
                  f"{library_ms:.4f} ms (F.scaled_dot_product_attention, "
                  f"is_causal), bound {bms:.4f} ms ({bby}); one wrapper call "
                  f"between CUDA events {cuda_ms(torch, kernel_fn, 5):.4f} ms "
                  f"(wgmma), {cuda_ms(torch, core_fn, 5):.4f} ms (CUDA-core)")
        ms, plain_ms, library_ms, bms, bby = timing["eval"]
        kernels["attention_fwd"] = dict(
            name="attention_fwd", route="cuda",
            source="bayeslms_tpu_torch/csrc/attention_fwd.cu",
            replaces="bayeslms_tpu/ops/attention_pallas.py:55",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=bby, library_ms=library_ms, design="wgmma")
        if worst > 1:
            raise AssertionError(f"attention_fwd disagrees with its plain "
                                 f"version: worst share {worst:.3f}")
        if fault < FAULT_MARGIN:
            raise AssertionError(f"attention_fwd: the planted fault exceeds "
                                 f"the tolerance only {fault:.1f}x")


def tm_bayes_matmul_phase(torch, kernels, calls):
    """Row 12 on the FFN linear2 call a Bayesian-FFN step handed it and at
    the Bayesian MHA's o_net shape: the design ``_design`` picks for bf16
    x ("split": W drawn once as three bf16 pieces, wgmma), which each call
    must take, against its twin and against x . sample_weights^T (kernel
    row 13's W), and a planted-fault build of the shared Philox header
    (through the split design's draw); the CUDA-core design ("simt", the
    rule's for float32 x) on the same calls against the same references,
    and timed beside it (``simt_ms``)."""
    from bayeslms_tpu_torch.ops import _build
    from bayeslms_tpu_torch.ops import bayes_matmul_cuda as bmc
    from bayeslms_tpu_torch.ops import bayes_sample_cuda as bsc

    with phase("kernel bayes_matmul"), torch.no_grad():
        x, mean, lgstd, seed = calls[0]
        M = x.shape[0]
        gen = torch.Generator(device="cuda").manual_seed(9)
        E = mean.shape[0]
        stdv = 1.0 / (E + 1) ** 0.5
        mha = [torch.randn((M, E), generator=gen, device="cuda")
               .to(torch.bfloat16),
               (torch.rand((E, E), generator=gen, device="cuda") * 2 - 1)
               * stdv,
               torch.rand((E, E), generator=gen, device="cuda")
               * (-np.log(stdv)) + 2 * np.log(stdv), seed]
        print(f"  tolerance |kernel - ref| <= {BMM_RTOL:.3e} |ref| + "
              f"{BMM_SHARE:.3e} max|ref|, elementwise; shapes "
              f"FFN linear2 x {tuple(x.shape)} W {tuple(mean.shape)}, MHA "
              f"o_net x {tuple(mha[0].shape)} W {tuple(mha[1].shape)}")
        err, worst, fault = 0.0, 0.0, float("inf")
        simt_err, simt_worst = 0.0, 0.0
        real_load = _build.load
        for name, args in (("FFN linear2", calls[0]), ("MHA o_net", mha)):
            xx, mm, ll, sd = args
            plan = bmc._design(xx.dtype, *xx.shape[:1], *mm.shape)
            print(f"  {name}: design {plan['design']}, grid {plan['grid']}, "
                  f"{plan['ctas']} CTAs ({plan['waves']:.2f} of a wave)")
            before = dict(bmc.design_launches)
            got = {"y": bmc.bayes_matmul_fwd(*args)}
            if bmc.design_launches["split"] != before["split"] + 1:
                raise AssertionError(f"bayes_matmul {name}: the call did not "
                                     f"take the split design: "
                                     f"{bmc.design_launches}")
            simt = {"y": bmc._fwd("simt", *args)}
            w = bsc.sample_weights(mm, ll, sd)
            refs = {"twin": {"y": bmc.bayes_matmul_plain(*args)},
                    "x . sample_weights^T": {
                        "y": (xx.float() @ w.t()).to(xx.dtype)}}
            torch.cuda.synchronize()
            for rname, ref in refs.items():
                e, q = check_outputs(f"{name} against {rname}", got, ref,
                                     BMM_RTOL, BMM_SHARE)
                err, worst = max(err, e), max(worst, q)
                e, q = check_outputs(f"{name} (simt) against {rname}", simt,
                                     ref, BMM_RTOL, BMM_SHARE)
                simt_err, simt_worst = max(simt_err, e), max(simt_worst, q)
            with mock.patch.object(_build, "load",
                                   lambda kk: real_load(BMM_FAULT)):
                bad = {"y": bmc.bayes_matmul_fwd(*args)}
            fault = min(fault, fault_share(bad, refs["x . sample_weights^T"],
                                           BMM_RTOL, BMM_SHARE))
        print(f"  planted fault 'tile index dropped from the Philox key' "
              f"(the shared header, through the split draw): worst share of "
              f"tolerance {fault:.1f}")
        N, K = mean.shape
        gen2 = torch.Generator(device="cuda").manual_seed(10)
        kernel_fn = lambda: bmc.bayes_matmul_fwd(*calls[0])  # noqa: E731
        simt_fn = lambda: bmc._fwd("simt", *calls[0])  # noqa: E731
        plain_fn = lambda: bmc.bayes_matmul_plain(*calls[0])  # noqa: E731
        library_fn = lambda: x.float() @ (mean + torch.exp(lgstd) * torch.randn(  # noqa: E731
            (N, K), generator=gen2, device="cuda")).t()
        ms = cuda_ms(torch, kernel_fn, 5)
        simt_ms = cuda_ms(torch, simt_fn, 5)
        plain_ms = cuda_ms(torch, plain_fn, 3)
        library_ms = cuda_ms(torch, library_fn, 5)
        # bytes: x (bf16), mean and lgstd (fp32) read, y (bf16) written;
        # operations: the fp32-accurate product, as the split design's three
        # bf16 products against the bf16 peak, and as the CUDA-core
        # design's fp32 products (the TPU kernel's dot) against the fp32
        # peak; the kernel's bound is the smaller
        t_bytes = (M * K * 2 + 2 * N * K * 4 + M * N * 2) / PEAK_BYTES_PER_S
        t_split = 3 * 2 * M * N * K / PEAK_BF16_FLOPS
        t_simt = 2 * M * N * K / PEAK_FP32_FLOPS
        bms, simt_bms = 1e3 * max(t_split, t_bytes), 1e3 * max(t_simt,
                                                                t_bytes)
        bby = "operations" if t_split >= t_bytes else "bytes"
        print(f"  FFN linear2 (M={M} N={N} K={K}): split {ms:.4f} ms "
              f"(bound {bms:.4f} ms, bf16 operations), simt {simt_ms:.4f} "
              f"ms (bound {simt_bms:.4f} ms, fp32 operations), plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms (torch.randn "
              f"+ exp + fp32 matmul, other bits)")
        kernels["bayes_matmul"] = dict(
            name="bayes_matmul", route="cuda",
            source="bayeslms_tpu_torch/csrc/bayes_matmul.cu",
            replaces="bayeslms_tpu/ops/bayes_matmul.py:82",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=bby, library_ms=library_ms, design="split",
            simt_ms=simt_ms, simt_bound_ms=simt_bms,
            simt_max_abs_err=simt_err)
        if max(worst, simt_worst) > 1:
            raise AssertionError(f"bayes_matmul disagrees: worst share split "
                                 f"{worst:.3f}, simt {simt_worst:.3f}")
        if fault < FAULT_MARGIN:
            raise AssertionError(f"bayes_matmul: the planted fault exceeds "
                                 f"the tolerance only {fault:.1f}x")


def tm_dropout_masks(torch, cfg, T, B, seed, attn=True):
    """Keep masks for every dropout site of a training forward, drawn on
    the card, so that two steps see the same ones; with ``attn=False``
    none for the attention probabilities, which then take the route's own
    draw (rows 15-17 draw them from a seed that the generator gives)."""
    from bayeslms_tpu_torch.models.transformer_lm import (
        BAYES_LAYER_DROPOUT, EncoderDropoutMasks, TransformerDropoutMasks)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    E, FF, h = cfg.emsize, cfg.nhid, cfg.nhead

    def keep(shape, rate):
        return torch.rand(shape, generator=gen, device="cuda") >= rate

    layers = []
    for i in range(cfg.nlayers):
        rate = BAYES_LAYER_DROPOUT if (i == 0 and cfg.t_bayes_pos in
                                       ("FFN", "MHA")) else cfg.dropout
        layers.append(EncoderDropoutMasks(
            keep((B, h, T, T), rate) if attn else None, keep((T, B, E), rate),
            keep((T, B, FF), rate), keep((T, B, E), rate)))
    return TransformerDropoutMasks(keep((T, B, E), cfg.dropout), layers)


def tm_phases(torch, kernels, smi, cfg, rcfg, corpus, tmpdir):
    """The Transformer's training (standard and Bayesian FFN) and scoring
    on the LSTM phases' corpus and the bench's N-best; adds rows 12 and 14
    to ``kernels``. Raises on any failed check."""
    from bayeslms_tpu_torch import TrainConfig, build_model, init_params
    from bayeslms_tpu_torch.data.corpus import batchify
    from bayeslms_tpu_torch.ops import attention_cuda as acu
    from bayeslms_tpu_torch.ops import bayes_matmul_cuda as bmc
    from bayeslms_tpu_torch.ops import bayes_sample_cuda as bsc
    from bayeslms_tpu_torch.ops import ce_cuda
    from bayeslms_tpu_torch.ops import ce_train_cuda as ctc
    from bayeslms_tpu_torch.rescore.scorer import BatchScorer
    from bayeslms_tpu_torch.train.loop import Trainer

    tcfg_m = tm_config(cfg)
    bcfg = tm_config(cfg, uncertainty="Bayesian", t_bayes_pos="FFN")
    B, T = TRAIN_BATCH, TRAIN_SEQ
    kl_scale = T / batchify(corpus.train, B).shape[0]
    ce_plain = [mock.patch.object(ctc, n, getattr(ctc, n + "_plain"))
                for n in CE_TRAIN]
    # rows 2 and 9-11 at the Transformer's width, beside their LSTM entries
    tag = f" (Transformer, D={tcfg_m.emsize})"

    def tcfg(save, epochs):
        return TrainConfig(lr=TM_LR, momentum=0.9, clip=1.0, batch_size=B,
                           seq_len=T, eval_batch_size=EVAL_BATCH,
                           epochs=epochs, log_interval=10,
                           save=os.path.join(tmpdir, save))

    data = torch.from_numpy(corpus.train[:T * B].reshape(B, T).T.copy()
                            ).long().cuda()
    target = torch.from_numpy(corpus.train[1:T * B + 1].reshape(B, T).T
                              .copy()).long().cuda()

    with phase("tm setup"):
        trainer = Trainer(tcfg_m, tcfg("tm.ckpt", 2))
        state = trainer.init_state()
        n_par = sum(p.numel() for p in state.params.values())
        print(f"  {tcfg_m.model} {tcfg_m.emsize}/{tcfg_m.nhid} x "
              f"{tcfg_m.nlayers}, {tcfg_m.nhead} heads, V = "
              f"{tcfg_m.vocab_size}, {tcfg_m.compute_dtype}: {n_par} "
              f"parameters; lr {TM_LR}, batch {B}, seq_len {T}")
        calls = []
        real = acu.causal_attention

        def record(*a):
            calls.append(a)
            return real(*a)

        rows = batchify(corpus.valid, EVAL_BATCH)[:T + 1]
        with mock.patch.object(acu, "causal_attention", record):
            trainer.evaluate(state.model, rows)
        # and the tensors one training step hands the CE kernels; its
        # dropout draws are given back, so that fit sees the same stream
        recorded = {}
        gen_state = trainer.gen.get_state()
        with contextlib.ExitStack() as stack:
            for p in recording(ctc, CE_TRAIN, recorded):
                stack.enter_context(p)
            trainer.train_step(state, None, data, target, kl_scale)
        trainer.gen.set_state(gen_state)
        torch.cuda.synchronize()
        if len(calls) != tcfg_m.nlayers:
            raise AssertionError(f"one evaluate window made {len(calls)} "
                                 f"attention calls, {tcfg_m.nlayers} "
                                 "expected")
        del state

    tm_attention_phase(torch, kernels, calls)
    del calls
    check_recorded(torch, kernels, ce_train_specs(ctc, T * B, cfg.vocab_size,
                                                  tcfg_m.emsize),
                   recorded, tag, TM_TRAIN_TOL)
    del recorded

    with phase("tm train main path"):
        for k in ctc.launches:
            ctc.launches[k] = 0
        acu.launches = 0
        acu.design_launches.update(wgmma=0, simt=0)
        steps, evals = [], []

        def on_step(b, loss):
            torch.cuda.synchronize()
            steps.append((time.perf_counter(), float(loss)))

        evaluate = trainer.evaluate

        def counted_eval(model, rows):
            before = acu.launches
            out = evaluate(model, rows)
            evals.append((acu.launches - before,
                          -(-(rows.shape[0] - 1) // T)))
            return out

        trainer.evaluate = counted_eval
        t0 = time.perf_counter()
        state, out = trainer.fit(corpus, log=lambda line: print("  " + line),
                                 on_step=on_step)
        fit_s = time.perf_counter() - t0
        trainer.evaluate = evaluate
        n = len(steps)
        launches = {**ctc.launches, "attention_fwd (evaluate)": acu.launches}
        print(f"  kernel launches in fit ({n} steps, {len(evals)} "
              f"evaluations): {launches}; attention launches and windows per "
              f"evaluation: {evals}")
        losses = [l for _, l in steps]
        print("  loss per step: " + " ".join(f"{l:.4f}" for l in losses))
        print("  validation loss per epoch: " + " ".join(
            f"{h['val_loss']:.4f}" for h in out["history"])
            + f"; test loss {out['test_loss']:.4f}")
        dts = np.diff([t for t, _ in steps])[2:]
        step_ms = 1e3 * float(np.median(dts))
        print(f"  step median {step_ms:.3f} ms over {len(dts)} warm steps, "
              f"{T * B / step_ms * 1e3:.1f} tokens/s; fit {fit_s:.1f} s on "
              f"{smi}")
        for name in CE_TRAIN:
            kernels[name + tag]["launches"] = launches[name]
            if launches[name] != n:
                raise AssertionError(f"{name}: {launches[name]} launches in "
                                     f"{n} steps, 1 a step expected")
        if not evals or any(a != tcfg_m.nlayers * w for a, w in evals):
            raise AssertionError(f"evaluate did not launch attention_fwd "
                                 f"once a layer and window: {evals}")
        kernels["attention_fwd"]["launches"] = acu.launches
        print(f"  row 14 launches by design: {acu.design_launches}")
        if acu.design_launches["wgmma"] != acu.launches:
            raise AssertionError("evaluate: not every row 14 launch took the "
                                 "wgmma kernel")
        if not all(np.isfinite(losses)) or not np.isfinite(out["test_loss"]):
            raise AssertionError("a training loss is not finite")
        if np.mean(losses[-5:]) >= np.mean(losses[:5]):
            raise AssertionError(
                f"the loss did not fall: first 5 {np.mean(losses[:5]):.4f}, "
                f"last 5 {np.mean(losses[-5:]):.4f}")
        del state

    with phase("tm train step against plain versions"):
        compare_steps(torch, trainer, data, target, kl_scale,
                      tm_dropout_masks(torch, tcfg_m, T, B, 3), ce_plain,
                      loss_rtol=STEP_LOSS_RTOL)

    with phase("tm bayes setup"):
        btrainer = Trainer(bcfg, tcfg("tm_bayes.ckpt", 1))

        def fused(st):
            st.model.layers_0.linear2.use_fused = True

        st = btrainer.init_state()
        fused(st)
        calls = []
        real_fwd = bmc.bayes_matmul_fwd

        def record_fwd(*a):
            calls.append(tuple(x.detach().clone() for x in a))
            return real_fwd(*a)

        with mock.patch.object(bmc, "bayes_matmul_fwd", record_fwd):
            btrainer.train_step(st, None, data, target, kl_scale)
        torch.cuda.synchronize()
        if len(calls) != 1:
            raise AssertionError(f"{len(calls)} bayes_matmul calls in a "
                                 "fused step, 1 expected")
        del st

    tm_bayes_matmul_phase(torch, kernels, calls)
    del calls

    with phase("tm bayes fused step against plain versions"):
        print("  linear2.use_fused = True: row 12 forward, its backward "
              "through row 13; plain: the twins of rows 9-13")
        compare_steps(
            torch, btrainer, data, target, kl_scale,
            tm_dropout_masks(torch, bcfg, T, B, 4),
            ce_plain + [mock.patch.object(bmc, "bayes_matmul_fwd",
                                          bmc.bayes_matmul_plain),
                        mock.patch.object(bsc, "sample_weights",
                                          bsc.sample_weights_plain)],
            loss_rtol=STEP_LOSS_RTOL, prepare=fused)

    with phase("tm bayes train"):
        print("  one epoch of the Bayesian-FFN Transformer with "
              "linear2.use_fused = True (the JAX package's opt-in row 12)")
        for k in ctc.launches:
            ctc.launches[k] = 0
        bmc.launches = 0
        bmc.design_launches.update(split=0, simt=0)
        bsc.launches = 0
        steps, kls = [], []
        step = btrainer.train_step
        init_state = btrainer.init_state

        def fused_init(seed=None):
            st = init_state(seed)
            fused(st)
            return st

        def counted_step(*a, **kw):
            res = step(*a, **kw)
            kls.append(res[3])
            return res

        def on_step(b, loss):
            torch.cuda.synchronize()
            steps.append((time.perf_counter(), float(loss)))

        btrainer.init_state, btrainer.train_step = fused_init, counted_step
        t0 = time.perf_counter()
        _, out = btrainer.fit(corpus, log=lambda line: print("  " + line),
                              on_step=on_step)
        fit_s = time.perf_counter() - t0
        btrainer.init_state, btrainer.train_step = init_state, step
        n = len(steps)
        launches = {**ctc.launches, "bayes_matmul": bmc.launches,
                    "bayes_sample (row 12's backward)": bsc.launches}
        print(f"  kernel launches in fit ({n} steps): {launches}; "
              f"bayes_matmul by design {dict(bmc.design_launches)}")
        losses = [l for _, l in steps]
        kl = [float(k) for k in kls]
        print("  loss per step: " + " ".join(f"{l:.4f}" for l in losses))
        print(f"  KL term (KL x seq_len / rows = x {kl_scale:.5f}) per step: "
              + " ".join(f"{k:.6f}" for k in kl))
        print(f"  validation loss {out['history'][0]['val_loss']:.4f}; test "
              f"loss {out['test_loss']:.4f}")
        dts = np.diff([t for t, _ in steps])[2:]
        step_ms = 1e3 * float(np.median(dts))
        print(f"  step median {step_ms:.3f} ms over {len(dts)} warm steps, "
              f"{T * B / step_ms * 1e3:.1f} tokens/s; fit {fit_s:.1f} s on "
              f"{smi}")
        for name in (*CE_TRAIN, "bayes_matmul",
                     "bayes_sample (row 12's backward)"):
            if launches[name] != n:
                raise AssertionError(f"{name}: {launches[name]} launches in "
                                     f"{n} steps, 1 a step expected")
        if bmc.design_launches["split"] != n:
            raise AssertionError(f"bayes_matmul: designs "
                                 f"{bmc.design_launches} in {n} steps, the "
                                 f"split one every step expected")
        kernels["bayes_matmul"]["launches"] = bmc.launches
        if not all(np.isfinite(losses)) or not np.isfinite(out["test_loss"]):
            raise AssertionError("a training loss is not finite")
        if not all(np.isfinite(k) and k > 0 for k in kl):
            raise AssertionError(f"the KL term is not finite and > 0: {kl}")

    with phase("tm score setup"):
        params = init_params(build_model(tcfg_m), tcfg_m, seed=0)
        scorer = BatchScorer(tcfg_m, params, rcfg)
        nbest = make_synthetic_nbest(n_meetings=30)
        w2i = {"<s>": 0, "<unk>": 1,
               **{f"w{i}": 2 + i for i in range(cfg.vocab_size - 2)}}
        # one pass records the packed chunk it hands the CE kernel
        recorded = {}
        with recording(ce_cuda, ("fused_decode_ce",), recorded)[0]:
            scorer.score_nbest(nbest, w2i)
        torch.cuda.synchronize()
        if len(recorded["fused_decode_ce"]) != 1:
            raise AssertionError(f"{len(recorded['fused_decode_ce'])} CE "
                                 "calls in a packed pass, 1 expected")

    ce_fwd_check(torch, kernels, recorded["fused_decode_ce"][0], tag,
                 TM_CE_ATOL)
    del recorded

    with phase("tm score"):
        ce_cuda.launches = 0
        ce_cuda.design_launches.update(split=0, wmma=0)
        acu.launches = 0
        pass_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = scorer.score_nbest(nbest, w2i)
            torch.cuda.synchronize()
            pass_s.append(time.perf_counter() - t0)
        print(f"  kernel launches in 3 passes: ce_fwd {ce_cuda.launches}, "
              f"attention_fwd {acu.launches} (the packed layout's explicit "
              "mask takes the plain attention, as in JAX)")
        got = np.array([s for pairs in res.values() for _, s in pairs])
        n_hyps = sum(len(h) for h in nbest.values())
        n_tokens = sum(len(h.split()) + 1 for hyps in nbest.values()
                       for h in hyps)
        med = float(np.median(pass_s))
        print(f"  passes {['%.4f' % s for s in pass_s]} s; median "
              f"{n_hyps / med:.1f} hyps/s, {n_tokens / med:.1f} tokens/s "
              f"({n_hyps} hyps, {n_tokens} scored tokens) on {smi}")
        kernels["ce_fwd" + tag]["launches"] = ce_cuda.launches
        print(f"  row 2 by route: {ce_cuda.design_launches}")
        if ce_cuda.launches == 0 \
                or ce_cuda.design_launches["split"] != ce_cuda.launches:
            raise AssertionError("TM scoring never launched ce_fwd, or left "
                                 "the split route")
        with mock.patch.object(ce_cuda, "fused_decode_ce", ce_cuda.ce_plain):
            ref = np.array([s for pairs in scorer.score_nbest(
                nbest, w2i).values() for _, s in pairs])
        diff = float(np.abs(got - ref).max())
        print(f"  {n_hyps} scores, |plain| mean {np.abs(ref).mean():.3f} max "
              f"{np.abs(ref).max():.3f}: max |kernel - plain| {diff:.4e} "
              f"(tolerance {TM_SCORE_ATOL:.0e})")
        if got.shape != (n_hyps,) or not np.all(np.isfinite(got)) \
                or diff > TM_SCORE_ATOL:
            raise AssertionError("TM scoring failed")


# ---------------------------------------------------------- long context
# The recipe's Transformer trained at seq_len 1,024, the length from which
# the JAX package routes causal training attention to its flash kernels
# (bayeslms_tpu/ops/attention.py:71-93; rows 15-17 here), at the recipe's
# batch 32, dropout 0.2 and lr 0.1, one epoch of TM_LONG_WINDOWS windows and
# a padded tail on a synthetic Markov corpus of its own; then
# Transformer-XL scoring of the bench's N-best from the checkpoint that
# this fit wrote.
TM_LONG_SEQ = 1024
TM_LONG_WINDOWS = 6
ATTN_TRAIN = ("attn_train_fwd", "attn_train_dq", "attn_train_dkv")
ATTN_TRAIN_LONG_T = (2048, 4096)
# Rows 15-17 against their twins, elementwise |kernel - plain| <= rtol
# |plain| + share max |plain|. Kernel and twin round z p (forward), dS and
# z P (backward) to bf16 at the same points, from fp32 values that differ
# in their last bits (sums in another order), so a rounded summand may
# land one bf16 step the other way, and the output is rounded once. With
# the forward rounding against a running max instead, the H100 showed
# 0.72 (o) and 0.45 (dq, dk) of this tolerance on one long-context step's
# calls, and the planted faults 80x or more.
ATTN_TRAIN_RTOL, ATTN_TRAIN_SHARE = 2 ** -7, 2 ** -10
ATTN_TRAIN_FAULTS = {
    "k-block index dropped from the dropout key":
        ("attention_train", ("-DATTN_TRAIN_FAULT=1",)),
    "diagonal masked": ("attention_train", ("-DATTN_TRAIN_FAULT=2",))}
# The keep share of the dropout draw, |share - 0.8| over the causal draws
# of one step's call (1.3e8 of them; 5 sigma is 1.7e-4)
KEEP_SHARE_ATOL = 0.002
# Transformer-XL scores against the plain path with row 14's twin too,
# relative: row 14 runs first in every memory build and first utterance,
# and its bf16 output may lie one bf16 step from its twin's ("kernel
# attention_fwd"); each of the five bf16 layers after it rounds that
# difference again, which the H100 showed as up to 3.1e-3 of a score
# (0.8 of a bf16 step; 1.8e-4 absolute with row 2's twin alone, within
# TM_SCORE_ATOL): two bf16 steps of a score.
XL_SCORE_RTOL = 2 ** -7
# Transformer-XL: logits with memories against the suffix of a
# full-context forward, float32 on the card (row 14 in fp32 beside the
# plain masked attention), |a - b| <= XL_ATOL + XL_RTOL |b|
XL_RTOL, XL_ATOL = 1e-4, 1e-4


def attn_train_specs(T, B, h, d):
    """Outputs, operations and bytes of rows 15-17 at (T, B, h, d), bf16:
    each row's causal products (2, 3 and 4 of them) and its inputs read
    once and outputs written once."""
    BH, n = B * h, T * B * h * d * 2
    cf = causal_flops(T, BH, d)
    stats = BH * T * 4
    return {
        "attn_train_fwd": dict(
            outs=("o", "m", "l"), flops=cf, nbytes=4 * n + 2 * stats,
            replaces="bayeslms_tpu/ops/attention_train_pallas.py:198"),
        "attn_train_dq": dict(
            outs=("dq",), flops=3 * cf // 2, nbytes=5 * n + 3 * stats,
            replaces="bayeslms_tpu/ops/attention_train_pallas.py:224"),
        "attn_train_dkv": dict(
            outs=("dk", "dv"), flops=2 * cf, nbytes=6 * n + 3 * stats,
            replaces="bayeslms_tpu/ops/attention_train_pallas.py:245"),
    }


def attention_train_phase(torch, kernels, recorded):
    """Rows 15-17 on every call that one long-context training step handed
    them, and alone at T = 2,048 and 4,096, against their twins, the
    backward kernels on the kernel forward's (m, l) and on the twin's, each
    call's design printed (every call must take the wgmma kernels); the
    CUDA-core kernels (fp32 and d = 256 take them) on step call 0 and at T =
    2,048, through copies of the same bf16 views that TMA cannot describe;
    |sum_c P - 1| of the P rows 16 and 17 rebuild from the kernel forward's
    (m, l), from their own debug sums; the keep bits each kernel of each
    design draws against the twin's, with its outputs equal to a call's
    without the bits, the keep share, repeat calls, two planted-fault
    builds; times (both designs), bounds."""
    from bayeslms_tpu_torch.ops import _build
    from bayeslms_tpu_torch.ops import attention_train_cuda as atc

    F = torch.nn.functional
    real_load = _build.load
    CORE = ", CUDA-core design"

    def outs(name, out):
        return dict(zip(specs[name]["outs"],
                        out if isinstance(out, tuple) else (out,)))

    def run(name, args, fault=None):
        if fault is None:
            return outs(name, getattr(atc, name)(*args))
        with mock.patch.object(_build, "load", lambda kk: real_load(fault)):
            return outs(name, getattr(atc, name)(*args))

    def counted(name, call):
        """call()'s result and the design of its one launch of ``name``,
        from the counts."""
        before = dict(atc.design_launches[name])
        res = call()
        took = [k for k, c in atc.design_launches[name].items()
                if c != before[k]]
        if len(took) != 1:
            raise AssertionError(f"{name}: one call counted {took}")
        return res, took[0]

    def core_args(name, a):
        """``name``'s arguments ``a`` with q, k, v (and dO) unaligned."""
        n = 3 if name == "attn_train_fwd" else 4
        return (*unaligned(torch, *a[:n]), *a[n:])

    def psum_error(q, k, v, g, m, l, delta, h, rate, seed):
        """max |sum_c P - 1| of the P rows 17 and 16 rebuild from (m, l),
        from each wgmma kernel's own debug sums."""
        T, B, E = q.shape
        errs = []
        for name in ("attn_train_dkv", "attn_train_dq"):
            psum = torch.zeros((B * h, T), dtype=torch.float32, device="cuda")
            _, design = counted(name, lambda: getattr(atc, name)(
                q, k, v, g, m, l, delta, h, rate, seed, psum_out=psum))
            if design != "wgmma":
                raise AssertionError(f"{name}'s sums took {design}")
            errs.append(float((psum - 1).abs().max()))
        return errs

    def plain(name, args):
        return outs(name, getattr(atc, name + "_plain")(*args))

    with phase("kernel attention_train"), torch.no_grad():
        q, k, v, h, rate, seed = recorded["attn_train_fwd"][0]
        T, B, E = q.shape
        d = E // h
        specs = attn_train_specs(T, B, h, d)
        print(f"  tolerance |kernel - plain| <= {ATTN_TRAIN_RTOL:.3e} |plain| "
              f"+ {ATTN_TRAIN_SHARE:.3e} max|plain|, elementwise; "
              f"{len(recorded['attn_train_fwd'])} call(s) of each kernel in "
              f"one step, T={T} B={B} heads={h} d={d} {q.dtype}, dropout "
              f"{rate}, q/k/v strides {q.stride()}")
        err = {n: 0.0 for n in ATTN_TRAIN}
        worst = {n: 0.0 for n in ATTN_TRAIN}
        fault = {n: float("inf") for n in ATTN_TRAIN}
        gen = torch.Generator(device="cuda").manual_seed(12)
        long_cases = []
        for t in ATTN_TRAIN_LONG_T:
            qkv = torch.randn((t, 2, 3 * E), generator=gen,
                              device="cuda").to(q.dtype)
            g = (torch.randn((t, 2, E), generator=gen, device="cuda")
                 * 1e-3).to(q.dtype)
            qq, kk, vv = qkv.split(E, dim=-1)
            _, mm, ll = atc.attn_train_fwd_plain(qq, kk, vv, h, rate, seed)
            oo, km, kl = atc.attn_train_fwd(qq, kk, vv, h, rate, seed)
            dl = atc.row_delta(g, oo, h)
            long_cases.append((f"T={t} B=2", {
                "attn_train_fwd": (qq, kk, vv, h, rate, seed),
                "attn_train_dq": (qq, kk, vv, g, mm, ll, dl, h, rate, seed),
                "attn_train_dkv": (qq, kk, vv, g, mm, ll, dl, h, rate,
                                   seed)}))
            long_cases.append((f"T={t} B=2, kernel m, l", {
                n: (qq, kk, vv, g, km, kl, dl, h, rate, seed)
                for n in ATTN_TRAIN[1:]}))
        # the step's backward calls carry the kernel forward's (m, l); each
        # again on the twin's
        step_twin = []
        for i, a in enumerate(recorded["attn_train_dq"]):
            _, mm, ll = atc.attn_train_fwd_plain(*a[:3], *a[7:])
            step_twin.append((f"step call {i}, twin m, l", {
                n: (*a[:4], mm, ll, *a[6:]) for n in ATTN_TRAIN[1:]}))
        # the CUDA-core kernels on step call 0 and at T = 2,048
        core = {n: core_args(n, recorded[n][0]) for n in ATTN_TRAIN}
        core_cases = [("step call 0" + CORE, core), (
            long_cases[0][0] + CORE,
            {n: core_args(n, long_cases[0][1][n]) for n in core})]
        for name in ATTN_TRAIN:
            cases = [(f"step call {i}" + ("" if name == "attn_train_fwd"
                                          else ", kernel m, l"), {name: a})
                     for i, a in enumerate(recorded[name])]
            cases += [c for c in step_twin + long_cases + core_cases
                      if name in c[1]]
            for label, argd in cases:
                args = argd[name]
                ref = plain(name, args)
                got, design = counted(name, lambda: run(name, args))
                print(f"  {name} {label}: design {design}")
                if design != ("simt" if CORE in label else "wgmma"):
                    raise AssertionError(f"{name} {label}: took {design}")
                torch.cuda.synchronize()
                e, w = check_outputs(f"{name} {label}", got, ref,
                                     ATTN_TRAIN_RTOL, ATTN_TRAIN_SHARE)
                err[name], worst[name] = max(err[name], e), max(worst[name],
                                                                w)
                if not all(bool(torch.isfinite(x.float()).all())
                           for x in got.values()):
                    raise AssertionError(f"{name} {label}: non-finite")
                again = run(name, args)
                if not all(torch.equal(again[o], got[o]) for o in got):
                    raise AssertionError(f"{name} {label}: two calls with "
                                         "one seed differ")
                if label.startswith("step call 0") and "twin" not in label:
                    for fname, fk in ATTN_TRAIN_FAULTS.items():
                        fs = fault_share(run(name, args, fk), ref,
                                         ATTN_TRAIN_RTOL, ATTN_TRAIN_SHARE)
                        print(f"  {name} {label} planted fault '{fname}': "
                              f"worst share of tolerance {fs:.1f}")
                        fault[name] = min(fault[name], fs)
                del ref, got, again
        # the shared score arithmetic: rows 16 and 17 rebuild P from the
        # forward's tensor-core scores on the kernel forward's (m, l)
        for label, a in [("step call 0", recorded["attn_train_dq"][0])] + [
                (lb, argd["attn_train_dq"]) for lb, argd in long_cases
                if lb.endswith("kernel m, l")]:
            e17, e16 = psum_error(*a)
            print(f"  {label}: max |sum_c P - 1| on the kernel forward's "
                  f"(m, l): row 17 {e17:.3e}, row 16 {e16:.3e}")
        # the keep bits each kernel of each design draws, through its debug
        # output, against the twin's integers (step call 0, every
        # batch-head); the call that records them takes the per-element
        # tests everywhere, the main path's calls skip them below the
        # diagonal: both must give the same outputs bit for bit
        g, m, l, delta = recorded["attn_train_dq"][0][3:7]
        tril = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
        n_draw = int(tril.sum()) * B * h
        sets = [("", (q, k, v, g))] + [(CORE, unaligned(torch, q, k, v, g))]
        for name in ATTN_TRAIN:
            for tag, (qq, kk, vv, gg) in sets:
                (bits, res), design = counted(name, lambda: atc.keep_bits(
                    name, qq, kk, vv, h, rate, seed, gg, m, l, delta))
                if design != ("simt" if tag else "wgmma"):
                    raise AssertionError(f"{name}{tag} keep bits: took "
                                         f"{design}")
                args = ((qq, kk, vv) if name == "attn_train_fwd" else
                        (qq, kk, vv, gg, m, l, delta)) + (h, rate, seed)
                base = outs(name, getattr(atc, name)(*args))
                equal = all(torch.equal(a, base[o])
                            for a, o in zip(outs(name, res).values(), base))
                same = True
                for b0 in range(0, B * h, 32):
                    ref = atc.keep_plain(seed, torch.arange(
                        b0, min(B * h, b0 + 32), device="cuda"), T,
                        rate) & tril
                    same = same and torch.equal(bits[b0:b0 + 32], ref)
                share = float(bits.sum()) / n_draw
                print(f"  {name}{tag} ({design}) keep bits: equal to the "
                      f"twin's {same} over {n_draw} draws; keep share "
                      f"{share:.6f} (0.8 +- {KEEP_SHARE_ATOL}); outputs "
                      f"equal to a call's without the bits {equal}")
                del bits, res, base
                if not same or abs(share - (1.0 - rate)) > KEEP_SHARE_ATOL:
                    raise AssertionError(f"{name}{tag}: keep bits differ "
                                         "from the twin's or their share "
                                         "is off")
                if not equal:
                    raise AssertionError(f"{name}{tag}: the outputs of the "
                                         "call that records the keep bits "
                                         "differ from a call's without them")
        # times at the step's shape: the kernels, the twins, and one
        # PyTorch call computing the same function (other dropout bits)
        heads = [x.reshape(T, B, h, d).permute(1, 2, 0, 3).contiguous()
                 .requires_grad_(True) for x in (q, k, v)]
        gh = g.reshape(T, B, h, d).permute(1, 2, 0, 3).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(*heads, is_causal=True,
                                                  dropout_p=rate)

        lib_fwd = cuda_ms(torch, sdpa, 5)
        with torch.enable_grad():
            out = sdpa()
            lib_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
                out, heads, gh, retain_graph=True), 5)
        del out, heads
        for name in ATTN_TRAIN:
            args = recorded[name][0]
            ms = cuda_ms(torch, lambda: getattr(atc, name)(*args), 5)
            plain_ms = cuda_ms(torch, lambda: getattr(atc, name + "_plain")(
                *args), 2)
            lib = lib_fwd if name == "attn_train_fwd" else lib_bwd
            bms, bby = bound_ms(specs[name]["flops"], specs[name]["nbytes"])
            simt = (", the CUDA-core design "
                    f"{cuda_ms(torch, lambda: getattr(atc, name)(*core[name]), 5):.3f}"
                    " ms (on the views copied to a batch stride of E + 4)")
            print(f"  {name}: kernel {ms:.3f} ms (wgmma{simt}), "
                  f"plain {plain_ms:.3f} ms, "
                  f"library {lib:.3f} ms (F.scaled_dot_product_attention, "
                  f"is_causal, dropout_p {rate}, "
                  f"{'forward' if lib is lib_fwd else 'backward: dq, dk, dv together'}"
                  f"), bound {bms:.4f} ms ({bby})")
            kernels[name] = dict(
                name=name, route="cuda",
                source="bayeslms_tpu_torch/csrc/attention_train.cu",
                replaces=specs[name]["replaces"], max_abs_err=err[name],
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                library_ms=lib, design="wgmma")
        for label, argd in long_cases:
            print(f"  {label}: kernel " + ", ".join(
                f"{n} {cuda_ms(torch, lambda: getattr(atc, n)(*argd[n]), 3):.3f}"
                for n in argd) + " ms")
        bad = [f"{n}: worst share {worst[n]:.3f}" for n in ATTN_TRAIN
               if worst[n] > 1]
        bad += [f"{n}: a planted fault only {fault[n]:.1f}x" for n in
                ATTN_TRAIN if fault[n] < FAULT_MARGIN]
        if bad:
            raise AssertionError("attention_train: " + "; ".join(bad))


def ce_sums_float64(torch, args):
    """sum_t dh_t (d rounded to bf16, as rows 10 and its twin round it)
    and db_v = sum_t d_tv (fp32 d, unrounded) in float64, for one call of
    rows 10-11's arguments: p from float64 scores of the same bf16 h and
    E, the coefficients a, b of the call."""
    h, emb, bias, tgt, _, _, a, b = args
    M, D = h.shape
    e = emb.to(h.dtype).double()
    dh = torch.zeros(D, dtype=torch.float64, device=h.device)
    db = torch.zeros(e.shape[0], dtype=torch.float64, device=h.device)
    for s in range(0, M, 2048):
        p = torch.softmax(h[s:s + 2048].double() @ e.t() + bias.double(),
                          dim=-1)
        d = a[s:s + 2048, None].double() * p
        d[torch.arange(d.shape[0], device=d.device),
          tgt[s:s + 2048].long()] += b[s:s + 2048].double()
        dh += (d.to(h.dtype).double() @ e).sum(0)
        db += d.sum(0)
        del p, d
    return dh, db


def long_ce_witness(torch, args):
    """The two sums over the long step's M tokens that rows 10-11 produce,
    from the kernels and their twins against float64 (``ce_sums_float64``)
    on the step's recorded call: sum_t dh_t (the last layer's norm2.bias
    gradient, post-LN) and db. Printed, not held to a limit: it says which
    side of a kernel-twin difference lies nearer the exact sums, why the
    long step comparison keeps rows 9-11 on both sides, and why db is held
    against float64 at this M (the checks are "kernel ce_train_*")."""
    from bayeslms_tpu_torch.ops import ce_train_cuda as ctc

    with phase("ce_train long: sums over the tokens against float64"), \
            torch.no_grad():
        M = args[0].shape[0]
        kern = ctc.ce_train_dh(*args).double()
        twin = ctc.ce_train_dh_plain(*args).double()
        mag = float(twin.abs().sum(0).max())
        kern, twin = kern.sum(0), twin.sum(0)
        ref, db64 = ce_sums_float64(torch, args)
        big = float(ref.abs().max())
        print(f"  M={M}: sum_t dh_t largest entry {big:.4e} (float64), "
              f"sum_t |dh_t| {mag:.4e} ({mag / big:.0f}-fold cancellation); "
              f"max error against float64: kernel "
              f"{float((kern - ref).abs().max()):.4e}, twin "
              f"{float((twin - ref).abs().max()):.4e}; |kernel - twin| "
              f"{float((kern - twin).abs().max()):.4e} against the step "
              f"rule's {STEP_GRAD_SHARE * big:.4e}")
        rtol, share = TM_TRAIN_TOL["ce_train_de"]
        dbig = float(db64.abs().max())
        for label, fn in (("kernel", ctc.ce_train_de),
                          ("twin", ctc.ce_train_de_plain)):
            x = fn(*args)[1].double()
            print(f"  db {label}: max |x - float64| "
                  f"{float((x - db64).abs().max()):.4e} (|float64| max "
                  f"{dbig:.4e}); share of the ce_train_de tolerance against "
                  f"float64 {tol_ratio(x, db64, rtol, share * dbig):.3f}")


def tm_long_phases(torch, kernels, smi, cfg, tmpdir):
    """The recipe's Transformer trained at seq_len 1,024 through
    ``Trainer.fit``: rows 15-17 on every layer of every step (checked
    first on one step's calls), rows 9-11 once a step, row 14 in
    ``evaluate``; rows 9-11 against their twins on one step's calls at M =
    32,768; a kernel-path step against the same step on rows 15-17's
    twins. Returns the checkpoint ``fit`` wrote. Raises on any failed
    check."""
    from bayeslms_tpu_torch import TrainConfig
    from bayeslms_tpu_torch.data.corpus import Corpus, batchify
    from bayeslms_tpu_torch.ops import attention_cuda as acu
    from bayeslms_tpu_torch.ops import attention_train_cuda as atc
    from bayeslms_tpu_torch.ops import ce_train_cuda as ctc
    from bayeslms_tpu_torch.train.loop import Trainer

    tcfg_m = tm_config(cfg)
    B, T = TRAIN_BATCH, TM_LONG_SEQ
    long_tag = f" (Transformer long, M={T * B})"
    root = os.path.join(tmpdir, "long")
    os.makedirs(root)
    with phase("tm long setup"):
        write_markov_corpus(root, cfg.vocab_size - 2,
                            B * (T * TM_LONG_WINDOWS + 301),
                            EVAL_BATCH * (T + 300), EVAL_BATCH * (T + 300),
                            seed=1)
        corpus = Corpus(root)
        trainer = Trainer(tcfg_m, TrainConfig(
            lr=TM_LR, momentum=0.9, clip=1.0, batch_size=B, seq_len=T,
            eval_batch_size=EVAL_BATCH, epochs=1, log_interval=2,
            save=os.path.join(root, "tm_long.ckpt")))
        rows = batchify(corpus.train, B)
        kl_scale = T / rows.shape[0]
        data = torch.from_numpy(rows[:T].copy()).long().cuda()
        target = torch.from_numpy(rows[1:T + 1].copy()).long().cuda()
        print(f"  corpus: {len(corpus.train)} train tokens ({rows.shape[0]} "
              f"rows of {B}: {(rows.shape[0] - 1) // T} windows of {T} and a "
              f"tail of {(rows.shape[0] - 1) % T}), {len(corpus.valid)} "
              f"valid, {len(corpus.test)} test")
        state = trainer.init_state()
        recorded = {}
        gen_state = trainer.gen.get_state()
        with contextlib.ExitStack() as stack:
            for p in recording(atc, ATTN_TRAIN, recorded) \
                    + recording(ctc, CE_TRAIN, recorded):
                stack.enter_context(p)
            trainer.train_step(state, None, data, target, kl_scale)
        trainer.gen.set_state(gen_state)
        torch.cuda.synchronize()
        calls = {n: len(recorded.get(n, ())) for n in ATTN_TRAIN + CE_TRAIN}
        print(f"  one step's calls of rows 15-17 and 9-11: {calls}")
        if any(calls[n] != tcfg_m.nlayers for n in ATTN_TRAIN) \
                or any(calls[n] != 1 for n in CE_TRAIN):
            raise AssertionError(f"{calls} calls in one step, "
                                 f"{tcfg_m.nlayers} each of rows 15-17 and "
                                 "one each of rows 9-11 expected")
        del state

    attention_train_phase(torch, kernels, recorded)
    # rows 9-11 at this path's M = 32,768 tokens, in entries of their own
    # db against float64: at this M the twin's own fp32 p moves db_v by
    # more than the tolerance where sum_t d_tv cancels (v = <s>), and the
    # kernel lies within it ("ce_train long: sums over the tokens")
    long_ce_witness(torch, recorded["ce_train_dh"][0])
    check_recorded(torch, kernels, ce_train_specs(ctc, T * B, cfg.vocab_size,
                                                  tcfg_m.emsize),
                   recorded, long_tag, TM_TRAIN_TOL,
                   exact={"ce_train_de": lambda args: {
                       "db": ce_sums_float64(torch, args)[1].float()}})
    del recorded

    with phase("tm long train"):
        for module in (ctc, atc):
            for k in module.launches:
                module.launches[k] = 0
        for counts in atc.design_launches.values():
            counts.update(wgmma=0, simt=0)
        acu.launches = 0
        acu.design_launches.update(wgmma=0, simt=0)
        steps, evals = [], []

        def on_step(b, loss):
            torch.cuda.synchronize()
            steps.append((time.perf_counter(), float(loss)))

        evaluate = trainer.evaluate

        def counted_eval(model, rows):
            before = acu.launches
            out = evaluate(model, rows)
            evals.append((acu.launches - before,
                          -(-(rows.shape[0] - 1) // T)))
            return out

        trainer.evaluate = counted_eval
        t0 = time.perf_counter()
        _, out = trainer.fit(corpus, log=lambda line: print("  " + line),
                             on_step=on_step)
        fit_s = time.perf_counter() - t0
        trainer.evaluate = evaluate
        n = len(steps)
        launches = {**ctc.launches, **atc.launches,
                    "attention_fwd (evaluate)": acu.launches}
        print(f"  kernel launches in fit ({n} steps, {len(evals)} "
              f"evaluations): {launches}; row 14 launches and windows per "
              f"evaluation: {evals}")
        losses = [l for _, l in steps]
        print("  loss per step (the last the padded tail): "
              + " ".join(f"{l:.4f}" for l in losses))
        print(f"  validation loss {out['history'][0]['val_loss']:.4f}; test "
              f"loss {out['test_loss']:.4f}")
        dts = np.diff([t for t, _ in steps])[1:-1]
        step_ms = 1e3 * float(np.median(dts))
        print(f"  step median {step_ms:.3f} ms over {len(dts)} warm full "
              f"windows, {T * B / step_ms * 1e3:.1f} tokens/s; fit "
              f"{fit_s:.1f} s on {smi}")
        for name in CE_TRAIN:
            kernels[name + long_tag]["launches"] = launches[name]
            if launches[name] != n:
                raise AssertionError(f"{name}: {launches[name]} launches in "
                                     f"{n} steps, 1 a step expected")
        kernels["attention_fwd"]["launches"] += acu.launches
        print(f"  rows 15-17 launches by design: {atc.design_launches}; row "
              f"14 (evaluate): {acu.design_launches}")
        if acu.design_launches["wgmma"] != acu.launches:
            raise AssertionError("evaluate: not every row 14 launch took the "
                                 "wgmma kernel")
        for name in ATTN_TRAIN:
            kernels[name]["launches"] = launches[name]
            if launches[name] != tcfg_m.nlayers * n:
                raise AssertionError(f"{name}: {launches[name]} launches in "
                                     f"{n} steps, {tcfg_m.nlayers} a step "
                                     "expected")
            if atc.design_launches[name]["wgmma"] != launches[name]:
                raise AssertionError(f"{name}: not every launch took the "
                                     "wgmma kernel")
        if not evals or any(a != tcfg_m.nlayers * w for a, w in evals):
            raise AssertionError(f"evaluate did not launch attention_fwd "
                                 f"once a layer and window: {evals}")
        full = losses[:-1]
        if not all(np.isfinite(losses)) or not np.isfinite(out["test_loss"]):
            raise AssertionError("a training loss is not finite")
        if np.mean(full[-2:]) >= full[0]:
            raise AssertionError(f"the loss did not fall: first window "
                                 f"{full[0]:.4f}, last two "
                                 f"{np.mean(full[-2:]):.4f}")

    with phase("tm long step against plain versions"):
        # Rows 9-11 stay on both sides: with their twins too, one gradient
        # breaks the step rule at M = 32,768, the last layer's norm2.bias,
        # sum_t dh_t, which cancels ~2,300-fold over the tokens' bf16 dh,
        # and there the twin lies farther from float64 than the kernel
        # (phase "ce_train long: sums over the tokens against float64";
        # PERF.md).
        # The CE kernels are held to their twins elementwise at this M in
        # "kernel ce_train_* (Transformer long, M=32768)".
        print("  plain: the twins of rows 15-17 (the attention dropout "
              "rebuilt from the same seed); rows 9-11 on both sides; every "
              "other dropout mask injected")
        before = dict(atc.launches)
        compare_steps(
            torch, trainer, data, target, kl_scale,
            tm_dropout_masks(torch, tcfg_m, T, B, 3, attn=False),
            [mock.patch.object(atc, "flash_attention_train",
                               atc.flash_attention_train_plain)],
            loss_rtol=STEP_LOSS_RTOL)
        got = {n: atc.launches[n] - before[n] for n in ATTN_TRAIN}
        print(f"  rows 15-17 launches in the kernel-path step: {got}")
        if any(c != tcfg_m.nlayers for c in got.values()):
            raise AssertionError("the kernel-path step did not run rows "
                                 "15-17 once a layer")
    return trainer.tcfg.save


def xl_attention_check(torch, kernels, calls):
    """Row 14 against its twin on every call one XL pass made (memory
    builds at B = 1 and bucketed lengths, chains' first utterances at (T,
    N)), at row 14's own tolerance, every call on the wgmma design, and its
    planted-fault build on each; the CUDA-core kernel and its fault on
    copies of one call of each (T, B) shape at a batch stride TMA cannot
    describe; folds the error into the ``attention_fwd`` entry. Raises on a
    failed check."""
    from bayeslms_tpu_torch.ops import _build
    from bayeslms_tpu_torch.ops import attention_cuda as acu

    real_load = _build.load
    with phase("kernel attention_fwd (XL calls)"), torch.no_grad():
        err, worst, fault = 0.0, 0.0, float("inf")
        shapes, designs = {}, {"wgmma": 0, "simt": 0}
        for q, k, v, h in calls:
            key = tuple(q.shape[:2])
            cases = [("wgmma", (q, k, v, h))]
            if key not in shapes:
                cases.append(("simt", (*unaligned(torch, q, k, v), h)))
            shapes[key] = shapes.get(key, 0) + 1
            ref = {"o": acu.causal_attention_plain(q, k, v, h)}
            big = float(ref["o"].float().abs().max())
            for want, args in cases:
                got, design = row14_design(
                    acu, lambda: {"o": acu.causal_attention(*args)})
                if design != want:
                    raise AssertionError(f"attention_fwd (XL) {key}: took "
                                         f"{design}, {want} expected")
                designs[design] += 1
                with mock.patch.object(_build, "load",
                                       lambda kk: real_load(ATTN_FAULT)):
                    bad = {"o": acu.causal_attention(*args)}
                err = max(err, max_err(got["o"], ref["o"]))
                worst = max(worst, tol_ratio(got["o"], ref["o"], ATTN_RTOL,
                                             ATTN_SHARE * big + 1e-30))
                fault = min(fault, fault_share(bad, ref, ATTN_RTOL,
                                               ATTN_SHARE))
                if not all(bool(torch.isfinite(x).all())
                           for x in (got["o"], bad["o"])):
                    raise AssertionError("attention_fwd (XL): a non-finite "
                                         "value")
        print(f"  {len(calls)} calls of one pass at {len(shapes)} (T, B) "
              f"shapes (B = 1: memory builds), the most frequent "
              f"{sorted(shapes.items(), key=lambda x: -x[1])[:6]}; "
              f"checked by design {designs} (the CUDA-core kernel on copies "
              f"of one call a shape); tolerance {ATTN_RTOL:.3e} |plain| + "
              f"{ATTN_SHARE:.3e} max|plain|: max |kernel - plain| {err:.3e}, "
              f"worst share of tolerance {worst:.3f}; planted fault "
              f"'diagonal masked': worst share {fault:.1f} at its least")
        e = kernels["attention_fwd"]
        e["max_abs_err"] = max(e["max_abs_err"], err)
        if worst > 1:
            raise AssertionError(f"attention_fwd disagrees with its plain "
                                 f"version on the XL calls: {worst:.3f}")
        if fault < FAULT_MARGIN:
            raise AssertionError(f"attention_fwd (XL): the planted fault "
                                 f"exceeds the tolerance only {fault:.1f}x")


def tm_xl_phase(torch, kernels, smi, cfg, rcfg, ckpt):
    """Transformer-XL scoring of the bench's 6,000-hypothesis N-best, the
    recording prefix as the chain, from the long-context checkpoint: row
    14 against its twin on every call of one pass; the pass against the
    plain path with row 2's twin (TM_SCORE_ATOL) and with the twins of
    rows 2 and 14 (XL_SCORE_RTOL), which row 14's planted fault must fail;
    an on-card check that logits with memories equal the suffix of a
    full-context forward."""
    import dataclasses

    from bayeslms_tpu_torch import build_model
    from bayeslms_tpu_torch.core.checkpoint import (load_checkpoint,
                                                    params_from_jax)
    from bayeslms_tpu_torch.ops import _build
    from bayeslms_tpu_torch.ops import attention_cuda as acu
    from bayeslms_tpu_torch.ops import ce_cuda
    from bayeslms_tpu_torch.rescore import layouts
    from bayeslms_tpu_torch.rescore.scorer import BatchScorer

    tcfg_m = tm_config(cfg)
    params, _ = load_checkpoint(ckpt)
    with phase("tm xl setup"):
        scorer = BatchScorer(tcfg_m, params,
                             dataclasses.replace(rcfg, xl_mems=True))
        if layouts.select(scorer).name != "xl":
            raise AssertionError("xl_mems did not select the xl layout")
        nbest = make_synthetic_nbest(n_meetings=30)
        w2i = {"<s>": 0, "<unk>": 1,
               **{f"w{i}": 2 + i for i in range(cfg.vocab_size - 2)}}
        # the warm pass records every call of row 14
        calls = []
        real = acu.causal_attention

        def record(*a):
            calls.append(a)
            return real(*a)

        with mock.patch.object(acu, "causal_attention", record):
            scorer.score_nbest(nbest, w2i, stream_fn=stream_of)
        torch.cuda.synchronize()

    xl_attention_check(torch, kernels, calls)
    del calls

    with phase("tm xl score"):
        ce_cuda.launches = 0
        ce_cuda.design_launches.update(split=0, wmma=0)
        acu.launches = 0
        acu.design_launches.update(wgmma=0, simt=0)
        pass_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = scorer.score_nbest(nbest, w2i, stream_fn=stream_of)
            torch.cuda.synchronize()
            pass_s.append(time.perf_counter() - t0)
        n_utts = len(nbest)
        n_chains = len({stream_of(k) for k in nbest})
        print(f"  kernel launches in 3 passes: ce_fwd {ce_cuda.launches} "
              f"(one an utterance), attention_fwd {acu.launches} (a layer "
              f"each: {n_chains} chains' first utterances and "
              f"{n_utts - n_chains} memory builds a pass; the scores with "
              "memories take the plain masked attention, as in JAX)")
        print(f"  row 14 launches by design: {acu.design_launches}; row 2 "
              f"by route: {ce_cuda.design_launches}")
        if ce_cuda.launches != 3 * n_utts \
                or ce_cuda.design_launches["split"] != ce_cuda.launches \
                or acu.launches != 3 * tcfg_m.nlayers * n_utts \
                or acu.design_launches["wgmma"] != acu.launches:
            raise AssertionError("XL scoring did not launch rows 2 and 14 "
                                 "as expected (row 2 split, row 14 on "
                                 "wgmma)")
        kernels["ce_fwd (Transformer, D=512)"]["launches"] += ce_cuda.launches
        kernels["attention_fwd"]["launches"] += acu.launches
        got = np.array([s for pairs in res.values() for _, s in pairs])
        n_hyps = sum(len(h) for h in nbest.values())
        n_tokens = sum(len(h.split()) + 1 for hyps in nbest.values()
                       for h in hyps)
        med = float(np.median(pass_s))
        print(f"  passes {['%.4f' % s for s in pass_s]} s; median "
              f"{n_hyps / med:.1f} hyps/s, {n_tokens / med:.1f} tokens/s "
              f"({n_hyps} hyps, {n_utts} utterances in {n_chains} chains) "
              f"on {smi}")
        def plain_scores(attention):
            with mock.patch.object(ce_cuda, "fused_decode_ce",
                                   ce_cuda.ce_plain), \
                    mock.patch.object(acu, "causal_attention", attention):
                return np.array([s for pairs in scorer.score_nbest(
                    nbest, w2i, stream_fn=stream_of).values()
                    for _, s in pairs])

        ref = plain_scores(acu.causal_attention)
        diff = float(np.abs(got - ref).max())
        print(f"  {n_hyps} scores, |plain| mean {np.abs(ref).mean():.3f} max "
              f"{np.abs(ref).max():.3f}; against row 2's twin (row 14 on "
              f"both sides): max |kernel - plain| {diff:.4e} (tolerance "
              f"{TM_SCORE_ATOL:.0e})")
        ref2 = plain_scores(acu.causal_attention_plain)
        rel = float((np.abs(got - ref2) / np.abs(ref2)).max())
        print(f"  against the twins of rows 2 and 14: max |kernel - plain| "
              f"{float(np.abs(got - ref2).max()):.4e}, relative {rel:.3e} "
              f"(tolerance {XL_SCORE_RTOL:.3e})")
        # row 14's planted-fault build (diagonal masked) through the same
        # comparison: it must fail it
        real_load = _build.load
        with mock.patch.object(_build, "load", lambda kk: real_load(
                ATTN_FAULT if kk == ATTN_FAULT[0] else kk)):
            bad = np.array([s for pairs in scorer.score_nbest(
                nbest, w2i, stream_fn=stream_of).values() for _, s in pairs])
        rel_bad = float(np.nan_to_num(np.abs(bad - ref2) / np.abs(ref2),
                                      nan=np.inf).max())
        print(f"  row 14 planted fault 'diagonal masked' through the pass: "
              f"relative {rel_bad:.3e} ({rel_bad / XL_SCORE_RTOL:.1f}x the "
              "tolerance)")
        if got.shape != (n_hyps,) or not np.all(np.isfinite(got)) \
                or diff > TM_SCORE_ATOL or rel > XL_SCORE_RTOL:
            raise AssertionError("XL scoring failed")
        if rel_bad <= XL_SCORE_RTOL:
            raise AssertionError("row 14's planted fault passes the XL score "
                                 "tolerance")
        del scorer

    with phase("tm xl suffix"), torch.no_grad():
        cfg32 = dataclasses.replace(tcfg_m, compute_dtype="float32")
        model = params_from_jax(build_model(cfg32), params).cuda()
        gen = torch.Generator(device="cuda").manual_seed(13)
        tokens = torch.randint(2, cfg.vocab_size, (96, 4), generator=gen,
                               device="cuda")
        simt = acu.design_launches["simt"]
        full = model(tokens)
        if acu.design_launches["simt"] != simt + tcfg_m.nlayers:
            raise AssertionError("the float32 full-context forward did not "
                                 "take row 14's CUDA-core kernel once a layer")
        _, mems = model(tokens[:40], return_mems=True)
        pad = [torch.cat([m, torch.zeros_like(m[:24])]) for m in mems]
        worst = 0.0
        for label, kw in (("exact", dict(mems=mems)),
                          ("right-padded to 64", dict(mems=pad, mem_len=40))):
            got = model(tokens[40:], **kw)
            e = float((got - full[40:]).abs().max())
            worst = max(worst, tol_ratio(got, full[40:], XL_RTOL, XL_ATOL))
            print(f"  memories of 40 tokens ({label}), 56 more, 4 columns, "
                  f"float32: |full| max {float(full.abs().max()):.3f}, max "
                  f"|with mems - full suffix| {e:.3e}")
        print(f"  worst share of tolerance ({XL_ATOL:.0e} + {XL_RTOL:.0e} "
              f"|full|) {worst:.3f}")
        if worst > 1:
            raise AssertionError("logits with memories differ from the "
                                 "full-context suffix")


# ---------------------------------------------------------------- GP-LSTM
# The recipe's GP-LSTM (recipes/run_nnlm_ami_lstm.sh:22-24,44-47:
# --uncertainty Gaussian --L_gauss_pos 13: a GP cell replacing the input
# gate, GPNN type 3, then a standard layer; GP sampling off as the
# reference ships) at the bench's width on the training phases' corpus.
# Rows 20-21 carry the GP cell's training and evaluation, rows 5-6 the
# standard layer's training, row 4 its evaluation and row 3 its packed-carry
# scoring (where the GP cell runs the JAX scan, as JAX does under resets).
GP_POS = "13"
GP_SHORT_T = 10  # gates 2-4 are checked at this T on the step's tensors
GP_TOL = {"gpg_fwd": TRAIN_TOL["lstm_train_fwd"],
          "gpg_bwd": TRAIN_TOL["lstm_train_bwd"],
          # rows 18-19: rows 5-6's recurrence with a mixture epilogue
          "gp6_fwd": TRAIN_TOL["lstm_train_fwd"],
          "gp6_bwd": TRAIN_TOL["lstm_train_bwd"],
          # rows 3-4: bf16 outputs of a T-step recurrence, as row 5's
          "lstm_fwd": TRAIN_TOL["lstm_train_fwd"],
          "lstm_fwd_reset": TRAIN_TOL["lstm_train_fwd"]}
# Planted faults of row 21 that no input can make, built from
# csrc/gp_lstm.cu with a define (see its header): the first two act on both
# designs, the third only on the persistent one (its recurrence reads the
# hoisted product P of step 0 at every step: the step's offset dropped).
# The third is tried on calls from a carried state: from a zero state P[0]
# is zero, and at the step's random init the product on h_{t-1} moves the
# gradients by less than FAULT_MARGIN tolerances (PERF.md).
P_STEP0 = "P of step 0 at every step"
GP_FAULTS = {
    "replaced gate's slice of du5 not zeroed":
        ("gp_lstm", ("-DGP_LSTM_FAULT=1",)),
    "dcoef dropped": ("gp_lstm", ("-DGP_LSTM_FAULT=2",)),
    P_STEP0: ("gp_lstm", ("-DGP_LSTM_FAULT=3",)),
}
GP_TWO_LAUNCH_FAULTS = ("replaced gate's slice of du5 not zeroed",
                        "dcoef dropped")
# The planted fault of rows 20 and 18 that only their persistent forwards
# can get wrong, built from csrc/gp_lstm.cu and csrc/gp6_lstm.cu with a
# define: every step's product reads h0 in place of ys[t-1]. Tried on the
# calls from a carried state, where a zero h0 cannot hide it.
H0_ALWAYS = "the product on h0 at every step"
GP_FWD_FAULT = ("gp_lstm", ("-DGP_LSTM_FAULT=4",))
GP6_FWD_FAULT = ("gp6_lstm", ("-DGP6_FAULT=4",))
# GP scores (kernel path against plain path, from the fit's checkpoint):
# the random-init tolerance plus the trained model's relative one.
GP_SCORE_ATOL, GP_SCORE_RTOL = SCORE_ATOL, TRAINED_SCORE_RTOL


def with_arg(args, i, value):
    a = list(args)
    a[i] = value
    return a


def check_kernel_calls(torch, kernels, name, spec, calls):
    """``name`` (spec: module, wrapper (default ``name``), plain, outs,
    source, replaces, faults, flops(args), nbytes(args), library: a
    factory that makes the library call on the args, or the reason there
    is none; optionally slack(args, ref): elementwise allowances added to
    the tolerance of some outputs) against its twin on every call of
    ``calls`` within GP_TOL, each planted fault on the calls it applies to
    (an input fault returns None where it does not; a build fault given as
    {"build": variant, "when": predicate of the args} is tried where the
    predicate holds) by FAULT_MARGIN or
    more; times it on the first call and adds it to ``kernels``. Raises on
    any failed check."""
    from bayeslms_tpu_torch.ops import _build

    real_load = _build.load
    module = spec["module"]
    rtol, share = GP_TOL[name]
    with phase(f"kernel {name}"), torch.no_grad():
        kernel = getattr(module, spec.get("wrapper", name))
        print(f"  tolerance |kernel - plain| <= {rtol:.3e} |plain| + "
              f"{share:.3e} max|plain|, elementwise; {len(calls)} call(s)")
        err, worst = 0.0, 0.0
        faults = {f: float("inf") for f in spec["faults"]}
        for tag, args in calls:
            print(f"  call {tag}: first operand {tuple(args[0].shape)} "
                  f"{args[0].dtype}")
            ref = dict(zip(spec["outs"], spec["plain"](*args)))
            got = dict(zip(spec["outs"], kernel(*args)))
            torch.cuda.synchronize()
            slack = spec.get("slack", lambda a, r: None)(args, ref)
            e, q = check_outputs(name, got, ref, rtol, share, slack)
            err, worst = max(err, e), max(worst, q)
            for fault, how in spec["faults"].items():
                if isinstance(how, dict):  # a build that shows on some calls
                    if not how["when"](args):
                        continue
                    how = how["build"]
                if callable(how):
                    bad_args = how(args)
                    if bad_args is None:
                        continue
                    bad = kernel(*bad_args)
                else:
                    with mock.patch.object(_build, "load",
                                           lambda k, v=how: real_load(v)):
                        bad = kernel(*args)
                faults[fault] = min(faults[fault], fault_share(
                    dict(zip(spec["outs"], bad)), ref, rtol, share, slack))
            del ref, got, slack
        for fault, q in faults.items():
            print(f"  planted fault '{fault}': worst share of tolerance "
                  f"{q:.1f}")
        args = calls[0][1]
        ms = cuda_ms(torch, lambda: kernel(*args), 5)
        plain_ms = cuda_ms(torch, lambda: spec["plain"](*args), 3)
        library = spec["library"]
        library_ms = None if isinstance(library, str) \
            else cuda_ms(torch, library(args), 5)
        bms, bby = bound_ms(spec["flops"](args), spec["nbytes"](args))
        lib = library if isinstance(library, str) else f"{library_ms:.3f} ms"
        print(f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bms:.3f} ms ({bby}) at {calls[0][0]}; library: {lib}")
        kernels[name] = dict(
            name=name, route="cuda",
            source=f"bayeslms_tpu_torch/csrc/{spec['source']}",
            replaces=spec["replaces"], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
            library_ms=library_ms)
        failed = []
        if worst > 1:
            failed.append(f"{name} disagrees with its plain version: worst "
                          f"share {worst:.3f}")
        failed += [f"{name}: planted fault '{f}' exceeds the tolerance only "
                   f"{q:.1f}x" for f, q in faults.items()
                   if not q >= FAULT_MARGIN]
        if failed:
            raise AssertionError("; ".join(failed))


def per_step_design_check(torch, kernels, name, spec, calls, run, counts,
                          faults, design="per_step", main="persistent"):
    """``name``'s older design ``design`` ("per_step"; "two_launch" for rows
    19 and 21), ``run`` its wrapper forced onto that design, which the rule
    keeps for the calls its ``main`` design ("persistent"; "streamed" for
    row 3) does not take, on ``calls`` (the main design's, checked just
    before) against the twin within
    GP_TOL[name] (with the spec's slack where it has one), and the planted
    faults ``faults`` (a name, or a tuple of names, of ``spec["faults"]``:
    an input fault or a build) on the first call by FAULT_MARGIN or more;
    every run counted in ``counts`` (calls by design) as ``design``; timed on
    the first call, the time added to ``kernels[name]`` as ``<design>_ms``
    beside the main design's ``ms``. Raises on a failed check."""
    from bayeslms_tpu_torch.ops import _build

    real_load = _build.load
    label = design.replace("_", "-")
    faults = (faults,) if isinstance(faults, str) else faults
    with phase(f"kernel {name} ({label} design)"), torch.no_grad():
        rtol, share = GP_TOL[name]
        outs = spec["outs"]
        slack_of = spec.get("slack", lambda a, r: None)
        err, worst = 0.0, 0.0
        for tag, args in calls:
            before = counts[design]
            got = dict(zip(outs, run(*args)))
            ref = dict(zip(outs, spec["plain"](*args)))
            torch.cuda.synchronize()
            if counts[design] != before + 1:
                raise AssertionError(f"the call did not take the {label} "
                                     f"design: {counts}")
            print(f"  call {tag}:")
            e, q = check_outputs(f"{name} ({label})", got, ref, rtol, share,
                                 slack_of(args, ref))
            err, worst = max(err, e), max(worst, q)
            del got, ref
        args = calls[0][1]
        ref = dict(zip(outs, spec["plain"](*args)))
        slack = slack_of(args, ref)
        shares = {}
        for fault in faults:
            how = spec["faults"][fault]
            if callable(how):
                bad = run(*how(args))
            else:
                with mock.patch.object(_build, "load",
                                       lambda k, v=how: real_load(v)):
                    bad = run(*args)
            shares[fault] = fault_share(dict(zip(outs, bad)), ref, rtol,
                                        share, slack)
            print(f"  planted fault '{fault}': worst share of tolerance "
                  f"{shares[fault]:.1f}")
        ms = cuda_ms(torch, lambda: run(*args), 5)
        print(f"  {label} {ms:.3f} ms (the {main} design "
              f"{kernels[name]['ms']:.3f} ms on the same call)")
        kernels[name].update({"design": main, f"{design}_ms": ms,
                              f"{design}_max_abs_err": err})
        if worst > 1:
            raise AssertionError(f"the {label} design disagrees with its "
                                 f"plain version: worst share {worst:.3f}")
        low = {f: q for f, q in shares.items() if not q >= FAULT_MARGIN}
        if low:
            raise AssertionError(f"the {label} design's planted faults exceed "
                                 f"the tolerance only {low}")


def persistent_only(counts, before, row, design="persistent"):
    """Raises unless the calls since ``before`` (calls by design) all took
    ``design`` (the persistent one unless named)."""
    if any(counts[k] != before[k] for k in counts if k != design) \
            or counts == before:
        raise AssertionError(f"{row}'s checks took {counts} (before: "
                             f"{before}): the {design} design alone "
                             f"expected")


def gp_fit(torch, kernels, trainer, corpus, smi, kl_scale, tag, cell_rows,
           counted):
    """One epoch of ``trainer.fit`` for a GP-LSTM whose GP cell takes the
    kernels ``cell_rows`` (forward, backward) and whose standard layer takes
    rows 5-6 (row 4 in ``evaluate``): the loss finite and falling, the KL
    term finite and > 0, every training kernel once a step, the cell's
    forward and row 4 once an ``evaluate`` window, row 4 and the cell's
    forward and backward on their persistent designs every time. Sets the
    launches of the kernels ``counted``.
    Raises on any failed check."""
    from bayeslms_tpu_torch.ops import ce_train_cuda as ctc
    from bayeslms_tpu_torch.ops import gp_lstm_cuda as gpc
    from bayeslms_tpu_torch.ops import lstm_cuda as lc
    from bayeslms_tpu_torch.ops import lstm_train_cuda as ltc

    fwd, bwd = cell_rows
    T, B = trainer.tcfg.seq_len, trainer.tcfg.batch_size
    with phase(f"{tag} train"):
        for module in (ltc, ctc, gpc):
            for k in module.launches:
                module.launches[k] = 0
        for k in lc.layer_launches:
            lc.layer_launches[k] = 0
        lc.layer_design_launches.update(persistent=0, streamed=0, per_step=0)
        gpc.design_launches[bwd].update(persistent=0, two_launch=0)
        gpc.design_launches[fwd].update(persistent=0, per_step=0)
        steps, kls = [], []
        step = trainer.train_step

        def counted_step(*a, **kw):
            out = step(*a, **kw)
            kls.append(out[3])
            return out

        def on_step(b, loss):
            torch.cuda.synchronize()
            steps.append((time.perf_counter(), float(loss)))

        trainer.train_step = counted_step
        t0 = time.perf_counter()
        state, out = trainer.fit(corpus, log=lambda line: print("  " + line),
                                 on_step=on_step)
        fit_s = time.perf_counter() - t0
        trainer.train_step = step
        n = len(steps)
        launches = {**ltc.launches, **ctc.launches, **gpc.launches,
                    **lc.layer_launches}
        print(f"  kernel launches in fit ({n} steps and the evaluations): "
              f"{launches}")
        losses = [l for _, l in steps]
        kl = [float(k) for k in kls]
        print("  loss per step: " + " ".join(f"{l:.4f}" for l in losses))
        print(f"  KL term (KL x seq_len / rows = x {kl_scale:.5f}) per step: "
              + " ".join(f"{k:.6f}" for k in kl))
        print(f"  validation loss {out['history'][0]['val_loss']:.4f}; test "
              f"loss {out['test_loss']:.4f}")
        dts = np.diff([t for t, _ in steps])[2:]
        step_ms = 1e3 * float(np.median(dts))
        print(f"  step median {step_ms:.3f} ms over {len(dts)} warm steps, "
              f"{T * B / step_ms * 1e3:.1f} tokens/s; fit {fit_s:.1f} s on "
              f"{smi}")
        for name in ("lstm_train_fwd", "lstm_train_bwd", bwd, *CE_TRAIN):
            if launches[name] != n:
                raise AssertionError(f"{name}: {launches[name]} launches in "
                                     f"{n} steps, 1 a step expected")
        n_eval = launches[fwd] - n
        print(f"  evaluate: {fwd} {n_eval}, lstm_fwd {launches['lstm_fwd']} "
              f"launches; row 4 by design {lc.layer_design_launches}")
        if n_eval <= 0 or launches["lstm_fwd"] != n_eval:
            raise AssertionError(f"evaluate did not take {fwd} and row 4 on "
                                 "every window")
        if lc.layer_design_launches != {"persistent": n_eval, "streamed": 0,
                                        "per_step": 0}:
            raise AssertionError(f"row 4 left its persistent design in "
                                 f"evaluate: {lc.layer_design_launches}")
        print(f"  {fwd} by design: {gpc.design_launches[fwd]}; {bwd} by "
              f"design: {gpc.design_launches[bwd]}")
        if gpc.design_launches[fwd] != {"persistent": launches[fwd],
                                        "per_step": 0}:
            raise AssertionError(f"{fwd} left its persistent design in fit: "
                                 f"{gpc.design_launches[fwd]}")
        if gpc.design_launches[bwd] != {"persistent": n, "two_launch": 0}:
            raise AssertionError(f"{bwd} left its persistent design in fit: "
                                 f"{gpc.design_launches[bwd]}")
        for name in counted:
            kernels[name]["launches"] = launches[name]
        if not all(np.isfinite(losses)) or not np.isfinite(out["test_loss"]):
            raise AssertionError("a training loss is not finite")
        if not all(np.isfinite(k) and k > 0 for k in kl):
            raise AssertionError(f"the KL term is not finite and > 0: {kl}")
        if np.mean(losses[-5:]) >= np.mean(losses[:5]):
            raise AssertionError(
                f"the loss did not fall: first 5 {np.mean(losses[:5]):.4f}, "
                f"last 5 {np.mean(losses[-5:]):.4f}")


def gp_score(torch, scorer, nbest, w2i, smi, tag):
    """A timed packed-carry pass of a GP-LSTM (its GP cell on the scan
    under the resets, as in JAX; its standard layer on row 3's streamed
    design, one launch a call; the CE on row 2) against the plain path
    within GP_SCORE_ATOL + GP_SCORE_RTOL |plain|. Returns row 3's launches
    in the pass. Raises on any failed check."""
    from bayeslms_tpu_torch.ops import ce_cuda
    from bayeslms_tpu_torch.ops import lstm_cuda as lc

    with phase(f"{tag} score"):
        lc.layer_launches["lstm_fwd_reset"] = 0
        lc.layer_design_launches.update(persistent=0, streamed=0, per_step=0)
        ce_cuda.launches = 0
        t0 = time.perf_counter()
        res = scorer.score_nbest(nbest, w2i, stream_fn=stream_of)
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t0
        n_row3, n_row2 = lc.layer_launches["lstm_fwd_reset"], ce_cuda.launches
        print(f"  kernel launches in a pass: lstm_fwd_reset {n_row3}, ce_fwd "
              f"{n_row2}; the GP cell runs the scan under resets, as in JAX")
        if n_row3 == 0 or n_row2 == 0:
            raise AssertionError("GP scoring did not run rows 3 and 2")
        print(f"  row 3 by design: {lc.layer_design_launches}")
        if lc.layer_design_launches != {"persistent": 0, "streamed": n_row3,
                                        "per_step": 0}:
            raise AssertionError(f"row 3 (resets) left the streamed design: "
                                 f"{lc.layer_design_launches}")
        got = np.array([s for pairs in res.values() for _, s in pairs])
        with mock.patch.object(lc, "lstm_fwd", lc.lstm_fwd_plain), \
                mock.patch.object(ce_cuda, "fused_decode_ce", ce_cuda.ce_plain):
            ref = np.array([s for pairs in scorer.score_nbest(
                nbest, w2i, stream_fn=stream_of).values() for _, s in pairs])
        n_hyps = sum(len(h) for h in nbest.values())
        diff = np.abs(got - ref)
        share = float((diff / (GP_SCORE_ATOL + GP_SCORE_RTOL
                               * np.abs(ref))).max())
        print(f"  {n_hyps} hypotheses in {pass_s:.3f} s ({n_hyps / pass_s:.1f}"
              f" hyps/s) on {smi}; scores mean {got.mean():.3f}, max "
              f"{np.abs(ref).max():.3f}; max |kernel - plain| "
              f"{float(diff.max()):.4e}, relative "
              f"{float((diff / np.abs(ref)).max()):.3e}; worst share of "
              f"{GP_SCORE_ATOL:.0e} + {GP_SCORE_RTOL:.0e} |plain|: "
              f"{share:.3f}")
        if got.shape != (n_hyps,) or not np.all(np.isfinite(got)) \
                or share > 1:
            raise AssertionError("GP scoring failed")
    return n_row3


def lstm_fwd_specs(torch, lc):
    """Check specs of rows 3 (resets) and 4: twin, outputs, planted faults
    made by changing the inputs, operations and bytes, the library call."""
    def cost(args):
        xg = args[0]
        T, B, G = xg.shape
        H = G // 4
        flops = 2 * T * B * H * G
        # xg, W_hh, b_hh, h0 and c0, ys, hT and cT; the mask and the resets
        # as the kernel reads them: bytes, and int32 sources
        nbytes = (T * B * G * 2 + G * H * 2 + G * 4 + 4 * B * H * 2
                  + T * B * H * 2 + sum(T * B for a in args[5:7]
                                        if a is not None)
                  + (0 if args[7] is None else B * 4))
        return flops, nbytes

    def cudnn(args):
        # yardstick only: torch.nn.LSTM forward (cuDNN), one layer, bf16,
        # on an input of x's width (it computes x W_ih^T too)
        T, B, G = args[0].shape
        lstm = torch.nn.LSTM(G // 4, G // 4, device="cuda",
                             dtype=torch.bfloat16)
        x = torch.randn((T, B, G // 4), device="cuda", dtype=torch.bfloat16)
        return lambda: lstm(x)

    faults = {
        "W_hh product dropped":
            lambda a: with_arg(a, 1, torch.zeros_like(a[1])),
        "step mask ignored": lambda a: None if a[5] is None else with_arg(
            a, 5, torch.ones_like(a[5])),
    }
    reset_faults = {
        **faults,
        # the same fault on the calls from a carried state alone: its share
        # there, where a zero h0 cannot hide the product
        "W_hh product dropped, from a carried state":
            lambda a: with_arg(a, 1, torch.zeros_like(a[1]))
            if bool(a[3].any()) else None,
        "resets ignored": lambda a: with_arg(a, 6, torch.zeros_like(a[6])),
        # a kernel that gathered column 0 for a -1 source
        "-1 source not zeroed": lambda a: None if not bool(
            (a[7] < 0).any()) else with_arg(a, 7, a[7].clamp(min=0)),
    }
    base = dict(module=lc, wrapper="lstm_fwd", plain=lc.lstm_fwd_plain,
                outs=("ys", "hT", "cT"),
                source="lstm_fwd.cu",
                flops=lambda a: cost(a)[0], nbytes=lambda a: cost(a)[1])
    return {
        "lstm_fwd_reset": dict(
            base, replaces="bayeslms_tpu/ops/lstm_pallas.py:186",
            faults=reset_faults,
            library="none: no single PyTorch call computes an LSTM whose "
                    "columns take another column's state mid-sequence"),
        "lstm_fwd": dict(
            base, replaces="bayeslms_tpu/ops/lstm_pallas.py:228",
            faults=faults, library=cudnn),
    }


def gpg_specs(torch, gpc):
    """Check specs of rows 20-21."""
    def sizes(args):
        xg = args[0]
        T, B, G = xg.shape
        H = G // 4
        rest = sum(a.numel() * a.element_size() for a in args[1:]
                   if isinstance(a, torch.Tensor))
        return T, B, H, T * B * G * 2 + rest

    def fwd_cost(args):
        T, B, H, n_in = sizes(args)
        return 2 * T * B * H * 5 * H, n_in + 2 * T * B * H * 2 + 2 * B * H * 2

    def bwd_cost(args):
        T, B, H, n_in = sizes(args)
        k = args[4].shape[0]
        return (4 * T * B * H * 5 * H,
                n_in + T * B * 5 * H * 2 + k * H * 4 + 2 * B * H * 2)

    none = ("none: no single PyTorch call computes an LSTM with a gate "
            "replaced by a GP unit")
    return {
        "gpg_fwd": dict(
            module=gpc, plain=gpc.gpg_fwd_plain, outs=("ys", "cs", "hT", "cT"),
            source="gp_lstm.cu",
            replaces="bayeslms_tpu/ops/gp_lstm_pallas.py:510",
            faults={"gpx dropped":
                    lambda a: with_arg(a, 1, torch.zeros_like(a[1])),
                    H0_ALWAYS: {"build": GP_FWD_FAULT,
                                "when": lambda a: bool(a[6].any())}},
            flops=lambda a: fwd_cost(a)[0], nbytes=lambda a: fwd_cost(a)[1],
            library=none),
        "gpg_bwd": dict(
            module=gpc, plain=gpc.gpg_bwd_plain,
            outs=("du5", "dcoef", "dh0", "dc0"), source="gp_lstm.cu",
            replaces="bayeslms_tpu/ops/gp_lstm_pallas.py:552",
            faults={**GP_FAULTS, P_STEP0: {"build": GP_FAULTS[P_STEP0],
                                           "when": lambda a: bool(
                                               a[6].any())}},
            flops=lambda a: bwd_cost(a)[0], nbytes=lambda a: bwd_cost(a)[1],
            library=none),
    }


def carried_state(torch, fwd_args, i_h0, seed):
    """``fwd_args`` with h0 and c0 (at ``i_h0`` and ``i_h0 + 1``) drawn
    uniform in +-0.5: a later window's start from a carried state, where a
    step's first window starts from zeros."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = list(fwd_args)
    for i in (i_h0, i_h0 + 1):
        a[i] = (torch.rand(a[i].shape, generator=gen, device="cuda")
                - 0.5).to(a[i].dtype)
    return a


def gp_gate_calls(torch, gpc, fwd_args, bwd_args):
    """Rows 20-21's calls for gates 2-4 at GP_SHORT_T on the step's tensors
    (gate 2 with the first coef row alone: its act set is sigmoid), and the
    step's call from a carried state (``carried_state``); the backward's ys
    and cs from the twin's forward, dy the step's."""
    T = GP_SHORT_T
    a = carried_state(torch, fwd_args, 6, 9)
    ys, cs, _, _ = gpc.gpg_fwd_plain(*a)
    tag = "gate 1, that step from a carried state"
    fwd, bwd = [(tag, a)], [(tag, [*a[:8], ys, cs, *bwd_args[10:]])]
    for gate in (2, 3, 4):
        xg, gpx, w5, bih, coef, mask, h0, c0, _ = fwd_args
        a = [xg[:T].contiguous(), gpx[:T].contiguous(), w5, bih,
             coef[:1].contiguous() if gate == 2 else coef, mask, h0, c0,
             gate]
        ys, cs, _, _ = gpc.gpg_fwd_plain(*a)
        dy = bwd_args[10][:T].contiguous()
        dhT = torch.zeros_like(h0)
        fwd.append((f"gate {gate}, T={T}", a))
        bwd.append((f"gate {gate}, T={T}",
                    [*a[:8], ys, cs, dy, dhT, dhT.clone(), gate]))
    return fwd, bwd


def gp_phases(torch, kernels, smi, cfg, rcfg, corpus, tmpdir):
    """The GP-LSTM's training and scoring on the training phases' corpus;
    adds rows 3, 4, 20 and 21 to ``kernels``. Raises on any failed
    check."""
    import dataclasses
    from bayeslms_tpu_torch import TrainConfig
    from bayeslms_tpu_torch.core.checkpoint import load_checkpoint
    from bayeslms_tpu_torch.data.corpus import batchify
    from bayeslms_tpu_torch.models.lstm_lm import (draw_dropout_masks,
                                                   init_hidden)
    from bayeslms_tpu_torch.ops import ce_train_cuda as ctc
    from bayeslms_tpu_torch.ops import gp_lstm_cuda as gpc
    from bayeslms_tpu_torch.ops import lstm_cuda as lc
    from bayeslms_tpu_torch.ops import lstm_train_cuda as ltc
    from bayeslms_tpu_torch.rescore.scorer import BatchScorer
    from bayeslms_tpu_torch.train.loop import Trainer

    gcfg = dataclasses.replace(cfg, uncertainty="Gaussian",
                               l_gauss_pos=GP_POS)
    B, T = TRAIN_BATCH, TRAIN_SEQ
    save = os.path.join(tmpdir, "gp.ckpt")
    kl_scale = T / batchify(corpus.train, B).shape[0]
    data = torch.from_numpy(corpus.train[:T * B].reshape(B, T).T.copy()
                            ).long().cuda()
    target = torch.from_numpy(corpus.train[1:T * B + 1].reshape(B, T).T
                              .copy()).long().cuda()
    gp_lstm = ("gpg_fwd", "gpg_bwd")

    with phase("gp setup"):
        tcfg = TrainConfig(lr=5.0, momentum=0.9, clip=1.0, batch_size=B,
                           seq_len=T, eval_batch_size=EVAL_BATCH, epochs=1,
                           log_interval=10, save=save)
        trainer = Trainer(gcfg, tcfg)
        state = trainer.init_state()
        n_par = sum(p.numel() for p in state.params.values())
        print(f"  GP-LSTM l_gauss_pos {GP_POS} (gate 1, GPNN type 3) "
              f"{gcfg.emsize}/{gcfg.nhid}, V = {gcfg.vocab_size}, "
              f"{gcfg.compute_dtype}: {n_par} parameters; lr 5, batch {B}, "
              f"seq_len {T}")
        recorded = {}
        gen_state = trainer.gen.get_state()
        with contextlib.ExitStack() as stack:
            for p in recording(gpc, gp_lstm, recorded):
                stack.enter_context(p)
            trainer.train_step(state, init_hidden(2, B, gcfg.nhid,
                                                  device="cuda"),
                               data, target, kl_scale)
        trainer.gen.set_state(gen_state)
        step_calls = {k: list(v) for k, v in recorded.items()}
        recorded = {}
        rows = batchify(corpus.valid, EVAL_BATCH)[:T + 1]
        with contextlib.ExitStack() as stack:
            for p in recording(gpc, ("gpg_fwd",), recorded) + recording(
                    lc, ("lstm_fwd",), recorded):
                stack.enter_context(p)
            trainer.evaluate(state.model, rows)
        torch.cuda.synchronize()
        print(f"  one step: {len(step_calls.get('gpg_fwd', []))} gpg_fwd, "
              f"{len(step_calls.get('gpg_bwd', []))} gpg_bwd calls; one "
              f"evaluate window: {len(recorded.get('gpg_fwd', []))} gpg_fwd, "
              f"{len(recorded.get('lstm_fwd', []))} lstm_fwd calls")
        if [len(step_calls.get(k, [])) for k in gp_lstm] != [1, 1] or \
                [len(recorded.get(k, [])) for k in ("gpg_fwd", "lstm_fwd")] \
                != [1, 1]:
            raise AssertionError("the GP step or evaluate window did not "
                                 "take rows 20-21 and row 4 once each")
        del state

    specs = gpg_specs(torch, gpc)
    fwd_step, bwd_step = step_calls["gpg_fwd"][0], step_calls["gpg_bwd"][0]
    short_fwd, short_bwd = gp_gate_calls(torch, gpc, fwd_step, bwd_step)
    fwd_calls = [("gate 1, one step", fwd_step),
                 ("gate 1, one evaluate window", recorded["gpg_fwd"][0]),
                 *short_fwd]
    before = dict(gpc.design_launches["gpg_fwd"])
    check_kernel_calls(torch, kernels, "gpg_fwd", specs["gpg_fwd"],
                       fwd_calls)
    persistent_only(gpc.design_launches["gpg_fwd"], before, "row 20")
    per_step_design_check(
        torch, kernels, "gpg_fwd", specs["gpg_fwd"], fwd_calls,
        lambda *a: gpc._gpg_fwd("per_step", *a),
        gpc.design_launches["gpg_fwd"], "gpx dropped")
    bwd_calls = [("gate 1, one step", bwd_step), *short_bwd]
    before = dict(gpc.design_launches["gpg_bwd"])
    check_kernel_calls(torch, kernels, "gpg_bwd", specs["gpg_bwd"], bwd_calls)
    persistent_only(gpc.design_launches["gpg_bwd"], before, "row 21")
    per_step_design_check(
        torch, kernels, "gpg_bwd", specs["gpg_bwd"], bwd_calls,
        lambda *a: gpc._gpg_bwd("two_launch", *a),
        gpc.design_launches["gpg_bwd"], GP_TWO_LAUNCH_FAULTS,
        design="two_launch")
    lspecs = lstm_fwd_specs(torch, lc)
    eval_call = recorded["lstm_fwd"][0]
    # the evaluate call has no step mask: a masked copy shows the mask
    # fault too
    gen = torch.Generator(device="cuda").manual_seed(7)
    masked = with_arg(eval_call, 5, (torch.rand(
        eval_call[0].shape[:2], generator=gen, device="cuda") < 0.8).to(
            torch.uint8))
    row4_calls = [("one evaluate window", eval_call),
                  ("that window with a random step mask", masked)]
    before = dict(lc.layer_design_launches)
    check_kernel_calls(torch, kernels, "lstm_fwd", lspecs["lstm_fwd"],
                       row4_calls)
    if lc.layer_design_launches["per_step"] != before["per_step"] \
            or lc.layer_design_launches == before:
        raise AssertionError(f"row 4's checks took {lc.layer_design_launches}"
                             f" (before: {before}): the persistent design "
                             f"alone expected")
    per_step_design_check(
        torch, kernels, "lstm_fwd", lspecs["lstm_fwd"], row4_calls,
        lambda *a: lc._lstm_fwd("per_step", *a), lc.layer_design_launches,
        "W_hh product dropped")
    del step_calls, recorded, short_fwd, short_bwd, row4_calls, bwd_calls
    del fwd_calls

    gp_fit(torch, kernels, trainer, corpus, smi, kl_scale, "gp",
           ("gpg_fwd", "gpg_bwd"), ("gpg_fwd", "gpg_bwd", "lstm_fwd"))

    with phase("gp train step against plain versions"):
        gen = torch.Generator(device="cuda").manual_seed(3)
        compare_steps(
            torch, trainer, data, target, kl_scale,
            draw_dropout_masks(gcfg, T, B, gen, "cuda"),
            [mock.patch.object(m, n, getattr(m, n + "_plain"))
             for m, n in ((ltc, "lstm_train_fwd"), (ltc, "lstm_train_bwd"),
                          *((ctc, n) for n in CE_TRAIN),
                          *((gpc, n) for n in gp_lstm))],
            loss_atol=STEP_LOSS_ATOL,
            hidden=lambda: init_hidden(2, B, gcfg.nhid, device="cuda"))

    with phase("gp score setup"):
        params, meta = load_checkpoint(save)
        print(f"  checkpoint of epoch {meta['epoch']}, val loss "
              f"{meta['val_loss']:.4f}")
        scorer = BatchScorer(gcfg, params, rcfg)
        nbest = make_synthetic_nbest(n_meetings=30,
                                     vocab_words=cfg.vocab_size - 2)
        w2i = corpus.vocab.word2idx
        recorded = {}
        with recording(lc, ("lstm_fwd",), recorded)[0]:
            scorer.score_nbest(nbest, w2i, stream_fn=stream_of)
        torch.cuda.synchronize()
        calls = recorded["lstm_fwd"]
        print(f"  one packed-carry pass: {len(calls)} lstm_fwd call(s) of "
              f"{tuple(calls[0][0].shape)}, resets "
              f"{int((calls[0][6] != 0).sum())}")

    # the pass's call, a copy whose every third chain restarts from a zero
    # state (source -1), as a chain's first utterance would, and the pass's
    # call from a carried state (a later chunk's), where a dropped W_hh
    # product cannot hide behind a zero h0
    a = calls[0]
    src = a[7].clone()
    N = max(len(h) for h in nbest.values())
    src[(torch.arange(src.numel(), device=src.device) // N) % 3 == 1] = -1
    row3_calls = [("one packed-carry pass", a),
                  ("that pass with -1 sources", with_arg(a, 7, src)),
                  ("that pass from a carried state",
                   carried_state(torch, a, 3, 13))]
    before = dict(lc.layer_design_launches)
    check_kernel_calls(torch, kernels, "lstm_fwd_reset",
                       lspecs["lstm_fwd_reset"], row3_calls)
    persistent_only(lc.layer_design_launches, before, "row 3", "streamed")
    per_step_design_check(
        torch, kernels, "lstm_fwd_reset", lspecs["lstm_fwd_reset"],
        row3_calls, lambda *a: lc._lstm_fwd("per_step", *a),
        lc.layer_design_launches, ("W_hh product dropped", "resets ignored"),
        main="streamed")
    del recorded, calls, a, row3_calls

    kernels["lstm_fwd_reset"]["launches"] = gp_score(
        torch, scorer, nbest, w2i, smi, "gp")


# ---------------------------------------------------------------- gate 6
# The GP-LSTM of the README's training table (L_gauss_pos 63: a GP cell
# whose GPNN, type 3, replaces the hidden projection, then a standard
# layer; sampling off as the reference ships) at the bench's width (emsize
# = nhid = 1,024, which gate 6 needs) on the training phases' corpus. Rows
# 18-19 carry the GP cell's training and evaluation, rows 5-6 the standard
# layer's training, row 4 its evaluation and row 3 its packed-carry scoring
# (where the GP cell runs the JAX scan, as JAX does under resets). Then
# gate 7 (73: the GP unit over x hoisted, its recurrence and the standard
# layer's on rows 5-6), GPNN2 (14: a scan in JAX, no kernel of its own) and
# the GP-FFN Transformer (t_gauss_pos 3 at the recipe's width).
GP6_POS = "63"
# Planted faults of row 19 that no input can make, built from
# csrc/gp6_lstm.cu with a define (see its header): the first two act on both
# designs, the third only on the persistent one (its recurrence reads the
# hoisted product P of step 0 at every step: the step's offset dropped).
GP6_FAULTS = {
    "relu term dropped from dpre": ("gp6_lstm", ("-DGP6_FAULT=1",)),
    "dcoef dropped": ("gp6_lstm", ("-DGP6_FAULT=2",)),
    P_STEP0: ("gp6_lstm", ("-DGP6_FAULT=3",)),
}
GP6_TWO_LAUNCH_FAULTS = ("relu term dropped from dpre", "dcoef dropped")
# The learning rates of the gate-6 fit and GPNN2's steps. At the recipes'
# lr 5 the gate-6 model's loss on this corpus spikes from 11.6 to 28 by
# step 6 on the kernel path and on the plain twins alike (gradient norms up
# to 372 before the clip; gate 7 too), where 13 and the standard model fall
# (tools/port_lr_probe.py on the H100, PERF.md); at lr 2 it falls to 5.3 in
# an epoch.
GP6_LR = 2.0
GP14_LR = 1.0
GP14_FRACTION = 0.5  # GPNN2's fit: the first half of the corpus, ~11 steps
# Row 19's dupre holds relu'(pre), a step at pre = 0: where the kernel's
# and the twin's fp32 sums of pre (1,024 bf16 products in other orders)
# fall on the two sides of 0, dupre takes either side's value. Within
# |pre| <= RELU_KINK max|pre| (~100x those sums' rounding) dupre may differ
# by the relu term's size, |du coef[2]|, beyond the tolerance.
RELU_KINK = 2.0 ** -14


def gp6_relu_slack(torch, args, ref):
    """Row 19's allowance at the relu step (RELU_KINK): {"dupre": |dux
    coef[2]| where |pre| is within the band, 0 elsewhere}, pre recomputed
    in fp32 from the call's bf16 h_{t-1} and W' and its b'."""
    xg, w, b, coef, _, h0, _, ys = args[:8]
    T, B, G = xg.shape
    hprev = torch.cat([h0[None], ys[:-1]]).reshape(T * B, -1).float()
    pre = (hprev @ w.float().t() + b.float()).reshape(T, B, G)
    tau = RELU_KINK * float(pre.abs().max())
    kink = pre.abs() <= tau
    print(f"  relu step: {int(kink.sum())} of {kink.numel()} elements with "
          f"|pre| <= {tau:.3e} may take either side's dupre")
    return {"dupre": kink * (ref["dux"].float() * coef[2]).abs()}


def gp6_specs(torch, gpc):
    """Check specs of rows 18-19: twins, outputs, planted faults made by
    changing the inputs (b' zeroed where it is not zero, coef rows 0 and 1
    swapped, the step mask ignored where there is one) and the two builds
    of GP6_FAULTS (row 19), operations and bytes (every tensor argument
    read once, the outputs written once)."""
    def cost(args, mult, out_bytes):
        T, B, G = args[0].shape
        nbytes = sum(a.numel() * a.element_size() for a in args
                     if isinstance(a, torch.Tensor))
        return mult * T * B * (G // 4) * G, nbytes + out_bytes(T, B, G)

    def fwd_cost(args):
        return cost(args, 2, lambda T, B, G: (2 * T * B + 2 * B) * G // 4 * 2)

    def bwd_cost(args):
        return cost(args, 4, lambda T, B, G: 2 * T * B * G * 2 + 3 * G * 4
                    + 2 * B * G // 4 * 2)

    faults = {
        "b' zeroed": lambda a: None if not bool(a[2].any()) else with_arg(
            a, 2, torch.zeros_like(a[2])),
        "coef rows 0 and 1 swapped":
            lambda a: with_arg(a, 3, a[3][[1, 0, 2]].contiguous()),
        "step mask ignored": lambda a: None if a[4] is None else with_arg(
            a, 4, torch.ones_like(a[4])),
    }
    none = ("none: no single PyTorch call computes an LSTM whose hidden "
            "projection is a GP unit's activation mixture")
    return {
        "gp6_fwd": dict(
            module=gpc, plain=gpc.gp6_fwd_plain, outs=("ys", "cs", "hT", "cT"),
            source="gp6_lstm.cu",
            replaces="bayeslms_tpu/ops/gp_lstm_pallas.py:192",
            faults={**faults, H0_ALWAYS: {"build": GP6_FWD_FAULT,
                                          "when": lambda a: bool(
                                              a[5].any())}},
            flops=lambda a: fwd_cost(a)[0], nbytes=lambda a: fwd_cost(a)[1],
            library=none),
        "gp6_bwd": dict(
            module=gpc, plain=gpc.gp6_bwd_plain,
            outs=("dux", "dupre", "dcoef", "dh0", "dc0"), source="gp6_lstm.cu",
            replaces="bayeslms_tpu/ops/gp_lstm_pallas.py:233",
            faults={**faults, **GP6_FAULTS,
                    P_STEP0: {"build": GP6_FAULTS[P_STEP0],
                              "when": lambda a: bool(a[5].any())}},
            flops=lambda a: bwd_cost(a)[0], nbytes=lambda a: bwd_cost(a)[1],
            slack=lambda a, r: gp6_relu_slack(torch, a, r), library=none),
    }


def gp6_variant_calls(torch, gpc, fwd_args, bwd_args):
    """Rows 18-19's step calls again with a random step mask, with a random
    b' (the GP unit's bias starts at zero) and from a carried state
    (``carried_state``), the backward's ys and cs from the twin's forward
    on those arguments, dy the step's."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    T, B = fwd_args[0].shape[:2]
    mask = (torch.rand((T, B), generator=gen, device="cuda") < 0.8).to(
        torch.uint8)
    bias = ((torch.rand(fwd_args[2].shape, generator=gen, device="cuda")
             - 0.5)).to(fwd_args[2].dtype)
    fwd, bwd = [], []
    for tag, a in (("a random step mask", with_arg(fwd_args, 4, mask)),
                   ("a random b'", with_arg(fwd_args, 2, bias)),
                   ("a carried state", carried_state(torch, fwd_args, 5,
                                                     10))):
        ys, cs, _, _ = gpc.gp6_fwd_plain(*a)
        fwd.append((f"that step with {tag}", a))
        bwd.append((f"that step with {tag}", [*a, ys, cs, *bwd_args[9:]]))
    return fwd, bwd


def gp6_phases(torch, kernels, smi, cfg, rcfg, corpus, tmpdir):
    """The gate-6 GP-LSTM's training and scoring on the training phases'
    corpus; adds rows 18 and 19 to ``kernels``. Raises on any failed
    check."""
    import dataclasses
    from bayeslms_tpu_torch import TrainConfig
    from bayeslms_tpu_torch.core.checkpoint import load_checkpoint
    from bayeslms_tpu_torch.data.corpus import batchify
    from bayeslms_tpu_torch.models.lstm_lm import (draw_dropout_masks,
                                                   init_hidden)
    from bayeslms_tpu_torch.ops import ce_train_cuda as ctc
    from bayeslms_tpu_torch.ops import gp_lstm_cuda as gpc
    from bayeslms_tpu_torch.ops import lstm_cuda as lc
    from bayeslms_tpu_torch.ops import lstm_train_cuda as ltc
    from bayeslms_tpu_torch.rescore.scorer import BatchScorer
    from bayeslms_tpu_torch.train.loop import Trainer

    gcfg = dataclasses.replace(cfg, uncertainty="Gaussian",
                               l_gauss_pos=GP6_POS)
    B, T = TRAIN_BATCH, TRAIN_SEQ
    save = os.path.join(tmpdir, "gp6.ckpt")
    kl_scale = T / batchify(corpus.train, B).shape[0]
    data = torch.from_numpy(corpus.train[:T * B].reshape(B, T).T.copy()
                            ).long().cuda()
    target = torch.from_numpy(corpus.train[1:T * B + 1].reshape(B, T).T
                              .copy()).long().cuda()
    rows6 = ("gp6_fwd", "gp6_bwd")

    with phase("gp6 setup"):
        tcfg = TrainConfig(lr=GP6_LR, momentum=0.9, clip=1.0, batch_size=B,
                           seq_len=T, eval_batch_size=EVAL_BATCH, epochs=1,
                           log_interval=10, save=save)
        trainer = Trainer(gcfg, tcfg)
        state = trainer.init_state()
        n_par = sum(p.numel() for p in state.params.values())
        print(f"  GP-LSTM l_gauss_pos {GP6_POS} (gate 6, GPNN type 3) "
              f"{gcfg.emsize}/{gcfg.nhid}, V = {gcfg.vocab_size}, "
              f"{gcfg.compute_dtype}: {n_par} parameters; lr {GP6_LR}, batch "
              f"{B}, seq_len {T}")
        recorded = {}
        gen_state = trainer.gen.get_state()
        with contextlib.ExitStack() as stack:
            for p in recording(gpc, rows6, recorded):
                stack.enter_context(p)
            trainer.train_step(state, init_hidden(2, B, gcfg.nhid,
                                                  device="cuda"),
                               data, target, kl_scale)
        trainer.gen.set_state(gen_state)
        step_calls = {k: list(v) for k, v in recorded.items()}
        recorded = {}
        rows = batchify(corpus.valid, EVAL_BATCH)[:T + 1]
        with contextlib.ExitStack() as stack:
            for p in recording(gpc, ("gp6_fwd",), recorded) + recording(
                    lc, ("lstm_fwd",), recorded):
                stack.enter_context(p)
            trainer.evaluate(state.model, rows)
        torch.cuda.synchronize()
        print(f"  one step: {len(step_calls.get('gp6_fwd', []))} gp6_fwd, "
              f"{len(step_calls.get('gp6_bwd', []))} gp6_bwd calls; one "
              f"evaluate window: {len(recorded.get('gp6_fwd', []))} gp6_fwd, "
              f"{len(recorded.get('lstm_fwd', []))} lstm_fwd calls")
        if [len(step_calls.get(k, [])) for k in rows6] != [1, 1] or \
                [len(recorded.get(k, [])) for k in ("gp6_fwd", "lstm_fwd")] \
                != [1, 1]:
            raise AssertionError("the gate-6 step or evaluate window did not "
                                 "take rows 18-19 and row 4 once each")
        del state

    specs = gp6_specs(torch, gpc)
    fwd_step, bwd_step = step_calls["gp6_fwd"][0], step_calls["gp6_bwd"][0]
    var_fwd, var_bwd = gp6_variant_calls(torch, gpc, fwd_step, bwd_step)
    fwd_calls = [("one step", fwd_step),
                 ("one evaluate window", recorded["gp6_fwd"][0]), *var_fwd]
    before = dict(gpc.design_launches["gp6_fwd"])
    check_kernel_calls(torch, kernels, "gp6_fwd", specs["gp6_fwd"],
                       fwd_calls)
    persistent_only(gpc.design_launches["gp6_fwd"], before, "row 18")
    per_step_design_check(
        torch, kernels, "gp6_fwd", specs["gp6_fwd"], fwd_calls,
        lambda *a: gpc._gp6_fwd("per_step", *a),
        gpc.design_launches["gp6_fwd"], "coef rows 0 and 1 swapped")
    bwd_calls = [("one step", bwd_step), *var_bwd]
    before = dict(gpc.design_launches["gp6_bwd"])
    check_kernel_calls(torch, kernels, "gp6_bwd", specs["gp6_bwd"], bwd_calls)
    persistent_only(gpc.design_launches["gp6_bwd"], before, "row 19")
    per_step_design_check(
        torch, kernels, "gp6_bwd", specs["gp6_bwd"], bwd_calls,
        lambda *a: gpc._gp6_bwd("two_launch", *a),
        gpc.design_launches["gp6_bwd"], GP6_TWO_LAUNCH_FAULTS,
        design="two_launch")
    del step_calls, recorded, var_fwd, var_bwd, bwd_calls, fwd_calls

    gp_fit(torch, kernels, trainer, corpus, smi, kl_scale, "gp6", rows6,
           rows6)

    with phase("gp6 train step against plain versions"):
        gen = torch.Generator(device="cuda").manual_seed(3)
        compare_steps(
            torch, trainer, data, target, kl_scale,
            draw_dropout_masks(gcfg, T, B, gen, "cuda"),
            [mock.patch.object(m, n, getattr(m, n + "_plain"))
             for m, n in ((ltc, "lstm_train_fwd"), (ltc, "lstm_train_bwd"),
                          *((ctc, n) for n in CE_TRAIN),
                          *((gpc, n) for n in rows6))],
            loss_atol=STEP_LOSS_ATOL,
            hidden=lambda: init_hidden(2, B, gcfg.nhid, device="cuda"))

    with phase("gp6 score setup"):
        params, meta = load_checkpoint(save)
        print(f"  checkpoint of epoch {meta['epoch']}, val loss "
              f"{meta['val_loss']:.4f}")
        scorer = BatchScorer(gcfg, params, rcfg)
        nbest = make_synthetic_nbest(n_meetings=30,
                                     vocab_words=cfg.vocab_size - 2)
        w2i = corpus.vocab.word2idx
        scorer.score_nbest(nbest, w2i, stream_fn=stream_of)  # warm-up
        torch.cuda.synchronize()
    gp_score(torch, scorer, nbest, w2i, smi, "gp6")

def gp_family_phases(torch, smi, cfg, corpus, tmpdir):
    """Gate 7 (73) and the GP-FFN Transformer (t_gauss_pos 3): a
    kernel-path step against the plain path; GPNN2 (14): a few steps of
    ``Trainer.fit`` with a finite, falling loss. Raises on any failed
    check."""
    import dataclasses
    from bayeslms_tpu_torch import TrainConfig
    from bayeslms_tpu_torch.data.corpus import batchify
    from bayeslms_tpu_torch.models.lstm_lm import (draw_dropout_masks,
                                                   init_hidden)
    from bayeslms_tpu_torch.ops import ce_train_cuda as ctc
    from bayeslms_tpu_torch.ops import lstm_train_cuda as ltc
    from bayeslms_tpu_torch.train.loop import Trainer

    B, T = TRAIN_BATCH, TRAIN_SEQ
    kl_scale = T / batchify(corpus.train, B).shape[0]
    data = torch.from_numpy(corpus.train[:T * B].reshape(B, T).T.copy()
                            ).long().cuda()
    target = torch.from_numpy(corpus.train[1:T * B + 1].reshape(B, T).T
                              .copy()).long().cuda()
    ce_plain = [mock.patch.object(ctc, n, getattr(ctc, n + "_plain"))
                for n in CE_TRAIN]

    def tcfg(save, lr, **kw):
        return TrainConfig(lr=lr, momentum=0.9, clip=1.0, batch_size=B,
                           seq_len=T, eval_batch_size=EVAL_BATCH, epochs=1,
                           log_interval=2, save=os.path.join(tmpdir, save),
                           **kw)

    with phase("gp7 train step against plain versions"):
        g7 = dataclasses.replace(cfg, uncertainty="Gaussian",
                                 l_gauss_pos="73")
        trainer = Trainer(g7, tcfg("gp7.ckpt", 5.0))
        for k in ltc.launches:
            ltc.launches[k] = 0
        st = trainer.init_state()
        trainer.train_step(st, init_hidden(2, B, g7.nhid, device="cuda"),
                           data, target, kl_scale)
        torch.cuda.synchronize()
        print(f"  l_gauss_pos 73 (gate 7, GPNN type 3) at {g7.emsize}/"
              f"{g7.nhid}: one step launches {dict(ltc.launches)} (rows 5-6 "
              "for the GP cell over the hoisted GP input and for the "
              "standard layer)")
        if dict(ltc.launches) != {"lstm_train_fwd": 2, "lstm_train_bwd": 2}:
            raise AssertionError("the gate-7 step did not take rows 5-6 "
                                 "twice")
        del st
        gen = torch.Generator(device="cuda").manual_seed(5)
        compare_steps(
            torch, trainer, data, target, kl_scale,
            draw_dropout_masks(g7, T, B, gen, "cuda"),
            [mock.patch.object(ltc, n, getattr(ltc, n + "_plain"))
             for n in ("lstm_train_fwd", "lstm_train_bwd")] + ce_plain,
            loss_atol=STEP_LOSS_ATOL,
            hidden=lambda: init_hidden(2, B, g7.nhid, device="cuda"))

    with phase("gpnn2 train"):
        g14 = dataclasses.replace(cfg, uncertainty="Gaussian",
                                  l_gauss_pos="14")
        trainer = Trainer(g14, tcfg("gp14.ckpt", GP14_LR,
                                    data_fraction=GP14_FRACTION))
        losses = []

        def on_step(b, loss):
            losses.append(float(loss))

        t0 = time.perf_counter()
        _, out = trainer.fit(corpus, log=lambda line: print("  " + line),
                             on_step=on_step)
        fit_s = time.perf_counter() - t0
        print(f"  l_gauss_pos 14 (GPNN2 replacing the input gate, its "
              f"frequencies drawn every time step): {len(losses)} steps, "
              f"loss " + " ".join(f"{l:.4f}" for l in losses)
              + f"; validation {out['history'][0]['val_loss']:.4f}, test "
              f"{out['test_loss']:.4f}; fit {fit_s:.1f} s on {smi}")
        if not all(np.isfinite(losses)) or not np.isfinite(out["test_loss"]):
            raise AssertionError("a GPNN2 training loss is not finite")
        if len(losses) < 6 or np.mean(losses[-3:]) >= np.mean(losses[:3]):
            raise AssertionError(f"the GPNN2 loss did not fall: {losses}")

    with phase("gp-ffn tm train step against plain versions"):
        gt = tm_config(cfg, uncertainty="Gaussian", t_gauss_pos=3)
        trainer = Trainer(gt, tcfg("tm_gauss.ckpt", TM_LR))
        st = trainer.init_state()
        print(f"  {gt.model} {gt.emsize}/{gt.nhid} x {gt.nlayers}, layer 0 "
              f"the GP-FFN layer (t_gauss_pos 3, GPNN type 3): "
              f"{sum(p.numel() for p in st.params.values())} parameters")
        del st
        compare_steps(torch, trainer, data, target, kl_scale,
                      tm_dropout_masks(torch, gt, T, B, 6), ce_plain,
                      loss_rtol=STEP_LOSS_RTOL)


# ------------------------------------------------------- fused 2-layer
# The JAX package's opt-in fused 2-layer training route
# (BAYESLM_PALLAS_LSTM2_TRAIN=1, bayeslms_tpu/ops/lstm.py:281-316; off by
# default there and in the port), rows 7-8, on the bench's LSTM at the
# recipe's training settings. The switch is set inside these phases only.
LSTM2_SWITCH = "BAYESLM_PALLAS_LSTM2_TRAIN"
# Planted faults of rows 7-8 that no input can make, built from
# csrc/lstm2_train.cu with a define (see its header); the dropout-mask
# faults show only on calls whose mask is not all ones.
def _dropped(args):
    return bool((args[1] != 1).any())


LSTM2_FWD_FAULT = {"build": ("lstm2_train", ("-DLSTM2_TRAIN_FAULT=3",)),
                   "when": _dropped}
# the persistent forward's layer 2 reads Q of step t + 1: a fault only the
# hoisted input product can make
LSTM2_Q_FAULT = ("lstm2_train", ("-DLSTM2_TRAIN_FAULT=4",))
LSTM2_BWD_FAULTS = {
    "dropout mask ignored in layer 2's recompute": {
        "build": ("lstm2_train", ("-DLSTM2_TRAIN_FAULT=1",)),
        "when": _dropped},
    "injection into layer 1 dropped":
        ("lstm2_train", ("-DLSTM2_TRAIN_FAULT=2",)),
}
LSTM2_BUILDS = (LSTM2_FWD_FAULT["build"], LSTM2_Q_FAULT,
                LSTM2_BWD_FAULTS["dropout mask ignored in layer 2's "
                                 "recompute"]["build"],
                LSTM2_BWD_FAULTS["injection into layer 1 dropped"])
# rows 7-8: rows 5-6's recurrence twice, the second layer's input the
# first's bf16-rounded output: the same elementwise rule
GP_TOL.update({"lstm2_train_fwd": TRAIN_TOL["lstm_train_fwd"],
               "lstm2_train_bwd": TRAIN_TOL["lstm_train_bwd"]})
LSTM2_FRACTION = 0.5  # the timed fits: the first half of the corpus


@contextlib.contextmanager
def fused_lstm2_switch(on=True):
    """``BAYESLM_PALLAS_LSTM2_TRAIN`` set to 1 (or unset) inside the block,
    restored after it."""
    old = os.environ.get(LSTM2_SWITCH)
    if on:
        os.environ[LSTM2_SWITCH] = "1"
    else:
        os.environ.pop(LSTM2_SWITCH, None)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(LSTM2_SWITCH, None)
        else:
            os.environ[LSTM2_SWITCH] = old


def lstm2_specs(torch, l2c):
    """Check specs of rows 7-8: twin, outputs, planted faults, operations
    (three, and six, 2 T B H 4H products) and bytes (every tensor argument
    read once, the outputs written once), and cuDNN's 2-layer LSTM with
    dropout 0.2 as the library call (other dropout bits, no step mask)."""
    def cost(args, n_products, out_elems):
        T, B, G = args[0].shape
        H = G // 4
        n_in = sum(a.numel() * a.element_size() for a in args
                   if isinstance(a, torch.Tensor))
        return (n_products * 2 * T * B * H * G,
                n_in + out_elems(T, B, H) * 2)

    def fwd_cost(a):
        return cost(a, 3, lambda T, B, H: 4 * T * B * H + 4 * B * H)

    def bwd_cost(a):
        return cost(a, 6, lambda T, B, H: 2 * T * B * 4 * H + 4 * B * H)

    def cudnn(backward):
        def make(args):
            T, B, G = args[0].shape
            H = G // 4
            with torch.enable_grad():
                lstm = torch.nn.LSTM(H, H, num_layers=2, dropout=0.2,
                                     device="cuda", dtype=torch.bfloat16)
                x = torch.randn((T, B, H), device="cuda",
                                dtype=torch.bfloat16, requires_grad=True)
                if not backward:
                    return lambda: lstm(x)
                out, _ = lstm(x)
                dy = torch.randn_like(out)

            def run():
                with torch.enable_grad():
                    return torch.autograd.grad(
                        out, [x, *lstm.parameters()], dy, retain_graph=True)
            return run
        return make

    return {
        "lstm2_train_fwd": dict(
            module=l2c, plain=l2c.lstm2_train_fwd_plain,
            outs=("ys1", "cs1", "ys2", "cs2", "hT1", "cT1", "hT2", "cT2"),
            source="lstm2_train.cu",
            replaces="bayeslms_tpu/ops/lstm_pallas.py:925",
            faults={"W_hh2 product dropped":
                    lambda a: with_arg(a, 5, torch.zeros_like(a[5])),
                    "dropout mask ignored": LSTM2_FWD_FAULT,
                    "layer 2 reads Q of the wrong step": LSTM2_Q_FAULT},
            flops=lambda a: fwd_cost(a)[0], nbytes=lambda a: fwd_cost(a)[1],
            library=cudnn(False)),
        "lstm2_train_bwd": dict(
            module=l2c, plain=l2c.lstm2_train_bwd_plain,
            outs=("du1", "du2", "dh01", "dc01", "dh02", "dc02"),
            source="lstm2_train.cu",
            replaces="bayeslms_tpu/ops/lstm_pallas.py:954",
            faults=dict(LSTM2_BWD_FAULTS),
            flops=lambda a: bwd_cost(a)[0], nbytes=lambda a: bwd_cost(a)[1],
            library=cudnn(True)),
    }


def timed_fit(torch, trainer, corpus, smi, tag, counters):
    """``trainer.fit`` with the launches of ``counters`` (modules with a
    ``launches`` dict) zeroed first; prints the losses and ms a step.
    Returns (losses, KL terms, ms a step, launches, fit output)."""
    for module in counters:
        for k in module.launches:
            module.launches[k] = 0
    steps, kls = [], []
    step = trainer.train_step

    def counted_step(*a, **kw):
        out = step(*a, **kw)
        kls.append(float(out[3]))
        return out

    def on_step(b, loss):
        torch.cuda.synchronize()
        steps.append((time.perf_counter(), float(loss)))

    trainer.train_step = counted_step
    t0 = time.perf_counter()
    try:
        _, out = trainer.fit(corpus, log=lambda line: print("  " + line),
                             on_step=on_step)
    finally:
        trainer.train_step = step
    fit_s = time.perf_counter() - t0
    launches = {k: v for m in counters for k, v in m.launches.items()}
    losses = [l for _, l in steps]
    dts = np.diff([t for t, _ in steps])[2:]
    step_ms = 1e3 * float(np.median(dts)) if len(dts) else float("nan")
    T, B = trainer.tcfg.seq_len, trainer.tcfg.batch_size
    print(f"  {tag}: {len(losses)} steps, loss "
          + " ".join(f"{l:.4f}" for l in losses))
    print(f"  {tag}: KL term per step " + " ".join(f"{k:.6f}" for k in kls))
    print(f"  {tag}: step median {step_ms:.3f} ms over {len(dts)} warm "
          f"steps, {T * B / step_ms * 1e3:.1f} tokens/s; validation "
          f"{out['history'][0]['val_loss']:.4f}, test {out['test_loss']:.4f};"
          f" fit {fit_s:.1f} s on {smi}; launches {launches}")
    if not all(np.isfinite(losses)) or not np.isfinite(out["test_loss"]):
        raise AssertionError(f"{tag}: a training loss is not finite")
    if len(losses) < 6 or np.mean(losses[-3:]) >= np.mean(losses[:3]):
        raise AssertionError(f"{tag}: the loss did not fall: {losses}")
    return losses, kls, step_ms, launches, out


def lstm2_bwd_per_step_check(torch, kernels, l2c, args, rmask, specs):
    """Row 8's per-step design (four launches a step), which ``_design``
    keeps for a batch past 32 columns, on the persistent design's recorded
    call (and with the random step mask) against the twin within
    GP_TOL["lstm2_train_bwd"], the planted fault that drops the injection
    (``-DLSTM2_TRAIN_FAULT=2``) by FAULT_MARGIN or more; timed, and the time
    added to the persistent design's ``kernels`` entry as ``per_step_ms``.
    Raises on a failed check."""
    from bayeslms_tpu_torch.ops import _build

    name = "lstm2_train_bwd"
    with phase(f"kernel {name} (per-step design)"), torch.no_grad():
        T, B, G = args[0].shape
        plan = l2c._card_design(args[0].device, B, G // 4, T)
        print(f"  T={T} B={B} H={G // 4}: the rule's design {plan['design']} "
              f"(recurrence grid {plan['grid']}, {plan['smem_bytes']} bytes "
              f"a CTA, {plan['barriers']} grid barriers; gate GEMM grid "
              f"{plan['gemm_grid']}, {plan['gemm_smem_bytes']} bytes)")
        rtol, share = GP_TOL[name]
        outs = specs[name]["outs"]
        step = lambda *a: l2c._train_bwd("per_step", *a)  # noqa: E731
        err, worst = 0.0, 0.0
        for a in (args, with_arg(args, 7, rmask)):
            before = dict(l2c.design_launches)
            got = dict(zip(outs, step(*a)))
            ref = dict(zip(outs, l2c.lstm2_train_bwd_plain(*a)))
            torch.cuda.synchronize()
            if l2c.design_launches["per_step"] != before["per_step"] + 1:
                raise AssertionError("the call did not take the per-step "
                                     f"design: {l2c.design_launches}")
            e, q = check_outputs(f"{name} (per-step)", got, ref, rtol, share)
            err, worst = max(err, e), max(worst, q)
        real_load = _build.load
        with mock.patch.object(_build, "load", lambda k: real_load(
                LSTM2_BWD_FAULTS["injection into layer 1 dropped"])):
            bad = dict(zip(outs, step(*args)))
        fault = fault_share(bad, dict(zip(outs, l2c.lstm2_train_bwd_plain(
            *args))), rtol, share)
        print(f"  planted fault 'injection into layer 1 dropped': worst "
              f"share of tolerance {fault:.1f}")
        ms = cuda_ms(torch, lambda: step(*args), 3)
        print(f"  per-step {ms:.3f} ms (the persistent design "
              f"{kernels[name]['ms']:.3f} ms on the same call)")
        kernels[name].update(design="persistent", per_step_ms=ms,
                             per_step_max_abs_err=err)
        if worst > 1:
            raise AssertionError(f"the per-step design disagrees with its "
                                 f"plain version: worst share {worst:.3f}")
        if fault < FAULT_MARGIN:
            raise AssertionError(f"the per-step design's planted fault "
                                 f"exceeds the tolerance only {fault:.1f}x")


def lstm2_phases(torch, kernels, smi, cfg, corpus, tmpdir):
    """A few steps of ``fit`` on the fused route and on the default
    two-layer route, timed in the same call; rows 7-8 against their twins
    on the calls one fused step of the standard LSTM, from the fused fit's
    checkpoint, hands them (with its dropout mask, a random step mask,
    dm = ones); a fused step of the standard and of the Bayesian LSTM
    against the same step on the twins.
    Adds rows 7-8 to ``kernels``. Raises on any failed check."""
    import dataclasses
    from bayeslms_tpu_torch import TrainConfig
    from bayeslms_tpu_torch.core.checkpoint import (load_checkpoint,
                                                    params_from_jax)
    from bayeslms_tpu_torch.data.corpus import batchify
    from bayeslms_tpu_torch.models.lstm_lm import (draw_dropout_masks,
                                                   init_hidden)
    from bayeslms_tpu_torch.ops import bayes_sample_cuda as bsc
    from bayeslms_tpu_torch.ops import ce_train_cuda as ctc
    from bayeslms_tpu_torch.ops import lstm2_train_cuda as l2c
    from bayeslms_tpu_torch.ops import lstm_train_cuda as ltc
    from bayeslms_tpu_torch.train.loop import Trainer

    B, T = TRAIN_BATCH, TRAIN_SEQ
    kl_scale = T / batchify(corpus.train, B).shape[0]
    data = torch.from_numpy(corpus.train[:T * B].reshape(B, T).T.copy()
                            ).long().cuda()
    target = torch.from_numpy(corpus.train[1:T * B + 1].reshape(B, T).T
                              .copy()).long().cuda()
    names = ("lstm2_train_fwd", "lstm2_train_bwd")

    def tcfg(save, **kw):
        return TrainConfig(lr=5.0, momentum=0.9, clip=1.0, batch_size=B,
                           seq_len=T, eval_batch_size=EVAL_BATCH, epochs=1,
                           log_interval=4, save=os.path.join(tmpdir, save),
                           **kw)

    with phase("fused lstm2 train"):
        fits = {}
        l2c.design_launches.update(persistent=0, per_step=0)
        l2c.fwd_design_launches.update(persistent=0, per_step=0)
        for route, on in (("fused", True), ("two-layer", False)):
            with fused_lstm2_switch(on):
                tr = Trainer(cfg, tcfg(f"lstm2_{route}.ckpt",
                                       data_fraction=LSTM2_FRACTION))
                fits[route] = timed_fit(torch, tr, corpus, smi,
                                        f"{route} route", (l2c, ltc))
        n_f = len(fits["fused"][0])
        lf, lt = fits["fused"][3], fits["two-layer"][3]
        print(f"  ms a step: fused {fits['fused'][2]:.3f}, two-layer "
              f"{fits['two-layer'][2]:.3f} (same call, {smi})")
        print(f"  the fused fit's row-8 calls by design: "
              f"{dict(l2c.design_launches)}; row 7's "
              f"{dict(l2c.fwd_design_launches)}")
        if lf["lstm2_train_fwd"] != n_f or lf["lstm2_train_bwd"] != n_f \
                or lf["lstm_train_fwd"] or lf["lstm_train_bwd"]:
            raise AssertionError(f"the fused fit launched {lf}")
        if l2c.design_launches != {"persistent": n_f, "per_step": 0}:
            raise AssertionError(f"row 8 took {l2c.design_launches} in the "
                                 f"fused fit's {n_f} steps")
        if l2c.fwd_design_launches != {"persistent": n_f, "per_step": 0}:
            raise AssertionError(f"row 7 took {l2c.fwd_design_launches} in "
                                 f"the fused fit's {n_f} steps")
        if lt["lstm2_train_fwd"] or lt["lstm2_train_bwd"] \
                or lt["lstm_train_fwd"] != 2 * len(fits["two-layer"][0]):
            raise AssertionError(f"the default fit launched {lt}")
    with phase("lstm2 setup"), fused_lstm2_switch():
        # the fused fit's weights: a trained model's states and gates are
        # larger than the random init's, and the planted faults show more
        trainer = Trainer(cfg, tcfg("lstm2.ckpt"))
        state = trainer.init_state()
        params_from_jax(state.model, load_checkpoint(
            os.path.join(tmpdir, "lstm2_fused.ckpt"))[0])
        recorded = {}
        for k in ltc.launches:
            ltc.launches[k] = 0
        with contextlib.ExitStack() as stack:
            for p in recording(l2c, names, recorded):
                stack.enter_context(p)
            trainer.train_step(state, init_hidden(2, B, cfg.nhid,
                                                  device="cuda"),
                               data, target)
        torch.cuda.synchronize()
        counts = {n: len(recorded.get(n, ())) for n in names}
        print(f"  one fused step of the standard LSTM: calls {counts}; "
              f"lstm_train launches {dict(ltc.launches)}")
        if set(counts.values()) != {1} or any(ltc.launches.values()):
            raise AssertionError("the fused step did not take rows 7-8 "
                                 "alone")
        del state
    fwd_args = recorded["lstm2_train_fwd"][0]
    bwd_args = recorded["lstm2_train_bwd"][0]
    gen = torch.Generator(device="cuda").manual_seed(7)
    rmask = (torch.rand((T, B), generator=gen, device="cuda") > 0.2
             ).to(torch.bfloat16)
    ones = torch.ones_like(fwd_args[1])
    calls = {"lstm2_train_fwd": fwd_args, "lstm2_train_bwd": bwd_args}
    specs = lstm2_specs(torch, l2c)
    for name in names:
        a = calls[name]
        print(f"  {name}: dropout mask keeps "
              f"{float((a[1] != 0).float().mean()):.4f} of the units")
        before = dict(l2c.design_launches)
        before_fwd = dict(l2c.fwd_design_launches)
        row_calls = [(f"one step's call (T={T}, B={B}), dropout mask", a),
                     ("random step mask", with_arg(a, 7, rmask)),
                     ("dm = ones", with_arg(a, 1, ones))]
        check_kernel_calls(torch, kernels, name, specs[name], row_calls)
        if name == "lstm2_train_fwd":
            counts = l2c.fwd_design_launches
            if counts["per_step"] != before_fwd["per_step"] \
                    or counts == before_fwd:
                raise AssertionError(f"row 7's checks took {counts} (before: "
                                     f"{before_fwd}): the persistent design "
                                     f"alone expected")
            per_step_design_check(
                torch, kernels, name, specs[name], row_calls[:2],
                lambda *x: l2c._train_fwd("per_step", *x), counts,
                "W_hh2 product dropped")
        if name == "lstm2_train_bwd":
            if l2c.design_launches["per_step"] != before["per_step"] \
                    or l2c.design_launches == before:
                raise AssertionError(f"row 8's checks took "
                                     f"{l2c.design_launches} (before: "
                                     f"{before}): the persistent design "
                                     f"alone expected")
            lstm2_bwd_per_step_check(torch, kernels, l2c, a, rmask, specs)
    del recorded, calls, fwd_args, bwd_args

    plain = [mock.patch.object(m, n, getattr(m, n + "_plain"))
             for m, n in ((l2c, "lstm2_train_fwd"), (l2c, "lstm2_train_bwd"),
                          *((ctc, n) for n in CE_TRAIN))]
    with phase("fused lstm2 train step against plain versions"), \
            fused_lstm2_switch():
        print("  standard LSTM, dropout 0.2 between the layers:")
        compare_steps(
            torch, trainer, data, target, 0.0,
            draw_dropout_masks(cfg, T, B, gen, "cuda"), plain,
            loss_atol=STEP_LOSS_ATOL,
            hidden=lambda: init_hidden(2, B, cfg.nhid, device="cuda"))
        bcfg = dataclasses.replace(cfg, uncertainty="Bayesian",
                                   l_bayes_pos=BAYES_POS)
        btrainer = Trainer(bcfg, tcfg("lstm2_bayes.ckpt"))
        for k in l2c.launches:
            l2c.launches[k] = 0
        print(f"  Bayesian LSTM (l_bayes_pos {BAYES_POS}), dm = ones:")
        compare_steps(
            torch, btrainer, data, target, kl_scale,
            draw_dropout_masks(bcfg, T, B, gen, "cuda"),
            plain + [mock.patch.object(bsc, "sample_slices",
                                       bsc.sample_slices_plain)],
            loss_atol=STEP_LOSS_ATOL,
            hidden=lambda: init_hidden(2, B, bcfg.nhid, device="cuda"))
        if dict(l2c.launches) != {n: 1 for n in names}:
            raise AssertionError(f"the Bayesian fused step launched "
                                 f"{dict(l2c.launches)}")
        del btrainer

    for name in names:
        kernels[name]["launches"] = lf[name]
    return fits


# -------------------------------------------- variational and legacy cores
# The rest of the JAX package's recurrent and Transformer families at the
# widths of the phases above, on their corpus: the variational LSTM
# (l_v_pos 11, the recipes' --L_v_pos 11: noise in both layers'
# recurrence, no kernel of its own), the legacy VLSTM (at batch 32, which
# its noise table needs; its training under the fused 2-layer switch, so
# that rows 7-8 run), the legacy GaussLSTM at positions 1 (the input gate's
# pre-activation from the GP unit over x) and 6 (the GP unit in place of the
# hidden projection), and the variational Transformer (t_v_pos 1 and 3,
# seq_len 100 = v_seq_len, so that its noise and KL apply). Each takes a
# few fit steps; then a pass of the 6,000-hypothesis N-best from its
# checkpoint against the plain path within GP_SCORE_ATOL + GP_SCORE_RTOL
# |plain|.
V_FRACTION = 0.5  # their fits: the first half of the corpus
# The variational LSTMs' lr: at the recipes' lr 5 the variational LSTM's
# loss on this corpus rose from 11.7 to 30.1 in 12 steps on the H100
# (PERF.md), where the CPU tests hold its steps to the JAX package's; at
# lr 1 (GPNN2's fit, another scan cell) it falls. The legacy GaussLSTMs
# take the gate-6 fit's lr.
V_LSTM_LR = 1.0
GAUSS_LEGACY_POS = (1, 6)
VTM_POS = (1, 3)


def family_score(torch, scorer, nbest, w2i, smi, tag, plain, count):
    """A timed pass of ``scorer`` (its layout's default: packed-carry for
    the LSTMs, packed-nocarry for the Transformer) against the same pass
    with ``plain`` (mock patches of kernel wrappers with their twins) within
    GP_SCORE_ATOL + GP_SCORE_RTOL |plain|; ``count()`` reads the kernels'
    launches (zeroed first by the caller), each of which must be > 0.
    Raises on any failed check."""
    with phase(f"{tag} score"):
        t0 = time.perf_counter()
        res = scorer.score_nbest(nbest, w2i, stream_fn=stream_of)
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t0
        launches = count()
        print(f"  kernel launches in a pass: {launches}")
        if not all(launches.values()):
            raise AssertionError(f"{tag} scoring missed a kernel: {launches}")
        got = np.array([s for pairs in res.values() for _, s in pairs])
        with contextlib.ExitStack() as stack:
            for p in plain:
                stack.enter_context(p)
            ref = np.array([s for pairs in scorer.score_nbest(
                nbest, w2i, stream_fn=stream_of).values() for _, s in pairs])
        n_hyps = sum(len(h) for h in nbest.values())
        diff = np.abs(got - ref)
        share = float((diff / (GP_SCORE_ATOL + GP_SCORE_RTOL
                               * np.abs(ref))).max())
        print(f"  {n_hyps} hypotheses in {pass_s:.3f} s ({n_hyps / pass_s:.1f}"
              f" hyps/s) on {smi}; scores mean {got.mean():.3f}, max "
              f"{np.abs(ref).max():.3f}; max |kernel - plain| "
              f"{float(diff.max()):.4e}; worst share of {GP_SCORE_ATOL:.0e} "
              f"+ {GP_SCORE_RTOL:.0e} |plain|: {share:.3f}")
        if got.shape != (n_hyps,) or not np.all(np.isfinite(got)) \
                or share > 1:
            raise AssertionError(f"{tag} scoring failed")


def family_phases(torch, smi, cfg, rcfg, corpus, tmpdir, tm=False):
    """The variational LSTM, the legacy VLSTM (its training on rows 7-8)
    and the legacy GaussLSTM at 1 and 6 (``tm=False``), or the variational
    Transformer at t_v_pos 1 and 3 (``tm=True``): a few fit steps each,
    the loss finite and falling, the KL finite and > 0 where the model has
    one (on full windows: the Transformer's noise and KL gate on the
    window's length), then a scoring pass against the plain path. Returns
    the fused route's launches of rows 7-8 in the legacy VLSTM's fit."""
    import dataclasses
    from bayeslms_tpu_torch import TrainConfig
    from bayeslms_tpu_torch.core.checkpoint import load_checkpoint
    from bayeslms_tpu_torch.ops import ce_cuda
    from bayeslms_tpu_torch.ops import ce_train_cuda as ctc
    from bayeslms_tpu_torch.ops import lstm2_train_cuda as l2c
    from bayeslms_tpu_torch.ops import lstm_cuda as lc
    from bayeslms_tpu_torch.ops import lstm_train_cuda as ltc
    from bayeslms_tpu_torch.rescore.scorer import BatchScorer
    from bayeslms_tpu_torch.train.loop import Trainer

    B, T = TRAIN_BATCH, TRAIN_SEQ
    nbest = make_synthetic_nbest(n_meetings=30,
                                 vocab_words=cfg.vocab_size - 2)
    w2i = corpus.vocab.word2idx
    ce_plain = mock.patch.object(ce_cuda, "fused_decode_ce", ce_cuda.ce_plain)
    if tm:
        runs = [(f"vtm {v}", tm_config(cfg, uncertainty="Variational",
                                       t_v_pos=v), TM_LR, False, True)
                for v in VTM_POS]
    else:
        runs = [("vlstm", dataclasses.replace(
                    cfg, uncertainty="Variational", l_v_pos="11"), V_LSTM_LR,
                 False, True),
                ("vlstm legacy", dataclasses.replace(
                    cfg, uncertainty="Variational", l_v_pos="11",
                    l_v_legacy=True), V_LSTM_LR, True, True)]
        runs += [(f"gauss legacy {p}", dataclasses.replace(
                     cfg, uncertainty="Gaussian", l_gauss_legacy_pos=p),
                  GP6_LR, False, False) for p in GAUSS_LEGACY_POS]
    fused = {}
    for tag, mcfg, lr, switch, has_kl in runs:
        save = os.path.join(tmpdir, tag.replace(" ", "_") + ".ckpt")
        with phase(f"{tag} train"), fused_lstm2_switch(switch):
            trainer = Trainer(mcfg, TrainConfig(
                lr=lr, momentum=0.9, clip=1.0, batch_size=B, seq_len=T,
                eval_batch_size=EVAL_BATCH, epochs=1, log_interval=4,
                save=save, data_fraction=V_FRACTION))
            print(f"  {tag}: {mcfg.model} {mcfg.emsize}/{mcfg.nhid} x "
                  f"{mcfg.nlayers}, {mcfg.uncertainty}, l_v_pos "
                  f"{mcfg.l_v_pos}, legacy VLSTM {mcfg.l_v_legacy}, legacy "
                  f"GaussLSTM {mcfg.l_gauss_legacy_pos}, t_v_pos "
                  f"{mcfg.t_v_pos}; lr {lr}, batch {B}, seq_len {T}; fused "
                  f"2-layer switch {'on' if switch else 'off'}")
            losses, kls, _, launches, _ = timed_fit(
                torch, trainer, corpus, smi, tag, (ctc, ltc, l2c))
            full = kls[:-1] if tm else kls  # the ragged last window: no KL
            if has_kl and not all(np.isfinite(k) and k > 0 for k in full):
                raise AssertionError(f"{tag}: the KL term is not finite and "
                                     f"> 0: {kls}")
            if not all(np.isfinite(kls)):
                raise AssertionError(f"{tag}: a KL term is not finite")
            if switch:
                if launches["lstm2_train_fwd"] != len(losses) \
                        or launches["lstm2_train_bwd"] != len(losses):
                    raise AssertionError(f"{tag}: rows 7-8 not once a step: "
                                         f"{launches}")
                fused = launches
            elif launches["lstm2_train_fwd"] or launches["lstm2_train_bwd"]:
                raise AssertionError(f"{tag}: rows 7-8 ran off the switch")
        scorer = BatchScorer(mcfg, load_checkpoint(save)[0], rcfg)
        ce_cuda.launches = lc.launches = 0
        lc.layer_launches["lstm_fwd_reset"] = 0
        lc.layer_design_launches.update(persistent=0, streamed=0, per_step=0)
        if tm:
            plain = [ce_plain]
            count = lambda: {"ce_fwd": ce_cuda.launches}  # noqa: E731
        elif mcfg.l_v_legacy:
            plain = [ce_plain, mock.patch.object(lc, "lstm2_fwd",
                                                 lc.lstm2_plain)]
            count = lambda: {"ce_fwd": ce_cuda.launches,  # noqa: E731
                             "lstm2_fwd": lc.launches}
        elif mcfg.l_gauss_legacy_pos >= 0:
            plain = [ce_plain, mock.patch.object(lc, "lstm_fwd",
                                                 lc.lstm_fwd_plain)]
            count = lambda: {  # noqa: E731
                "ce_fwd": ce_cuda.launches,
                "lstm_fwd_reset": lc.layer_launches["lstm_fwd_reset"]}
        else:  # the variational LSTM: the scan, no LSTM kernel
            plain = [ce_plain]
            count = lambda: {"ce_fwd": ce_cuda.launches}  # noqa: E731
        family_score(torch, scorer, nbest, w2i, smi, tag, plain, count)
        if not tm and mcfg.l_gauss_legacy_pos >= 0:
            # row 3 (its standard layer under resets) on the streamed
            # design, one launch a call
            n_row3 = lc.layer_launches["lstm_fwd_reset"]
            print(f"  row 3 by design: {lc.layer_design_launches}")
            if lc.layer_design_launches != {"persistent": 0,
                                            "streamed": n_row3,
                                            "per_step": 0}:
                raise AssertionError(f"{tag}: row 3 left the streamed "
                                     f"design: {lc.layer_design_launches}")
        del scorer, trainer
    return fused


def ce_operand_phase(torch, smi, cfg, corpus):
    """Print only (ROADMAP.md C, open check 3): one step of the GP-LSTMs
    whose GP cell runs the scan (53: gate 5; 14: GPNN2) with the trainer's
    CE operand, the cell's float32 states rounded to bf16 for the CE
    kernels, against the same step with a float32 CE on the unrounded
    states (plain PyTorch); the loss and the worst gradient deviation."""
    import dataclasses
    from bayeslms_tpu_torch import TrainConfig
    from bayeslms_tpu_torch.data.corpus import batchify
    from bayeslms_tpu_torch.models.lstm_lm import (RecurrentLM,
                                                   draw_dropout_masks,
                                                   init_hidden)
    from bayeslms_tpu_torch.train import loop
    from bayeslms_tpu_torch.train.loop import Trainer

    F = torch.nn.functional
    B, T = TRAIN_BATCH, TRAIN_SEQ
    kl_scale = T / batchify(corpus.train, B).shape[0]
    data = torch.from_numpy(corpus.train[:T * B].reshape(B, T).T.copy()
                            ).long().cuda()
    target = torch.from_numpy(corpus.train[1:T * B + 1].reshape(B, T).T
                              .copy()).long().cuda()

    # the float32 step: the model's output states, kept before the
    # trainer's rounding, go to a float32 CE in place of the rounded ones
    kept = {}
    forward = RecurrentLM.forward

    def keeping_forward(self, *a, **kw):
        out = forward(self, *a, **kw)
        kept["h"] = out[0]
        return out

    def fp32_ce(h, emb, bias, tgt):
        hf = kept["h"].reshape(h.shape).float()
        return F.cross_entropy(hf @ emb.float().t() + bias.float(), tgt,
                               reduction="none")

    with phase("gp scan cells: bf16 CE operand against a float32 CE"):
        for pos in ("53", "14"):
            gcfg = dataclasses.replace(cfg, uncertainty="Gaussian",
                                       l_gauss_pos=pos)
            trainer = Trainer(gcfg, TrainConfig(batch_size=B, seq_len=T))
            gen = torch.Generator(device="cuda").manual_seed(5)
            print(f"  l_gauss_pos {pos} on {smi}:")
            compare_steps(
                torch, trainer, data, target, kl_scale,
                draw_dropout_masks(gcfg, T, B, gen, "cuda"),
                [mock.patch.object(RecurrentLM, "forward", keeping_forward),
                 mock.patch.object(loop, "fused_decode_ce_train", fp32_ce)],
                hidden=lambda: init_hidden(2, B, gcfg.nhid, device="cuda"),
                labels=("bf16-operand", "fp32-CE"), check=False)
            del trainer


# Row 2's routes (ops/ce_cuda.py ``route``): the kernels each launches and
# the source that holds them
CE_ROUTES = {"split": ("ce_stats_split, ce_stats_merge",
                       "bayeslms_tpu_torch/csrc/ce_train.cu"),
             "wmma": ("ce_fwd_kernel", "bayeslms_tpu_torch/csrc/ce_fwd.cu")}


def ce_fwd_check(torch, kernels, args, tag="", atol=CE_ATOL):
    """Row 2 (the scoring CE) on the call the main path handed it, through
    the route its width takes (``ce_cuda.route``; every wrapper call here
    must take it): against its twin within ``atol``, at a ragged vocabulary
    edge too, a planted fault (targets shifted) that must exceed ``atol``
    by FAULT_MARGIN; times it and adds it to ``kernels`` as ce_fwd +
    ``tag``, with its design. Raises on any failed check."""
    from bayeslms_tpu_torch.ops import ce_cuda

    with phase(f"kernel ce_fwd{tag}"):
        h, emb, bias, tgt = args
        M, D = h.shape
        V = emb.shape[0]
        design = ce_cuda.route(D)
        names, source = CE_ROUTES[design]
        before = dict(ce_cuda.design_launches)
        got = ce_cuda.fused_decode_ce(h, emb, bias, tgt)
        ref = ce_cuda.ce_plain(h, emb, bias, tgt)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        print(f"  route {design} ({names}, {source})")
        print(f"  M={M} V={V} D={D} {emb.dtype}: max |kernel - plain| "
              f"{err:.3e} (tolerance {atol:.0e}); plain CE mean "
              f"{float(ref.mean()):.4f}, max {float(ref.max()):.4f}")
        bad = max_err(ce_cuda.fused_decode_ce(h, emb, bias,
                                              torch.roll(tgt, 1)), ref)
        print(f"  planted fault 'targets shifted': max |faulty - plain| "
              f"{bad:.3e} ({bad / atol:.1f}x the tolerance)")
        # a ragged vocabulary edge too (V' not a multiple of the 128 tile),
        # with a random bias: the model's initial bias is zero
        Vr, Mr = V - 77, 1000
        tr = tgt[:Mr] % Vr
        gen = torch.Generator(device=h.device).manual_seed(1)
        br = torch.rand((Vr,), generator=gen, device=h.device) * 2 - 1
        err_r = max_err(ce_cuda.fused_decode_ce(h[:Mr], emb[:Vr], br, tr),
                        ce_cuda.ce_plain(h[:Mr], emb[:Vr], br, tr))
        print(f"  M={Mr} V={Vr}, bias U(-1, 1): max |kernel - plain| "
              f"{err_r:.3e} (tolerance {atol:.0e})")
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
        if design == "split":
            plan = ce_cuda.ce_train_cuda._card_fwd_plan(
                h.device, M, V, D, ce_cuda.SPLIT_WIDTH)
            print(f"  plan: S {plan['S']}, grid {plan['grid']}, "
                  f"{plan['ctas']} CTAs; {flops / ms / 1e9:.1f} TFLOP/s, "
                  f"{bms / ms:.3f} of the bound")
        took = {k: ce_cuda.design_launches[k] - before[k] for k in before}
        print(f"  wrapper calls by route in this check: {took}")
        kernels["ce_fwd" + tag] = dict(
            name="ce_fwd" + tag, route="cuda", source=source,
            replaces="bayeslms_tpu/ops/ce_pallas.py:90",
            max_abs_err=max(err, err_r), ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=bby, library_ms=library_ms,
            design=design, kernels=names)
        if any(n for k, n in took.items() if k != design):
            raise AssertionError(f"ce_fwd: a call left route {design}: "
                                 f"{took}")
        if max(err, err_r) > atol:
            raise AssertionError(f"ce_fwd disagrees with its plain version: "
                                 f"{err:.3e}, ragged {err_r:.3e}")
        if bad < FAULT_MARGIN * atol:
            raise AssertionError(f"ce_fwd: the planted fault exceeds the "
                                 f"tolerance only {bad / atol:.1f}x")


# A width that row 2's split route refuses (a multiple of 32, not of 64):
# scoring at it takes csrc/ce_fwd.cu, which stays for such widths
NARROW_D = 96


def narrow_scoring_phase(torch, kernels, smi, cfg, rcfg, w2i):
    """A packed-carry pass of the bench's LSTM at emsize = nhid = NARROW_D
    (random weights), whose scoring calls take ``csrc/ce_fwd.cu``: every
    call on that route, the scores against the plain path within
    SCORE_ATOL, then row 2 on one recorded call through ``ce_fwd_check``
    (tag ``(D=96)``) with its launches from the pass."""
    import dataclasses

    from bayeslms_tpu_torch import build_model, init_params
    from bayeslms_tpu_torch.ops import ce_cuda, lstm_cuda
    from bayeslms_tpu_torch.rescore.scorer import BatchScorer

    tag = f" (D={NARROW_D})"
    ncfg = dataclasses.replace(cfg, emsize=NARROW_D, nhid=NARROW_D)
    nbest = make_synthetic_nbest(n_meetings=2)
    recorded = {}
    with phase(f"scoring at D={NARROW_D}"):
        scorer = BatchScorer(ncfg, init_params(build_model(ncfg), ncfg,
                                               seed=1), rcfg)
        ce_cuda.launches = 0
        ce_cuda.design_launches.update(split=0, wmma=0)
        with recording(ce_cuda, ("fused_decode_ce",), recorded)[0]:
            out = scorer.score_nbest(nbest, w2i, stream_fn=stream_of)
        torch.cuda.synchronize()
        got = np.array([s for pairs in out.values() for _, s in pairs])
        n_wmma = ce_cuda.design_launches["wmma"]
        print(f"  row 2 by route in one pass: {ce_cuda.design_launches}")
        if n_wmma == 0 or n_wmma != ce_cuda.launches:
            raise AssertionError(f"scoring at D={NARROW_D} did not take "
                                 f"ce_fwd.cu on every call: "
                                 f"{ce_cuda.design_launches}")
        with mock.patch.object(lstm_cuda, "lstm2_fwd", lstm_cuda.lstm2_plain), \
                mock.patch.object(ce_cuda, "fused_decode_ce",
                                  ce_cuda.ce_plain):
            ref = np.array([s for pairs in scorer.score_nbest(
                nbest, w2i, stream_fn=stream_of).values() for _, s in pairs])
        diff = float(np.abs(got - ref).max())
        print(f"  {got.size} scores, |plain| max {np.abs(ref).max():.3f}: "
              f"max |kernel - plain| {diff:.4e} (tolerance "
              f"{SCORE_ATOL:.0e}) on {smi}")
        if not np.all(np.isfinite(got)) or diff > SCORE_ATOL:
            raise AssertionError(f"scores at D={NARROW_D}: {diff:.4e} from "
                                 "the plain path")
    ce_fwd_check(torch, kernels, recorded["fused_decode_ce"][0], tag)
    kernels["ce_fwd" + tag]["launches"] = n_wmma


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
        # the port's kernels and the sampler's planted-fault variants, all
        # nvcc processes at once
        for name, path in _build.build([*_build.KERNELS,
                                        *SAMPLER_FAULTS.values(),
                                        ATTN_FAULT, BMM_FAULT,
                                        *ATTN_TRAIN_FAULTS.values(),
                                        *GP_FAULTS.values(),
                                        *GP6_FAULTS.values(),
                                        GP_FWD_FAULT, GP6_FWD_FAULT,
                                        *LSTM2_BUILDS]).items():
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

    lstm2_check(torch, kernels, recorded["lstm"])

    ce_fwd_check(torch, kernels, recorded["ce"])
    del recorded

    with phase("main path"):
        lstm_cuda.launches = 0
        lstm_cuda.design_launches.update(persistent=0, per_step=0)
        ce_cuda.launches = 0
        ce_cuda.design_launches.update(split=0, wmma=0)
        pass_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = scorer.score_nbest(nbest, w2i, stream_fn=stream_of)
            torch.cuda.synchronize()
            pass_s.append(time.perf_counter() - t0)
        launches = {"lstm2_fwd": lstm_cuda.launches,
                    "ce_fwd": ce_cuda.launches}
        print(f"  kernel launches in 3 passes: {launches}; row 1 by design "
              f"{lstm_cuda.design_launches}; row 2 by route "
              f"{ce_cuda.design_launches}")
        if ce_cuda.design_launches["split"] != ce_cuda.launches:
            raise AssertionError("a scoring call left the split route: "
                                 f"{ce_cuda.design_launches}")
        if lstm_cuda.design_launches["persistent"] != lstm_cuda.launches:
            raise AssertionError("a scoring call left row 1's persistent "
                                 f"design: {lstm_cuda.design_launches}")
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
        kernel = lstm_cuda.lstm2_fwd
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

    narrow_scoring_phase(torch, kernels, smi, cfg, rcfg, w2i)
    corpus, tmp = train_phases(torch, kernels, smi, cfg, rcfg)
    bayes_phases(torch, kernels, smi, cfg, rcfg, corpus, tmp.name)
    lstm2_phases(torch, kernels, smi, cfg, corpus, tmp.name)
    gp_phases(torch, kernels, smi, cfg, rcfg, corpus, tmp.name)
    gp6_phases(torch, kernels, smi, cfg, rcfg, corpus, tmp.name)
    gp_family_phases(torch, smi, cfg, corpus, tmp.name)
    ce_operand_phase(torch, smi, cfg, corpus)
    fused = family_phases(torch, smi, cfg, rcfg, corpus, tmp.name)
    for name in ("lstm2_train_fwd", "lstm2_train_bwd"):
        kernels[name]["launches"] += fused[name]
    family_phases(torch, smi, cfg, rcfg, corpus, tmp.name, tm=True)
    tm_phases(torch, kernels, smi, cfg, rcfg, corpus, tmp.name)
    ckpt = tm_long_phases(torch, kernels, smi, cfg, tmp.name)
    tm_xl_phase(torch, kernels, smi, cfg, rcfg, ckpt)
    tmp.cleanup()

    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
