#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (bayeslms_tpu_torch) on one H100.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc. It
builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version at the shapes of the main path, then drives the main path:
packed-carry N-best rescoring through ``BatchScorer.score_nbest`` with the
bench's 2-layer 1024/1024 LSTM LM (V = 49,152, bf16, random weights from a
fixed seed) on a synthetic 6,000-hypothesis N-best. Every phase prints its
result and seconds; any failure exits non-zero before the result lines.
The last two lines are a JSON object per kernel and the device line.
"""

import contextlib
import json
import subprocess
import sys
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

    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
