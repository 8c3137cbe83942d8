"""The port's tracing and profiling (``utils/profiling.py``, the trainer's
``profile_dir``) on the CPU: ``trace`` writes a Chrome trace naming an
``annotate``d region; ``StepTimer`` equals the JAX package's on the same
samples and clock readings; ``fit`` traces its first trained epoch only
(the first resumed one after a resume); ``device_memory_stats`` is empty
without a card."""

import json
import os
import time

import numpy as np
import pytest
import torch

from bayeslms_tpu.utils import profiling as jprof
from bayeslms_tpu_torch import ModelConfig, TrainConfig
from bayeslms_tpu_torch.data import corpus as tcorpus
from bayeslms_tpu_torch.train import loop
from bayeslms_tpu_torch.utils import profiling

from test_torch_port_resume import V, _write_corpus


def test_trace_writes_a_chrome_trace_naming_an_annotated_region(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("port_region"):
            torch.ones((64, 64)) @ torch.ones((64, 64))
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((tmp_path / files[0]).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "port_region" in names
    assert any(n and n.startswith("aten::mm") for n in names)
    # a second region writes a second file beside the first
    with profiling.trace(str(tmp_path)):
        torch.zeros(3).sum()
    assert len(os.listdir(tmp_path)) == 2


def test_step_timer_equals_jax(monkeypatch):
    rng = np.random.default_rng(0)
    samples = rng.uniform(5, 50, size=12)
    for alpha in (0.05, 0.3):
        ours, ref = profiling.StepTimer(alpha), jprof.StepTimer(alpha)
        for ms in samples:
            assert ours.update(float(ms)) == pytest.approx(
                ref.update(float(ms)), rel=1e-12)
    # tick reads the wall clock: the same readings give the same EMA
    clock = iter(np.cumsum(rng.uniform(0.01, 0.05, size=20)).tolist() * 2)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    ours, ref = profiling.StepTimer(0.3), jprof.StepTimer(0.3)
    got = [ours.tick() for _ in range(20)]
    want = [ref.tick() for _ in range(20)]
    assert got[0] is None and want[0] is None
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-12)


def test_device_memory_stats_is_empty_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory_stats() == {}


def test_fit_traces_only_the_first_trained_epoch(tmp_path, monkeypatch):
    _write_corpus(tmp_path / "c", n_train=300, n_valid=60, n_test=60)
    corpus = tcorpus.Corpus(str(tmp_path / "c"))
    traced, epochs = [], []
    real = loop.trace

    def spy(logdir):
        traced.append(epochs[-1] if epochs else None)
        return real(logdir)

    monkeypatch.setattr(loop, "trace", spy)
    cfg = ModelConfig(model="LSTM", vocab_size=V, emsize=16, nhid=16,
                      dropout=0.0)

    def trainer(n):
        t = loop.Trainer(cfg, TrainConfig(
            lr=1.0, batch_size=4, seq_len=10, eval_batch_size=3, epochs=n,
            resume=True, save=str(tmp_path / "m.ckpt"),
            profile_dir=str(tmp_path / "prof")), device="cpu")
        run = t.run_epoch

        def run_epoch(state, *a, **k):
            epochs.append(state.epoch)
            return run(state, *a, **k)
        t.run_epoch = run_epoch
        return t

    trainer(2).fit(corpus, log=lambda *_: None)
    assert epochs == [1, 2] and len(traced) == 1
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1
    events = json.loads((tmp_path / "prof" / files[0]).read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    # resumed: the first epoch this run trains is the one traced
    trainer(3).fit(corpus, log=lambda *_: None)
    assert epochs == [1, 2, 3] and len(traced) == 2
    assert len(os.listdir(tmp_path / "prof")) == 2
