"""chip_smoke.py, the port's on-card check, off the card: its N-best is the
JAX bench's, and without a CUDA device (or without the repository) it
fails before printing any result."""

import os
import pathlib
import shutil
import subprocess
import sys

import bench
import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_synthetic_nbest_is_the_bench_one():
    assert chip_smoke.make_synthetic_nbest(n_meetings=3) == \
        bench.make_synthetic_nbest(n_meetings=3)
    assert chip_smoke.stream_of("meet4_utt7") == bench.stream_of("meet4_utt7")


def _run(cwd):
    # no card visible, also on a machine that has one
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_fails_without_cuda():
    res = _run(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_fails_without_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_markov_corpus_has_structure_and_windows(tmp_path):
    """The training phase's synthetic corpus: every word of the text is in
    words.txt, each word has at most four successors, and the stream fills
    the windows the phase asks for."""
    from bayeslms_tpu_torch.data.corpus import Corpus, batchify, windows

    chip_smoke.write_markov_corpus(str(tmp_path), 500, 4 * (10 * 5 + 3),
                                   200, 100)
    c = Corpus(str(tmp_path))
    assert len(c.vocab) == 502
    words = [w for line in (tmp_path / "train.txt").read_text().split("\n")
             for w in line.split()]
    assert words and all(w in c.vocab for w in words)
    succ = {}
    for a, b in zip(words, words[1:]):
        succ.setdefault(a, set()).add(b)
    assert max(len(s) for s in succ.values()) <= 4
    data, _, tail = windows(batchify(c.train, 4), 10, drop_ragged=False)
    assert data.shape[0] >= 5 and tail is not None
