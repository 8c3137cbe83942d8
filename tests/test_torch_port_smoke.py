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
