"""The port stands alone: bayeslms_tpu_torch imports neither JAX (jax,
flax, optax) nor anything of bayeslms_tpu, and its entry points run on
the card unless the caller asks for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "bayeslms_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "optax", "bayeslms_tpu")


def _banned(name: str) -> bool:
    return name.split(".")[0] in BANNED


def _modules():
    return sorted(
        "bayeslms_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_no_banned_import_in_sources():
    offenders = []
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [f"{path}: {n}" for n in names if _banned(n)]
    assert not offenders


_CHILD = r"""
import sys
from importlib.abc import MetaPathFinder

class Refuse(MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {banned!r}:
            raise ImportError("refused: " + name)
        return None

for m in [m for m in sys.modules if m.split(".")[0] in {banned!r}]:
    del sys.modules[m]
sys.meta_path.insert(0, Refuse())
import importlib
for m in {modules!r}:
    importlib.import_module(m)
from bayeslms_tpu_torch import ModelConfig, RescoreConfig, build_model, init_params
from bayeslms_tpu_torch.rescore.scorer import BatchScorer
cfg = ModelConfig(model="LSTM", vocab_size=12, emsize=8, nhid=8)
scorer = BatchScorer(cfg, init_params(build_model(cfg), cfg), RescoreConfig(),
                     device="cpu")
w2i = {{"<s>": 0, "<unk>": 1, **{{f"w{{i}}": i for i in range(2, 12)}}}}
out = scorer.score_nbest({{"u1": ["w2 w3", "w4"], "u2": ["w5 zz"]}}, w2i)
assert [len(v) for v in out.values()] == [2, 1]
assert not [m for m in sys.modules if m.split(".")[0] in {banned!r}]
print("ISOLATED", sorted(round(s, 3) for v in out.values() for _, s in v))
"""


def test_port_imports_and_scores_without_jax():
    code = _CHILD.format(banned=BANNED, modules=_modules())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED" in res.stdout


def test_scorer_defaults_to_cuda_and_refuses_cpu_fallback(monkeypatch):
    from bayeslms_tpu_torch import ModelConfig, RescoreConfig, build_model, init_params
    from bayeslms_tpu_torch.rescore.scorer import BatchScorer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(model="LSTM", vocab_size=12, emsize=8, nhid=8)
    params = init_params(build_model(cfg), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchScorer(cfg, params, RescoreConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchScorer(cfg, params, RescoreConfig(), device="cuda")
