"""The port stands alone: bayeslms_tpu_torch imports neither JAX (jax,
flax, optax), msgpack nor anything of bayeslms_tpu, reads the reference's
``model.pt`` and the JAX package's ``.ckpt`` without them, scores (packed,
the GP-LSTM among them, and Transformer-XL) and runs the long-context
attention training twin and the GP recurrence's twin without them, and its
entry points run on the card unless the caller asks for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "bayeslms_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "optax", "msgpack", "bayeslms_tpu")


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
from bayeslms_tpu_torch.core.checkpoint import load_params
bcfg = ModelConfig(model="LSTM", vocab_size=10000, emsize=256, nhid=256,
                   uncertainty="Bayesian", l_bayes_pos=3)
for path in ("exp/campaign/torch_lstm_bayes3/model.pt",
             "exp/campaign/ours_lstm_bayes3_e8/model.ckpt"):
    BatchScorer(bcfg, load_params(path, bcfg), RescoreConfig(), device="cpu")
tcfg = ModelConfig(model="Transformer", vocab_size=10000, emsize=128, nhid=512,
                   nlayers=2, nhead=4, uncertainty="Bayesian", t_bayes_pos="FFN")
tm = BatchScorer(tcfg, load_params("exp/campaign/torch_tm_bayesft/model.pt", tcfg),
                 RescoreConfig(), device="cpu")
tout = tm.score_nbest({{"u1": ["w2 w3", "w4"]}},
                      {{"<s>": 0, "<unk>": 1, "w2": 2, "w3": 3, "w4": 4}})
assert [len(v) for v in tout.values()] == [2]
xcfg = ModelConfig(model="Transformer", vocab_size=12, emsize=8, nhid=16,
                   nlayers=2, nhead=2)
xl = BatchScorer(xcfg, init_params(build_model(xcfg), xcfg),
                 RescoreConfig(xl_mems=True), device="cpu")
xout = xl.score_nbest({{"a_u1": ["w2 w3", "w4"], "a_u2": ["w5 zz"]}}, w2i,
                      stream_fn=lambda k: k.split("_")[0])
assert [len(v) for v in xout.values()] == [2, 1]
import torch
from bayeslms_tpu_torch.ops.attention_train_cuda import flash_attention_train
qkv = torch.randn((1024, 1, 24), requires_grad=True)
flash_attention_train(*qkv.split(8, dim=-1), 2, 0.2,
                      torch.tensor([5], dtype=torch.int32)).sum().backward()
assert qkv.grad.shape == qkv.shape
gcfg = ModelConfig(model="LSTM", vocab_size=10000, emsize=128, nhid=128,
                   uncertainty="Gaussian", l_gauss_pos="13")
gp = BatchScorer(gcfg, load_params("exp/campaign/torch_lstm_gp12/model.pt",
                                   gcfg), RescoreConfig(), device="cpu")
gout = gp.score_nbest({{"u1": ["w2 w3", "w4"]}},
                      {{"<s>": 0, "<unk>": 1, "w2": 2, "w3": 3, "w4": 4}})
assert [len(v) for v in gout.values()] == [2]
from bayeslms_tpu_torch.ops.gp_lstm_cuda import gpg_layer_fused
gargs = [torch.randn(s, requires_grad=True) for s in (
    (5, 2, 32), (5, 2, 8), (32, 8), (32,), (8, 8), (3, 8), (2, 8), (2, 8))]
gys, (gh, gc) = gpg_layer_fused(*gargs, 1, ("sigmoid", "tanh", "relu"))
(gys.sum() + gh.sum() + gc.sum()).backward()
assert all(a.grad is not None for a in gargs)
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
