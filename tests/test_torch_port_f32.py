"""Float32 scoring (kernel rows 1-4 at float32 operands) on the CPU: the
2-layer forward's gate ``lstm_cuda.lstm2_fwd_ok`` against the JAX
package's ``pallas_lstm2_ok`` over a grid of widths, item sizes and
batches; ``lstm_stack2``'s scoring route as JAX routes it (two layers where
the gate refuses, against JAX's ``lstm_stack2``; row 1's call, bit for bit
as before, where it admits); the float32 CE's launch plan; the bf16-only
wrappers' refusals and the command line's dtype rule on the card (a patched
``torch.cuda.is_available``), each naming its ROADMAP item; an interpolated
pair of a bf16 model and a float32 ``--inter_path`` model against JAX's
scores; and ``text_nbest``. The float32 twins themselves are held
to the Pallas kernels in interpret mode by tests/test_torch_port_lstm.py,
test_torch_port_lstm_fwd.py and test_torch_port_ce.py; the kernels to the
twins on the card by tests/test_torch_port_cuda.py and chip_smoke.py."""

import dataclasses
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslms_tpu as jx
from bayeslms_tpu.ops import lstm as jlstm
from bayeslms_tpu.ops import lstm_pallas as lp
from bayeslms_tpu.rescore.scorer import BatchScorer as JaxScorer
import bayeslms_tpu_torch as bt
from bayeslms_tpu_torch.cli import main as cli
from bayeslms_tpu_torch.core.checkpoint import save_checkpoint
from bayeslms_tpu_torch.ops import (_build, ce_cuda, ce_train_cuda,
                                    gp_lstm_cuda, lstm2_train_cuda,
                                    lstm_cuda, lstm_train_cuda)
from bayeslms_tpu_torch.ops import lstm as tlstm
from bayeslms_tpu_torch.rescore.nbest import SPECIAL_WORDS, text_nbest
from bayeslms_tpu_torch.rescore.scorer import BatchScorer


def _jax_lstm2_ok(monkeypatch, H, itemsize, B):
    """JAX's own ``pallas_lstm2_ok`` with a TPU as its first device."""
    monkeypatch.setattr(lp.jax, "devices",
                        lambda *a: [SimpleNamespace(platform="tpu")])
    dtype = jnp.bfloat16 if itemsize == 2 else jnp.float32
    return lp.pallas_lstm2_ok(H, dtype, batch=B)


@pytest.mark.parametrize("H", [64, 128, 256, 512, 724, 1024, 1448])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_lstm2_gate_gives_jax_s_answer(monkeypatch, H, itemsize):
    for B in (1, 16, 20, 600, 1200, 4000):
        assert lstm_cuda.lstm2_fwd_ok(H, itemsize, B) == \
            _jax_lstm2_ok(monkeypatch, H, itemsize, B), (H, itemsize, B)


@pytest.mark.parametrize("H,itemsize,B,admitted", [
    (256, 4, 20, True), (256, 4, 600, True), (512, 4, 600, True),
    (724, 4, 600, False), (1024, 4, 600, False), (1024, 4, 20, False),
    (1024, 2, 600, True)])
def test_lstm2_gate_at_the_scoring_calls(H, itemsize, B, admitted):
    """The table of the float32 slice: the checkpoints' widths admitted in
    float32, H 724 refused for the VMEM set, H 1,024 refused in float32 at
    any batch and admitted in bf16 at the main path's B 600."""
    assert lstm_cuda.lstm2_fwd_ok(H, itemsize, B) is admitted


def _stack_inputs(H, E=16, T=4, B=2, seed=0, reset=True):
    rng = np.random.default_rng(seed)
    sc = H ** -0.5
    x = rng.normal(size=(T, B, E)).astype(np.float32)
    p1 = [rng.normal(size=s).astype(np.float32) * sc for s in (
        (4 * H, E), (4 * H, H), (4 * H,), (4 * H,))]
    p2 = [rng.normal(size=s).astype(np.float32) * sc for s in (
        (4 * H, H), (4 * H, H), (4 * H,), (4 * H,))]
    h0 = rng.normal(size=(2, B, H)).astype(np.float32) * 0.3
    c0 = rng.normal(size=(2, B, H)).astype(np.float32) * 0.3
    mask = np.ones((T, B), np.float32)
    mask[T - 1, 0] = 0.0
    rmask = rsrc = None
    if reset:
        rmask = np.zeros((T, B), np.float32)
        rmask[1, :] = 1.0
        rsrc = np.array([0, -1][:B] + [0] * (B - 2), np.int32)
    return x, p1, p2, h0, c0, mask, rmask, rsrc


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def test_stack2_takes_two_layers_where_the_gate_refuses():
    """float32 at H 1,024: the gate refuses, so ``lstm_stack2`` runs two
    ``lstm_layer`` calls (each refused by ``lstm_kernel_ok`` too: the scan)
    and never row 1's plain version, as JAX's ``lstm_stack2`` does; with a
    step mask and resets (a -1 source among them), equal to JAX's in
    float32 on the CPU."""
    x, p1, p2, h0, c0, mask, rmask, rsrc = _stack_inputs(1024)
    assert not lstm_cuda.lstm2_fwd_ok(1024, 4, x.shape[1])
    ref = jlstm.lstm_stack2(
        jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0),
        jlstm.LSTMParams(*map(jnp.asarray, p1)),
        jlstm.LSTMParams(*map(jnp.asarray, p2)), step_mask=_j(mask),
        allow_pallas=True, reset_mask=_j(rmask), reset_src=_j(rsrc))
    with mock.patch.object(lstm_cuda, "lstm2_fwd",
                           side_effect=AssertionError("row 1 called")):
        got = tlstm.lstm_stack2(
            torch.from_numpy(x), torch.from_numpy(h0), torch.from_numpy(c0),
            tlstm.LSTMParams(*map(torch.from_numpy, p1)),
            tlstm.LSTMParams(*map(torch.from_numpy, p2)), _t(mask),
            _t(rmask), _t(rsrc))
    (ys, (h1, h2), (c1, c2)) = got
    (rys, (rh1, rh2), (rc1, rc2)) = ref
    for g, r in zip((ys, h1, h2, c1, c2), (rys, rh1, rh2, rc1, rc2)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reset", [False, True])
def test_stack2_keeps_row_1_where_the_gate_admits(dtype, reset):
    """Where the gate admits (H 64, B 2, either dtype), ``lstm_stack2``
    hands the recurrence to ``lstm2_fwd`` (its plain version on the CPU)
    with the same arguments as before the gate: bit for bit the direct
    call."""
    x, p1, p2, h0, c0, mask, rmask, rsrc = _stack_inputs(64, reset=reset)
    xt = torch.from_numpy(x).to(dtype)
    P1 = tlstm.LSTMParams(*map(torch.from_numpy, p1))
    P2 = tlstm.LSTMParams(*map(torch.from_numpy, p2))
    hs, cs = torch.from_numpy(h0).to(dtype), torch.from_numpy(c0).to(dtype)
    calls = []
    real = lstm_cuda.lstm2_fwd
    with mock.patch.object(lstm_cuda, "lstm2_fwd",
                           lambda *a: calls.append(a) or real(*a)):
        got = tlstm.lstm_stack2(xt, hs, cs, P1, P2, _t(mask), _t(rmask),
                                _t(rsrc))
    assert len(calls) == 1
    T, B, _ = x.shape
    xg1 = (xt.reshape(T * B, -1) @ P1.w_ih.to(dtype).t()
           + P1.b_ih.to(dtype)).reshape(T, B, -1)
    ref = lstm_cuda.lstm2_plain(
        xg1.contiguous(), P1.w_hh.to(dtype).contiguous(),
        P1.b_hh.to(dtype).float(), P2.w_ih.to(dtype).contiguous(),
        P2.w_hh.to(dtype).contiguous(),
        (P2.b_ih + P2.b_hh).to(dtype).float(), hs[0], cs[0], hs[1], cs[1],
        _t(mask), _t(rmask), _t(rsrc))
    for g, r in zip((got[0], *got[1], *got[2]), (ref[0], *ref[1], *ref[2])):
        assert g.dtype == dtype and torch.equal(g, r)


@pytest.mark.parametrize("M,V,S", [(90279, 49152, 1), (78600, 10000, 1),
                                   (90279, 10000, 1), (320, 49152, 32),
                                   (3200, 49152, 11), (1, 1, 1),
                                   (20, 130, 2)])
def test_f32_ce_plan_covers_the_vocabulary_once(M, V, S):
    """``f32_plan`` on 132 SMs: the token tiles alone at the scoring passes'
    M (S = 1), the walk split where they do not make two waves; every
    vocabulary tile in exactly one part, none empty."""
    plan = ce_cuda.f32_plan(M, V, 132)
    vt = -(-V // ce_cuda.F32_COLS)
    tpp = plan["tiles_per_part"]
    assert plan["S"] == S and plan["grid"] == (-(-M // 128), S)
    assert 1 <= S <= ce_cuda.F32_MAX_SPLITS
    assert (S - 1) * tpp < vt <= S * tpp


def _f32(*shape):
    return torch.zeros(shape, dtype=torch.float32)


@pytest.mark.parametrize("check,item", [
    (lambda: lstm_train_cuda._checked("lstm_train_fwd", _f32(2, 1, 128),
                                      _f32(128, 32), None, None, ()),
     "B.5b"),
    (lambda: lstm2_train_cuda._checked("lstm2_train_fwd", _f32(2, 1, 128),
                                       None, (), (), None, ()), "B.5d"),
    (lambda: gp_lstm_cuda._checked("gpg_fwd", _f32(2, 1, 128), None, None,
                                   None, None, None, 1, ()), "B.5c"),
    (lambda: gp_lstm_cuda._gp6_checked("gp6_fwd", _f32(2, 1, 128), None,
                                       None, None, None, ()), "B.5c"),
    (lambda: ce_train_cuda._check("ce_train_fwd", _f32(4, 256),
                                  _f32(8, 256), _f32(8),
                                  torch.zeros(4, dtype=torch.long)),
     "B.5a")], ids=["rows 5-6", "rows 7-8", "rows 20-21", "rows 18-19",
                    "rows 9-11"])
def test_bf16_only_wrappers_name_their_roadmap_item(check, item):
    """The kernels without a float32 design yet refuse a float32 operand
    before anything else, naming the ROADMAP item that brings it."""
    assert item in _build.F32_ITEMS.values()
    with pytest.raises(ValueError, match=f"ROADMAP.md {item}"):
        check()


SCORE = ["score", "--nbest-list", "n", "--vocabulary", "v", "--model-path",
         "m", "--outfile", "o"]
RESCORE = ["rescore", "--lattices", "l", "--words", "w", "--model-path", "m",
           "--workdir", "wd"]


@pytest.mark.parametrize("argv,refusal", [
    (SCORE, None), (RESCORE, None), (SCORE + ["--no-carry-over"], None),
    (SCORE + ["--model", "Transformer", "--mc-samples", "4"], None),
    (SCORE + ["--interpolation_flag", "1", "--inter_path", "b"], None),
    (SCORE + ["--compute-dtype", "bfloat16", "--mc-samples", "4"], None),
    (["train", "--data", "d"], "ROADMAP.md B.5a-B.5d"),
    (["train", "--data", "d", "--model", "Transformer"],
     "ROADMAP.md B.5a-B.5d"),
    (SCORE + ["--mc-samples", "4"], "ROADMAP.md B.5b"),
    (RESCORE + ["--mc-samples", "4"], "ROADMAP.md B.5b"),
    (SCORE + ["--model", "GRU", "--mc-samples", "4"], "ROADMAP.md B.5b"),
    (SCORE + ["--compute-dtype", "float16"], "bfloat16 or float32")],
    ids=lambda a: " ".join(a) if isinstance(a, list) else str(a))
def test_cli_dtype_rule_on_the_card(monkeypatch, argv, refusal):
    """With a card (``torch.cuda.is_available`` patched True), float32
    passes ``_check_device`` for score and rescore (the Transformer's MC
    too) and is refused for train and a recurrent model's MC, naming the
    ROADMAP item, before any device work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    args = cli.build_parser().parse_args(argv)
    if refusal is None:
        cli._check_device(args)
    else:
        with pytest.raises(ValueError, match=refusal):
            cli._check_device(args)


V = 32
W2I = {"<s>": 1, "<unk>": 0, **{f"w{i}": i for i in range(2, V)}}
MAIN = dict(model="LSTM", vocab_size=V, emsize=16, nhid=16, dropout=0.0,
            uncertainty="Bayesian", l_bayes_pos=3, compute_dtype="bfloat16")
SECOND = dict(model="LSTM", vocab_size=V, emsize=24, nhid=24, dropout=0.0,
              compute_dtype="float32")
# JAX's CPU scan carries bf16 states, the port's row-1 twin fp32 ones
# (ROADMAP C, deliberate differences): bf16 scores part by up to ~2e-5 of
# the largest |score| here; each is held within 2^-12 of it.
PAIR_SHARE = 2.0 ** -12


def _pair_params(cfg_kw, seed):
    cfg = bt.ModelConfig(**cfg_kw)
    p = bt.init_params(bt.build_model(cfg), cfg, seed=seed)
    p["decoder_b"] = np.random.default_rng(seed).normal(
        size=V).astype(np.float32) * 0.2
    return p


def _pair_nbest():
    rng = np.random.default_rng(7)
    return {f"{r}_{u}": [" ".join(f"w{rng.integers(2, V)}"
                                  for _ in range(rng.integers(1, 10)))
                         for _ in range(3)]
            for r in "AB" for u in range(4)}


@pytest.mark.parametrize("flag", [1, 2])
def test_bf16_model_with_a_float32_inter_path_model_scores_as_jax(
        monkeypatch, flag):
    """A bf16 main model interpolated with a float32 second model (each in
    its own dtype, as ``--inter_path`` now keeps its checkpoint's): the
    port's packed-carry scores against the JAX scorer's on the same pair,
    flags 1 and 2."""
    monkeypatch.setenv("BAYESLM_NATIVE_ENCODE", "0")
    p1, p2 = _pair_params(MAIN, 1), _pair_params(SECOND, 2)
    rc = dict(carry_over=True, max_hyp_len=16, batch_size=4,
              carry_chunk_utts=2, inter_flag=flag, inter_alpha=0.7)
    nbest = _pair_nbest()
    stream = lambda k: k.split("_")[0]  # noqa: E731
    js = JaxScorer(jx.ModelConfig(**MAIN), jax.tree.map(jnp.asarray, p1),
                   jx.RescoreConfig(**rc), jx.ModelConfig(**SECOND),
                   jax.tree.map(jnp.asarray, p2))
    ref = js.score_nbest(nbest, W2I, stream_fn=stream)
    scorer = BatchScorer(bt.ModelConfig(**MAIN), p1, bt.RescoreConfig(**rc),
                         bt.ModelConfig(**SECOND), p2, device="cpu")
    assert scorer.cfg2.compute_dtype == "float32"
    got = scorer.score_nbest(nbest, W2I, stream_fn=stream)
    assert list(got) == list(ref)
    g = np.array([s for k in ref for _, s in got[k]])
    r = np.array([s for k in ref for _, s in ref[k]])
    assert np.all(np.isfinite(g))
    assert np.abs(g - r).max() <= PAIR_SHARE * np.abs(r).max()


def test_inter_path_keeps_its_checkpoint_s_compute_dtype(tmp_path):
    """``--inter_path``'s model takes the compute dtype its checkpoint's
    meta names, as the JAX CLI takes its sidecar's; a checkpoint without a
    model config takes the run's ``--compute-dtype``."""
    cfg = bt.ModelConfig(**SECOND)
    tree = bt.init_params(bt.build_model(cfg), cfg, seed=0)
    named, bare = str(tmp_path / "named.pt"), str(tmp_path / "bare.pt")
    save_checkpoint(named, tree, meta={"model_config":
                                       dataclasses.asdict(cfg)})
    save_checkpoint(bare, tree, meta=None)
    for path, want in ((named, "float32"), (bare, "bfloat16")):
        args = cli.build_parser().parse_args(
            SCORE + ["--interpolation_flag", "1", "--inter_path", path,
                     "--compute-dtype", "bfloat16", "--emsize", "24",
                     "--nhid", "24"])
        cfg2, _ = cli._inter_model(args, V)
        assert cfg2.compute_dtype == want


def test_text_nbest_is_the_bench_s_shape_from_its_seed():
    """30 recordings x 10 utterances x 20 hypotheses; hypothesis 0 the
    line clipped to 40 words, each other one 1-3 words replaced by
    vocabulary words (no special word); the same set from the same seed,
    another from another."""
    rng = np.random.default_rng(3)
    words = ["<s>", "<unk>", *(f"v{i}" for i in range(50))]
    lines = [" ".join(f"t{j}" for j in range(int(rng.integers(1, 60))))
             for _ in range(310)]
    nb = text_nbest(lines, words, seed=0)
    assert nb == text_nbest(lines, words, seed=0)
    assert nb != text_nbest(lines, words, seed=1)
    assert len(nb) == 300 and {k.split("_")[0] for k in nb} == {
        f"meet{m}" for m in range(30)}
    for i, (key, hyps) in enumerate(nb.items()):
        assert key == f"meet{i // 10}_utt{i % 10}" and len(hyps) == 20
        ref = lines[i].split()[:40]
        assert hyps[0] == " ".join(ref)
        for h in hyps[1:]:
            w = h.split()
            assert len(w) == len(ref)
            swapped = [a for a, b in zip(w, ref) if a != b]
            assert 1 <= len(swapped) <= min(3, len(ref))
            assert all(a.startswith("v") and a not in SPECIAL_WORDS
                       for a in swapped)
