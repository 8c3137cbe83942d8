"""The port's DARTS search (``nas/supernet.py``, ``nas/architect.py``,
``nas/search.py``) against the JAX package on the CPU, float32, from the
same weights: ``gumbel_softmax`` on injected uniforms; the four supernets'
training forwards and branch KLs with the same dropout masks and eps (the
JAX side's ``jax.random.bernoulli`` and ``gaussian.sample_diff`` hand out
draws by shape, the port's ``Draws`` takes the same); the architect's
first-order and exact second-order gradients on the arch weights and its
Adam step; ``SearchRunner.run`` against the JAX runner from the same
start; and, as tests/test_nas.py checks the JAX package, the search
result's shape, ``derive`` and ``finetune``. Tolerance rtol 2e-4 / atol
1e-5; the second-order gradient, a difference of two terms through a
double backward, atol 1e-6 on arch gradients of ~1e-3 at these sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu.nas import search as jsearch
from bayeslms_tpu.nas import supernet as jsup
from bayeslms_tpu.ops import gaussian as jgauss
from bayeslms_tpu_torch.nas import search as tsearch
from bayeslms_tpu_torch.nas.supernet import Draws, gumbel_softmax

RTOL, ATOL = 2e-4, 1e-5
V, T, B = 20, 6, 4


class TinyCorpus:
    """A periodic stream; by default 2 windows of 8 steps at batch 4, no
    ragged tail, in both splits (one compiled shape on the JAX side)."""

    def __init__(self, n=68):
        t = np.arange(n)
        self.train = ((t * 3) % (V - 2) + 1).astype(np.int32)
        self.valid = self.train[:300].copy()
        self.test = self.train[:300].copy()


def _cfg(pkg, model, dropout=0.0):
    return pkg.ModelConfig(model=model, vocab_size=V, emsize=8,
                           nhid=8 if model == "LSTM" else 16, nlayers=2,
                           nhead=2, dropout=dropout)


def _tcfg(pkg, **kw):
    return pkg.TrainConfig(**{**dict(lr=0.5, batch_size=B, epochs=1,
                                     seq_len=8, seed=0), **kw})


def _runners(model, mode, dropout=0.0, unrolled=False, **tkw):
    tr = tsearch.SearchRunner(_cfg(bt, model, dropout), _tcfg(bt, **tkw),
                              mode=mode, unrolled=unrolled, device="cpu")
    jr = jsearch.SearchRunner(_cfg(jx, model, dropout), _tcfg(jx, **tkw),
                              mode=mode, unrolled=unrolled)
    tree, arch = tr.init_params(3)
    arch = arch + 0.3 * torch.randn(arch.shape,
                                    generator=torch.Generator().manual_seed(1))
    return tr, jr, tree, arch


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


class ByShape:
    """Draws keyed by shape, shared by both packages: keep masks at rate
    0.1 and standard-normal eps."""

    def __init__(self, seed=0):
        self.rng, self.masks, self.eps = np.random.default_rng(seed), {}, {}

    def keep(self, shape):
        if shape not in self.masks:
            self.masks[shape] = self.rng.uniform(size=shape) >= 0.1
        return self.masks[shape]

    def normal(self, shape):
        if shape not in self.eps:
            self.eps[shape] = self.rng.normal(size=shape).astype(np.float32)
        return self.eps[shape]

    def inject(self, kind, shape):
        return torch.from_numpy(np.asarray(
            self.keep(shape) if kind == "keep" else self.normal(shape)))

    def install(self, monkeypatch):
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, p=0.5, shape=None:
                            jnp.asarray(self.keep(tuple(shape))))
        monkeypatch.setattr(jgauss, "sample_diff",
                            lambda key, lgstd, scale=1.0: scale * jnp.asarray(
                                self.normal(tuple(jnp.shape(lgstd))))
                            * jnp.exp(lgstd))


def test_gumbel_softmax_matches_jax_on_injected_uniforms(monkeypatch):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 4, 2)).astype(np.float32)
    u = rng.uniform(size=logits.shape).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(u))
    ref = jsup.gumbel_softmax(jnp.asarray(logits), jax.random.key(0), 5.0)
    got = gumbel_softmax(torch.from_numpy(logits), torch.from_numpy(u), 5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-6)
    drawn = gumbel_softmax(torch.from_numpy(logits),
                           generator=torch.Generator().manual_seed(0))
    assert not torch.allclose(drawn, got)


SUPERNETS = [("LSTM", "bayes"), ("LSTM", "gauss"), ("Transformer", "bayes"),
             ("Transformer", "gauss")]


@pytest.mark.parametrize("model,mode", SUPERNETS,
                         ids=[f"{m}-{d}" for m, d in SUPERNETS])
def test_supernet_forwards_and_kls_match_jax(monkeypatch, model, mode):
    """Training forward (dropout 0.1, the Bayesian branch's and the GP
    units' eps injected), the deterministic forward, the unweighted branch
    KL, and d(loss)/d(arch)."""
    tr, jr, tree, arch = _runners(model, mode, dropout=0.1)
    ref_tree, _ = jr.init_params(0)
    assert jax.tree.map(np.shape, ref_tree) == jax.tree.map(np.shape, tree)
    draws = ByShape()
    draws.install(monkeypatch)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, V, size=(T, B))
    wl = rng.normal(size=(T, B, V)).astype(np.float32)
    H = tr.cfg.nhid
    h0 = [rng.normal(size=(2, B, H)).astype(np.float32) * 0.3
          for _ in range(2)]
    jp = jax.tree.map(jnp.asarray, tree)

    def jfwd(a, det):
        args = (jnp.asarray(tokens),) if model == "Transformer" else (
            jnp.asarray(tokens), tuple(map(jnp.asarray, h0)))
        out, var = jr.model.apply(
            {"params": jp}, *args, a, deterministic=det,
            rngs={"dropout": jax.random.key(0), "sample": jax.random.key(1)},
            mutable=["losses"])
        logits = out if model == "Transformer" else out[0]
        kl = sum(jax.tree.leaves(var["losses"]))
        return jnp.sum(logits * wl) + kl, (logits, kl)

    (_, (ref, rkl)), rg = jax.jit(jax.value_and_grad(
        lambda a: jfwd(a, False), has_aux=True))(jnp.asarray(arch.numpy()))
    ta = arch.clone().requires_grad_(True)
    args = (torch.from_numpy(tokens),) if model == "Transformer" else (
        torch.from_numpy(tokens), tuple(map(torch.from_numpy, h0)))
    out = tr.model(*args, ta, deterministic=False,
                   draws=Draws(inject=draws.inject))
    logits, kl = out[0], out[-1]
    (torch.sum(logits * torch.from_numpy(wl)) + kl).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(kl.detach()), float(rkl), rtol=RTOL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(rg), rtol=RTOL,
                               atol=ATOL)
    (_, (dref, _)) = jax.jit(lambda a: jfwd(a, True))(
        jnp.asarray(arch.numpy()))
    with torch.no_grad():
        dout = tr.model(*args, arch)
    np.testing.assert_allclose(dout[0].numpy(), np.asarray(dref), rtol=RTOL,
                               atol=ATOL)


ARCHITECT = [("LSTM", "bayes", False), ("LSTM", "bayes", True),
             ("LSTM", "gauss", False), ("Transformer", "bayes", False),
             ("Transformer", "bayes", True), ("Transformer", "gauss", True)]


@pytest.mark.parametrize("model,mode,unrolled", ARCHITECT,
                         ids=[f"{m}-{d}-{'2nd' if u else '1st'}"
                              for m, d, u in ARCHITECT])
def test_architect_matches_jax(monkeypatch, model, mode, unrolled):
    """The arch gradient (first order: the validation gradient; second
    order: the unrolled step's validation gradient less eta x the raw clip
    coefficient x the exact mixed second derivative) and one Adam step, on
    a training window with a carried state and a validation window of
    another length."""
    tr, jr, tree, arch = _runners(model, mode, dropout=0.1,
                                  unrolled=unrolled)
    draws = ByShape(1)
    draws.install(monkeypatch)
    rng = np.random.default_rng(6)
    H = tr.cfg.nhid
    d, t = (rng.integers(0, V, size=(T, B)) for _ in range(2))
    vd, vt = (rng.integers(0, V, size=(T - 2, B)) for _ in range(2))
    h = rng.normal(size=(2, B, H)).astype(np.float32) * 0.3
    hidden = (h, np.zeros_like(h))
    zeros = (np.zeros_like(h), np.zeros_like(h))
    kl_scale = 0.05

    def batches(conv, hconv):
        return ((conv(d), conv(t), hconv(hidden), kl_scale),
                (conv(vd), conv(vt), hconv(zeros), kl_scale))

    jtb, jvb = batches(jnp.asarray, lambda s: tuple(map(jnp.asarray, s)))
    ttb, tvb = batches(lambda a: torch.from_numpy(a).long(),
                       lambda s: tuple(map(torch.from_numpy, s)))
    rngs = {"dropout": jax.random.key(0), "sample": jax.random.key(1)}
    jp = jax.tree.map(jnp.asarray, tree)
    ja = jnp.asarray(arch.numpy())
    ref = jax.jit(jr.architect._arch_grad)(jp, ja, jtb, jvb, rngs)
    tdraws = Draws(inject=draws.inject)
    got = tr.architect.arch_grad(tr.params(), arch, ttb, tvb, tdraws)
    atol = 1e-6 if unrolled else ATOL
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=atol)
    # one Adam step of the JAX architect's optimizer on its own gradient
    upd, _ = jr.architect.opt.update(ref, jr.architect.opt.init(ja), ja)
    ts = tr.architect.step(tr.architect.init(arch), tr.params(), ttb, tvb,
                           tdraws)
    np.testing.assert_allclose(ts.arch.numpy(), np.asarray(ja + upd),
                               rtol=RTOL, atol=1e-7)
    assert not torch.equal(ts.arch, arch)


@pytest.mark.parametrize("unrolled", [False, True], ids=["1st", "2nd"])
def test_search_run_matches_jax(unrolled):
    """One epoch of the LSTM ``bayes`` search at dropout 0 (no draws: the
    branch runs at its posterior mean) from the same start: the unaligned
    validation windows, both hiddens zeroed per epoch, the weight step's
    weight decay; arch softmax, loss and every weight."""
    tr, jr, tree, arch = _runners("LSTM", "bayes", unrolled=unrolled)
    corpus = TinyCorpus()
    ref = jr.run(corpus, log=lambda *a: None,
                 init=(jax.tree.map(jnp.asarray, tree),
                       jnp.asarray(arch.numpy())))
    got = tr.run(corpus, log=lambda *a: None, init=(tree, arch))
    np.testing.assert_allclose(got.arch_softmax, ref.arch_softmax,
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got.history[0]["loss"],
                               ref.history[0]["loss"], rtol=RTOL)
    np.testing.assert_array_equal(got.derived_choice, ref.derived_choice)


@pytest.mark.parametrize("model,mode", SUPERNETS,
                         ids=[f"{m}-{d}" for m, d in SUPERNETS])
def test_search_runs_and_moves_the_arch_weights(model, mode):
    """tests/test_nas.py's checks on the port: the softmax decision matrix
    (nlayers, slots, 2) sums to one and has moved off the near-uniform
    start."""
    tr = tsearch.SearchRunner(_cfg(bt, model), _tcfg(bt), mode=mode,
                              unrolled=mode == "bayes", device="cpu")
    res = tr.run(TinyCorpus(), log=lambda *a: None)
    slots = 1 if model == "Transformer" else 4
    assert res.arch_softmax.shape == (2, slots, 2)
    np.testing.assert_allclose(res.arch_softmax.sum(-1), 1.0, rtol=1e-5)
    assert np.abs(res.arch_softmax - 0.5).max() > 1e-4
    assert len(res.history) == 1 and np.isfinite(res.history[0]["loss"])


def test_derive_and_finetune():
    """derive() hard-selects the argmax branches (exactly one-hot in
    float32, as the JAX package's), and finetune() trains that fixed
    architecture: its loss falls on the periodic stream."""
    tr = tsearch.SearchRunner(_cfg(bt, "LSTM"), _tcfg(bt), device="cpu")
    res = tr.run(TinyCorpus(), log=lambda *a: None)
    assert res.derived_choice.shape == (2, 4)
    hard = tsearch.SearchRunner.derive(res.arch_softmax)
    np.testing.assert_array_equal(
        hard.numpy(), np.asarray(jsearch.SearchRunner.derive(
            res.arch_softmax)))
    w = torch.softmax(hard, dim=-1)
    np.testing.assert_array_equal(w.argmax(-1).numpy(), res.derived_choice)
    np.testing.assert_allclose(w.max(-1).values.numpy(), 1.0)
    params, _ = tr.init_params(0)
    params, losses = tr.finetune(params, hard, TinyCorpus(900), steps=30)
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert set(_flat(params)) == {k for k, _ in tr.model.named_parameters()}


def test_search_runner_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsearch.SearchRunner(_cfg(bt, "LSTM"), _tcfg(bt))
