"""The port's flash-attention training path (``ops/attention_train_cuda.py``,
the plain twin of kernel rows 15-17, and its route in ``ops/attention.py``)
against the JAX package on the CPU, float32 (one case bf16), same
numpy-seeded inputs.

- Rate 0: the twin against ``attention_train_pallas.flash_attention_train``
  run in interpret mode (as tests/test_pallas_kernels.py runs it), value
  and dq, dk, dv at rtol 1e-4 / atol 1e-5 (the JAX test's own tolerance
  for that kernel against XLA). In bf16 at T = 130, where the TPU's
  rounding points act: within 2^-12 of each output's largest entry, at
  most 0.1% of elements differing, and a twin that rounds p against a
  running max fails that check.
- Rate 0.25: the TPU's generator bits cannot be reproduced, so the twin's
  own keep mask is fed to the port's plain ``multihead_attention`` (as an
  injected ``dropout_mask``) and to JAX's einsum path (through a replaced
  ``jax.random.bernoulli``); values and gradients at rtol 2e-4 / atol 1e-5
  (the golden tests').
- The twin's custom backward against autograd through its own
  materialised forward (rtol 1e-5 / atol 1e-6: the same float32 products).
- The mask rule: the keep bits against a scalar Python Philox of the
  (seed, logical tile, offset) definition, bit for bit; the same bits
  across calls and across T that share the TPU's block; keep share within
  5 sigma of 0.75.
- The route and the gate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import bayeslms_tpu.ops.attention as jatt
import bayeslms_tpu.ops.attention_train_pallas as atp
from bayeslms_tpu_torch.ops import attention as tatt
from bayeslms_tpu_torch.ops import attention_train_cuda as atc

_U32 = 0xFFFFFFFF


def _arrays(rng, T, B, E, n=4):
    return [rng.normal(size=(T, B, E)).astype(np.float32) for _ in range(n)]


def _seed(s):
    return torch.tensor([s], dtype=torch.int32)


def _grads(fn, arrays, w):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("T", [16, 24, 130])
def test_twin_matches_pallas_interpret(monkeypatch, T):
    """24 and 130 pad to the TPU's block (24, 128); 130 spans two q- and
    k-blocks, so the dkv grid's accumulation across q-blocks is held too."""
    monkeypatch.setattr(atp, "_INTERPRET", pltpu.InterpretParams())
    B, E, h = 2, 32, 4
    rng = np.random.default_rng(T)
    q, k, v, w = _arrays(rng, T, B, E)
    jseed = jnp.zeros((1,), jnp.int32)

    def jloss(q, k, v):
        out = atp.flash_attention_train(q, k, v, h, 0.0, jseed)
        return jnp.sum(out * w), out

    (_, ref), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    got, tg = _grads(lambda *a: atc.flash_attention_train_plain(
        *a, h, 0.0, _seed(0)), (q, k, v), w)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-5)
    for name, a, b in zip(("dq", "dk", "dv"), tg, jg):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def _running_max_fwd(q, k, v, nhead, rate, seed, tile=64):
    """Row 15's twin with p rounded against a running max over 64-key
    tiles (and rescaled after), not against the row's final max as the TPU
    kernel rounds it: the variant the bf16 case must tell apart."""
    T, B, E = q.shape
    d, BH = E // nhead, B * nhead
    qh = atc._heads(q, nhead) * float(d) ** -0.5
    kh, vh = atc._heads(k, nhead), atc._heads(v, nhead)
    tril = torch.ones((T, T), dtype=torch.bool).tril()
    s = torch.where(tril, qh @ kh.transpose(1, 2), torch.tensor(atc._NEG))
    m = torch.full((BH, T, 1), atc._NEG)
    l, acc = torch.zeros((BH, T, 1)), torch.zeros((BH, T, d))
    for c0 in range(0, T, tile):
        st = s[:, :, c0:c0 + tile]
        mn = torch.maximum(m, st.amax(-1, keepdim=True))
        p, a = torch.exp(st - mn), torch.exp(m - mn)
        l = l * a + p.sum(-1, keepdim=True)
        acc = acc * a + p.to(q.dtype).float() @ vh[:, c0:c0 + tile]
        m = mn
    return atc._unheads(acc / l, B).to(q.dtype), m[..., 0], l[..., 0]


def test_twin_matches_pallas_interpret_bf16(monkeypatch):
    """bf16, rate 0, T = 130 (two blocks): the rounding points (z p before
    P V, dS, z P) act only in bf16. The twin's value and dq, dk, dv against
    the interpret-mode kernel: max |twin - JAX| <= 2^-12 of the largest
    |JAX| entry (a sixteenth of a bf16 step at the top of the range) and at
    most 0.1% of the elements differ at all (float32 sums in another order
    may move a rounded value one step). The same twin rounding p against a
    running max fails that check."""
    monkeypatch.setattr(atp, "_INTERPRET", pltpu.InterpretParams())
    T, B, E, h = 130, 2, 32, 4
    rng = np.random.default_rng(7)
    q, k, v, w = _arrays(rng, T, B, E)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]

    def jloss(q, k, v):
        out = atp.flash_attention_train(q, k, v, h, 0.0,
                                        jnp.zeros((1,), jnp.int32))
        return jnp.sum(out.astype(jnp.float32) * w), out

    (_, ref), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                      has_aux=True)(*bf)
    refs = [np.asarray(x.astype(jnp.float32)) for x in (ref, *jg)]

    def run():
        ts = [torch.from_numpy(a).bfloat16().requires_grad_(True)
              for a in (q, k, v)]
        out = atc.flash_attention_train_plain(*ts, h, 0.0, _seed(0))
        (out.float() * torch.from_numpy(w)).sum().backward()
        return [x.detach().float().numpy() for x in (out, *(t.grad for t
                                                           in ts))]

    def worst(gots):
        """Per output: (max error over 2^-12 max |JAX|, share differing)."""
        return {n: (float(np.abs(a - b).max() / (2.0 ** -12
                                                  * np.abs(b).max())),
                    float(np.mean(a != b)))
                for n, a, b in zip(("o", "dq", "dk", "dv"), gots, refs)}

    for n, (err, share) in worst(run()).items():
        assert err <= 1.0 and share <= 1e-3, (n, err, share)
    monkeypatch.setattr(atc, "attn_train_fwd_plain", _running_max_fwd)
    bad = worst(run())
    assert all(bad[n][0] > 1.0 and bad[n][1] > 1e-3
               for n in ("o", "dq", "dk")), bad


@pytest.mark.parametrize("T", [24, 130])
def test_twin_with_dropout_matches_plain_path_and_jax(monkeypatch, T):
    B, h, d, rate = 2, 2, 8, 0.25
    rng = np.random.default_rng(100 + T)
    q, k, v, w = _arrays(rng, T, B, h * d)
    seed = _seed(987654)
    keep = atc.keep_plain(seed, torch.arange(B * h), T, rate)
    keep = keep.reshape(B, h, T, T)
    got, tg = _grads(lambda *a: atc.flash_attention_train_plain(
        *a, h, rate, seed), (q, k, v), w)
    plain, pg = _grads(lambda *a: tatt.multihead_attention(
        *a, h, None, rate, deterministic=False, causal=True,
        dropout_mask=keep), (q, k, v), w)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(keep.numpy()))

    def jloss(q, k, v):
        out = jatt.multihead_attention(q, k, v, h, None, rate,
                                       jax.random.key(0), deterministic=False,
                                       causal=True)
        return jnp.sum(out * w), out

    (_, ref), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    for other, og in ((plain, pg), (np.asarray(ref), jg)):
        np.testing.assert_allclose(got, other, rtol=2e-4, atol=1e-5)
        for name, a, b in zip(("dq", "dk", "dv"), tg, og):
            np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4,
                                       atol=1e-5, err_msg=name)
    # dropout took effect: rate 0 differs
    nodrop = atc.flash_attention_train_plain(
        *map(torch.from_numpy, (q, k, v)), h, 0.0, seed)
    assert float((nodrop - torch.from_numpy(got)).abs().max()) > 0.1


def test_twin_backward_equals_autograd_of_its_forward():
    T, B, h, d, rate = 40, 2, 3, 8, 0.3
    rng = np.random.default_rng(5)
    q, k, v, w = _arrays(rng, T, B, h * d)
    seed = _seed(31337)
    z = atc._z(seed, torch.arange(B * h), T, rate)

    def materialised(q, k, v):
        qh, kh, vh = (atc._heads(x, h) for x in (q, k, v))
        s = (qh * d ** -0.5) @ kh.transpose(1, 2)
        s = s.masked_fill(~torch.ones((T, T), dtype=torch.bool).tril(),
                          float("-inf"))
        return atc._unheads(torch.softmax(s, -1) * z @ vh, B)

    ref, rg = _grads(materialised, (q, k, v), w)
    got, tg = _grads(lambda *a: atc.flash_attention_train_plain(
        *a, h, rate, seed), (q, k, v), w)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    for name, a, b in zip(("dq", "dk", "dv"), tg, rg):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)


def _philox_py(ctr, k0, k1):
    """Philox4x32-10 (Random123) with Python's unbounded integers."""
    c = [ctr, 0, 0, 0]
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _U32, (k1 + 0xBB67AE85) & _U32
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & _U32, (p0 >> 32) ^ c[3] ^ k1,
             p0 & _U32]
    return c


@pytest.mark.parametrize("T", [20, 130, 300])
def test_keep_bits_follow_the_tile_keyed_stream(T):
    """Element (bh, r, c) takes word e % 4 of Philox(ctr = e // 4, key =
    (seed, (bh nb + r // bq) nb + c // bq)), e = (r mod bq) bq + c mod bq,
    and is kept when its top 24 bits are below floor(0.8 2^24)."""
    seed, rate, BH = 2 ** 31 - 5, 0.2, 3
    bq = min(128, -(-T // 8) * 8)
    nb = -(-T // bq)
    thresh = int(0.8 * (1 << 24))
    keep = atc.keep_plain(_seed(seed), torch.arange(BH), T, rate)
    rng = np.random.default_rng(T)
    for bh, r, c in zip(rng.integers(0, BH, 200), rng.integers(0, T, 200),
                        rng.integers(0, T, 200)):
        tile = (int(bh) * nb + r // bq) * nb + c // bq
        e = (r % bq) * bq + c % bq
        word = _philox_py(int(e) // 4, seed, int(tile))[int(e) % 4]
        assert bool(keep[bh, r, c]) == ((word >> 8) < thresh)


def test_keep_bits_depend_on_seed_and_position_only():
    rate = 0.25
    a = atc.keep_plain(_seed(7), torch.arange(4), 24, rate)
    assert torch.equal(a, atc.keep_plain(_seed(7), torch.arange(4), 24, rate))
    # T = 20 and 24 share the block (24): the same bits where both exist
    b = atc.keep_plain(_seed(7), torch.arange(4), 20, rate)
    assert torch.equal(a[:, :20, :20], b)
    # T = 130 and 200 share the block (128) and the tile count (2)
    c = atc.keep_plain(_seed(7), torch.arange(2, 4), 130, rate)
    d = atc.keep_plain(_seed(7), torch.arange(4), 200, rate)
    assert torch.equal(c, d[2:, :130, :130])
    assert not torch.equal(a, atc.keep_plain(_seed(8), torch.arange(4), 24,
                                             rate))
    # one batch-head's bits are not another's
    assert not torch.equal(a[0], a[1])
    big = atc.keep_plain(_seed(11), torch.arange(64), 128, rate)
    n = big.numel()
    share = float(big.float().mean())
    assert abs(share - 0.75) < 5 * (0.75 * 0.25 / n) ** 0.5


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, so that the
    routing's kernel branch is reached without a card."""

    @property
    def is_cuda(self):
        return True


def _spy(monkeypatch):
    calls = []

    def spy(q, k, v, nhead, rate, seed):
        calls.append((q.shape[0], nhead, rate, seed.clone()))
        return atc.flash_attention_train_plain(q, k, v, nhead, rate, seed)

    monkeypatch.setattr(atc, "flash_attention_train", spy)
    return calls


def test_routes(monkeypatch):
    """Causal, non-deterministic, mask-free attention at T >= 1,024 on a
    CUDA tensor takes the kernels with a seed drawn from the generator
    (zeros at rate 0); CPU tensors, shorter T, an explicit mask and an
    injected dropout mask take the plain path; a gate failure on the card
    raises."""
    calls = _spy(monkeypatch)
    T, B, h, d = tatt.FLASH_TRAIN_MIN_T, 1, 2, 8
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(a) for a in _arrays(rng, T, B, h * d, 3))
    gen = torch.Generator().manual_seed(3)
    tatt.multihead_attention(q, k, v, h, None, 0.2, deterministic=False,
                             causal=True, generator=gen)
    assert calls == []  # the CPU's plain path
    card = [x.as_subclass(_OnCard) for x in (q, k, v)]
    got = tatt.multihead_attention(*card, h, None, 0.2, deterministic=False,
                                   causal=True, generator=gen)
    assert len(calls) == 1 and calls[0][:3] == (T, h, 0.2)
    seed = calls[0][3]
    assert seed.dtype == torch.int32 and seed.shape == (1,)
    assert 0 <= int(seed) < 2 ** 31 - 1
    assert got.shape == (T, B, h * d)
    tatt.multihead_attention(*card, h, None, 0.0, deterministic=False,
                             causal=True, generator=gen)
    assert int(calls[1][3]) == 0 and calls[1][2] == 0.0
    short = [x[:T - 1] for x in card]
    keep = torch.ones((B, h, T, T), dtype=torch.bool)
    tatt.multihead_attention(*short, h, None, 0.2, deterministic=False,
                             causal=True, generator=gen)
    tatt.multihead_attention(*card, h, tatt.causal_mask(T), 0.2,
                             deterministic=False, causal=True, generator=gen)
    tatt.multihead_attention(*card, h, None, 0.2, deterministic=False,
                             causal=True, dropout_mask=keep)
    assert len(calls) == 2
    odd = [x[..., :12].as_subclass(_OnCard) for x in (q, k, v)]  # d = 6
    with pytest.raises(ValueError, match="multiple of 8"):
        tatt.multihead_attention(*odd, h, None, 0.2, deterministic=False,
                                 causal=True, generator=gen)


@pytest.mark.parametrize("bayes_pos", ["none", "MHA"])
def test_both_attention_modules_reach_the_route(monkeypatch, bayes_pos):
    from bayeslms_tpu_torch.core.config import ModelConfig
    from bayeslms_tpu_torch.core.registry import build_model, init_params

    calls = _spy(monkeypatch)
    cfg = ModelConfig(model="Transformer", vocab_size=20, emsize=16, nhid=16,
                      nlayers=2, nhead=2, dropout=0.1,
                      uncertainty="none" if bayes_pos == "none"
                      else "Bayesian", t_bayes_pos=bayes_pos)
    model = build_model(cfg)
    init_params(model, cfg)
    x = torch.randn((tatt.FLASH_TRAIN_MIN_T, 1, 16)).as_subclass(_OnCard)
    gen = torch.Generator().manual_seed(0)
    for layer in model.layers:
        layer.self_attn(x, None, False, None, gen)
    assert len(calls) == cfg.nlayers


@pytest.mark.parametrize("T,E,nhead", [(1024, 512, 8), (1024, 36, 3),
                                       (8192, 64, 1), (8193, 64, 1),
                                       (1024, 512, 1), (1024, 40, 4)])
def test_gate_is_jax_gate(monkeypatch, T, E, nhead):
    """``flash_attn_train_ok`` on a CUDA tensor admits exactly the shapes
    that the JAX package's ``flash_attn_train_ok`` admits on its chip, head
    dims wider than the kernels' tiles included."""
    class Chip:
        platform = "tpu"

    monkeypatch.setattr(atp.jax, "devices", lambda *a: [Chip()])
    q = torch.zeros((T, 1, E)).as_subclass(_OnCard)
    assert atc.flash_attn_train_ok(q, nhead) == \
        atp.flash_attn_train_ok(T, E, nhead)
    assert not atc.flash_attn_train_ok(torch.zeros((T, 1, E)), nhead)


def test_wide_head_on_the_card_raises():
    """A head the kernels do not take (> 256) passes the gate, reaches rows
    15-17 and is refused there rather than computed on the plain path."""
    q = torch.zeros((tatt.FLASH_TRAIN_MIN_T, 1, 512)).as_subclass(_OnCard)
    with pytest.raises(NotImplementedError, match="head dim 512"):
        tatt.multihead_attention(q, q, q, 1, None, 0.1, deterministic=False,
                                 causal=True)
