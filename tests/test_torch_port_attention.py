"""The port's attention (``ops/attention.py``, ``ops/attention_cuda.py``)
against the JAX package on the CPU, float32, same numpy-seeded inputs: the
plain twin of kernel row 14 against ``causal_attention_pallas`` in
interpret mode (as tests/test_pallas_kernels.py runs it), and
``multihead_attention`` with a packed scorer's mask and with injected
dropout masks against the JAX einsum path. Tolerance rtol 2e-4 / atol 1e-5
(the golden tests'); the twin against Pallas 1e-5 / 1e-6 (the same
float32 arithmetic in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslms_tpu.ops.attention as jatt
import bayeslms_tpu.ops.attention_pallas as ap
from bayeslms_tpu_torch.ops import attention as tatt
from bayeslms_tpu_torch.ops import attention_cuda

RTOL, ATOL = 2e-4, 1e-5


def _qkv(rng, T, B, E):
    return [rng.normal(size=(T, B, E)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("T", [8, 100, 130])
def test_attention_twin_matches_pallas_interpret(monkeypatch, T, d):
    """T = 100 and 130 are off the 128-row query block (the TPU pads them;
    the twin and the kernel mask the ragged edge), d = 32 is the in-repo
    checkpoints' head (128 / 4), d = 64 the recipe's (512 / 8)."""
    monkeypatch.setattr(ap, "_INTERPRET", True)
    h, B = 2, 3
    rng = np.random.default_rng(T + d)
    q, k, v = _qkv(rng, T, B, h * d)
    ref = ap.causal_attention_pallas(*map(jnp.asarray, (q, k, v)), h)
    got = attention_cuda.causal_attention(*map(torch.from_numpy, (q, k, v)),
                                          h)
    assert got.dtype == torch.float32 and got.shape == (T, B, h * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def _split_pv(p, v):
    """Row 14's wgmma P V (csrc/attention_fwd.cu): float32 p split into
    P_hi = bf16(p) and P_lo = bf16(p - P_hi), both products of bf16 values
    summed in float32 (the tensor cores' products of bf16 values are
    exact)."""
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    return hi @ v + lo @ v


@pytest.mark.parametrize("keys", [64, 100, 1024])
def test_row14_split_p_keeps_fp32_precision(keys):
    """P V with P split in two bf16 halves lies within 2^-16 of float64's
    sum_c p_c |v_c| (P itself within 2^-16 of p: bf16's half-ulp 2^-8 of
    2^-8); P rounded to bf16 alone does not: the reason the wgmma design
    runs two products."""
    rng = np.random.default_rng(keys)
    s = rng.normal(scale=3.0, size=(64, keys))
    p = torch.from_numpy(np.exp(s - s.max(axis=1, keepdims=True))).float()
    v = torch.from_numpy(rng.normal(size=(keys, 64))).to(torch.bfloat16)
    exact = p.double() @ v.double()
    scale = p.double() @ v.double().abs()
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    assert bool(((hi.double() + lo.double() - p.double()).abs()
                 <= 2 ** -16 * p.double()).all())
    split = _split_pv(p, v.float()).double()
    assert float(((split - exact).abs() / scale).max()) <= 2 ** -16
    single = (hi @ v.float()).double()
    assert float(((single - exact).abs() / scale).max()) > 2 ** -12


def test_attention_twin_keeps_the_input_dtype():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(rng, 9, 2, 16))
    got = attention_cuda.causal_attention_plain(q, k, v, 2)
    ref = attention_cuda.causal_attention_plain(q.float(), k.float(),
                                                v.float(), 2)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref, rtol=2 ** -7, atol=1e-6)


def test_causal_mask_and_positional_encoding_match_jax():
    np.testing.assert_array_equal(tatt.causal_mask(7).numpy(),
                                  np.asarray(jatt.causal_mask(7)))
    np.testing.assert_allclose(
        tatt.sinusoidal_positional_encoding(300, 24).numpy(),
        np.asarray(jatt.sinusoidal_positional_encoding(300, 24)),
        rtol=RTOL, atol=ATOL)


def _pack_mask(rng, B, T):
    """The packed scorer's (B, 1, T, T) mask: causal within segments."""
    seg = np.sort(rng.integers(0, 3, size=(B, T)), axis=1)
    same = seg[:, :, None] == seg[:, None, :]
    valid = (same & np.tril(np.ones((T, T), bool))) | np.eye(T, dtype=bool)
    return np.where(valid, 0.0, -np.inf).astype(np.float32)[:, None]


@pytest.mark.parametrize("masked", ["causal", "pack"])
def test_multihead_attention_matches_jax(masked):
    T, B, h, d = 11, 3, 2, 8
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, T, B, h * d)
    mask = None if masked == "causal" else _pack_mask(rng, B, T)
    ref = jatt.multihead_attention(*map(jnp.asarray, (q, k, v)), h,
                                   None if mask is None else jnp.asarray(mask),
                                   causal=True)
    got = tatt.multihead_attention(*map(torch.from_numpy, (q, k, v)), h,
                                   None if mask is None
                                   else torch.from_numpy(mask), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_multihead_attention_with_injected_dropout_matches_jax(monkeypatch):
    """Training: the JAX path's ``jax.random.bernoulli`` hands out the same
    keep mask that the port takes injected; values and the gradients of
    q, k and v."""
    T, B, h, d, rate = 9, 2, 2, 8, 0.3
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, T, B, h * d)
    keep = rng.uniform(size=(B, h, T, T)) >= rate
    w = rng.normal(size=(T, B, h * d)).astype(np.float32)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(keep))

    def jloss(q, k, v):
        out = jatt.multihead_attention(q, k, v, h, None, rate,
                                       jax.random.key(0), deterministic=False,
                                       causal=True)
        return jnp.sum(out * w), out

    (_, ref), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                      has_aux=True)(*map(jnp.asarray,
                                                         (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = tatt.multihead_attention(tq, tk, tv, h, None, rate,
                                   deterministic=False, causal=True,
                                   dropout_mask=torch.from_numpy(keep))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    for a, b in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    # drawn masks: about rate of the probabilities dropped
    gen = torch.Generator().manual_seed(0)
    drawn = tatt.multihead_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.ones((T, B, h * d)),
        h, None, rate, deterministic=False, causal=True, generator=gen)
    assert float(drawn.std()) > 0.01


def test_routes(monkeypatch):
    """Row 14 takes causal, deterministic, mask-free calls that
    ``attention_ok`` admits (a CUDA tensor on the card); an explicit mask
    and training take the plain path; CPU tensors never reach the gate's
    kernel branch."""
    calls = []
    real = attention_cuda.causal_attention

    def spy(*a):
        calls.append(a[3])
        return real(*a)

    monkeypatch.setattr(attention_cuda, "causal_attention", spy)
    rng = np.random.default_rng(4)
    q, k, v = map(torch.from_numpy, _qkv(rng, 6, 2, 16))
    assert not attention_cuda.attention_ok(q, 2)  # a CPU tensor
    tatt.multihead_attention(q, k, v, 2, causal=True)
    assert calls == []
    monkeypatch.setattr(attention_cuda, "attention_ok", lambda q, h: True)
    ref = tatt.multihead_attention(q, k, v, 2, tatt.causal_mask(6),
                                   causal=True)
    tatt.multihead_attention(q, k, v, 2, causal=True, deterministic=False)
    assert calls == []
    got = tatt.multihead_attention(q, k, v, 2, causal=True)
    assert calls == [2]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, so that the
    routing's kernel branch is reached without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("T,E,nhead", [(100, 512, 8), (100, 512, 1),
                                       (100, 36, 3), (8192, 64, 1),
                                       (8193, 64, 1)])
def test_gate_is_jax_gate(monkeypatch, T, E, nhead):
    """``attention_ok`` on a CUDA tensor admits exactly the shapes that the
    JAX package's ``pallas_attention_ok`` admits on its chip, head dims
    wider than the kernel's tiles included."""
    class Chip:
        platform = "tpu"

    monkeypatch.setattr(ap.jax, "devices", lambda *a: [Chip()])
    q = torch.zeros((T, 1, E)).as_subclass(_OnCard)
    assert attention_cuda.attention_ok(q, nhead) == \
        ap.pallas_attention_ok(T, E, nhead)


def test_wide_head_on_the_card_raises():
    """A causal, deterministic, mask-free call with a head dim the kernel
    does not take (> 256) goes to row 14, as in JAX, and is refused there
    rather than computed on the plain path."""
    q = torch.zeros((4, 1, 512)).as_subclass(_OnCard)
    with pytest.raises(NotImplementedError, match="head dim 512"):
        tatt.multihead_attention(q, q, q, 1, causal=True)
