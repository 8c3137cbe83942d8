"""The Bayesian sample-and-matmul's designs (kernel row 12,
``csrc/bayes_matmul.cu``) on the CPU.

- The rule ``_design(dtype, M, N, K)``: "split" for bf16 x, with its grid
  of 128 x 104 tiles filling most of the H100's 132 SMs at the Bayesian
  FFN's linear2 and the MHA's o_net shapes; "simt" for float32 x.
- The split: W1 + W2 + W3 == W bit for bit over the twin's W
  (``sample_weights_plain``), for several seeds and lgstd ranges, and
  sum_i x Wi^T from bf16 x equals the float32 product to float32 rounding
  (each x Wi product exact in float32)."""

import numpy as np
import pytest
import torch

from bayeslms_tpu_torch.ops import bayes_matmul_cuda as bmc
from bayeslms_tpu_torch.ops import bayes_sample_cuda as bsc

N_SM = 132  # the H100 SXM's SMs

# (M, N, K): the Bayesian FFN's linear2 and the MHA's o_net in the
# recipe's Transformer (emsize 512, nhid 4,096) at a step's 3,200 tokens
FFN_LINEAR2, MHA_O_NET = (3200, 512, 4096), (3200, 512, 512)


@pytest.mark.parametrize("shape", [FFN_LINEAR2, MHA_O_NET])
def test_split_fills_the_card_at_the_main_path_shapes(shape):
    plan = bmc._design(torch.bfloat16, *shape, n_sm=N_SM)
    assert plan["design"] == "split" and plan["launches"] == 2
    assert plan["grid"] == (5, 25) and plan["ctas"] == 125
    # one wave: 128-column tiles would give 100 CTAs, 0.76 of a wave
    assert 0.9 < plan["waves"] <= 1.0
    M, N, _ = shape
    assert -(-N // 128) * -(-M // 128) / N_SM < 0.8


@pytest.mark.parametrize("M,N,K", [(8, 128, 128), (37, 256, 384),
                                   FFN_LINEAR2])
def test_the_rule_takes_split_for_bf16_and_simt_for_float32(M, N, K):
    split = bmc._design(torch.bfloat16, M, N, K)
    simt = bmc._design(torch.float32, M, N, K)
    assert split["design"] == "split" and simt["design"] == "simt"
    assert split["grid"] == (-(-N // 104), -(-M // 128))
    assert simt["grid"] == (-(-M // 128), N // 64)
    assert simt["launches"] == 1


def _weights(seed, N, K, lg_lo, lg_hi, mean_scale):
    rng = np.random.default_rng(seed)
    mean = torch.from_numpy((rng.normal(size=(N, K)) * mean_scale)
                            .astype(np.float32))
    lgstd = torch.from_numpy(rng.uniform(lg_lo, lg_hi, size=(N, K))
                             .astype(np.float32))
    return bsc.sample_weights_plain(mean, lgstd, torch.tensor(
        [seed * 7919 + 1], dtype=torch.int32))


@pytest.mark.parametrize("seed,lg_lo,lg_hi,mean_scale", [
    (0, -4.0, -2.0, 0.1), (1, -10.0, -6.0, 0.01), (2, -2.0, 1.0, 1.0),
    (3, 0.0, 3.0, 50.0), (4, -20.0, -16.0, 1e-4)])
def test_three_pieces_sum_to_w_bit_for_bit(seed, lg_lo, lg_hi, mean_scale):
    w = _weights(seed, 128, 256, lg_lo, lg_hi, mean_scale)
    w1, w2, w3 = bmc.split_weights(w)
    assert all(p.dtype == torch.bfloat16 for p in (w1, w2, w3))
    assert torch.equal((w1.float() + w2.float()) + w3.float(), w)
    # each piece is at most 2^-8 of the one before it
    nz = w1 != 0
    assert bool((w2.float().abs()[nz] <= 2 ** -8 * w1.float().abs()[nz]).all())


def test_products_of_the_pieces_are_exact_in_float32():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(6, 64)).astype(np.float32)) \
        .to(torch.bfloat16)
    w = _weights(5, 128, 64, -4.0, 0.0, 0.3)
    for piece in bmc.split_weights(w):
        prod32 = x.float()[:, None, :] * piece.float()[None]
        prod64 = x.double()[:, None, :] * piece.double()[None]
        assert torch.equal(prod32.double(), prod64)


@pytest.mark.parametrize("M,N,K", [(16, 128, 512), (5, 256, 4096)])
def test_split_product_equals_the_float32_product_to_its_rounding(M, N, K):
    rng = np.random.default_rng(M + K)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)) \
        .to(torch.bfloat16)
    w = _weights(M, N, K, -4.0, -1.0, 0.1)
    exact = x.double() @ w.double().t()
    split = sum(x.float() @ p.float().t() for p in bmc.split_weights(w))
    fp32 = x.float() @ w.t()
    # float32 sums of K terms: |error| <= K 2^-24 sum_k |x_k w_k| (a
    # generous bound of the recursive sum's); the split's three sums and
    # the two additions of their results stay inside the same bound
    bound = K * 2.0 ** -24 * (x.double().abs() @ w.double().abs().t())
    assert bool(((fp32.double() - exact).abs() <= bound).all())
    assert bool(((split.double() - exact).abs() <= bound).all())
    # and the two agree as closely as two float32 orders of one sum do
    scale = float(exact.abs().max())
    assert float((split - fp32).abs().max()) <= 2 ** -16 * scale
