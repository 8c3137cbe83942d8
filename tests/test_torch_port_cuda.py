"""The port's CUDA kernels against their plain versions on the card, at
small shapes with ragged edges. Marked ``cuda``: skipped without a card and
nvcc; on the card (which has no JAX, imported by tests/conftest.py),
``python -m pytest --noconftest tests/test_torch_port_cuda.py -q``.
chip_smoke.py checks the same kernels at the main path's shapes."""

import pytest
import torch

from bayeslms_tpu_torch.ops import _build, ce_cuda, lstm_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        _build._nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda")


def test_lstm2_kernel_matches_plain(dev):
    g = torch.Generator().manual_seed(0)
    T, B, H = 9, 70, 64  # B off the 64-column tile
    r = lambda *s, sc=1.0: ((torch.rand(s, generator=g) * 2 - 1) * sc)  # noqa: E731
    bf = torch.bfloat16
    args = [r(T, B, 4 * H).to(dev, bf)]
    args += [r(4 * H, H, sc=0.125).to(dev, bf), r(4 * H, sc=0.1).to(dev)]
    args += [r(4 * H, H, sc=0.125).to(dev, bf), r(4 * H, H, sc=0.125).to(dev, bf),
             r(4 * H, sc=0.1).to(dev)]
    args += [r(B, H, sc=0.5).to(dev, bf) for _ in range(4)]
    mask = (torch.rand((T, B), generator=g) < 0.8).to(dev, torch.uint8)
    reset = (torch.rand((T, B), generator=g) < 0.2).to(dev, torch.uint8)
    src = ((torch.arange(B) // 10) * 10).to(torch.int32)
    src[::9] = -1
    args += [mask, reset, src.to(dev)]
    before = lstm_cuda.launches
    got = lstm_cuda.lstm2_fwd(*args)
    ref = lstm_cuda.lstm2_plain(*args)
    assert lstm_cuda.launches == before + 1
    for a, b in zip((got[0], *got[1], *got[2]), (ref[0], *ref[1], *ref[2])):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=2 ** -6)


@pytest.mark.parametrize("M,V", [(1, 1), (300, 1000), (129, 4097)])
def test_ce_kernel_matches_plain(dev, M, V):
    g = torch.Generator().manual_seed(M)
    D = 96
    h = (torch.rand((M, D), generator=g) * 2 - 1).to(dev, torch.bfloat16)
    emb = ((torch.rand((V, D), generator=g) * 2 - 1) * 0.3).to(dev, torch.bfloat16)
    bias = (torch.rand((V,), generator=g) * 0.2).to(dev)
    tgt = torch.randint(0, V, (M,), generator=g).to(dev)
    got = ce_cuda.fused_decode_ce(h, emb, bias, tgt)
    ref = ce_cuda.ce_plain(h, emb, bias, tgt)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    h = torch.zeros((4, 24), device=dev, dtype=torch.bfloat16)  # D % 32 != 0
    with pytest.raises(ValueError):
        ce_cuda.fused_decode_ce(h, torch.zeros((5, 24), device=dev),
                                torch.zeros(5, device=dev),
                                torch.zeros(4, dtype=torch.long, device=dev))
    with pytest.raises(ValueError):
        ce_cuda.fused_decode_ce(h.float(), torch.zeros((5, 24), device=dev),
                                torch.zeros(5, device=dev),
                                torch.zeros(4, dtype=torch.long, device=dev))


def _lstm_train_args(dev, T, B, H, masked, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: ((torch.rand(s, generator=g) * 2 - 1) * sc)  # noqa: E731
    bf = torch.bfloat16
    xg = r(T, B, 4 * H).to(dev, bf)
    w_hh = r(4 * H, H, sc=0.125).to(dev, bf)
    b_hh = r(4 * H, sc=0.1).to(dev)
    mask = None
    if masked:
        mask = (torch.rand((T, B), generator=g) < 0.8).to(dev, torch.uint8)
    h0, c0 = (r(B, H, sc=0.5).to(dev, bf) for _ in range(2))
    return xg, w_hh, b_hh, mask, h0, c0


def _close(got, ref, rtol):
    """Elementwise |got - ref| <= 2^-12 max|ref| + rtol |ref|: a rounding
    step or two of bf16 either way, not more."""
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=float(ref.float().abs().max()) * 2 ** -12
                               + 1e-30)


@pytest.mark.parametrize("masked", [False, True])
def test_lstm_train_kernels_match_plain(dev, masked):
    from bayeslms_tpu_torch.ops import lstm_train_cuda as ltc

    T, B, H = 9, 37, 64  # B off the 32-column tile
    args = _lstm_train_args(dev, T, B, H, masked)
    before = dict(ltc.launches)
    got = ltc.lstm_train_fwd(*args)
    ref = ltc.lstm_train_fwd_plain(*args)
    assert ltc.launches["lstm_train_fwd"] == before["lstm_train_fwd"] + 1
    for a, b in zip(got, ref):
        assert a.dtype == torch.bfloat16
        _close(a, b, 2 ** -6)
    g = torch.Generator().manual_seed(1)
    dy = (torch.rand((T, B, H), generator=g) * 2 - 1).to(dev, torch.bfloat16)
    dhT, dcT = ((torch.rand((B, H), generator=g) * 2 - 1).to(dev, torch.bfloat16)
                for _ in range(2))
    ys, cs = ref[0], ref[1]
    got = ltc.lstm_train_bwd(*args, ys, cs, dy, dhT, dcT)
    ref = ltc.lstm_train_bwd_plain(*args, ys, cs, dy, dhT, dcT)
    assert ltc.launches["lstm_train_bwd"] == before["lstm_train_bwd"] + 1
    for a, b in zip(got, ref):
        assert a.dtype == torch.bfloat16
        _close(a, b, 2 ** -6)


@pytest.mark.parametrize("M,V", [(1, 1), (300, 1000), (129, 4097)])
def test_ce_train_kernels_match_plain(dev, M, V):
    from bayeslms_tpu_torch.ops import ce_train_cuda as ctc

    g = torch.Generator().manual_seed(M)
    D = 256
    h = (torch.rand((M, D), generator=g) * 2 - 1).to(dev, torch.bfloat16)
    emb = ((torch.rand((V, D), generator=g) * 2 - 1) * 0.3).to(dev, torch.bfloat16)
    bias = (torch.rand((V,), generator=g) * 0.2).to(dev)
    tgt = torch.randint(0, V, (M,), generator=g).to(dev)
    ce, mx, se = ctc.ce_train_fwd(h, emb, bias, tgt)
    rce, rmx, rse = ctc.ce_train_fwd_plain(h, emb, bias, tgt)
    torch.testing.assert_close(ce, rce, rtol=0, atol=1e-4)
    torch.testing.assert_close(mx, rmx, rtol=0, atol=1e-5)
    torch.testing.assert_close(se, rse, rtol=1e-5, atol=0)
    a = (torch.rand((M,), generator=g) + 0.5).to(dev) / M
    b = -a
    # each side with its own statistics, as the autograd Function runs it
    dh = ctc.ce_train_dh(h, emb, bias, tgt, mx, se, a, b)
    _close(dh, ctc.ce_train_dh_plain(h, emb, bias, tgt, rmx, rse, a, b),
           2 ** -6)
    de, db = ctc.ce_train_de(h, emb, bias, tgt, mx, se, a, b)
    rde, rdb = ctc.ce_train_de_plain(h, emb, bias, tgt, rmx, rse, a, b)
    _close(de, rde, 2 ** -6)
    torch.testing.assert_close(db, rdb, rtol=1e-4, atol=1e-6 / M)


def test_train_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from bayeslms_tpu_torch.ops import ce_train_cuda as ctc
    from bayeslms_tpu_torch.ops import lstm_train_cuda as ltc

    args = list(_lstm_train_args(dev, 3, 4, 48, False))  # H % 32 != 0
    with pytest.raises(ValueError):
        ltc.lstm_train_fwd(*args)
    args = list(_lstm_train_args(dev, 3, 4, 32, False))
    args[0] = args[0].float()
    with pytest.raises(ValueError):
        ltc.lstm_train_fwd(*args)
    h = torch.zeros((4, 128), device=dev, dtype=torch.bfloat16)  # D % 256
    with pytest.raises(ValueError):
        ctc.ce_train_fwd(h, torch.zeros((5, 128), device=dev),
                         torch.zeros(5, device=dev),
                         torch.zeros(4, dtype=torch.long, device=dev))
