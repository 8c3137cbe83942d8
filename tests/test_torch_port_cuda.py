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
