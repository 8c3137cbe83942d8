"""The port's CUDA kernels against their plain versions on the card, at
small shapes with ragged edges. Marked ``cuda``: skipped without a card and
nvcc; on the card (which has no JAX, imported by tests/conftest.py),
``python -m pytest --noconftest tests/test_torch_port_cuda.py -q``.
chip_smoke.py checks the same kernels at the main path's shapes."""

import pytest
import torch

from bayeslms_tpu_torch.ops import _build, bayes_sample_cuda, ce_cuda, lstm_cuda

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


# eps = sqrt(-2 log u1) cos(2 pi u2) <= 7.5 from bit-equal uniforms; the
# library's log, cos (and, for a sample, exp) may differ by an ulp or two
# between the kernel and torch: 8 ulps at [4, 8) for eps, and 2^-21 of the
# sample's own magnitude for the exp
EPS_ATOL = 8 * 2.0 ** -21


@pytest.mark.parametrize("shape", [(256, 384), (1024, 1024)])
def test_sampler_kernel_matches_plain(dev, shape):
    g = torch.Generator().manual_seed(shape[1])
    lg = (torch.rand(shape, generator=g) * 3 - 3).to(dev)
    mean = torch.randn(shape, generator=g).to(dev)
    seed = torch.tensor([2 ** 31 - 3], dtype=torch.int32, device=dev)
    before = bayes_sample_cuda.launches
    noise, u1, u2 = bayes_sample_cuda.sample_uniforms(lg, seed)
    p1, p2 = bayes_sample_cuda.uniforms_plain(seed, shape)
    assert torch.equal(u1, p1) and torch.equal(u2, p2)  # bit for bit
    eps = bayes_sample_cuda.normal_plain(seed, shape)
    ref = torch.exp(lg) * eps
    assert float(((noise - ref).abs() - EPS_ATOL * torch.exp(lg)
                  - 2.0 ** -21 * ref.abs()).max()) <= 0
    got = bayes_sample_cuda.sample_weights(mean, lg, seed)
    torch.testing.assert_close(
        got, bayes_sample_cuda.sample_weights_plain(mean, lg, seed),
        rtol=2.0 ** -21, atol=EPS_ATOL * float(torch.exp(lg).max()))
    assert bayes_sample_cuda.launches == before + 2
    # the same seed draws the same bits; the gradient is the noise
    lgr = lg.clone().requires_grad_(True)
    n = bayes_sample_cuda.sample_noise(lgr, seed)
    assert torch.equal(n.detach(), noise)
    (n * 3.0).sum().backward()
    assert torch.equal(lgr.grad, noise * 3.0)


def test_sampler_refuses_what_the_kernel_does_not_take(dev):
    seed = torch.zeros((1,), dtype=torch.int32, device=dev)
    for lg, sd in ((torch.zeros((3, 5), device=dev), seed),
                   (torch.zeros((4, 4), device=dev, dtype=torch.bfloat16), seed),
                   (torch.zeros((4, 4), device=dev), seed.cpu()),
                   (torch.zeros((4, 4), device=dev), seed.long())):
        with pytest.raises(ValueError):
            bayes_sample_cuda.sample_weights(None, lg, sd)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,d", [(1, 32), (100, 64), (130, 32), (257, 128)])
def test_attention_kernel_matches_plain(dev, T, d, dtype):
    """Ragged T (off the 64-row tiles), the qkv projection's column views
    read in place; bf16 outputs within a rounding step of the fp32 twin."""
    from bayeslms_tpu_torch.ops import attention_cuda

    g = torch.Generator().manual_seed(T + d)
    h, B = 3, 5
    qkv = (torch.randn((T, B, 3 * h * d), generator=g)).to(dev, dtype)
    q, k, v = qkv.split(h * d, dim=-1)
    before = attention_cuda.launches
    got = attention_cuda.causal_attention(q, k, v, h)
    assert attention_cuda.launches == before + 1
    ref = attention_cuda.causal_attention_plain(q, k, v, h)
    assert got.dtype == dtype and got.shape == (T, B, h * d)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), ref.float(), rtol=2 ** -7,
                                   atol=2 ** -12)
    else:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,N,K", [(8, 128, 128), (37, 256, 384)])
def test_bayes_matmul_kernel_matches_plain(dev, M, N, K, dtype):
    """The fused forward against x W^T with W from the sampler kernel (the
    same Philox stream, so the same W bit for bit) and against the twin;
    the backward draws W again with the sampler."""
    from bayeslms_tpu_torch.ops import bayes_matmul_cuda as bmc

    g = torch.Generator().manual_seed(M)
    x = torch.randn((M, K), generator=g).to(dev, dtype)
    mean = (torch.randn((N, K), generator=g) * 0.1).to(dev)
    lg = (torch.rand((N, K), generator=g) * 2 - 4).to(dev)
    seed = torch.tensor([12345], dtype=torch.int32, device=dev)
    before = bmc.launches
    got = bmc.bayes_matmul_fwd(x, mean, lg, seed)
    assert bmc.launches == before + 1 and got.dtype == dtype
    w = bayes_sample_cuda.sample_weights(mean, lg, seed)
    ref = (x.float() @ w.t()).to(dtype)
    tol = dict(rtol=2 ** -7, atol=2 ** -10) if dtype == torch.bfloat16 \
        else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    torch.testing.assert_close(
        got.float(), bmc.bayes_matmul_plain(x, mean, lg, seed).float(), **tol)
    xr, mr, lr = (t.clone().requires_grad_(True) for t in (x, mean, lg))
    y = bmc.bayes_matmul(xr, mr, lr, seed)
    gy = torch.randn(y.shape, generator=g).to(dev, dtype)
    (y.float() * gy.float()).sum().backward()
    dw = gy.float().t() @ x.float()
    torch.testing.assert_close(lr.grad, dw * (w - mean), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(mr.grad, dw, rtol=1e-5, atol=1e-5)


def _within(got, ref, rtol, share):
    """Elementwise |got - ref| <= rtol |ref| + share max|ref| + 1e-6: the
    floor for outputs that vanish (at T = 1, dq = dk = 0 up to the
    rounding of dS = P (dP - delta), ~1e-7 from unit inputs)."""
    ref = ref.detach().float()
    torch.testing.assert_close(got.detach().float(), ref, rtol=rtol,
                               atol=float(ref.abs().max()) * share + 1e-6)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,d", [(1, 32), (24, 32), (130, 64), (257, 128),
                                 (70, 256)])
def test_attention_train_kernels_match_plain(dev, T, d, dtype, rate):
    """Rows 15-17 against their twins: ragged T (off the 64- and 32-row
    tiles and the TPU's 128 block), the qkv projection's column views read
    in place, each backward kernel on the twin's (m, l, delta); the keep
    bits each kernel draws equal the twin's bit for bit; the autograd
    Function against the twins' Function. bf16: a rounded summand (z p,
    dS) one bf16 step the other way, times its partner (unit-scale
    inputs here, where chip_smoke.py's are the step's): 2^-6 of a value
    and 2^-8 of the largest; float32: sums in another order."""
    from bayeslms_tpu_torch.ops import attention_train_cuda as atc

    g = torch.Generator().manual_seed(T + d)
    h, B = 3, 2
    qkv = torch.randn((T, B, 3 * h * d), generator=g).to(dev, dtype)
    q, k, v = qkv.split(h * d, dim=-1)
    go = torch.randn((T, B, h * d), generator=g).to(dev, dtype)
    seed = torch.tensor([123457], dtype=torch.int32, device=dev)
    tol = (2 ** -6, 2 ** -8) if dtype == torch.bfloat16 else (1e-4, 1e-5)
    before = dict(atc.launches)
    o, m, l = atc.attn_train_fwd(q, k, v, h, rate, seed)
    ro, rm, rl = atc.attn_train_fwd_plain(q, k, v, h, rate, seed)
    assert o.dtype == dtype and o.shape == (T, B, h * d)
    _within(o, ro, *tol)
    torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, rl, rtol=1e-4, atol=1e-6)
    delta = atc.row_delta(go, ro, h)
    args = (q, k, v, go, rm, rl, delta, h, rate, seed)
    _within(atc.attn_train_dq(*args), atc.attn_train_dq_plain(*args), *tol)
    for a, b in zip(atc.attn_train_dkv(*args), atc.attn_train_dkv_plain(*args)):
        _within(a, b, *tol)
    assert all(atc.launches[n] == before[n] + 1 for n in before)
    if rate > 0:
        tril = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
        ref = atc.keep_plain(seed, torch.arange(B * h, device=dev), T,
                             rate) & tril
        for name in before:
            got = atc.keep_bits(name, q, k, v, h, rate, seed, go, rm, rl,
                                delta)
            assert torch.equal(got, ref), name
    xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    ys = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = atc.flash_attention_train(*xs, h, rate, seed)
    ref = atc.flash_attention_train_plain(*ys, h, rate, seed)
    (out.float() * go.float()).sum().backward()
    (ref.float() * go.float()).sum().backward()
    _within(out, ref, *tol)
    for a, b in zip(xs, ys):
        _within(a.grad, b.grad, *tol)


def test_attention_train_refuses_what_the_kernels_do_not_take(dev):
    from bayeslms_tpu_torch.ops import attention_train_cuda as atc

    seed = torch.zeros((1,), dtype=torch.int32, device=dev)
    wide = torch.zeros((8, 1, 512), device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        atc.attn_train_fwd(wide, wide, wide, 1, 0.1, seed)
    x = torch.zeros((8, 2, 64), device=dev, dtype=torch.bfloat16)
    for bad in (seed.long(), seed.cpu(), torch.zeros((2,), dtype=torch.int32,
                                                     device=dev)):
        with pytest.raises(ValueError):
            atc.attn_train_fwd(x, x, x, 2, 0.1, bad)
    with pytest.raises(ValueError):  # features not unit-strided
        atc.attn_train_fwd(x.transpose(0, 2).contiguous().transpose(0, 2),
                           x, x, 2, 0.1, seed)
    with pytest.raises(ValueError):
        atc.attn_train_fwd(x.half(), x.half(), x.half(), 2, 0.1, seed)


@pytest.mark.parametrize("masked,reset", [(False, False), (True, False),
                                          (True, True)])
def test_lstm_fwd_kernel_matches_plain(dev, masked, reset):
    """Rows 3-4: one layer, B off the 64-column tile, -1 reset sources."""
    from bayeslms_tpu_torch.ops import lstm_cuda as lc

    g = torch.Generator().manual_seed(1)
    T, B, H = 11, 70, 64
    r = lambda *s, sc=1.0: ((torch.rand(s, generator=g) * 2 - 1) * sc)  # noqa: E731
    bf = torch.bfloat16
    args = [r(T, B, 4 * H).to(dev, bf), r(4 * H, H, sc=0.125).to(dev, bf),
            r(4 * H, sc=0.1).to(dev), r(B, H, sc=0.5).to(dev, bf),
            r(B, H, sc=0.5).to(dev, bf)]
    mask = reset_mask = src = None
    if masked:
        mask = (torch.rand((T, B), generator=g) < 0.8).to(dev, torch.uint8)
    if reset:
        reset_mask = (torch.rand((T, B), generator=g) < 0.2).to(dev,
                                                                torch.uint8)
        src = ((torch.arange(B) // 10) * 10).to(torch.int32)
        src[::9] = -1
        src = src.to(dev)
    key = "lstm_fwd_reset" if reset else "lstm_fwd"
    before = lc.layer_launches[key]
    got = lc.lstm_fwd(*args, mask, reset_mask, src)
    ref = lc.lstm_fwd_plain(*args, mask, reset_mask, src)
    assert lc.layer_launches[key] == before + 1
    for a, b in zip(got, ref):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=2 ** -6)


def _gpg_args(dev, T, B, H, gate, masked, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: ((torch.rand(s, generator=g) * 2 - 1) * sc)  # noqa: E731
    bf = torch.bfloat16
    k = 1 if gate == 2 else 3
    mask = None
    if masked:
        mask = (torch.rand((T, B), generator=g) < 0.8).to(dev, torch.uint8)
    return [r(T, B, 4 * H).to(dev, bf), r(T, B, H).to(dev, bf),
            r(5 * H, H, sc=0.125).to(dev, bf), r(4 * H, sc=0.1).to(dev),
            torch.rand((k, H), generator=g).to(dev), mask,
            r(B, H, sc=0.5).to(dev, bf), r(B, H, sc=0.5).to(dev, bf)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("gate", [1, 2, 3, 4])
def test_gp_lstm_kernels_match_plain(dev, gate, masked):
    """Rows 20-21 at B = 40 (off the 32-column tile): forward, backward,
    dcoef bit-equal across repeat calls."""
    from bayeslms_tpu_torch.ops import gp_lstm_cuda as gc

    T, B, H = 9, 40, 64
    args = _gpg_args(dev, T, B, H, gate, masked, seed=gate)
    before = dict(gc.launches)
    got = gc.gpg_fwd(*args, gate)
    ref = gc.gpg_fwd_plain(*args, gate)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=2 ** -6)
    ys, cs = ref[0], ref[1]
    g = torch.Generator().manual_seed(9)
    dy = ((torch.rand((T, B, H), generator=g) * 2 - 1)).to(dev, torch.bfloat16)
    dhT = torch.zeros((B, H), device=dev, dtype=torch.bfloat16)
    bw = gc.gpg_bwd(*args, ys, cs, dy, dhT, dhT, gate)
    bref = gc.gpg_bwd_plain(*args, ys, cs, dy, dhT, dhT, gate)
    for a, b in zip(bw, bref):
        big = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -6,
                                   atol=2 ** -8 * big)
    assert torch.equal(gc.gpg_bwd(*args, ys, cs, dy, dhT, dhT, gate)[1],
                       bw[1])
    assert gc.launches == {**before, "gpg_fwd": before["gpg_fwd"] + 1,
                           "gpg_bwd": before["gpg_bwd"] + 2}


def test_new_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from bayeslms_tpu_torch.ops import gp_lstm_cuda as gc
    from bayeslms_tpu_torch.ops import lstm_cuda as lc

    args = _gpg_args(dev, 3, 4, 64, 1, False)
    with pytest.raises(ValueError):
        gc.gpg_fwd(*[a.float() if a is not None and a.dtype == torch.bfloat16
                     else a for a in args], 1)
    with pytest.raises(ValueError):
        gc.gpg_fwd(*args, 5)
    with pytest.raises(ValueError):
        gc.gpg_fwd(*args[:4], args[4][:2].contiguous(), *args[5:], 1)
    xg = torch.zeros((3, 4, 4 * 48), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # H % 32 != 0
        lc.lstm_fwd(xg, torch.zeros((192, 48), device=dev,
                                    dtype=torch.bfloat16),
                    torch.zeros(192, device=dev), xg[0, :, :48],
                    xg[0, :, :48])


def _gp6_args(dev, T, B, H, masked, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: ((torch.rand(s, generator=g) * 2 - 1) * sc)  # noqa: E731
    bf = torch.bfloat16
    mask = None
    if masked:
        mask = (torch.rand((T, B), generator=g) < 0.8).to(dev, torch.uint8)
    return [r(T, B, 4 * H).to(dev, bf), r(4 * H, H, sc=0.125).to(dev, bf),
            r(4 * H, sc=0.5).to(dev, bf), r(3, 4 * H).to(dev), mask,
            r(B, H, sc=0.5).to(dev, bf), r(B, H, sc=0.5).to(dev, bf)]


@pytest.mark.parametrize("masked", [False, True])
def test_gp6_lstm_kernels_match_plain(dev, masked):
    """Rows 18-19 at B = 40 (off the 32-column tile): forward, backward,
    dcoef bit-equal across repeat calls, one launch count a call."""
    from bayeslms_tpu_torch.ops import gp_lstm_cuda as gc

    T, B, H = 9, 40, 64
    args = _gp6_args(dev, T, B, H, masked, seed=3 + masked)
    before = dict(gc.launches)
    got = gc.gp6_fwd(*args)
    ref = gc.gp6_fwd_plain(*args)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=2 ** -6)
    ys, cs = ref[0], ref[1]
    g = torch.Generator().manual_seed(9)
    dy = ((torch.rand((T, B, H), generator=g) * 2 - 1)).to(dev, torch.bfloat16)
    dhT = torch.zeros((B, H), device=dev, dtype=torch.bfloat16)
    bw = gc.gp6_bwd(*args, ys, cs, dy, dhT, dhT)
    bref = gc.gp6_bwd_plain(*args, ys, cs, dy, dhT, dhT)
    for a, b in zip(bw, bref):
        big = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -6,
                                   atol=2 ** -8 * big)
    assert torch.equal(gc.gp6_bwd(*args, ys, cs, dy, dhT, dhT)[2], bw[2])
    assert gc.launches == {**before, "gp6_fwd": before["gp6_fwd"] + 1,
                           "gp6_bwd": before["gp6_bwd"] + 2}


def test_gp6_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from bayeslms_tpu_torch.ops import gp_lstm_cuda as gc

    args = _gp6_args(dev, 3, 4, 64, False)
    with pytest.raises(ValueError):  # float32 operands
        gc.gp6_fwd(*[a.float() if a is not None and a.dtype == torch.bfloat16
                     else a for a in args])
    with pytest.raises(ValueError):  # one act's coefficients
        gc.gp6_fwd(*args[:3], args[3][:1].contiguous(), *args[4:])
    with pytest.raises(ValueError):  # b' in float32
        gc.gp6_fwd(*args[:2], args[2].float(), *args[3:])


def _lstm2_train_args(dev, T, B, H, masked, dropped):
    g = torch.Generator().manual_seed(7 + masked + 2 * dropped)
    r = lambda *s, sc=1.0: ((torch.rand(s, generator=g) * 2 - 1) * sc)  # noqa: E731
    bf = torch.bfloat16
    dm = ((torch.rand((T, B, H), generator=g) < 0.8) / 0.8 if dropped
          else torch.ones((T, B, H)))
    mask = (torch.rand((T, B), generator=g) < 0.8).to(dev, torch.uint8) \
        if masked else None
    return [r(T, B, 4 * H).to(dev, bf), dm.to(dev, bf),
            r(4 * H, H, sc=0.125).to(dev, bf), r(4 * H, sc=0.1).to(dev),
            r(4 * H, H, sc=0.125).to(dev, bf),
            r(4 * H, H, sc=0.125).to(dev, bf), r(4 * H, sc=0.1).to(dev), mask,
            *(r(B, H, sc=0.5).to(dev, bf) for _ in range(4))]


@pytest.mark.parametrize("masked,dropped", [(False, False), (True, True)])
def test_lstm2_train_kernels_match_plain(dev, masked, dropped):
    """Rows 7-8 against their twins, B off the 32-column tile."""
    from bayeslms_tpu_torch.ops import lstm2_train_cuda as l2c

    T, B, H = 9, 37, 64
    args = _lstm2_train_args(dev, T, B, H, masked, dropped)
    before = dict(l2c.launches)
    got = l2c.lstm2_train_fwd(*args)
    ref = l2c.lstm2_train_fwd_plain(*args)
    for a, b in zip(got, ref):
        assert a.dtype == torch.bfloat16
        _close(a, b, 2 ** -6)
    g = torch.Generator().manual_seed(1)
    d = [(torch.rand(s, generator=g) * 2 - 1).to(dev, torch.bfloat16)
         for s in ((T, B, H), (T, B, H), (B, H), (B, H), (B, H), (B, H))]
    got = l2c.lstm2_train_bwd(*args, *ref[:4], *d)
    ref = l2c.lstm2_train_bwd_plain(*args, *ref[:4], *d)
    for a, b in zip(got, ref):
        assert a.dtype == torch.bfloat16
        _close(a, b, 2 ** -5)
    assert l2c.launches == {"lstm2_train_fwd": before["lstm2_train_fwd"] + 1,
                            "lstm2_train_bwd": before["lstm2_train_bwd"] + 1}


def test_lstm2_train_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from bayeslms_tpu_torch.ops import lstm2_train_cuda as l2c

    args = _lstm2_train_args(dev, 3, 4, 64, False, False)
    with pytest.raises(ValueError):  # float32 operands
        l2c.lstm2_train_fwd(*[a.float() if a is not None
                              and a.dtype == torch.bfloat16 else a
                              for a in args])
    with pytest.raises(ValueError):  # H not a multiple of 32
        l2c.lstm2_train_fwd(*_lstm2_train_args(dev, 3, 4, 48, False, False))
    with pytest.raises(ValueError):  # a bf16 bias
        l2c.lstm2_train_fwd(*args[:3], args[3].bfloat16(), *args[4:])
