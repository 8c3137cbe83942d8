"""Causal multi-head self-attention for training, with dropout on the
attention probabilities drawn inside the kernels: the CUDA kernels'
wrappers, their plain twins and the autograd Function
``flash_attention_train``.

Replaces ``bayeslms_tpu/ops/attention_train_pallas.py``
``flash_attention_train`` (its ``_fwd_kernel``, ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` Pallas bodies, kernel rows 15-17) and
``flash_attn_train_ok``. The kernels are in ``csrc/attention_train.cu``,
whose header says what bounds them on the H100 and how their design answers
that. ``attn_train_fwd``, ``attn_train_dq`` and ``attn_train_dkv`` launch
them for CUDA tensors and raise on what they do not take; for CPU tensors
they run the plain twins beside them.

Two designs, chosen by ``_design`` and counted apart in
``design_launches``: rows 15-17 run on the tensor cores ("wgmma", TMA
loads) for bf16 heads of d <= 128 (d % 8 == 0, 16-byte aligned views),
and on the fp32 CUDA cores ("simt") for float32, d = 256 and views TMA
cannot describe. ``_fwd_plan``, ``_dq_plan`` and ``_dkv_plan`` give rows
15-17's launch plans as plain Python: the grid and tile count they launch
with, the tile geometry the library checks against its own, and the tile
walk its kernels make, which the CPU tests check.

Per batch column, head and query row r, over the keys c <= r (q, k, v the
time-major (T, B, E) projections, E = nhead d, unscaled):
s = (q_r d^-1/2) . k_c in float32, m_r = max s, p = exp(s - m_r), l_r =
sum p; o_r = sum_c round(z p) v_c / l_r, with z in {0, 1/keep} the dropout
draw and round() the compute dtype; the backward rebuilds P = p / l from
(m, l) and gives dq = round(dS) K d^-1/2, dk = round(dS)^T q d^-1/2 and
dv = round(z P)^T dO, dS = P (z dO V^T - delta), delta = rowsum(dO o). The
rounding points are the TPU kernels'; every sum is float32.

Dropout: a keep bit depends on (seed, batch-head, row, column) only. The
TPU's on-core generator has no counterpart here; the kernels run
Philox4x32-10 keyed by (seed, tile), tile = (bh nb + i) nb + j the TPU's
(q-block i, k-block j) tile at its block bq = min(128, round_up(T, 8)),
nb = ceil(T / bq), counted by the element's offset e = (r mod bq) bq +
(c mod bq) in that tile (word e % 4 of group e / 4), and keep an element
when its word's top 24 bits are below floor(keep 2^24), the TPU kernel's
threshold. ``keep_plain`` computes the same integers with torch int64 ops,
bit for bit. The seed is a device int32 tensor of shape (1,) that the
kernels read themselves.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
# row 14's design rule and plan format hold for rows 15-17 too
from .attention_cuda import WGMMA_MAX_D, _design, _plan_words  # noqa: F401
from .bayes_sample_cuda import philox4x32_10

# kernel launches, one per call that reaches a kernel; reset by callers that
# read them, such as chip_smoke.py
launches = {"attn_train_fwd": 0, "attn_train_dq": 0, "attn_train_dkv": 0}
# the same launches by design (``_design``)
design_launches = {n: {"wgmma": 0, "simt": 0} for n in launches}

KERNEL = "attention_train"
MAX_T = 8192  # the JAX gate's sequence limit
MAX_D = 256   # the widest head the kernels' tiles take
_NEG = -1e30
_U32 = 0xFFFFFFFF
# (batch-head, T, T) float32 elements a step of the plain versions holds;
# their score, probability and mask blocks are their only large buffers
PLAIN_ELEMS = 1 << 25

_P = ctypes.c_void_p
_I, _U, _F = ctypes.c_int, ctypes.c_uint, ctypes.c_float
_MID = [_I] * 4 + [_P, _F, _P, _U, _F, _I, _I, _P, _I]
_ARGTYPES = {"attn_train_fwd": [_P] * 6 + _MID + [_P, _P],
             "attn_train_dq": [_P] * 8 + _MID + [_P] * 3,
             "attn_train_dkv": [_P] * 9 + _MID + [_P] * 3}


def block(T: int) -> int:
    """The TPU kernels' block, bq = bk (``_block``): the dropout tiles'
    side."""
    return min(128, -(-T // 8) * 8)


def flash_attn_train_ok(q: torch.Tensor, nhead: int) -> bool:
    """Whether causal, mask-free training attention at long context takes
    these kernels: the JAX gate (``flash_attn_train_ok``: head dim a
    multiple of 8, T <= 8,192) on a CUDA tensor. A head wider than the
    kernels' 256 columns passes the gate and is refused by the kernels."""
    T, _, E = q.shape
    d = E // nhead
    return q.is_cuda and E % nhead == 0 and d % 8 == 0 and T <= MAX_T


def _simt_rows(d: int) -> int:
    """Rows of a CUDA-core kernel's tile (``Geo<DP>::BR``)."""
    return 64 if d <= 64 else 32


def _fwd_plan(T: int, B: int, nhead: int, d: int, design: str) -> dict:
    """Row 15's launch plan: the grid and tile count it is launched with,
    the query rows and keys of a tile and the threads of a CTA (which the
    library holds against its kernel's), and ``block(x)`` -> (query tile,
    batch-head, key tiles walked) of CTA x, as the kernel computes them
    from the grid and tile count. wgmma: x runs over ntiles x B h, the
    longest rows first (qt = ntiles - 1 - x // BH), each CTA walking key
    tiles 0 .. qt twice; simt: grid (B h, ntiles), CTA (bh, qt) walking 0
    .. qt."""
    BH = B * nhead
    if design == "wgmma":
        rows = 128
        nt = -(-T // rows)

        def blk(x):
            qt = nt - 1 - x // BH
            return qt, x % BH, range(qt + 1)
        return dict(design=design, grid=(nt * BH,), threads=384, rows=rows,
                    keys=128, ntiles=nt, block=blk)
    rows = _simt_rows(d)
    nt = -(-T // rows)

    def blk(x):
        bh, qt = x % BH, x // BH
        return qt, bh, range(qt + 1)
    return dict(design=design, grid=(BH, nt), threads=256, rows=rows,
                keys=rows, ntiles=nt, block=blk)


def dq_keys(d: int) -> int:
    """Keys of a row-16 wgmma tile (``DqGeo<NC>::KT``): 128 at d <= 64, 64
    at d = 128, where the S and dP fragments of 128 keys beside dq would not
    fit the registers."""
    return 128 if d <= 64 else 64


def _dq_plan(T: int, B: int, nhead: int, d: int, design: str) -> dict:
    """Row 16's launch plan, as ``_fwd_plan``'s: ``block(x)`` -> (query
    tile, batch-head, [(key tile, warpgroup) walked]) of CTA x. wgmma: 128
    query rows a CTA, the longest rows first as row 15's, key tiles of
    ``dq_keys(d)`` walked once from key 0 to the diagonal; warpgroup w
    (rows 128 qt + 64 w ..) skips a key tile wholly above its rows, and
    every tile when its rows lie past T. simt: grid (B h, ntiles), CTA (bh,
    qt) walking key tiles 0 .. qt, tiles of BR rows and keys."""
    BH = B * nhead
    if design == "wgmma":
        rows, keys = 128, dq_keys(d)
        nt = -(-T // rows)

        def blk(x):
            qt, bh = nt - 1 - x // BH, x % BH
            q0 = qt * rows
            walk = [(kt, w) for kt in range(-(-min(T, q0 + rows) // keys))
                    for w in (0, 1)
                    if kt * keys <= q0 + 64 * w + 63 and q0 + 64 * w < T]
            return qt, bh, walk
        return dict(design=design, grid=(nt * BH,), threads=384, rows=rows,
                    keys=keys, ntiles=nt, block=blk)
    rows = _simt_rows(d)
    nt = -(-T // rows)

    def blk(x):
        bh, qt = x % BH, x // BH
        return qt, bh, [(kt, 0) for kt in range(qt + 1)]
    return dict(design=design, grid=(BH, nt), threads=256, rows=rows,
                keys=rows, ntiles=nt, block=blk)


def _dkv_plan(T: int, B: int, nhead: int, d: int, design: str) -> dict:
    """Row 17's launch plan, as ``_fwd_plan``'s: the keys of a CTA, the
    query rows of a tile, and ``block(x)`` -> (key tile, batch-head,
    [(query tile, warpgroup) walked]) of CTA x. wgmma: key tiles of 128 in
    ascending order (the longest walks first, kt = x // BH), query tiles of
    64 from the one that holds key 128 kt down to T; warpgroup w (keys 128
    kt + 64 w ..) skips a query tile whose rows all lie above its keys.
    simt: grid (B h, ntiles), tiles of BR keys and BR query rows."""
    BH = B * nhead
    if design == "wgmma":
        keys, rows = 128, 64
        nt = -(-T // keys)

        def blk(x):
            kt, bh = x // BH, x % BH
            walk = []
            for q0 in range(kt * keys, T, rows):
                for w in (0, 1):
                    if q0 + rows > kt * keys + 64 * w:
                        walk.append((q0 // rows, w))
            return kt, bh, walk
        return dict(design=design, grid=(nt * BH,), threads=384, keys=keys,
                    rows=rows, ntiles=nt, block=blk)
    rows = _simt_rows(d)
    nt = -(-T // rows)

    def blk(x):
        bh, kt = x % BH, x // BH
        return kt, bh, [(q0 // rows, 0) for q0 in range(kt * rows, T, rows)]
    return dict(design=design, grid=(BH, nt), threads=256, keys=rows,
                rows=rows, ntiles=nt, block=blk)


_PLANS = {"attn_train_fwd": _fwd_plan, "attn_train_dq": _dq_plan,
          "attn_train_dkv": _dkv_plan}


def drop_params(rate: float):
    """(threshold, 1/keep in float32) of the dropout draw at ``rate``: keep
    an element when its 24-bit uniform is below the threshold, as the TPU
    kernel's ``_drop_tile``."""
    keep = 1.0 - rate
    return int(keep * (1 << 24)), float(np.float32(1.0 / keep))


def keep_plain(seed: torch.Tensor, bh: torch.Tensor, T: int,
               rate: float) -> torch.Tensor:
    """The kernels' keep bits of batch-heads ``bh`` (1-D int64): bool
    (len(bh), T, T), every (row, column), the causal ones meaningful."""
    thresh, _ = drop_params(rate)
    bq = block(T)
    nb = -(-T // bq)
    dev = bh.device
    rows = torch.arange(T, dtype=torch.int64, device=dev)[None, :, None]
    col4 = torch.arange(0, -(-T // 4) * 4, 4, dtype=torch.int64,
                        device=dev)[None, None, :]
    li, lj = rows // bq, col4 // bq
    tile = ((bh[:, None, None] * nb + li) * nb + lj) & _U32
    e = (rows - li * bq) * bq + (col4 - lj * bq)
    s = seed.to(device=dev, dtype=torch.int64).reshape(()) & _U32
    words = philox4x32_10((e >> 2).expand(tile.shape), s, tile)
    w = torch.stack(words, dim=-1).reshape(len(bh), T, -1)[:, :, :T]
    return (w >> 8) < thresh


def _z(seed, bh, T, rate):
    """The dropout factors z in {0, 1/keep}, float32 (len(bh), T, T)."""
    _, inv_keep = drop_params(rate)
    keep = keep_plain(seed, bh, T, rate)
    return torch.where(keep, torch.tensor(inv_keep, device=keep.device),
                       torch.tensor(0.0, device=keep.device))


def _heads(x: torch.Tensor, nhead: int) -> torch.Tensor:
    """(T, B, E) -> (B nhead, T, d) float32."""
    T, B, E = x.shape
    return x.float().reshape(T, B * nhead, E // nhead).transpose(0, 1)


def _unheads(x: torch.Tensor, B: int) -> torch.Tensor:
    """(B nhead, T, d) -> (T, B, nhead d)."""
    BH, T, d = x.shape
    return x.transpose(0, 1).reshape(T, B, BH // B * d)


def _chunks(BH: int, T: int):
    n = max(1, PLAIN_ELEMS // max(1, T * T))
    return [(b0, min(BH, b0 + n)) for b0 in range(0, BH, n)]


def attn_train_fwd_plain(q, k, v, nhead: int, rate: float, seed):
    """Plain PyTorch version of row 15, same arguments as
    ``attn_train_fwd``: the materialised causal softmax, batch-heads a
    chunk at a time."""
    T, B, E = q.shape
    d, dt, BH = E // nhead, q.dtype, B * nhead
    qh = _heads(q, nhead) * float(d) ** -0.5
    kh, vh = _heads(k, nhead), _heads(v, nhead)
    tril = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    o = torch.empty((BH, T, d), dtype=torch.float32, device=q.device)
    m = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    for b0, b1 in _chunks(BH, T):
        s = torch.where(tril, qh[b0:b1] @ kh[b0:b1].transpose(1, 2),
                        torch.tensor(_NEG, device=q.device))
        mm = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - mm)
        ll = p.sum(dim=-1, keepdim=True)
        if rate > 0.0:
            p = p * _z(seed, torch.arange(b0, b1, device=q.device), T, rate)
        o[b0:b1] = (p.to(dt).float() @ vh[b0:b1]) / ll
        m[b0:b1], l[b0:b1] = mm[..., 0], ll[..., 0]
    return _unheads(o, B).to(dt), m, l


def _bwd_plain(q, k, v, g, m, l, delta, nhead, rate, seed, want_dq,
               want_dkv):
    T, B, E = q.shape
    d, dt, BH = E // nhead, q.dtype, B * nhead
    scale = float(d) ** -0.5
    qu = _heads(q, nhead)
    qh = qu * scale
    kh, vh, gh = _heads(k, nhead), _heads(v, nhead), _heads(g, nhead)
    tril = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    dq = torch.empty((BH, T, d), dtype=torch.float32, device=q.device) \
        if want_dq else None
    dk = torch.empty_like(qu) if want_dkv else None
    dv = torch.empty_like(qu) if want_dkv else None
    for b0, b1 in _chunks(BH, T):
        sl = slice(b0, b1)
        s = torch.where(tril, qh[sl] @ kh[sl].transpose(1, 2),
                        torch.tensor(_NEG, device=q.device))
        p = torch.exp(s - m[sl, :, None]) / l[sl, :, None]
        dp = gh[sl] @ vh[sl].transpose(1, 2)
        pz = p
        if rate > 0.0:
            z = _z(seed, torch.arange(b0, b1, device=q.device), T, rate)
            dp, pz = dp * z, p * z
        ds = (p * (dp - delta[sl, :, None])).to(dt).float()
        if want_dq:
            dq[sl] = (ds @ kh[sl]) * scale
        if want_dkv:
            dv[sl] = pz.to(dt).float().transpose(1, 2) @ gh[sl]
            dk[sl] = (ds.transpose(1, 2) @ qu[sl]) * scale
    un = lambda x: None if x is None else _unheads(x, B).to(dt)  # noqa: E731
    return un(dq), un(dk), un(dv)


def attn_train_dq_plain(q, k, v, g, m, l, delta, nhead: int, rate: float,
                        seed):
    """Plain PyTorch version of row 16, same arguments as
    ``attn_train_dq``."""
    return _bwd_plain(q, k, v, g, m, l, delta, nhead, rate, seed, True,
                      False)[0]


def attn_train_dkv_plain(q, k, v, g, m, l, delta, nhead: int, rate: float,
                         seed):
    """Plain PyTorch version of row 17, same arguments as
    ``attn_train_dkv``."""
    return _bwd_plain(q, k, v, g, m, l, delta, nhead, rate, seed, False,
                      True)[1:]


def _check(name, nhead, seed, *xs):
    q = xs[0]
    T, B, E = q.shape
    if E % nhead or E // nhead <= 0:
        raise ValueError(f"{name}: head dim {E}/{nhead} must be a whole "
                         "number")
    if E // nhead > MAX_D:
        raise NotImplementedError(
            f"{name}: head dim {E // nhead} > {MAX_D}, wider than the "
            "kernels' tiles")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: bf16 or float32, got {q.dtype}")
    for x in xs:
        if tuple(x.shape) != (T, B, E) or x.dtype != q.dtype \
                or x.device != q.device:
            raise ValueError(f"{name}: q, k, v (and dO) must match "
                             f"{(T, B, E)} {q.dtype} on {q.device}")
        if x.stride(2) != 1:
            raise ValueError(f"{name}: inputs need unit stride along their "
                             "features")
    if tuple(seed.shape) != (1,) or seed.dtype != torch.int32 \
            or seed.device != q.device:
        raise ValueError(f"{name}: seed must be int32 (1,) on {q.device}")


def _stats(name, q, nhead, *stats):
    T, B, _ = q.shape
    for x in stats:
        if tuple(x.shape) != (B * nhead, T) or x.dtype != torch.float32 \
                or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"{name}: m, l and delta must be contiguous "
                             f"float32 {(B * nhead, T)} on {q.device}")


def _launch(name, ins, outs, nhead, rate, seed, keep_out=None,
            psum_out=None):
    """Launch kernel ``name`` on inputs ``ins`` (q, k, v[, dO], then any
    float32 statistics) writing ``outs``, in the design ``_design`` picks,
    on the plan ``_fwd_plan`` / ``_dq_plan`` / ``_dkv_plan`` gives; raises
    on a launch error."""
    q = ins[0]
    T, B, E = q.shape
    d = E // nhead
    thresh, inv_keep = drop_params(rate) if rate > 0.0 else (0, 1.0)
    views = list(ins[:4]) if name != "attn_train_fwd" else list(ins[:3])
    design = _design(views, nhead)
    if psum_out is not None and (
            design != "wgmma" or tuple(psum_out.shape) != (B * nhead, T)
            or psum_out.dtype != torch.float32
            or not psum_out.is_contiguous() or psum_out.device != q.device):
        raise ValueError(f"{name}: psum_out must be contiguous float32 "
                         f"{(B * nhead, T)} on {q.device}, wgmma design")
    st = []
    for x in views + [q] * (4 - len(views)):
        st += [x.stride(0), x.stride(1)]
    strides = (ctypes.c_longlong * 8)(*st)
    fn = getattr(_build.load(KERNEL), name)
    fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
    words = _plan_words(_PLANS[name](T, B, nhead, d, design))
    extra = [ctypes.cast(words, _P)]
    if name != "attn_train_fwd":
        extra.append(0 if psum_out is None else psum_out.data_ptr())
    err = fn(*(x.data_ptr() for x in (*ins, *outs)), T, B, nhead, d,
             ctypes.cast(strides, _P), float(d) ** -0.5, seed.data_ptr(),
             thresh, inv_keep, block(T), int(rate > 0.0),
             0 if keep_out is None else keep_out.data_ptr(),
             int(q.dtype == torch.bfloat16), *extra,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed ({design}): CUDA "
                           f"error {err}")
    launches[name] += 1
    design_launches[name][design] += 1


def attn_train_fwd(q, k, v, nhead: int, rate: float, seed,
                   keep_out: torch.Tensor = None):
    """Row 15: (o (T, B, E) in q's dtype, m, l float32 (B nhead, T)) of
    time-major q, k, v (T, B, E) projections (views with unit feature
    stride, such as the fused qkv projection's column slices, are read in
    place), dropout ``rate``, int32 (1,) ``seed``. CUDA tensors launch
    ``csrc/attention_train.cu`` (bf16 or float32, head dim <= 256, any T);
    CPU tensors run ``attn_train_fwd_plain``. ``keep_out``, (B nhead, T,
    T) uint8, receives the keep bits the kernel draws. Each launch adds
    one to ``launches``."""
    if not q.is_cuda:
        return attn_train_fwd_plain(q, k, v, nhead, rate, seed)
    _check("attn_train_fwd", nhead, seed, q, k, v)
    T, B, E = q.shape
    o = torch.empty((T, B, E), dtype=q.dtype, device=q.device)
    m = torch.empty((B * nhead, T), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    _launch("attn_train_fwd", (q, k, v), (o, m, l), nhead, rate, seed,
            keep_out)
    return o, m, l


def attn_train_dq(q, k, v, g, m, l, delta, nhead: int, rate: float, seed,
                  keep_out: torch.Tensor = None,
                  psum_out: torch.Tensor = None):
    """Row 16: dq (T, B, E) in q's dtype from q, k, v, the output gradient
    g (T, B, E) in q's dtype, row 15's m and l and delta = rowsum(g o),
    float32 (B nhead, T). CUDA tensors launch the kernel, CPU tensors run
    ``attn_train_dq_plain``; ``keep_out`` as for ``attn_train_fwd``,
    ``psum_out`` as for ``attn_train_dkv``."""
    if not q.is_cuda:
        return attn_train_dq_plain(q, k, v, g, m, l, delta, nhead, rate,
                                   seed)
    _check("attn_train_dq", nhead, seed, q, k, v, g)
    _stats("attn_train_dq", q, nhead, m, l, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("attn_train_dq", (q, k, v, g, m, l, delta), (dq,), nhead, rate,
            seed, keep_out, psum_out)
    return dq


def attn_train_dkv(q, k, v, g, m, l, delta, nhead: int, rate: float, seed,
                   keep_out: torch.Tensor = None,
                   psum_out: torch.Tensor = None):
    """Row 17: (dk, dv), each (T, B, E) in q's dtype, from the arguments of
    ``attn_train_dq``. CUDA tensors launch the kernel, CPU tensors run
    ``attn_train_dkv_plain``; ``keep_out`` as for ``attn_train_fwd``.
    ``psum_out``, (B nhead, T) float32 zeros, receives sum_c P of every
    row the wgmma kernel rebuilds from (m, l) (added by atomics in row 17,
    by the row's one owner in row 16: a debug output, as ``keep_out``)."""
    if not q.is_cuda:
        return attn_train_dkv_plain(q, k, v, g, m, l, delta, nhead, rate,
                                    seed)
    _check("attn_train_dkv", nhead, seed, q, k, v, g)
    _stats("attn_train_dkv", q, nhead, m, l, delta)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _launch("attn_train_dkv", (q, k, v, g, m, l, delta), (dk, dv), nhead,
            rate, seed, keep_out, psum_out)
    return dk, dv


def row_delta(g: torch.Tensor, o: torch.Tensor, nhead: int) -> torch.Tensor:
    """delta = rowsum(g o) per batch-head and row, float32 (B nhead, T):
    one torch reduction, as JAX computes it outside its kernels."""
    T, B, E = o.shape
    return (g.float() * o.float()).reshape(T, B * nhead, E // nhead) \
        .sum(dim=-1).t().contiguous()


class _FlashAttentionTrain(torch.autograd.Function):
    """Row 15 forward; delta, then rows 16 and 17, backward (the JAX custom
    VJP ``_fat_fwd`` / ``_fat_bwd``). ``plain`` runs the twins whatever the
    device."""

    @staticmethod
    def forward(ctx, q, k, v, nhead, rate, seed, plain):
        fwd = attn_train_fwd_plain if plain else attn_train_fwd
        o, m, l = fwd(q, k, v, nhead, rate, seed)
        ctx.save_for_backward(q, k, v, o, m, l, seed)
        ctx.nhead, ctx.rate, ctx.plain = nhead, rate, plain
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, m, l, seed = ctx.saved_tensors
        nhead, rate = ctx.nhead, ctx.rate
        g = g.to(q.dtype).contiguous()
        delta = row_delta(g, o, nhead)
        if ctx.plain:
            dq, dk, dv = _bwd_plain(q, k, v, g, m, l, delta, nhead, rate,
                                    seed, True, True)
        else:
            dq = attn_train_dq(q, k, v, g, m, l, delta, nhead, rate, seed)
            dk, dv = attn_train_dkv(q, k, v, g, m, l, delta, nhead, rate,
                                    seed)
        return dq, dk, dv, None, None, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          nhead: int, rate: float,
                          seed: torch.Tensor) -> torch.Tensor:
    """Differentiable causal attention with attention-probability dropout:
    q, k, v (T, B, E) projections, unscaled; ``seed`` int32 (1,) on their
    device (ignored when ``rate`` is 0). Returns (T, B, E) in q's dtype.
    CUDA tensors run rows 15-17, CPU tensors the plain twins."""
    return _FlashAttentionTrain.apply(q, k, v, nhead, float(rate), seed,
                                      False)


def flash_attention_train_plain(q, k, v, nhead: int, rate: float, seed):
    """The same function on the plain twins, on any device: the tests'
    reference and chip_smoke.py's."""
    return _FlashAttentionTrain.apply(q, k, v, nhead, float(rate), seed,
                                      True)


def keep_bits(name: str, q, k, v, nhead: int, rate: float, seed, g=None,
              m=None, l=None, delta=None):
    """The keep bits that kernel ``name`` (attn_train_fwd, _dq or _dkv)
    draws on these inputs, through the kernel's own debug output: bool
    (B nhead, T, T), False where it draws none (above the diagonal); and
    that call's outputs, which a call without ``keep_out`` must give bit
    for bit (the wgmma kernels take a path without per-element tests there).
    CUDA tensors only."""
    if not q.is_cuda:
        raise ValueError("keep_bits: the kernels' draws need CUDA tensors")
    T, B, _ = q.shape
    out = torch.zeros((B * nhead, T, T), dtype=torch.uint8, device=q.device)
    if name == "attn_train_fwd":
        res = attn_train_fwd(q, k, v, nhead, rate, seed, out)
    else:
        bwd = attn_train_dq if name == "attn_train_dq" else attn_train_dkv
        res = bwd(q, k, v, g, m, l, delta, nhead, rate, seed, out)
    return out.bool(), res
