"""Fused tied-decoder cross-entropy with gradients: the CUDA kernels'
wrappers, their plain twins and the autograd Function
``fused_decode_ce_train``.

Replaces ``bayeslms_tpu/ops/ce_pallas.py`` ``fused_decode_ce_train`` (its
``_fwd_stats_kernel``, ``_bwd_dh_kernel`` and ``_bwd_de_kernel`` Pallas
bodies). The kernels are in ``csrc/ce_train.cu``, whose header says what
bounds them on the H100 and how their design answers that. ``ce_train_fwd``,
``ce_train_dh`` and ``ce_train_de`` launch them for CUDA tensors and raise on
what they do not take; for CPU tensors they run the plain twins beside them.

With s_mv = h_m . E_v + b_v (products of h and E in h's dtype accumulated in
float32, a float32 bias): the forward gives ce_m, max_m and sumexp_m; the
backward forms d_mv = a_m p_mv + b_m [v = t_m] with p_mv = exp(s_mv - max_m)
/ sumexp_m, and gives dh = d E and dE = d^T h with d rounded to h's dtype,
and db = sum_m d_mv in float32. The scoring path's ``ce_cuda`` launches
the forward's kernels too (``score_fwd``), at the forward's own width rule.
A target of -1 hits no word in the kernels and the twins alike.

``shard_lse_t`` and ``fused_decode_ce_train_spmd`` are the same kernels on
a vocabulary shard, for tensor-parallel training (the JAX package's
``_shard_lse_t`` and ``fused_decode_ce_train_spmd``, ``ce_pallas.py``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches, one per call that reaches a kernel; reset by callers that
# read them, such as chip_smoke.py
launches = {"ce_train_fwd": 0, "ce_train_dh": 0, "ce_train_de": 0}

_P = ctypes.c_void_p
_FWD_ARGTYPES = [_P] * 8 + [ctypes.c_int] * 4 + [_P]
_BWD_ARGTYPES = [ctypes.c_int] + [_P] * 11 + [ctypes.c_int] * 4 + [_P]

# The backward's tiling (csrc/ce_train.cu): D columns a CTA owns, output
# rows of a tile, walked rows of a score tile, the portable cluster size
D_SLICE = 256
OWN_ROWS = 128
WALK_ROWS = 64
MAX_CLUSTER = 8
# The forward's tiling: tokens of a tile, vocabulary rows of a score tile,
# D columns of a chunk (the forward alone takes D % FWD_CHUNK == 0; the
# training wrappers keep D_SLICE, which the backward needs)
FWD_ROWS = 128
FWD_COLS = 256
FWD_CHUNK = 64
# most parts the forward's vocabulary walk and dh's are split into, and the
# share of the unsplit walk's waves a split must reach to be taken
MAX_FWD_SPLITS = 32
MAX_SPLITS = 8
SPLIT_GAIN = 0.9
# Tokens per step of the plain versions, whose (rows, V) float32 blocks are
# their only large buffers
PLAIN_ROWS = 4096


def _scores(h, e, bias, s):
    return torch.addmm(bias, h[s:s + PLAIN_ROWS].float(), e.t())


def ce_train_fwd_plain(h, emb, bias, targets):
    """Plain PyTorch version of the forward kernel, same arguments as
    ``ce_train_fwd``. A target of -1 hits no word: its logit counts as 0,
    so its ce is the log-sum-exp."""
    e = emb.to(h.dtype).float()
    b = bias.float()
    t = targets.long()
    ce, mx, se = [], [], []
    for s in range(0, h.shape[0], PLAIN_ROWS):
        logits = _scores(h, e, b, s)
        m = logits.max(dim=1).values
        sumexp = torch.exp(logits - m[:, None]).sum(dim=1)
        ts = t[s:s + PLAIN_ROWS]
        tl = logits.gather(1, ts.clamp(min=0)[:, None])[:, 0] * (ts >= 0)
        ce.append(torch.log(sumexp) + m - tl)
        mx.append(m)
        se.append(sumexp)
    if not ce:
        z = torch.zeros((0,), dtype=torch.float32, device=h.device)
        return z, z.clone(), z.clone()
    return torch.cat(ce), torch.cat(mx), torch.cat(se)


def _d_rows(h, e, bias, t, mx, se, a, b, s):
    """float32 d for tokens [s, s + PLAIN_ROWS); a target of -1 hits no
    word (b is not added)."""
    p = torch.exp(_scores(h, e, bias, s) - mx[s:s + PLAIN_ROWS, None]) \
        / se[s:s + PLAIN_ROWS, None]
    d = a[s:s + PLAIN_ROWS, None] * p
    ts = t[s:s + PLAIN_ROWS]
    hit = (ts >= 0).nonzero()[:, 0]
    d[hit, ts[hit]] += b[s:s + PLAIN_ROWS][hit]
    return d


def ce_train_dh_plain(h, emb, bias, targets, mx, se, a, b):
    """Plain PyTorch version of the dh kernel, same arguments as
    ``ce_train_dh``."""
    e = emb.to(h.dtype).float()
    bias, t = bias.float(), targets.long()
    out = torch.empty(h.shape, dtype=h.dtype, device=h.device)
    for s in range(0, h.shape[0], PLAIN_ROWS):
        d = _d_rows(h, e, bias, t, mx, se, a, b, s)
        out[s:s + PLAIN_ROWS] = (d.to(h.dtype).float() @ e).to(h.dtype)
    return out


def ce_train_de_plain(h, emb, bias, targets, mx, se, a, b):
    """Plain PyTorch version of the dE/db kernel, same arguments as
    ``ce_train_de``."""
    e = emb.to(h.dtype).float()
    bias, t = bias.float(), targets.long()
    de = torch.zeros(emb.shape, dtype=torch.float32, device=h.device)
    db = torch.zeros(emb.shape[:1], dtype=torch.float32, device=h.device)
    for s in range(0, h.shape[0], PLAIN_ROWS):
        d = _d_rows(h, e, bias, t, mx, se, a, b, s)
        de += d.to(h.dtype).float().t() @ h[s:s + PLAIN_ROWS].float()
        db += d.sum(dim=0)
    return de, db


def _check(fn, h, emb, bias, targets, vectors=(), width=D_SLICE):
    """Validate and convert the arguments the kernels take (D a multiple of
    ``width``); returns (M, V, D, emb in bf16, bias in fp32, targets in
    int32)."""
    _build.refuse_float32(fn, h, "rows 9-11")
    M, D = h.shape
    V = emb.shape[0]
    dev = h.device
    if h.dtype != torch.bfloat16 or not h.is_contiguous():
        raise ValueError(f"{fn}: h must be contiguous bf16, got {h.dtype}")
    if D % width != 0 or tuple(emb.shape) != (V, D) or emb.device != dev:
        raise ValueError(f"{fn}: emb must be (V, {D}) on {dev} with {D} a "
                         f"multiple of {width}; got {tuple(emb.shape)}")
    if tuple(bias.shape) != (V,) or tuple(targets.shape) != (M,) \
            or bias.device != dev or targets.device != dev:
        raise ValueError(f"{fn}: bias must be ({V},) and targets ({M},) on "
                         f"{dev}")
    for name, v in vectors:
        if v.dtype != torch.float32 or tuple(v.shape) != (M,) \
                or v.device != dev or not v.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous float32 "
                             f"({M},) on {dev}")
    return (M, V, D, emb.to(torch.bfloat16).contiguous(),
            bias.to(torch.float32).contiguous(),
            targets.to(torch.int32).contiguous())


def _cdiv(a, b):
    return -(-a // b)


def _fwd_plan(M, V, D, n_sm, width=D_SLICE):
    """The forward launch of ``csrc/ce_train.cu`` for (M, V, D) on a card
    of ``n_sm`` SMs, one CTA each (its ring takes most of the shared
    memory). CTA (x, y) walks the vocabulary tiles [y n / S, (y + 1) n / S)
    of token tile x, n = ceil(V / 256) tiles, and writes its partials to a
    (3, S, M) float32 workspace, which a second kernel merges. S (at most
    MAX_FWD_SPLITS and n) minimises the walk's length, waves x (ceil(n /
    S) + 1), waves = ceil(token tiles x S / n_sm), the smallest on a tie:
    each part costs about a tile more, to fill its ring and write its
    partials. It is taken only where that is at most SPLIT_GAIN of the
    unsplit walk's. The grid's x is the token tile, so the CTAs of one
    part are launched, and walk E, together. D must be a multiple of
    ``width``: D_SLICE for training, whose backward takes 256-column
    slices; FWD_CHUNK for scoring (``score_fwd``), the kernel's own chunk.
    Returns a dict with S, the grid, CTAs, the workspace bytes and the tile
    counts."""
    if width not in (D_SLICE, FWD_CHUNK) or D % width:
        raise ValueError(f"D = {D} is not a multiple of {width}")
    token_tiles = _cdiv(M, FWD_ROWS)
    vocab_tiles = _cdiv(V, FWD_COLS)
    cost = {s: _cdiv(token_tiles * s, n_sm) * (_cdiv(vocab_tiles, s) + 1)
            for s in range(1, max(1, min(MAX_FWD_SPLITS, vocab_tiles)) + 1)}
    S = min(cost, key=lambda s: (cost[s], s))
    if cost[S] > SPLIT_GAIN * cost[1]:
        S = 1
    grid = (token_tiles, S)
    return dict(which="forward", S=S, grid=grid, ctas=grid[0] * grid[1],
                token_tiles=token_tiles, vocab_tiles=vocab_tiles,
                workspace_bytes=3 * S * M * 4)


def _bwd_plan(M, V, D, n_sm, max_clusters=None, de=False):
    """The backward launch of ``csrc/ce_train.cu`` for (M, V, D): dh
    (``de`` False: tokens own the output rows, the vocabulary is walked)
    or dE/db (``de`` True: the roles swapped). A cluster of C = D / 256
    CTAs (G clusters of at most 8 where D > 2,048) owns 128 output rows;
    rank r of cluster g owns columns [256 (g C + r), +256). dh's walk is
    split into S parts where that fills the card better: S is the number
    of parts (at most MAX_SPLITS and the walk's groups) that minimises
    waves / S, waves = ceil(clusters / max_clusters), the smallest on a
    tie, and only where that takes at most SPLIT_GAIN of the unsplit
    walk's waves (the partials cost S M D 4 bytes and a second kernel);
    ``max_clusters`` is what the card holds at once
    (cudaOccupancyMaxActiveClusters), n_sm // C where not given. dE takes
    S = 1. Returns a dict with C, G, S, the grid, CTAs, clusters, the
    workspace bytes (S M D float32 where S > 1) and the tile counts."""
    if D % D_SLICE:
        raise ValueError(f"D = {D} is not a multiple of {D_SLICE}")
    slices = D // D_SLICE
    G = _cdiv(slices, MAX_CLUSTER)
    C = _cdiv(slices, G)
    n_own, n_walk = (V, M) if de else (M, V)
    own_tiles = _cdiv(n_own, OWN_ROWS)
    walk_tiles = _cdiv(n_walk, WALK_ROWS)
    groups = _cdiv(walk_tiles, C)
    cap = max(1, max_clusters if max_clusters else n_sm // C)
    S = 1
    if not de and own_tiles:
        cost = {s: _cdiv(own_tiles * G * s, cap) / s
                for s in range(1, max(1, min(MAX_SPLITS, groups)) + 1)}
        best = min(cost, key=lambda s: (cost[s], s))
        if cost[best] <= SPLIT_GAIN * cost[1]:
            S = best
    grid = (C * G, own_tiles, S)
    return dict(which="dE" if de else "dh", C=C, G=G, S=S, grid=grid,
                slices=slices, cluster=(C, 1, 1),
                ctas=grid[0] * grid[1] * grid[2],
                clusters=own_tiles * G * S, max_clusters=cap,
                own_tiles=own_tiles, walk_tiles=walk_tiles, groups=groups,
                workspace_bytes=S * M * D * 4 if S > 1 else 0)


# (device index, which, D) -> clusters the card holds at once
_card = {}


def _card_plan(dev, M, V, D, de):
    key = (dev.index, int(de), D)
    if key not in _card:
        lib = _build.load("ce_train")
        f = lib.ce_train_bwd_clusters
        f.argtypes, f.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        with torch.cuda.device(dev):
            n = f(int(de), D)
        if n <= 0:
            raise RuntimeError(f"ce_train backward: the card holds no "
                               f"cluster (CUDA error {-n})")
        _card[key] = n
    return _bwd_plan(M, V, D, _build.sm_count(dev.index), _card[key], de)


def _card_fwd_plan(dev, M, V, D, width=D_SLICE):
    return _fwd_plan(M, V, D, _build.sm_count(dev.index), width)


def _call(name, fn, argtypes, *args, count=True):
    lib = _build.load("ce_train")
    f = getattr(lib, fn)
    f.argtypes, f.restype = argtypes, ctypes.c_int
    err = f(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if count:
        launches[name] += 1


def _fwd(name, h, emb, bias, targets, width, count):
    M, V, D, emb, bias, tgt = _check(name, h, emb, bias, targets,
                                     width=width)
    plan = _card_fwd_plan(h.device, M, V, D, width)
    ce, mx, se = (torch.empty((M,), dtype=torch.float32, device=h.device)
                  for _ in range(3))
    ws = torch.empty((3, plan["S"], M), dtype=torch.float32, device=h.device)
    _call(name, "ce_train_fwd", _FWD_ARGTYPES, h.data_ptr(),
          emb.data_ptr(), bias.data_ptr(), tgt.data_ptr(), ce.data_ptr(),
          mx.data_ptr(), se.data_ptr(), ws.data_ptr(), M, V, D, plan["S"],
          torch.cuda.current_stream(h.device).cuda_stream, count=count)
    return ce, mx, se


def score_fwd(h, emb, bias, targets):
    """The forward's kernels for the scoring CE (``ce_cuda``, kernel row
    2): CUDA tensors only, D a multiple of FWD_CHUNK, the same launch and
    score arithmetic as ``ce_train_fwd``. Returns ce (M,) float32; the
    statistics are dropped. Counts nothing here: ``ce_cuda`` counts its
    own launches."""
    return _fwd("fused_decode_ce", h, emb, bias, targets, FWD_CHUNK,
                False)[0]


def ce_train_fwd(h: torch.Tensor, emb: torch.Tensor, bias: torch.Tensor,
                 targets: torch.Tensor):
    """Per-token CE of a tied decoder with its softmax statistics.

    h (M, D) in the compute dtype; emb (V, D), cast to h's dtype; bias (V,)
    float32; targets (M,) int. Returns ce, max, sumexp (M,) float32. CUDA
    tensors launch ``ce_train_fwd`` of ``csrc/ce_train.cu`` (bf16, D a
    multiple of 256, any M and V; the split walk of ``_fwd_plan`` and the
    merge of its partials, one call); CPU tensors run
    ``ce_train_fwd_plain``.
    """
    if not h.is_cuda:
        return ce_train_fwd_plain(h, emb, bias, targets)
    return _fwd("ce_train_fwd", h, emb, bias, targets, D_SLICE, True)


def _bwd(name, which, h, emb, bias, targets, mx, se, a, b, out, db):
    M, V, D, emb, bias, tgt = _check(name, h, emb, bias, targets,
                                     (("max", mx), ("sumexp", se), ("a", a),
                                      ("b", b)))
    plan = _card_plan(h.device, M, V, D, which == 1)
    ws = torch.empty((plan["S"], M, D), dtype=torch.float32,
                     device=h.device) if plan["S"] > 1 else None
    _call(name, "ce_train_bwd", _BWD_ARGTYPES, which, h.data_ptr(),
          emb.data_ptr(), bias.data_ptr(), tgt.data_ptr(), mx.data_ptr(),
          se.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
          None if db is None else db.data_ptr(),
          None if ws is None else ws.data_ptr(), M, V, D, plan["S"],
          torch.cuda.current_stream(h.device).cuda_stream)


def ce_train_dh(h, emb, bias, targets, mx, se, a, b):
    """dh_m = sum_v (a_m p_mv + b_m [v = t_m]) E_v, (M, D) in h's dtype.

    The forward's arguments, its statistics mx, se and the per-token
    coefficients a, b (M,) float32 (the CE's gradient: a = g, b = -g). CUDA
    tensors launch the dh kernel of ``csrc/ce_train.cu``; CPU tensors run
    ``ce_train_dh_plain``.
    """
    if not h.is_cuda:
        return ce_train_dh_plain(h, emb, bias, targets, mx, se, a, b)
    out = torch.empty(h.shape, dtype=torch.bfloat16, device=h.device)
    _bwd("ce_train_dh", 0, h, emb, bias, targets, mx, se, a, b, out, None)
    return out


def ce_train_de(h, emb, bias, targets, mx, se, a, b):
    """dE_v = sum_m (a_m p_mv + b_m [v = t_m]) h_m, (V, D) float32, and db_v
    = sum_m (...), (V,) float32. Arguments as ``ce_train_dh``. CUDA tensors
    launch the dE kernel of ``csrc/ce_train.cu``; CPU tensors run
    ``ce_train_de_plain``.
    """
    if not h.is_cuda:
        return ce_train_de_plain(h, emb, bias, targets, mx, se, a, b)
    de = torch.empty(emb.shape, dtype=torch.float32, device=h.device)
    db = torch.empty(emb.shape[:1], dtype=torch.float32, device=h.device)
    _bwd("ce_train_de", 1, h, emb, bias, targets, mx, se, a, b, de, db)
    return de, db


class _FusedDecodeCETrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, emb, bias, targets):
        # the table in h's dtype, cast once for the three kernels
        emb_c = emb.to(h.dtype).contiguous()
        ce, mx, se = ce_train_fwd(h, emb_c, bias, targets)
        ctx.save_for_backward(h, emb_c, bias, targets, mx, se)
        ctx.emb_dtype = emb.dtype
        return ce

    @staticmethod
    def backward(ctx, g):
        h, emb_c, bias, targets, mx, se = ctx.saved_tensors
        a = g.float().contiguous()
        b = -a
        dh = ce_train_dh(h, emb_c, bias, targets, mx, se, a, b)
        de, db = ce_train_de(h, emb_c, bias, targets, mx, se, a, b)
        return dh.to(h.dtype), de.to(ctx.emb_dtype), db.to(bias.dtype), None


def fused_decode_ce_train(h: torch.Tensor, emb: torch.Tensor,
                          bias: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """Differentiable per-token CE of a tied decoder (the JAX package's
    ``fused_decode_ce_train``): h (M, D) in the compute dtype, emb (V, D),
    bias (V,), targets (M,) int. Returns ce (M,) float32; gradients flow to
    h, emb and bias. The backward recomputes the score tiles from the
    forward's (max, sumexp) instead of keeping (M, V) logits."""
    return _FusedDecodeCETrain.apply(h, emb, bias, targets)


# ------------------------------------------------ the vocabulary-sharded CE
# Under tensor parallelism the tied table and its bias are split over the
# tp ranks by vocabulary rows. Each rank runs rows 9-11 on its slice and
# returns per-token partials (lse_k, t_k): the log-sum-exp over its words
# and the target's logit, 0 where the target is on another rank's slice
# (there the target is -1, which the kernels and their twins never hit).
# The global CE is logsumexp_k(lse_k) - sum_k t_k; autograd of that merge
# hands each rank its cotangents (d_lse, d_t), which the backward kernels
# take as their (a, b) form, d = a p_local + b [v = t]. dE and db stay on
# the rank; dh is summed over the ranks by the collectives' transposes.


class _ShardLseT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, emb, bias, targets):
        emb_c = emb.to(h.dtype).contiguous()
        ce, mx, se = ce_train_fwd(h, emb_c, bias, targets)
        lse = torch.log(se) + mx
        t = torch.where(targets >= 0, lse - ce, torch.zeros_like(lse))
        ctx.save_for_backward(h, emb_c, bias, targets, mx, se)
        ctx.emb_dtype = emb.dtype
        return lse, t

    @staticmethod
    def backward(ctx, d_lse, d_t):
        h, emb_c, bias, targets, mx, se = ctx.saved_tensors
        a = d_lse.float().contiguous()
        b = d_t.float().contiguous()
        dh = ce_train_dh(h, emb_c, bias, targets, mx, se, a, b)
        de, db = ce_train_de(h, emb_c, bias, targets, mx, se, a, b)
        return dh.to(h.dtype), de.to(ctx.emb_dtype), db.to(bias.dtype), None


def shard_lse_t(h: torch.Tensor, emb: torch.Tensor, bias: torch.Tensor,
                targets: torch.Tensor):
    """Per-token (lse, t) of one vocabulary shard, the JAX package's
    ``_shard_lse_t``: h (M, D) in the compute dtype, emb (V_loc, D), bias
    (V_loc,), targets (M,) shard-local, -1 where the target is on another
    shard. lse = log sum over the shard's words of exp(score), t the
    target's score (0 off the shard), both (M,) float32 and
    differentiable; the backward runs rows 10-11 with a = d_lse, b =
    d_t."""
    return _ShardLseT.apply(h, emb, bias, targets)


def local_targets(targets: torch.Tensor, shard: int,
                  v_loc: int) -> torch.Tensor:
    """Global targets as ids of vocabulary shard ``shard`` (rows [shard
    v_loc, (shard + 1) v_loc)), -1 where they lie on another shard."""
    t = targets.long() - shard * v_loc
    return torch.where((t >= 0) & (t < v_loc), t, torch.full_like(t, -1))


def merge_partials(lse_k: torch.Tensor, t_k: torch.Tensor) -> torch.Tensor:
    """ce from the shards' stacked (tp, M) partials: logsumexp over the
    shards of lse minus the sum of t."""
    return torch.logsumexp(lse_k, dim=0) - t_k.sum(dim=0)


def fused_decode_ce_train_spmd(h: torch.Tensor, emb: torch.Tensor,
                               bias: torch.Tensor, targets: torch.Tensor,
                               mesh) -> torch.Tensor:
    """Differentiable per-token CE over a vocabulary split across the
    mesh's tp ranks (the JAX package's ``fused_decode_ce_train_spmd``):
    h (M, D), targets (M,) global ids, the same on every tp rank (this dp
    shard's tokens); emb (V / tp, D) and bias (V / tp,) this rank's rows.
    Returns the merged ce (M,), equal on every tp rank. The collectives'
    transposes sum the tp ranks' cotangents, so each rank's loss must
    cover only its own share of the tokens (as
    ``parallel/train_parallel.py`` slices it), or the gradients come out
    tp times too large."""
    from ..parallel.mesh import gather

    v_loc = emb.shape[0]
    lse, t = shard_lse_t(h, emb, bias,
                         local_targets(targets, mesh.tp_index, v_loc))
    return merge_partials(gather(mesh, lse[None], "tp"),
                          gather(mesh, t[None], "tp"))
