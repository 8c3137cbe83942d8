"""LSTM forward recurrences for scoring and eval: the CUDA kernels'
wrappers and their plain twins.

Replaces ``bayeslms_tpu/ops/lstm_pallas.py`` ``lstm2_layer_pallas`` (its
``_kernel2`` / ``_kernel2_reset`` Pallas bodies) with ``lstm2_fwd``, and
``lstm_layer_pallas`` (``_kernel_reset`` and ``_kernel``, kernel rows 3 and
4) with ``lstm_fwd``. Both dispatch on the operands' dtype: bf16 takes
``csrc/lstm2_fwd.cu`` (two designs picked by ``_design``) and
``csrc/lstm_fwd.cu`` (three designs picked by ``_design_fwd``); float32
takes ``csrc/lstm_f32.cu`` (one float32 step kernel a layer a step, CUDA-core
FMA); any other dtype raises. ``lstm_kernel_ok`` is ``pallas_lstm_ok``'s
gate and ``lstm2_fwd_ok`` ``pallas_lstm2_ok``'s for the forward. The
kernels' headers say what bounds them on the H100 and how their designs
answer that. The wrappers launch them for CUDA tensors and raise on what
they do not take; for CPU tensors they run ``lstm2_plain`` and
``lstm_fwd_plain``, which repeat the kernels' arithmetic step by step in
PyTorch.

Arithmetic (kernels and plain alike): h and c are carried in float32; the
products take h rounded to the weights' dtype (unrounded at float32) and
accumulate in float32; the gate pre-activations add ``xg`` (the first
layer) and a float32 bias. At a reset step a column takes its source
column's float32 state (source -1: zeros). The TPU kernel instead selects
through ``pmat @ s.astype(bf16)``, which rounds h and c to bf16 at each
reset; the JAX scan path does not. Outputs are in the weights' dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from . import lstm_train_cuda as _ltc

# kernel launches (one per call that reaches the kernel), and those calls
# by design; reset by callers that read them, such as chip_smoke.py
launches = 0
design_launches = {"persistent": 0, "per_step": 0, "f32": 0}
# the same for ``lstm_fwd``, by the TPU kernel a call replaces: row 3 (with
# resets) and row 4 (without)
layer_launches = {"lstm_fwd_reset": 0, "lstm_fwd": 0}
# and ``lstm_fwd``'s calls by design (``_design_fwd``; "f32" the float32
# kernel's)
layer_design_launches = {"persistent": 0, "streamed": 0, "per_step": 0,
                         "f32": 0}

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 14 + [ctypes.c_int] * 3 + [_P]
_PERSIST_ARGTYPES = [_P] * 18 + [ctypes.c_int] * 4 + [_P]
# lstm_fwd and lstm_fwd_persistent: nine pointers, T, B, H, the stream
_FWD_ARGTYPES = [_P] * 9 + [ctypes.c_int] * 3 + [_P]
# lstm_fwd_stream: twelve pointers, T, B, H, the rings' stages, the stream
_STREAM_ARGTYPES = [_P] * 12 + [ctypes.c_int] * 4 + [_P]

# The persistent design's geometry (csrc/lstm2_fwd.cu): hidden units a CTA
# (of both layers), k columns of a streamed chunk, batch rows of an m tile,
# bytes of a ring stage (one m64 x 64 bf16 tile), the resident rows' bytes
# a chunk (64 rows of W_hh1 and W_ih2, 32 of W_hh2, 128 bytes each), fp32
# product columns a batch row, threads a CTA, the most ring stages, the
# shared memory a CTA may take.
Q_UNITS = 8
Q_KC = 64
Q_MT = 64
Q_STAGE = Q_MT * Q_KC * 2
Q_ROWS_CHUNK = (64 + 32) * Q_KC * 2
Q_PC = 96
Q_THREADS = 288
Q_MAX_NST = 8
SMEM_LIMIT = 232448


def persist_smem(H: int, nst: int) -> int:
    """Dynamic shared memory of a persistent CTA at width H with ``nst``
    ring stages, bytes: 1 KB of alignment, the resident rows, the ring, the
    64 gate rows' biases, the ring's barriers (two a stage)."""
    return 1024 + (H // Q_KC) * Q_ROWS_CHUNK + nst * Q_STAGE + 64 * 4 \
        + 2 * nst * 8


def _design(T: int, B: int, H: int, n_sm: int) -> dict:
    """The design of ``lstm2_fwd`` for T steps of B columns at width H on a
    card of ``n_sm`` SMs: "persistent" (one launch of H / 8 CTAs, each
    owning 8 hidden units of both layers with their rows of W_hh1, W_ih2
    and W_hh2 in shared memory, a grid barrier a step) where H is a
    multiple of 64, the CTAs number no more than the SMs (one a SM) and a
    CTA's rows and a ring of two stages or more fit its shared memory;
    "per_step" (``lstm_step_kernel``, 2T launches on (ceil(B / 64), H / 32)
    blocks) otherwise. An explicit rule: the chosen design runs or raises.
    Returns a dict with the design, grid, CTAs, units a CTA, threads, ring
    stages, m tiles, shared memory bytes, launches and barriers for the
    call."""
    fixed = persist_smem(H, 0)
    nst = min(Q_MAX_NST, (SMEM_LIMIT - fixed) // (Q_STAGE + 16))
    ctas = H // Q_UNITS
    if H > 0 and H % Q_KC == 0 and ctas <= n_sm and nst >= 2 and B > 0:
        return dict(design="persistent", grid=(ctas,), ctas=ctas,
                    units=Q_UNITS, threads=Q_THREADS, stages=nst,
                    m_tiles=-(-B // Q_MT), smem_bytes=persist_smem(H, nst),
                    launches=1, barriers=T)
    grid = (-(-B // 64), H // 32)
    return dict(design="per_step", grid=grid, ctas=grid[0] * grid[1],
                units=32, threads=256, stages=None,
                m_tiles=None, smem_bytes=None, launches=2 * T, barriers=0)


def _card_design(dev, T, B, H):
    return _design(T, B, H, _build.sm_count(dev.index))


# The streamed design of ``lstm_fwd`` (row 3's, ``csrc/lstm_fwd.cu``
# ``lstm_layer_stream``, on row 1's ring and products): hidden units a CTA
# (the kernel's U), the most ring stages of its two rings together (16
# timed fastest at the pass's call; PERF.md, row 3).
S_UNITS = 8
S_MAX_NST = 16


def stream_smem(H: int, nst: int) -> int:
    """Dynamic shared memory of a streamed CTA at width H with ``nst`` ring
    stages, bytes: 1 KB of alignment, the 4 x ``S_UNITS`` resident gate
    rows of W_hh, the ring, their biases, the ring's barriers (two a
    stage)."""
    return 1024 + (H // Q_KC) * 4 * S_UNITS * Q_KC * 2 + nst * Q_STAGE \
        + 4 * S_UNITS * 4 + 2 * nst * 8


def _stream_plan(T: int, B: int, H: int, n_sm: int) -> Optional[dict]:
    """The streamed design's plan for the call, or None where it does not
    take it: H a multiple of 64, H / ``S_UNITS`` CTAs no more than the
    SMs, the rows and two rings of two stages or more within a CTA's
    shared memory (the rings' stages together: the most that fit, up to
    ``S_MAX_NST``, an even count)."""
    stages = min(S_MAX_NST, (SMEM_LIMIT - stream_smem(H, 0))
                 // (Q_STAGE + 16)) // 2 * 2
    ctas = H // S_UNITS
    if not (B > 0 and H > 0 and H % Q_KC == 0 and 0 < ctas <= n_sm
            and stages >= 4 and stages % 2 == 0
            and stream_smem(H, stages) <= SMEM_LIMIT):
        return None
    return dict(design="streamed", grid=(ctas,), ctas=ctas, units=S_UNITS,
                threads=Q_THREADS, stages=stages, m_tiles=-(-B // Q_MT),
                smem_bytes=stream_smem(H, stages), launches=1,
                barriers=max(T - 1, 0))


def _design_fwd(T: int, B: int, H: int, n_sm: int,
                resets: bool = False) -> dict:
    """The design of ``lstm_fwd`` (rows 3 and 4) for T steps of B columns
    at width H on a card of ``n_sm`` SMs:

    - "persistent" (row 5's persistent forward without the cs store: one
      cooperative launch of H / 8 CTAs, each keeping its 4 x 8 gate rows of
      W_hh in shared memory, mma.sync, a grid barrier a step) where the
      call has no resets, B <= 32, H is a multiple of 8, the CTAs number no
      more than the SMs (one a SM) and a CTA's shared memory fits;
    - "streamed" (row 1's design for one layer: one cooperative launch of
      H / ``S_UNITS`` CTAs, each keeping its gate rows of W_hh in shared
      memory, h streamed by TMA into wgmma through a ring for each consumer
      warpgroup, the resets on the product rows the owner gathers, a grid
      barrier a step) for every call with resets
      (row 3) and every call past 32 columns, where ``_stream_plan`` takes
      it;
    - "per_step" (``lstm_step_kernel``, T launches on (ceil(B / 64), H / 32)
      blocks) otherwise.

    An explicit rule: the chosen design runs or raises. Returns a dict with
    the design, grid, CTAs, units a CTA, threads, shared memory bytes,
    launches and grid barriers for the call (and the streamed design's ring
    stages and m tiles)."""
    smem = _ltc.fwd_persist_smem(H)
    if not resets and _ltc._fits(B, H, n_sm, smem):
        ctas = H // _ltc.P_UNITS
        return dict(design="persistent", grid=(ctas,), ctas=ctas,
                    units=_ltc.P_UNITS, threads=_ltc.P_THREADS,
                    smem_bytes=smem, launches=1, barriers=max(T - 1, 0))
    if resets or B > _ltc.P_ROWS:
        plan = _stream_plan(T, B, H, n_sm)
        if plan is not None:
            return plan
    grid = (-(-B // 64), H // 32)
    return dict(design="per_step", grid=grid, ctas=grid[0] * grid[1],
                units=32, threads=256, smem_bytes=None, launches=T,
                barriers=0)


# The JAX gate's scoped-VMEM arithmetic (lstm_pallas.py `_est_vmem`,
# `_VMEM_LIMIT`, `_ROWS_FWD`, `_ROWS_TRAIN_BWD`): the largest W_hh and the
# U = 1 block set that its kernels take.
_VMEM_LIMIT = 100 * 1024 * 1024
_WHH_MAX_BYTES = 8 * 1024 * 1024
_ROWS_FWD = 5
_ROWS_TRAIN_BWD = 11


def est_vmem(U: int, B: int, H: int, row_elems: int, itemsize: int,
             reset: bool = False) -> int:
    """Upper-bound scoped-VMEM bytes of one grid step of the JAX package's
    LSTM kernels (``lstm_pallas._est_vmem``, term for term)."""
    G = 4 * H
    seq = 2 * U * B * row_elems * itemsize
    whh = 2 * H * G * itemsize
    fixed = (6 * B * H + G) * itemsize + 2 * B * H * 4 \
        + 2 * U * B * 8 * itemsize
    if reset:
        fixed += 2 * B * B * itemsize + 2 * U * B * 8 * itemsize
    return seq + whh + fixed


def lstm_kernel_ok(x: torch.Tensor, nhid: int, train: bool = False) -> bool:
    """The JAX package's ``pallas_lstm_ok(nhid, x.dtype, batch=B, train)``
    with a CUDA tensor in place of the TPU platform: W_hh within 8 MiB and
    the U = 1 block set within 0.9 of the VMEM budget (the reset kernel's
    for the forward, the backward's for training)."""
    itemsize = x.element_size()
    if not x.is_cuda or nhid * 4 * nhid * itemsize > _WHH_MAX_BYTES:
        return False
    rows = _ROWS_TRAIN_BWD if train else _ROWS_FWD
    return est_vmem(1, x.shape[1], nhid, rows * nhid, itemsize,
                    reset=not train) <= int(0.9 * _VMEM_LIMIT)


# The JAX gate of the fused 2-layer forward (lstm_pallas.py
# `pallas_lstm2_ok`, `_ROWS2_FWD`): its three resident weight blocks and
# the reset kernel's U = 1 block set at the batch.
_ROWS2_FWD = 5


def lstm2_fwd_ok(H: int, itemsize: int, B: int) -> bool:
    """The JAX package's ``pallas_lstm2_ok(H, dtype, batch=B)`` without
    its platform test, as a function of the width, the operands' item size
    and the batch: W_hh within 8 MiB in that dtype, and the reset kernel's
    U = 1 block set (``est_vmem2`` at ``_ROWS2_FWD``) within 0.9 of the VMEM
    budget. ``ops/lstm.py`` ``lstm_stack2`` asks it on every device, so
    where it admits a CPU call takes ``lstm2_fwd``'s plain version as
    before, and where it refuses both devices run two ``lstm_layer``
    calls, as JAX does."""
    from .lstm2_train_cuda import est_vmem2

    if H * 4 * H * itemsize > _WHH_MAX_BYTES:
        return False
    return est_vmem2(1, B, H, _ROWS2_FWD * H, itemsize, reset=True) \
        <= int(0.9 * _VMEM_LIMIT)


def apply_reset(state, reset_t, reset_src):
    """Columns with ``reset_t`` set take column ``reset_src``'s state (their
    chain's first hypothesis); zeros where the source is -1."""
    src = state.index_select(0, reset_src.clamp(min=0).long())
    src = src * (reset_src >= 0).to(state.dtype)[:, None]
    return torch.where(reset_t.bool()[:, None], src, state)


def cell_update(gates, h, c, keep=None):
    """LSTM cell from its gate pre-activations [i, f, g, o]; columns whose
    ``keep`` is 0 keep their previous (h, c)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    cn = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    hn = torch.sigmoid(o) * torch.tanh(cn)
    if keep is None:
        return hn, cn
    keep = keep.bool()[:, None]
    return torch.where(keep, hn, h), torch.where(keep, cn, c)


def lstm2_plain(xg1, whh1, bhh1, wih2, whh2, b2, h01, c01, h02, c02,
                step_mask=None, reset_mask=None, reset_src=None,
                acc=torch.float32):
    """Plain PyTorch version of the kernel, same arguments as
    ``lstm2_fwd``. ``acc`` is the dtype of the carries and sums: float64
    with float64 operands is chip_smoke.py's float64 reference."""
    dtype = whh1.dtype
    f32 = acc
    w1, wi2, w2 = (w.to(f32).t() for w in (whh1, wih2, whh2))
    h1, c1, h2, c2 = (s.to(f32) for s in (h01, c01, h02, c02))
    ys = []
    for t in range(xg1.shape[0]):
        if reset_mask is not None:
            h1, c1, h2, c2 = (apply_reset(s, reset_mask[t], reset_src)
                              for s in (h1, c1, h2, c2))
        keep = None if step_mask is None else step_mask[t]
        g1 = xg1[t].to(f32) + h1.to(dtype).to(f32) @ w1 + bhh1
        h1, c1 = cell_update(g1, h1, c1, keep)
        g2 = (h1.to(dtype).to(f32) @ wi2 + h2.to(dtype).to(f32) @ w2 + b2)
        h2, c2 = cell_update(g2, h2, c2, keep)
        ys.append(h2.to(dtype))
    return (torch.stack(ys), (h1.to(dtype), h2.to(dtype)),
            (c1.to(dtype), c2.to(dtype)))


def _check(name, t, dtype, shape, device, fn="lstm2_fwd"):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{fn}: {name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def lstm2_fwd(xg1: torch.Tensor, whh1: torch.Tensor, bhh1: torch.Tensor,
              wih2: torch.Tensor, whh2: torch.Tensor, b2: torch.Tensor,
              h01: torch.Tensor, c01: torch.Tensor, h02: torch.Tensor,
              c02: torch.Tensor, step_mask: Optional[torch.Tensor] = None,
              reset_mask: Optional[torch.Tensor] = None,
              reset_src: Optional[torch.Tensor] = None):
    """Both layers of a 2-layer LSTM over a (T, B) sequence.

    xg1 (T, B, 4H): x W_ih1^T + b_ih1 in the compute dtype; whh1, wih2,
    whh2 (4H, H) torch layout in the compute dtype; bhh1 = b_hh1 and
    b2 = b_ih2 + b_hh2, (4H,) float32; h0/c0 (B, H) per layer; step_mask
    and reset_mask (T, B), nonzero = set; reset_src (B,) int, -1 = zero
    state. Returns ys2 (T, B, H), (hT1, hT2), (cT1, cT2), all in the
    compute dtype. CUDA tensors launch a kernel by their dtype: bf16
    ``csrc/lstm2_fwd.cu`` in the design ``_design`` picks, float32
    ``lstm2_fwd_f32`` of ``csrc/lstm_f32.cu`` (2T launches); another
    dtype raises. CPU tensors run ``lstm2_plain``. Each call that reaches a
    kernel adds one to the module's ``launches`` and to its design's
    ``design_launches`` ("f32" for the float32 kernel; the persistent
    design is one launch a call, the per-step design 2T).
    """
    if not xg1.is_cuda:
        return lstm2_plain(xg1, whh1, bhh1, wih2, whh2, b2, h01, c01, h02,
                           c02, step_mask, reset_mask, reset_src)
    if xg1.dtype == torch.float32:
        return _lstm2_fwd_f32(xg1, whh1, bhh1, wih2, whh2, b2, h01, c01, h02,
                              c02, step_mask, reset_mask, reset_src)
    if xg1.dtype != torch.bfloat16:
        raise ValueError(f"lstm2_fwd: {xg1.dtype} operands; the kernels "
                         "take bf16 or float32")
    return _lstm2_fwd(None, xg1, whh1, bhh1, wih2, whh2, b2, h01, c01, h02,
                      c02, step_mask, reset_mask, reset_src)


def _checked2(dtype, xg1, whh1, bhh1, wih2, whh2, b2, h01, c01, h02, c02,
              step_mask, reset_mask, reset_src, width=32):
    """Validate ``lstm2_fwd``'s arguments for a kernel of operand ``dtype``
    (H a multiple of ``width``); returns (T, B, H, mask, reset, src) with
    the masks as contiguous bytes and the sources as int32, or None."""
    T, B, G = xg1.shape
    H = G // 4
    dev = xg1.device
    if G != 4 * H or H % width != 0:
        raise ValueError(f"lstm2_fwd: hidden size {G // 4} must be a "
                         f"multiple of {width} (xg1 width {G})")
    _check("xg1", xg1, dtype, (T, B, G), dev)
    for name, w in (("whh1", whh1), ("wih2", wih2), ("whh2", whh2)):
        _check(name, w, dtype, (G, H), dev)
    for name, b in (("bhh1", bhh1), ("b2", b2)):
        _check(name, b, torch.float32, (G,), dev)
    for name, s in (("h01", h01), ("c01", c01), ("h02", h02), ("c02", c02)):
        if tuple(s.shape) != (B, H) or s.device != dev:
            raise ValueError(f"lstm2_fwd: {name} must be ({B}, {H}) on {dev}")
    if (reset_mask is None) != (reset_src is None):
        raise ValueError("lstm2_fwd: reset_mask and reset_src go together")
    mask = None
    if step_mask is not None:
        mask = (step_mask != 0).to(torch.uint8).contiguous()
        _check("step_mask", mask, torch.uint8, (T, B), dev)
    reset = src = None
    if reset_mask is not None:
        reset = (reset_mask != 0).to(torch.uint8).contiguous()
        _check("reset_mask", reset, torch.uint8, (T, B), dev)
        src = reset_src.to(torch.int32).contiguous()
        _check("reset_src", src, torch.int32, (B,), dev)
    return T, B, H, mask, reset, src


def _lstm2_fwd(design, xg1, whh1, bhh1, wih2, whh2, b2, h01, c01, h02, c02,
               step_mask=None, reset_mask=None, reset_src=None):
    """``lstm2_fwd`` on bf16 CUDA tensors in ``design`` ("persistent" or
    "per_step"), or in the one ``_design`` picks where it is None;
    chip_smoke.py times the per-step design on the persistent design's
    calls through it. A design that does not take the shapes raises."""
    T, B, H, mask, reset, src = _checked2(
        torch.bfloat16, xg1, whh1, bhh1, wih2, whh2, b2, h01, c01, h02, c02,
        step_mask, reset_mask, reset_src)
    dev = xg1.device
    plan = _card_design(dev, T, B, H)
    if design is None:
        design = plan["design"]
    if design == "persistent" and plan["design"] != "persistent":
        raise ValueError(f"lstm2_fwd: the persistent design does not take "
                         f"T={T} B={B} H={H}")
    run = _persistent if design == "persistent" else _per_step
    out = run(plan, xg1, whh1, bhh1, wih2, whh2, b2, h01, c01, h02, c02,
              mask, reset, src)
    global launches
    launches += 1
    design_launches[design] += 1
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _per_step(plan, xg1, whh1, bhh1, wih2, whh2, b2, h01, c01, h02, c02,
              mask, reset, src):
    T, B, G = xg1.shape
    H = G // 4
    dev = xg1.device
    bf16 = torch.bfloat16
    states = []
    for s0 in ((h01, c01), (h02, c02)):
        pair = []
        for s in s0:
            buf = torch.empty((2, B, H), dtype=torch.float32, device=dev)
            buf[0].copy_(s)
            pair.append(buf)
        states.append(pair)
    (h1, c1), (h2, c2) = states
    ys = torch.empty((T, B, H), dtype=bf16, device=dev)
    fn = _build.load("lstm2_fwd").lstm2_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(_ptr(xg1), _ptr(whh1), _ptr(bhh1), _ptr(wih2), _ptr(whh2),
             _ptr(b2), _ptr(mask), _ptr(reset), _ptr(src), _ptr(h1),
             _ptr(c1), _ptr(h2), _ptr(c2), _ptr(ys), T, B, H,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm2_fwd kernel launch failed: CUDA error {err}")
    f = T % 2
    return (ys, (h1[f].to(bf16), h2[f].to(bf16)),
            (c1[f].to(bf16), c2[f].to(bf16)))


def _f32_states(dev, B, H, *states):
    """(2, B, H) fp32 ping-pong buffers, each with its initial state in
    slot 0 (the float32 kernels' layout)."""
    bufs = []
    for s in states:
        buf = torch.empty((2, B, H), dtype=torch.float32, device=dev)
        buf[0].copy_(s)
        bufs.append(buf)
    return bufs


def _lstm2_fwd_f32(xg1, whh1, bhh1, wih2, whh2, b2, h01, c01, h02, c02,
                   step_mask=None, reset_mask=None, reset_src=None):
    """``lstm2_fwd`` on float32 CUDA tensors: ``lstm2_fwd_f32`` of
    ``csrc/lstm_f32.cu``, two launches a step; any H."""
    T, B, H, mask, reset, src = _checked2(
        torch.float32, xg1, whh1, bhh1, wih2, whh2, b2, h01, c01, h02, c02,
        step_mask, reset_mask, reset_src, width=1)
    dev = xg1.device
    h1, c1, h2, c2 = _f32_states(dev, B, H, h01, c01, h02, c02)
    ys = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    fn = _build.load("lstm_f32").lstm2_fwd_f32
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(_ptr(xg1), _ptr(whh1), _ptr(bhh1), _ptr(wih2), _ptr(whh2),
             _ptr(b2), _ptr(mask), _ptr(reset), _ptr(src), _ptr(h1),
             _ptr(c1), _ptr(h2), _ptr(c2), _ptr(ys), T, B, H,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm2_fwd float32 kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    design_launches["f32"] += 1
    f = T % 2
    return ys, (h1[f], h2[f]), (c1[f], c2[f])


def _marks(reset, src):
    """marks[t, s] (T, B) bytes: another column takes column s's state at
    step t, so the owners of s's units store its product rows for it; None
    without resets."""
    if reset is None:
        return None
    T, B = reset.shape
    dev = reset.device
    cols = torch.arange(B, dtype=torch.int32, device=dev)
    takes = (reset != 0) & ((src >= 0) & (src != cols))[None, :]
    marks = torch.zeros((T, B), dtype=torch.int32, device=dev)
    marks.scatter_add_(1, src.clamp(min=0).long().expand(T, B),
                       takes.to(torch.int32))
    return (marks > 0).to(torch.uint8)


def _persistent(plan, xg1, whh1, bhh1, wih2, whh2, b2, h01, c01, h02, c02,
                mask, reset, src):
    T, B, G = xg1.shape
    H = G // 4
    dev = xg1.device
    bf16 = torch.bfloat16
    # fp32 carries with the initial state in slot 1 (step s in slot s % 2);
    # layer 1's raw bf16 h the same way; ys with bf16(h02) in front
    carries = [torch.empty((2, B, H), dtype=torch.float32, device=dev)
               for _ in range(4)]
    for buf, s in zip(carries, (h01, c01, h02, c02)):
        buf[1].copy_(s)
    h1, c1, h2, c2 = carries
    r1 = torch.empty((2, B, H), dtype=bf16, device=dev)
    r1[1].copy_(h01)
    y = torch.empty((T + 1, B, H), dtype=bf16, device=dev)
    y[0].copy_(h02)
    prod = torch.empty((plan["ctas"], B, Q_PC), dtype=torch.float32,
                       device=dev)
    marks = _marks(reset, src)
    bar = torch.zeros((1,), dtype=torch.int32, device=dev)
    fn = _build.load("lstm2_fwd").lstm2_fwd_persistent
    fn.argtypes, fn.restype = _PERSIST_ARGTYPES, ctypes.c_int
    err = fn(_ptr(xg1), _ptr(whh1), _ptr(bhh1), _ptr(wih2), _ptr(whh2),
             _ptr(b2), _ptr(mask), _ptr(reset), _ptr(src), _ptr(marks),
             _ptr(h1), _ptr(c1), _ptr(h2), _ptr(c2), _ptr(r1), _ptr(y),
             _ptr(prod), _ptr(bar), T, B, H, plan["stages"],
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm2_fwd persistent launch failed: error {err}")
    f = (T - 1) % 2
    return (y[1:], (h1[f].to(bf16), h2[f].to(bf16)),
            (c1[f].to(bf16), c2[f].to(bf16)))


def lstm_fwd_plain(xg, whh, bhh, h0, c0, step_mask=None, reset_mask=None,
                   reset_src=None, acc=torch.float32):
    """Plain PyTorch version of the kernel, same arguments as
    ``lstm_fwd``; ``acc`` as ``lstm2_plain``'s."""
    dtype = whh.dtype
    f32 = acc
    w = whh.to(f32).t()
    h, c = h0.to(f32), c0.to(f32)
    ys = []
    for t in range(xg.shape[0]):
        if reset_mask is not None:
            h, c = (apply_reset(s, reset_mask[t], reset_src) for s in (h, c))
        keep = None if step_mask is None else step_mask[t]
        g = xg[t].to(f32) + h.to(dtype).to(f32) @ w + bhh
        h, c = cell_update(g, h, c, keep)
        ys.append(h.to(dtype))
    return torch.stack(ys), h.to(dtype), c.to(dtype)


def lstm_fwd(xg: torch.Tensor, whh: torch.Tensor, bhh: torch.Tensor,
             h0: torch.Tensor, c0: torch.Tensor,
             step_mask: Optional[torch.Tensor] = None,
             reset_mask: Optional[torch.Tensor] = None,
             reset_src: Optional[torch.Tensor] = None):
    """One LSTM layer over a (T, B) sequence, forward only.

    xg (T, B, 4H): x W_ih^T + b_ih in the compute dtype; whh (4H, H) torch
    layout in the compute dtype; bhh (4H,) float32; h0, c0 (B, H);
    step_mask and reset_mask (T, B), nonzero = set; reset_src (B,) int,
    -1 = zero state. Returns ys (T, B, H), hT, cT (B, H), in the compute
    dtype. CUDA tensors launch a kernel by their dtype (with resets kernel
    row 3's replacement, without row 4's): bf16 ``csrc/lstm_fwd.cu`` in the
    design ``_design_fwd`` picks, float32 ``lstm_fwd_f32`` of
    ``csrc/lstm_f32.cu`` (T launches); another dtype raises. CPU tensors
    run ``lstm_fwd_plain``. Each call that reaches a kernel adds one to
    ``layer_launches`` and to its design's ``layer_design_launches`` ("f32"
    for the float32 kernel; the persistent and streamed designs are one
    launch a call, the per-step design T).
    """
    if not xg.is_cuda:
        return lstm_fwd_plain(xg, whh, bhh, h0, c0, step_mask, reset_mask,
                              reset_src)
    if xg.dtype == torch.float32:
        return _lstm_fwd_f32(xg, whh, bhh, h0, c0, step_mask, reset_mask,
                             reset_src)
    if xg.dtype != torch.bfloat16:
        raise ValueError(f"lstm_fwd: {xg.dtype} operands; the kernels take "
                         "bf16 or float32")
    return _lstm_fwd(None, xg, whh, bhh, h0, c0, step_mask, reset_mask,
                     reset_src)


def _checked1(dtype, xg, whh, bhh, h0, c0, step_mask, reset_mask, reset_src,
              width=32):
    """Validate ``lstm_fwd``'s arguments for a kernel of operand ``dtype``
    (H a multiple of ``width``); returns (T, B, H, mask, reset, src) with
    the masks as contiguous bytes and the sources as int32, or None."""
    T, B, G = xg.shape
    H = G // 4
    dev = xg.device
    if G != 4 * H or H % width != 0:
        raise ValueError(f"lstm_fwd: hidden size {G / 4} must be a multiple "
                         f"of {width} (xg width {G})")
    _check("xg", xg, dtype, (T, B, G), dev, fn="lstm_fwd")
    _check("whh", whh, dtype, (G, H), dev, fn="lstm_fwd")
    _check("bhh", bhh, torch.float32, (G,), dev, fn="lstm_fwd")
    for name, s in (("h0", h0), ("c0", c0)):
        if tuple(s.shape) != (B, H) or s.device != dev:
            raise ValueError(f"lstm_fwd: {name} must be ({B}, {H}) on {dev}")
    if (reset_mask is None) != (reset_src is None):
        raise ValueError("lstm_fwd: reset_mask and reset_src go together")
    mask = reset = src = None
    if step_mask is not None:
        mask = (step_mask != 0).to(torch.uint8).contiguous()
        _check("step_mask", mask, torch.uint8, (T, B), dev, fn="lstm_fwd")
    if reset_mask is not None:
        reset = (reset_mask != 0).to(torch.uint8).contiguous()
        _check("reset_mask", reset, torch.uint8, (T, B), dev, fn="lstm_fwd")
        src = reset_src.to(torch.int32).contiguous()
        _check("reset_src", src, torch.int32, (B,), dev, fn="lstm_fwd")
    return T, B, H, mask, reset, src


def _lstm_fwd_f32(xg, whh, bhh, h0, c0, step_mask=None, reset_mask=None,
                  reset_src=None):
    """``lstm_fwd`` on float32 CUDA tensors: ``lstm_fwd_f32`` of
    ``csrc/lstm_f32.cu``, one launch a step; any H."""
    T, B, H, mask, reset, src = _checked1(
        torch.float32, xg, whh, bhh, h0, c0, step_mask, reset_mask,
        reset_src, width=1)
    dev = xg.device
    h, c = _f32_states(dev, B, H, h0, c0)
    ys = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    fn = _build.load("lstm_f32").lstm_fwd_f32
    fn.argtypes, fn.restype = _FWD_ARGTYPES, ctypes.c_int
    err = fn(_ptr(xg), _ptr(whh), _ptr(bhh), _ptr(mask), _ptr(reset),
             _ptr(src), _ptr(h), _ptr(c), _ptr(ys), T, B, H,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_fwd float32 kernel launch failed: CUDA "
                           f"error {err}")
    layer_launches["lstm_fwd_reset" if reset is not None else "lstm_fwd"] += 1
    layer_design_launches["f32"] += 1
    return ys, h[T % 2], c[T % 2]


def _lstm_fwd(design, xg, whh, bhh, h0, c0, step_mask=None, reset_mask=None,
              reset_src=None):
    """``lstm_fwd`` on CUDA tensors in ``design`` ("persistent", "streamed"
    or "per_step"), or in the one ``_design_fwd`` picks where it is None;
    chip_smoke.py times the per-step design on the other designs' calls
    through it. A design that does not take the call raises."""
    T, B, H, mask, reset, src = _checked1(
        torch.bfloat16, xg, whh, bhh, h0, c0, step_mask, reset_mask,
        reset_src)
    dev = xg.device
    bf16 = torch.bfloat16
    n_sm = _build.sm_count(dev.index)
    rule = _design_fwd(T, B, H, n_sm, resets=reset is not None)["design"]
    if design is None:
        design = rule
    if design == "persistent" and rule != "persistent":
        raise ValueError(f"lstm_fwd: the persistent design does not take "
                         f"T={T} B={B} H={H}"
                         + (" with resets" if reset is not None else ""))
    if design == "streamed":
        plan = _stream_plan(T, B, H, n_sm)
        if plan is None:
            raise ValueError(f"lstm_fwd: the streamed design does not take "
                             f"T={T} B={B} H={H}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load("lstm_fwd")
    if design == "streamed":
        ys, hT, cT, err = _stream(lib, plan, xg, whh, bhh, h0, c0, mask,
                                  reset, src, stream)
    elif design == "persistent":
        # fp32 carries, the initial state in and the final state out; the
        # first step's product takes h0 in bf16
        ys = torch.empty((T, B, H), dtype=bf16, device=dev)
        h = torch.empty((B, H), dtype=torch.float32, device=dev)
        c = torch.empty_like(h)
        h.copy_(h0)
        c.copy_(c0)
        h0b = h0.to(bf16).contiguous()
        bar = torch.zeros((1,), dtype=torch.int32, device=dev)
        fn = lib.lstm_fwd_persistent
        fn.argtypes, fn.restype = _FWD_ARGTYPES, ctypes.c_int
        err = fn(_ptr(xg), _ptr(whh), _ptr(bhh), _ptr(mask), _ptr(h0b),
                 _ptr(h), _ptr(c), _ptr(ys), _ptr(bar), T, B, H, stream)
        hT, cT = h, c
    else:
        ys = torch.empty((T, B, H), dtype=bf16, device=dev)
        h = torch.empty((2, B, H), dtype=torch.float32, device=dev)
        c = torch.empty_like(h)
        h[0].copy_(h0)
        c[0].copy_(c0)
        fn = lib.lstm_fwd
        fn.argtypes, fn.restype = _FWD_ARGTYPES, ctypes.c_int
        err = fn(_ptr(xg), _ptr(whh), _ptr(bhh), _ptr(mask), _ptr(reset),
                 _ptr(src), _ptr(h), _ptr(c), _ptr(ys), T, B, H, stream)
        hT, cT = h[T % 2], c[T % 2]
    if err != 0:
        raise RuntimeError(f"lstm_fwd {design} launch failed: CUDA error "
                           f"{err}")
    layer_launches["lstm_fwd_reset" if reset is not None else "lstm_fwd"] += 1
    layer_design_launches[design] += 1
    return ys, hT.to(bf16), cT.to(bf16)


def _stream(lib, plan, xg, whh, bhh, h0, c0, mask, reset, src, stream):
    """The streamed design's launch: fp32 carries with the initial state in
    slot 1 (step s in slot s % 2), ys with bf16(h0) in front (the first
    step's product operand), the CTAs' product-row scratch. Returns ys, the
    final fp32 state and the launch's error code."""
    T, B, G = xg.shape
    H = G // 4
    dev = xg.device
    h = torch.empty((2, B, H), dtype=torch.float32, device=dev)
    c = torch.empty_like(h)
    h[1].copy_(h0)
    c[1].copy_(c0)
    y = torch.empty((T + 1, B, H), dtype=torch.bfloat16, device=dev)
    y[0].copy_(h0)
    prod = torch.empty((plan["ctas"], B, 4 * plan["units"]),
                       dtype=torch.float32, device=dev)
    marks = _marks(reset, src)
    bar = torch.zeros((1,), dtype=torch.int32, device=dev)
    fn = lib.lstm_fwd_stream
    fn.argtypes, fn.restype = _STREAM_ARGTYPES, ctypes.c_int
    err = fn(_ptr(xg), _ptr(whh), _ptr(bhh), _ptr(mask), _ptr(reset),
             _ptr(src), _ptr(marks), _ptr(h), _ptr(c), _ptr(y), _ptr(prod),
             _ptr(bar), T, B, H, plan["stages"], stream)
    f = (T - 1) % 2
    return y[1:], h[f], c[f], err
