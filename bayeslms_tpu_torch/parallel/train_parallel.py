"""Data- and tensor-parallel training steps, counterpart of
``bayeslms_tpu/parallel/train_parallel.py`` (``make_sharded_train_step``,
its shard_map dp step and ``_make_shardmap_tp_step``) and of the mesh paths
of ``bayeslms_tpu/train/loop.py``. ``train.loop.Trainer(..., mesh=...)``
calls them; every rank runs the same code on its own shard.

- ``dp_step`` (a mesh with tp = 1): each rank runs the whole one-device
  step (every fused kernel) on its B / dp columns; the gradients, loss, mle
  and KL are averaged over dp before ``sgd_momentum_step``, so every rank
  applies the identical update. Dropout draws from the rank's own stream,
  the Bayesian, GP and variational draws from one stream that is the same
  on every rank (``utils/rng.py``): one posterior draw a step for the whole
  batch, as the JAX step keeps its sample key shared.
- ``tp_step`` (tp > 1): the tied embedding / decoder and ``decoder_b`` are
  split over tp by vocabulary rows (``shard_model``), every other
  parameter is replicated. The embedding is a masked lookup in the rank's
  rows summed over tp; the model body runs on B / (dp tp) columns; the
  pre-decoder states are gathered over tp and each rank runs rows 9-11 on
  its rows for the whole tp group's tokens (``ce_train_cuda.
  fused_decode_ce_train_spmd``), the partials merged by a logsumexp. Each
  rank's loss covers only its own columns. The collectives' transposes
  (``parallel/mesh.py`` ``gather``, ``psum``) sum the tp ranks'
  cotangents, so, as the JAX docstring sets out: replicated gradients are
  averaged over tp, then over dp; the vocabulary shards' are divided by
  tp, then averaged over dp; the clip norm is sqrt(replicated^2 + sum over
  tp of shard^2), handed to ``sgd_momentum_step(gnorm=)``.

``check`` refuses, with ``NotImplementedError`` naming ROADMAP.md item
A13b, what the JAX package partitions with GSPMD instead (its
``ops/kernel_gate.py`` keeps the Pallas kernels out of that trace; PyTorch
has no such trace, and the port has no GSPMD path): a tp mesh with an
untied decoder, a vocabulary or batch that does not divide, or the
Transformer's Bayesian EMB; a dp batch that does not divide.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..models.lstm_lm import DropoutMasks
from ..models.transformer_lm import (EncoderDropoutMasks,
                                     TransformerDropoutMasks)
from ..ops.ce_train_cuda import fused_decode_ce_train_spmd
from ..train.optim import sgd_momentum_step
from .mesh import (Mesh, all_gather, all_reduce, batch_columns, gather,
                   mean_, psum)

# the parameters split over tp by vocabulary rows
VOCAB_LEAVES = ("embedding", "decoder_b")


def check(cfg, tcfg, dp: int, tp: int) -> None:
    """Raise ``NotImplementedError`` (ROADMAP.md A13b) where the steps of
    a (dp, tp) mesh do not take ``cfg`` / ``tcfg`` (a vocabulary of 0, not
    known yet, is not checked)."""
    why = []
    if tp > 1:
        if not cfg.tied:
            why.append("an untied decoder")
        if cfg.vocab_size and cfg.vocab_size % tp:
            why.append(f"a vocabulary of {cfg.vocab_size} over tp {tp}")
        if cfg.is_transformer and cfg.uncertainty == "Bayesian" \
                and cfg.t_bayes_pos == "EMB":
            why.append("the Transformer's Bayesian EMB")
    if tcfg.batch_size % (dp * tp):
        why.append(f"a batch of {tcfg.batch_size} over dp {dp} x tp {tp}")
    if why:
        raise NotImplementedError(
            f"the (dp {dp}, tp {tp}) mesh with {', '.join(why)}: the JAX "
            "package partitions these with GSPMD, which is not ported "
            "(ROADMAP.md queue A item A13b)")


def dropout_seed(seed: int, rank: int) -> int:
    """The seed of a rank's own dropout stream."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def columns_axis(mesh: Mesh) -> str:
    """The axis a window's columns split over: dp, or dp x tp ("all")."""
    return "all" if mesh.tp > 1 else "dp"


def cut_masks(masks, mesh: Mesh, axis: str):
    """This rank's columns of one forward's dropout masks (LSTM or
    Transformer; the attention masks' batch is their first axis)."""
    if masks is None:
        return None

    def cut(x, dim=1):
        return None if x is None else batch_columns(mesh, x, axis, dim)

    if isinstance(masks, DropoutMasks):
        layer = masks.layer
        if isinstance(layer, (list, tuple)):
            layer = tuple(cut(x) for x in layer)
        else:
            layer = cut(layer)
        return DropoutMasks(cut(masks.emb), layer, cut(masks.out))
    if isinstance(masks, TransformerDropoutMasks):
        return TransformerDropoutMasks(cut(masks.emb), [
            EncoderDropoutMasks(cut(m.attn, 0), cut(m.attn_out), cut(m.ff),
                                cut(m.ff_out)) for m in masks.layers])
    raise TypeError(f"dropout masks of type {type(masks).__name__}")


# ---------------------------------------------------- vocabulary shards

def _rows(mesh: Mesh, n: int) -> slice:
    v = n // mesh.tp
    return slice(mesh.tp_index * v, (mesh.tp_index + 1) * v)


def shard_model(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Replace the model's embedding and ``decoder_b`` by this rank's
    vocabulary rows (in place; a no-op at tp = 1)."""
    if mesh.tp > 1:
        for k in VOCAB_LEAVES:
            p = getattr(model, k)
            setattr(model, k, torch.nn.Parameter(
                p.detach()[_rows(mesh, p.shape[0])].clone()))
    return model


def shard_tree(tree: Mapping, mesh: Mesh) -> dict:
    """A full parameter tree (the JAX layout) with the vocabulary leaves
    cut to this rank's rows."""
    if mesh.tp == 1:
        return dict(tree)
    out = dict(tree)
    for k in VOCAB_LEAVES:
        a = np.asarray(tree[k])
        out[k] = a[_rows(mesh, a.shape[0])]
    return out


def full_leaf(mesh: Mesh, name: str, t: torch.Tensor) -> torch.Tensor:
    """A parameter (or momentum) tensor whole: the vocabulary leaves
    gathered over tp (every tp rank must call it), the rest as they are."""
    if mesh.tp > 1 and name in VOCAB_LEAVES:
        return all_gather(mesh, t, "tp", dim=0)
    return t.detach()


# ------------------------------------------------------------------ steps

def _stats(mesh: Mesh, mle, kl, mle_axis: str):
    """(mle averaged over ``mle_axis``, kl averaged over dp)."""
    n = mesh.size(mle_axis)
    mle = all_reduce(mesh, mle.detach(), mle_axis) / n
    kl = all_reduce(mesh, kl.detach(), "dp") / mesh.dp
    return mle, kl


def _detach(hidden):
    return None if hidden is None else (hidden[0].detach(),
                                        hidden[1].detach())


def dp_step(tr, state, hidden, data, target, kl_scale: float,
            mask: Optional[torch.Tensor], dropout_masks, noise):
    """One data-parallel step (see the module's docstring). ``data``,
    ``target``, ``mask`` and ``dropout_masks`` are the whole batch's, cut
    here to this rank's columns; ``hidden`` is this rank's state."""
    mesh = tr.mesh
    cut = lambda x: None if x is None else batch_columns(  # noqa: E731
        mesh, x, "dp")
    params = state.params
    for p in params.values():
        p.grad = None
    mle, kl, new_hidden = tr._loss(
        state.model, hidden, cut(data), cut(target), kl_scale, cut(mask),
        cut_masks(dropout_masks, mesh, "dp"), noise)
    (mle + kl).backward()
    grads = tr._grads(params)
    mean_(mesh, list(grads.values()), "dp")
    mle, kl = _stats(mesh, mle, kl, "dp")
    _, gnorm = sgd_momentum_step(params, grads, state.opt_state, state.lr,
                                 tr.tcfg.clip, tr.tcfg.momentum)
    return _detach(new_hidden), mle + kl, mle, kl, gnorm


def reduce_grads(mesh: Mesh, grads: Mapping[str, torch.Tensor]):
    """The tp step's gradient bookkeeping, in place: vocabulary shards
    divided by tp, replicated gradients averaged over tp, then all averaged
    over dp. Returns the global norm over every shard."""
    shard = [g for k, g in grads.items() if k in VOCAB_LEAVES]
    rep = [g for k, g in grads.items() if k not in VOCAB_LEAVES]
    for g in shard:
        g.div_(mesh.tp)
    mean_(mesh, rep, "tp")
    mean_(mesh, list(grads.values()), "dp")
    zero = torch.zeros((), device=mesh.device)
    rep_sq = sum((g.float().pow(2).sum() for g in rep), zero)
    shard_sq = sum((g.float().pow(2).sum() for g in shard), zero)
    return torch.sqrt(rep_sq + all_reduce(mesh, shard_sq, "tp"))


def tp_step(tr, state, hidden, data, target, kl_scale: float,
            mask: Optional[torch.Tensor], dropout_masks, noise):
    """One tensor-parallel step (see the module's docstring); arguments as
    ``dp_step``'s, ``hidden`` this rank's B / (dp tp) columns."""
    mesh, cfg = tr.mesh, tr.mcfg
    model = state.model
    tp, ti = mesh.tp, mesh.tp_index
    params = state.params
    for p in params.values():
        p.grad = None
    # this dp shard's columns are the tp group's; this rank's are its
    # ti-th block of them
    d_grp = batch_columns(mesh, data, "dp")
    t_grp = batch_columns(mesh, target, "dp")
    b_loc = d_grp.shape[1] // tp
    loc = slice(ti * b_loc, (ti + 1) * b_loc)
    emb_l, bias_l = model.embedding, model.decoder_b
    v_loc = emb_l.shape[0]
    # the embedding: a masked lookup in this rank's rows, summed over tp
    ids = d_grp - ti * v_loc
    hit = (ids >= 0) & (ids < v_loc)
    e = emb_l[ids.clamp(0, v_loc - 1)] * hit[..., None]
    e_loc = psum(mesh, e, "tp")[:, loc]
    kw = dict(return_hidden=True, deterministic=False, generator=tr.streams,
              dropout_masks=cut_masks(dropout_masks, mesh, "all"),
              noise=noise, emb_in=e_loc)
    if tr.is_tm:
        out, new_hidden = model(d_grp[:, loc], **kw), None
    else:
        out, new_hidden = model(d_grp[:, loc], hidden, **kw)
    T, _, H = out.shape
    dtype = getattr(torch, cfg.compute_dtype)
    h_grp = gather(mesh, out.to(dtype), "tp", dim=1)
    ce = fused_decode_ce_train_spmd(h_grp.reshape(-1, H), emb_l, bias_l,
                                    t_grp.reshape(-1), mesh)
    # this rank's own columns only: each token's loss counted once
    ce_loc = ce.reshape(T, -1)[:, loc]
    if mask is None:
        mle = ce_loc.mean()
    else:
        m = batch_columns(mesh, mask, "all")
        n_grp = all_reduce(mesh, m.sum(), "tp")
        mle = tp * (ce_loc * m).sum() / n_grp.clamp(min=1)
    kl = tr._kl(model) * kl_scale
    (mle + kl).backward()
    grads = tr._grads(params)
    gnorm = reduce_grads(mesh, grads)
    mle, kl = _stats(mesh, mle, kl, "all")
    _, gnorm = sgd_momentum_step(params, grads, state.opt_state, state.lr,
                                 tr.tcfg.clip, tr.tcfg.momentum, gnorm=gnorm)
    return _detach(new_hidden), mle + kl, mle, kl, gnorm


def train_step(tr, *args):
    """The mesh's step: ``tp_step`` where tp > 1, else ``dp_step``."""
    return (tp_step if tr.mesh.tp > 1 else dp_step)(tr, *args)
