"""Training loop, counterpart of ``bayeslms_tpu/train/loop.py`` on one
device: MLE with the fused decoder CE, SGD with momentum, the plateau
scheduler.

Reference behaviours (train.py), as the JAX package keeps them:
- loss = mean token CE + KL * seq_len / rows of the batchified stream; the
  standard models have no KL, the Bayesian and GP ones' is the model's
  ``kl_value`` (the LSTM core's, the GP-LSTM core's GPNN KLs, or the
  Transformer's dispatch over FFN, MHA, EMB and the GP-FFN layer; against
  N(0, 1), or with
  ``prior_kl`` against the prior's means where the reference has that
  branch);
- the prior / finetune workflow: ``prior`` with ``prior_path`` overwrites
  every parameter that the prior checkpoint (the port's own, a JAX
  ``.ckpt`` or a reference ``model.pt``) holds with the same name and
  shape, and keeps the fresh lgstds;
- SGD momentum 0.9 after a global-norm clip;
- the LSTM state carried, detached, across the windows of an epoch and
  zeroed at each epoch's start (the Transformer carries nothing); the
  ragged final window padded to ``seq_len`` with the CE masked, the model
  running over the pad steps (causal, so the real tokens' CE is exact);
- per-epoch validation; on improvement save the best checkpoint, else
  halve the LR, reload the best checkpoint and reset the momentum; stop
  after ``max_plateaus`` plateaus; the test loss of the best checkpoint
  at the end;
- eval: deterministic (no dropout), token-exact mean CE including the
  ragged final window.

The step runs the model's training forward (LSTM grad route: CUDA kernels
``lstm_train_cuda``; the Bayesian core's gate-slice sampler
``bayes_sample_cuda``, its seeds drawn on the device from the trainer's
generator; the GP cell's recurrence ``gp_lstm_cuda`` (gates 1-4 and 6;
gate 7 on ``lstm_train_cuda``); the Transformer's
plain attention and dense layers, and kernel row 12 where a ``BayesDense``
has ``use_fused``) and the differentiable
fused CE (``ce_train_cuda``) over the model's pre-decoder states, width
nhid (LSTM) or emsize (Transformer); ``evaluate`` runs the scoring route
(``lstm_cuda.lstm2_fwd``; for the GP-LSTM ``gp_lstm_cuda`` and
``lstm_cuda.lstm_fwd``; for the Transformer a causal forward per window,
its attention through ``attention_cuda``) and the decoder's logits and CE
as plain PyTorch, as the JAX package leaves them to XLA there. Entry
points run on the card; ``device="cpu"`` (tests) runs every kernel's
plain twin.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.checkpoint import (load_checkpoint, load_params,
                               params_from_jax, params_to_jax,
                               partial_update, save_checkpoint)
from ..core.config import ModelConfig, TrainConfig
from ..core.registry import build_model, init_params
from ..data.corpus import apply_data_fraction, batchify, get_batch, windows
from ..models.lstm_lm import init_hidden
from ..ops.ce_train_cuda import fused_decode_ce_train
from .optim import OptState, init_opt_state, sgd_momentum_step


@dataclass
class TrainerState:
    model: torch.nn.Module  # RecurrentLM or TransformerLM, float32
    # parameters on the trainer's device
    opt_state: OptState
    lr: float
    best_val_loss: Optional[float]
    plateaus: int
    epoch: int

    @property
    def params(self):
        return dict(self.model.named_parameters())


class Trainer:
    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 device=None):
        """``device``: where the model trains; None means ``cuda``, which
        must be present (no CPU fallback)."""
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer: no CUDA device; pass device='cpu' to train on the "
                "CPU with the kernels' plain versions")
        self.mcfg = model_cfg.validate()
        self.tcfg = train_cfg.validate()
        self.device = device
        self.is_tm = model_cfg.is_transformer
        # dropout masks and the Bayesian draws; the JAX package's rng_impl
        # has no counterpart here
        self.gen = torch.Generator(device=device).manual_seed(train_cfg.seed)
        # prior means for the KL (prior_kl), on the device, set by
        # init_state: (weight_hh_mean_1, weight_ih_mean_1) for the Bayesian
        # LSTM, the weight_mean at ``bayes_site`` for a Bayesian FFN or MHA
        # Transformer
        self.prior_w = None

    # ------------------------------------------------------------------ init
    def init_state(self, seed: Optional[int] = None) -> TrainerState:
        seed = self.tcfg.seed if seed is None else seed
        model = build_model(self.mcfg)
        tree = init_params(model, self.mcfg, seed=seed)
        tcfg = self.tcfg
        if tcfg.prior and tcfg.prior_path:
            prior = load_params(tcfg.prior_path, self.mcfg)
            tree, updated = partial_update(tree, prior)
            params_from_jax(model, tree)
            print(f"prior init: updated {len(updated)} param tensors")
            if tcfg.prior_kl:
                self.prior_w = self._prior_means(model, prior)
        model.to(self.device)
        return TrainerState(model=model,
                            opt_state=init_opt_state(dict(model.named_parameters())),
                            lr=self.tcfg.lr, best_val_loss=None, plateaus=0,
                            epoch=0)

    def _prior_means(self, model, prior):
        """The prior's means that the model's KL reads, or None where the
        prior holds none (a standard prior: the KL stays against N(0, 1),
        as the JAX package's ``priors`` lookup finds nothing)."""
        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=self.device)

        if self.is_tm:
            site = model.bayes_site()
            node = prior if site else {}
            for k in site or ():
                node = node.get(k, {})
            mean = node.get("weight_mean")
            return None if mean is None else dev(mean)
        core = prior.get("core", {})
        if {"weight_hh_mean_1", "weight_ih_mean_1"} <= set(core):
            return tuple(dev(core[k]) for k in ("weight_hh_mean_1",
                                                "weight_ih_mean_1"))
        return None

    # ------------------------------------------------------------------ step
    def _kl(self, model) -> torch.Tensor:
        if self.is_tm:
            return model.kl_value(self.prior_w)
        kl_value = getattr(model.core, "kl_value", None)
        if kl_value is None:
            return torch.zeros((), device=self.device)
        return kl_value(self.prior_w)

    def train_step(self, state: TrainerState, hidden, data: torch.Tensor,
                   target: torch.Tensor, kl_scale: float = 0.0,
                   mask: Optional[torch.Tensor] = None,
                   dropout_masks=None, noise=None):
        """One optimizer step on a (T, B) window; updates ``state``'s
        parameters and momentum in place. ``hidden`` is the LSTM state (None
        for the Transformer, which carries none). ``mask`` (T, B) 0/1
        averages the CE over the real tokens of the padded ragged window.
        ``dropout_masks`` (``lstm_lm.DropoutMasks`` or
        ``transformer_lm.TransformerDropoutMasks``) replaces the masks drawn
        from the trainer's generator, ``noise`` the Bayesian draws (see
        ``BayesLSTMCore``, ``TransformerLM``). Returns (new hidden, detached,
        or None; loss, mle, kl, gnorm as device scalars)."""
        model = state.model
        params = state.params
        for p in params.values():
            p.grad = None
        kw = dict(return_hidden=True, deterministic=False, generator=self.gen,
                  dropout_masks=dropout_masks, noise=noise)
        if self.is_tm:
            out, new_hidden = model(data, **kw), None
        else:
            out, new_hidden = model(data, hidden, **kw)
        T, B, H = out.shape
        # the CE's operand in the compute dtype: a GP cell on the scan
        # (gate 5, GPNN2) carries the float32 state it started from, as
        # JAX's scan promotes it, and its output would reach the CE in
        # float32, which the kernels do not take
        dtype = getattr(torch, self.mcfg.compute_dtype)
        ce = fused_decode_ce_train(out.reshape(T * B, H).to(dtype),
                                   model.embedding, model.decoder_b,
                                   target.reshape(-1)).reshape(T, B)
        if mask is None:
            mle = ce.mean()
        else:
            mle = (ce * mask).sum() / mask.sum().clamp(min=1)
        kl = self._kl(model) * kl_scale
        loss = mle + kl
        loss.backward()
        # a parameter the loss does not reach (the GP cell's bias_hh, as
        # in the reference) has a zero gradient, as in JAX
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in params.items()}
        _, gnorm = sgd_momentum_step(params, grads, state.opt_state, state.lr,
                                     self.tcfg.clip, self.tcfg.momentum)
        if new_hidden is not None:
            new_hidden = (new_hidden[0].detach(), new_hidden[1].detach())
        return new_hidden, loss.detach(), mle.detach(), kl.detach(), gnorm

    # ------------------------------------------------------------------ epoch
    def run_epoch(self, state: TrainerState, train_rows: np.ndarray,
                  log=print, on_step: Optional[Callable] = None):
        """One pass over the batchified stream. ``on_step(b, loss)`` is
        called after each step's launch (b = window index, the ragged
        window last)."""
        tcfg, cfg = self.tcfg, self.mcfg
        data_all, tgt_all, tail = windows(train_rows, tcfg.seq_len,
                                          drop_ragged=False)
        kl_scale = tcfg.seq_len / train_rows.shape[0]
        hidden = None if self.is_tm else init_hidden(
            cfg.nlayers, train_rows.shape[1], cfg.nhid, device=self.device)
        data_all = torch.from_numpy(data_all).long().to(self.device)
        tgt_all = torch.from_numpy(tgt_all).long().to(self.device)
        n = data_all.shape[0]
        pending = []  # losses stay on the device between log points
        t0 = time.time()
        for b in range(n):
            hidden, loss, _, kl, _ = self.train_step(
                state, hidden, data_all[b], tgt_all[b], kl_scale)
            pending.append(loss)
            if on_step is not None:
                on_step(b, loss)
            if b % tcfg.log_interval == 0 and b > 0:
                cur = float(torch.stack(pending).mean())
                ms = (time.time() - t0) * 1000 / len(pending)
                pending = []
                log(f"| epoch {state.epoch:3d} | {b:5d}/{n:5d} batches | lr "
                    f"{state.lr:02.3f} | ms/batch {ms:5.2f} | loss {cur:5.2f} "
                    f"| kl {float(kl):5.4f} | ppl {math.exp(min(cur, 30)):8.2f}")
                t0 = time.time()
        if tail is not None:
            # padded to seq_len, CE masked to the real tokens, KL scale kept
            d_t, t_t = tail
            L, bsz = tcfg.seq_len, d_t.shape[1]
            data_p = np.zeros((L, bsz), dtype=np.int64)
            tgt_p = np.zeros((L, bsz), dtype=np.int64)
            m_p = np.zeros((L, bsz), dtype=np.float32)
            data_p[:len(d_t)], tgt_p[:len(d_t)], m_p[:len(d_t)] = d_t, t_t, 1.0
            hidden, loss, _, _, _ = self.train_step(
                state, hidden, torch.from_numpy(data_p).to(self.device),
                torch.from_numpy(tgt_p).to(self.device), kl_scale,
                mask=torch.from_numpy(m_p).to(self.device))
            if on_step is not None:
                on_step(n, loss)
        return state

    @torch.no_grad()
    def evaluate(self, model, rows: np.ndarray) -> float:
        """Token-exact mean CE over a batchified (rows, bsz) stream, the
        ragged final window included (its CE sum equals that of the JAX
        package's padded, masked window: both models are causal). The
        Transformer scores each window on its own, causally, with no
        carry."""
        L = self.tcfg.seq_len
        bsz = rows.shape[1]
        src = torch.from_numpy(rows).long().to(self.device)
        hidden = None if self.is_tm else init_hidden(
            self.mcfg.nlayers, bsz, self.mcfg.nhid,
            dtype=getattr(torch, self.mcfg.compute_dtype), device=self.device)
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for i in range(0, rows.shape[0] - 1, L):
            d, t = get_batch(src, i, L)
            if self.is_tm:
                logits = model(d)
            else:
                logits, hidden = model(d, hidden)
            total += F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                     t.reshape(-1), reduction="sum")
        return float(total) / (bsz * (rows.shape[0] - 1))

    # ------------------------------------------------------------------ fit
    def _reload_best(self, state: TrainerState) -> None:
        tree, _ = load_checkpoint(self.tcfg.save)
        params_from_jax(state.model, tree)

    def fit(self, corpus, log=print, on_step: Optional[Callable] = None):
        """Train on ``corpus`` (``data.corpus.Corpus`` or anything with
        ``train``, ``valid`` and ``test`` id streams). Returns (state,
        {"history": [{"epoch", "val_loss", "lr"}], "test_loss"})."""
        tcfg = self.tcfg
        train_rows = batchify(apply_data_fraction(corpus.train,
                                                  tcfg.data_fraction),
                              tcfg.batch_size)
        val_rows = batchify(corpus.valid, tcfg.eval_batch_size)
        test_rows = batchify(corpus.test, tcfg.eval_batch_size)
        state = self.init_state()
        history = []
        for epoch in range(1, tcfg.epochs + 1):
            state.epoch = epoch
            t0 = time.time()
            state = self.run_epoch(state, train_rows, log, on_step)
            val_loss = self.evaluate(state.model, val_rows)
            log("-" * 89)
            log(f"| end of epoch {epoch:3d} | time: {time.time() - t0:5.2f}s "
                f"| valid loss {val_loss:5.2f} | valid ppl "
                f"{math.exp(min(val_loss, 30)):8.2f}")
            log("-" * 89)
            history.append({"epoch": epoch, "val_loss": val_loss,
                            "lr": state.lr})
            if state.best_val_loss is None or val_loss < state.best_val_loss:
                save_checkpoint(
                    tcfg.save, params_to_jax(state.model),
                    meta={"epoch": epoch, "val_loss": val_loss,
                          "model_config": dataclasses.asdict(self.mcfg)})
                state.best_val_loss = val_loss
            else:
                # plateau: halve the LR, reload the best parameters, fresh
                # optimizer (momentum reset), count towards the early stop
                state.lr *= tcfg.lr_decay
                self._reload_best(state)
                state.opt_state = init_opt_state(state.params)
                state.plateaus += 1
            if state.plateaus >= tcfg.max_plateaus:
                break
        self._reload_best(state)
        test_loss = self.evaluate(state.model, test_rows)
        log("=" * 89)
        log(f"| End of training | test loss {test_loss:5.2f} | test ppl "
            f"{math.exp(min(test_loss, 30)):8.2f}")
        log("=" * 89)
        return state, {"history": history, "test_loss": test_loss}
