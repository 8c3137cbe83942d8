"""Training loop, counterpart of ``bayeslms_tpu/train/loop.py`` on one
device: MLE with the fused decoder CE, SGD with momentum, the plateau
scheduler.

Reference behaviours (train.py), as the JAX package keeps them:
- loss = mean token CE + KL * seq_len / rows of the batchified stream; the
  standard LSTM has no KL (the Bayesian cores, ROADMAP.md queue A item 7,
  add theirs at ``_kl``);
- SGD momentum 0.9 after a global-norm clip;
- the LSTM state carried, detached, across the windows of an epoch and
  zeroed at each epoch's start; the ragged final window padded to
  ``seq_len`` with the CE masked, the LSTM running over the pad steps;
- per-epoch validation; on improvement save the best checkpoint, else
  halve the LR, reload the best checkpoint and reset the momentum; stop
  after ``max_plateaus`` plateaus; the test loss of the best checkpoint
  at the end;
- eval: deterministic (no dropout), token-exact mean CE including the
  ragged final window.

The step runs the model's training forward (LSTM grad route: CUDA kernels
``lstm_train_cuda``) and the differentiable fused CE (``ce_train_cuda``);
``evaluate`` runs the scoring route (``lstm_cuda.lstm2_fwd``) and the
decoder's logits and CE as plain PyTorch, as the JAX package leaves them to
XLA there. Entry points run on the card; ``device="cpu"`` (tests) runs
every kernel's plain twin.
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

from ..core.checkpoint import (load_checkpoint, params_from_jax,
                               params_to_jax, save_checkpoint)
from ..core.config import ModelConfig, TrainConfig
from ..core.registry import build_model, init_params
from ..data.corpus import apply_data_fraction, batchify, get_batch, windows
from ..models.lstm_lm import DropoutMasks, RecurrentLM, init_hidden
from ..ops.ce_train_cuda import fused_decode_ce_train
from .optim import OptState, init_opt_state, sgd_momentum_step


@dataclass
class TrainerState:
    model: RecurrentLM  # float32 parameters on the trainer's device
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
        # dropout masks; the JAX package's rng_impl has no counterpart here
        self.gen = torch.Generator(device=device).manual_seed(train_cfg.seed)

    # ------------------------------------------------------------------ init
    def init_state(self, seed: Optional[int] = None) -> TrainerState:
        seed = self.tcfg.seed if seed is None else seed
        model = build_model(self.mcfg)
        init_params(model, self.mcfg, seed=seed)
        model.to(self.device)
        return TrainerState(model=model,
                            opt_state=init_opt_state(dict(model.named_parameters())),
                            lr=self.tcfg.lr, best_val_loss=None, plateaus=0,
                            epoch=0)

    # ------------------------------------------------------------------ step
    def _kl(self, model: RecurrentLM) -> torch.Tensor:
        return torch.zeros((), device=self.device)

    def train_step(self, state: TrainerState, hidden, data: torch.Tensor,
                   target: torch.Tensor, kl_scale: float = 0.0,
                   mask: Optional[torch.Tensor] = None,
                   dropout_masks: Optional[DropoutMasks] = None):
        """One optimizer step on a (T, B) window; updates ``state``'s
        parameters and momentum in place. ``mask`` (T, B) 0/1 averages the
        CE over the real tokens of the padded ragged window.
        ``dropout_masks`` replaces the masks drawn from the trainer's
        generator. Returns (new hidden, detached; loss, mle, kl, gnorm as
        device scalars)."""
        model = state.model
        params = state.params
        for p in params.values():
            p.grad = None
        out, new_hidden = model(data, hidden, return_hidden=True,
                                deterministic=False, generator=self.gen,
                                dropout_masks=dropout_masks)
        T, B, H = out.shape
        ce = fused_decode_ce_train(out.reshape(T * B, H), model.embedding,
                                   model.decoder_b,
                                   target.reshape(-1)).reshape(T, B)
        if mask is None:
            mle = ce.mean()
        else:
            mle = (ce * mask).sum() / mask.sum().clamp(min=1)
        kl = self._kl(model) * kl_scale
        loss = mle + kl
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        _, gnorm = sgd_momentum_step(params, grads, state.opt_state, state.lr,
                                     self.tcfg.clip, self.tcfg.momentum)
        return ((new_hidden[0].detach(), new_hidden[1].detach()),
                loss.detach(), mle.detach(), kl.detach(), gnorm)

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
        hidden = init_hidden(cfg.nlayers, train_rows.shape[1], cfg.nhid,
                             device=self.device)
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
    def evaluate(self, model: RecurrentLM, rows: np.ndarray) -> float:
        """Token-exact mean CE over a batchified (rows, bsz) stream, the
        ragged final window included (its CE sum equals that of the JAX
        package's padded, masked window: the LSTM is causal)."""
        L = self.tcfg.seq_len
        bsz = rows.shape[1]
        src = torch.from_numpy(rows).long().to(self.device)
        hidden = init_hidden(self.mcfg.nlayers, bsz, self.mcfg.nhid,
                             dtype=getattr(torch, self.mcfg.compute_dtype),
                             device=self.device)
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for i in range(0, rows.shape[0] - 1, L):
            d, t = get_batch(src, i, L)
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
