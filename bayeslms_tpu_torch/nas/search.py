"""The NAS search loop, counterpart of ``bayeslms_tpu/nas/search.py``: an
architect step on a validation window, then a weight step (MLE + the
unweighted branch KL scaled by seq_len / rows, clip, SGD with momentum and
weight decay 1e-5) on a training window, per batch (the reference's
train_search_bayes.py:247-343); the softmaxed arch weights of each epoch
are the search's result.

``SearchRunner`` runs on ``cuda`` unless the caller passes the CPU, and
raises without a card. Its draws (dropout masks, the branches' eps) come
from a ``torch.Generator`` seeded with ``seed``; one ``supernet.Draws`` a
batch serves both of its steps, as the JAX loop hands both one set of
keys.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..core.checkpoint import params_from_jax, params_to_jax
from ..core.config import ModelConfig, TrainConfig
from ..data.corpus import batchify, windows
from ..models.lstm_lm import init_hidden
from ..train.optim import init_opt_state, sgd_momentum_step
from .architect import Architect
from .supernet import Draws, build_supernet, init_arch_weights

SEARCH_WEIGHT_DECAY = 1e-5  # the search loop's SGD (train_search_bayes.py:387)


@dataclass
class SearchResult:
    arch_softmax: np.ndarray  # (nlayers, slots, 2)
    history: list
    derived_choice: Optional[np.ndarray] = None  # argmax per (layer, slot)


class SearchRunner:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 mode: str = "bayes", unrolled: bool = False,
                 arch_lr: float = 3e-3, network_weight_decay: float = 5e-7,
                 device=None):
        """``device``: where the search runs; None means ``cuda``, which
        must be present (no CPU fallback)."""
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SearchRunner: no CUDA device; pass device='cpu' to search "
                "on the CPU")
        self.cfg, self.tcfg, self.device = cfg.validate(), tcfg, device
        self.mode = mode
        self.model = build_supernet(cfg, mode).to(device)
        self.is_tm = cfg.is_transformer
        self.slots = 1 if self.is_tm else 4
        self.gen = torch.Generator(device=device).manual_seed(tcfg.seed)
        self.architect = Architect(
            self.loss_fn, arch_lr=arch_lr, w_lr=tcfg.lr, unrolled=unrolled,
            network_weight_decay=network_weight_decay,
            network_clip=tcfg.clip)

    # ------------------------------------------------------------- losses
    def loss_and_hidden(self, params, arch, batch, draws):
        """(mean CE + kl_scale x branch KL, the new hidden) of one training
        forward with the weights ``params`` ({name: tensor})."""
        data, target, hidden, kl_scale = batch
        kw = dict(deterministic=False, draws=draws)
        if self.is_tm:
            logits, kl = functional_call(self.model, params, (data, arch),
                                         kw)
            new_hidden = hidden
        else:
            logits, new_hidden, kl = functional_call(
                self.model, params, (data, hidden, arch), kw)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             target.reshape(-1))
        return ce + kl_scale * kl, new_hidden

    def loss_fn(self, params, arch, batch, draws):
        """The scalar loss the architect differentiates (its validation
        hidden is the epoch's zero state, the new one discarded)."""
        return self.loss_and_hidden(params, arch, batch, draws)[0]

    def params(self) -> dict:
        return dict(self.model.named_parameters())

    def weight_step(self, opt_state, arch, batch, lr: float, draws):
        """One SGD step of the network weights in place; returns (loss,
        the new hidden, detached)."""
        params = self.params()
        for p in params.values():
            p.grad = None
        with torch.enable_grad():
            loss, new_hidden = self.loss_and_hidden(params, arch.detach(),
                                                    batch, draws)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        sgd_momentum_step(params, grads, opt_state, lr, self.tcfg.clip,
                          self.tcfg.momentum,
                          weight_decay=SEARCH_WEIGHT_DECAY)
        if new_hidden is not None:
            new_hidden = tuple(h.detach() for h in new_hidden)
        return loss.detach(), new_hidden

    # -------------------------------------------------------------- setup
    def init_params(self, seed: int = 0):
        """Fresh network weights, drawn on the CPU from a generator seeded
        with ``seed`` (the same on every device) and loaded into the
        supernet, as the JAX parameter tree; and arch logits, 1e-3 N(0,
        1)."""
        gen = torch.Generator(device="cpu").manual_seed(seed)
        fresh = build_supernet(self.cfg, self.mode)
        fresh.reset_parameters(gen)
        arch = init_arch_weights(self.cfg.nlayers, self.slots,
                                 generator=gen).to(self.device)
        tree = params_to_jax(fresh)
        params_from_jax(self.model, tree)
        return tree, arch

    def _hidden(self):
        return None if self.is_tm else init_hidden(
            self.cfg.nlayers, self.tcfg.batch_size, self.cfg.nhid,
            device=self.device)

    def _dev(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).long().to(
            self.device)

    # ---------------------------------------------------------------- run
    def run(self, corpus, epochs: Optional[int] = None, log=print,
            init=None, on_step=None) -> SearchResult:
        """Search for ``epochs`` (default ``tcfg.epochs``). ``init``:
        (parameter tree, arch) to start from, else ``init_params(seed)``.
        ``on_step(epoch, b, loss)`` after each batch's two steps."""
        tcfg = self.tcfg
        epochs = epochs or tcfg.epochs
        train_rows = batchify(corpus.train, tcfg.batch_size)
        valid_rows = batchify(corpus.valid, tcfg.batch_size)
        n_tr, n_va = train_rows.shape[0], valid_rows.shape[0]
        kl_scale = tcfg.seq_len / n_tr
        tree, arch = init if init is not None else self.init_params(tcfg.seed)
        params_from_jax(self.model, tree)
        a_state = self.architect.init(torch.as_tensor(
            np.asarray(arch) if not isinstance(arch, torch.Tensor) else arch,
            dtype=torch.float32).to(self.device))
        opt_state = init_opt_state(self.params())
        history = []
        loss = None
        for epoch in range(1, epochs + 1):
            # both hiddens zeroed each epoch; the training one is then
            # carried (detached) across weight steps, the validation one
            # stays the zero state for every architect step
            hidden, hidden_valid = self._hidden(), self._hidden()
            for b, i in enumerate(range(0, n_tr - 1, tcfg.seq_len)):
                draws = Draws(self.gen)
                # the training window is the i-th seq_len slice with the
                # ragged tail; the validation window starts at token offset
                # i % (n_va - 1), an unaligned sliding slice
                T = min(tcfg.seq_len, n_tr - 1 - i)
                vi = i % (n_va - 1)
                Tv = min(tcfg.seq_len, n_va - 1 - vi)
                train_batch = (self._dev(train_rows[i:i + T]),
                               self._dev(train_rows[i + 1:i + 1 + T]),
                               hidden, kl_scale)
                valid_batch = (self._dev(valid_rows[vi:vi + Tv]),
                               self._dev(valid_rows[vi + 1:vi + 1 + Tv]),
                               hidden_valid, kl_scale)
                a_state = self.architect.step(a_state, self.params(),
                                              train_batch, valid_batch,
                                              draws)
                loss, hidden = self.weight_step(opt_state, a_state.arch,
                                                train_batch, tcfg.lr, draws)
                if on_step is not None:
                    on_step(epoch, b, loss)
            soft = torch.softmax(a_state.arch, dim=-1).cpu().numpy()
            history.append({"epoch": epoch, "loss": float(loss),
                            "arch": soft.tolist()})
            log(f"| search epoch {epoch} | loss {float(loss):.3f} |\n"
                f"{soft.round(3)}")
        self.arch = a_state.arch
        soft = torch.softmax(a_state.arch, dim=-1).cpu().numpy()
        return SearchResult(arch_softmax=soft, history=history,
                            derived_choice=soft.argmax(axis=-1))

    @staticmethod
    def derive(arch) -> torch.Tensor:
        """The argmax architecture as hard logits: +50 on the chosen branch,
        -50 elsewhere, whose softmax is exactly one-hot in float32, so that
        training the supernet with them trains the chosen architecture."""
        a = np.asarray(arch.detach().cpu() if isinstance(arch, torch.Tensor)
                       else arch)
        choice = a.argmax(axis=-1)
        hard = np.where(np.arange(a.shape[-1])[None, None, :]
                        == choice[..., None], 50.0, -50.0)
        return torch.as_tensor(hard, dtype=torch.float32)

    def finetune(self, params, arch_hard, corpus, steps: int, seed: int = 0):
        """Train the derived architecture (``derive``'s hard logits) for
        ``steps`` weight steps from the parameter tree ``params``, on the
        aligned training windows in turn, the hidden carried. Returns (the
        parameter tree, the losses)."""
        tcfg = self.tcfg
        params_from_jax(self.model, params)
        arch_hard = torch.as_tensor(arch_hard).to(self.device)
        train_rows = batchify(corpus.train, tcfg.batch_size)
        tr_d, tr_t = windows(train_rows, tcfg.seq_len)
        kl_scale = tcfg.seq_len / train_rows.shape[0]
        opt_state = init_opt_state(self.params())
        hidden = self._hidden()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        losses = []
        for b in range(steps):
            i = b % tr_d.shape[0]
            batch = (self._dev(tr_d[i]), self._dev(tr_t[i]), hidden,
                     kl_scale)
            loss, hidden = self.weight_step(opt_state, arch_hard, batch,
                                            tcfg.lr, Draws(gen))
            losses.append(float(loss))
        return params_to_jax(self.model), losses
