"""Training loop, counterpart of ``bayeslms_tpu/train/loop.py`` on one
device: MLE with the fused decoder CE, SGD with momentum, the plateau
scheduler.

Reference behaviours (train.py), as the JAX package keeps them:
- loss = mean token CE + KL * seq_len / rows of the batchified stream; the
  standard models have no KL, the Bayesian, GP and variational ones' is
  the model's ``kl_value`` (the LSTM core's, the GP-LSTM core's GPNN KLs,
  the variational cores' KL of the step's own forward, or the
  Transformer's dispatch over FFN, MHA, EMB, the GP-FFN layer and the
  variational layers; against N(0, 1), or with
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
  running over the pad steps (causal, so the real tokens' CE is exact),
  except for the variational models, whose KL reads the activations and
  whose Transformer layers gate their noise on the window's length: their
  short window runs at its true length;
- per-epoch validation; on improvement save the best checkpoint, else
  halve the LR, reload the best checkpoint and reset the momentum; stop
  after ``max_plateaus`` plateaus; the test loss of the best checkpoint
  at the end;
- eval: deterministic (no dropout), token-exact mean CE including the
  ragged final window;
- full-state resume (``resume``): after each epoch ``<save>.resume`` holds
  the parameters, the momentum buffers, the schedule (epoch, lr, best
  validation loss, plateaus) and the trainer generator's state, and
  ``fit`` continues from it when it is there; profiling (``profile_dir``):
  ``fit`` traces its first trained epoch (``utils/profiling.py`` ``trace``).

The step runs the model's training forward (LSTM grad route: CUDA kernels
``lstm_train_cuda``, or ``lstm2_train_cuda`` under the fused 2-layer switch
of ``ops/lstm.py``; the Bayesian core's gate-slice sampler
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

With a mesh (``mesh=``, or ``dp_shards`` > 1, which lays the joined
process group out as dp ranks) every rank runs the step of
``parallel/train_parallel.py`` on its columns of each window: the dp step,
or the tensor-parallel step where tp > 1 (the vocabulary split over tp).
The batchified stream is the whole one on every rank, which keeps its own
columns' LSTM state. ``evaluate`` gives the one-device value on every rank
(under tp on the table gathered whole); rank 0 alone logs and writes the
checkpoint and ``.resume``, with the vocabulary shards gathered, and a
resume cuts them again. The ``.resume`` file then also holds every rank's
dropout stream.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.checkpoint import (_flatten, _unflatten, load_params,
                               params_from_jax, params_to_jax,
                               partial_update, save_checkpoint)
from ..core.config import ModelConfig, TrainConfig
from ..core.registry import build_model, init_params
from ..data.corpus import apply_data_fraction, batchify, get_batch, windows
from ..models.lstm_lm import init_hidden
from ..ops.ce_train_cuda import fused_decode_ce_train
from ..parallel import train_parallel
from ..parallel.mesh import barrier, broadcast, gather_object
from ..parallel.multihost import is_primary
from ..utils.profiling import StepTimer, trace
from ..utils.rng import Streams
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
                 device=None, mesh=None):
        """``device``: where the model trains; None means ``cuda``, which
        must be present (no CPU fallback). ``mesh`` (``parallel/mesh.py``):
        train on its ranks, on its device; ``train_cfg.dp_shards`` > 1
        without one builds a dp mesh of the joined process group."""
        if mesh is None and train_cfg.dp_shards > 1:
            from ..parallel.mesh import make_mesh

            mesh = make_mesh(dp=train_cfg.dp_shards, tp=1, device=device)
        if mesh is not None:
            device = mesh.device
            train_parallel.check(model_cfg, train_cfg, mesh.dp, mesh.tp)
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer: no CUDA device; pass device='cpu' to train on the "
                "CPU with the kernels' plain versions")
        self.mcfg = model_cfg.validate()
        self.tcfg = train_cfg.validate()
        self.device = device
        self.is_tm = model_cfg.is_transformer
        self.mesh = mesh
        # dropout masks and the Bayesian draws; the JAX package's rng_impl
        # has no counterpart here. Under a mesh ``gen`` gives the draws,
        # the same on every rank, and each rank drops from its own stream
        self.gen = torch.Generator(device=device).manual_seed(train_cfg.seed)
        self.streams = self.gen if mesh is None else Streams(
            torch.Generator(device=device).manual_seed(
                train_parallel.dropout_seed(train_cfg.seed, mesh.rank)),
            self.gen)
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
            if self._primary():
                print(f"prior init: updated {len(updated)} param tensors")
            if tcfg.prior_kl:
                self.prior_w = self._prior_means(model, prior)
        if self.mesh is not None:
            train_parallel.shard_model(model, self.mesh)
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
        or None; loss, mle, kl, gnorm as device scalars).

        Under a mesh ``data``, ``target``, ``mask`` and ``dropout_masks``
        are the whole batch's, cut to this rank's columns by the step of
        ``parallel/train_parallel.py``; ``hidden`` is this rank's state
        (``local_batch`` columns), and the returned values are the mesh's
        averages."""
        if self.mesh is not None:
            return train_parallel.train_step(self, state, hidden, data,
                                             target, kl_scale, mask,
                                             dropout_masks, noise)
        params = state.params
        for p in params.values():
            p.grad = None
        mle, kl, new_hidden = self._loss(state.model, hidden, data, target,
                                         kl_scale, mask, dropout_masks,
                                         noise)
        loss = mle + kl
        loss.backward()
        _, gnorm = sgd_momentum_step(params, self._grads(params),
                                     state.opt_state, state.lr,
                                     self.tcfg.clip, self.tcfg.momentum)
        if new_hidden is not None:
            new_hidden = (new_hidden[0].detach(), new_hidden[1].detach())
        return new_hidden, loss.detach(), mle.detach(), kl.detach(), gnorm

    def _loss(self, model, hidden, data, target, kl_scale, mask,
              dropout_masks, noise):
        """The step's forward on one device's (or one rank's) columns:
        (mle, kl term, new hidden)."""
        kw = dict(return_hidden=True, deterministic=False,
                  generator=self.streams, dropout_masks=dropout_masks,
                  noise=noise)
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
                                   model.decoder_weight, model.decoder_b,
                                   target.reshape(-1)).reshape(T, B)
        if mask is None:
            mle = ce.mean()
        else:
            mle = (ce * mask).sum() / mask.sum().clamp(min=1)
        return mle, self._kl(model) * kl_scale, new_hidden

    @staticmethod
    def _grads(params):
        """Each parameter's gradient; one the loss does not reach (the GP
        cell's bias_hh, as in the reference) is zero, as in JAX."""
        return {k: torch.zeros_like(p) if p.grad is None else p.grad
                for k, p in params.items()}

    def local_batch(self, batch: int) -> int:
        """The columns of a ``batch``-column window this rank trains."""
        if self.mesh is None:
            return batch
        return batch // self.mesh.size(
            train_parallel.columns_axis(self.mesh))

    def _primary(self) -> bool:
        return self.mesh is None or is_primary()

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
            cfg.nlayers, self.local_batch(train_rows.shape[1]), cfg.nhid,
            device=self.device)
        data_all = torch.from_numpy(data_all).long().to(self.device)
        tgt_all = torch.from_numpy(tgt_all).long().to(self.device)
        n = data_all.shape[0]
        pending = []  # losses stay on the device between log points
        timer = StepTimer(alpha=0.3)  # the EMA of ms/batch over intervals
        t0 = time.time()
        for b in range(n):
            hidden, loss, _, kl, _ = self.train_step(
                state, hidden, data_all[b], tgt_all[b], kl_scale)
            pending.append(loss)
            if on_step is not None:
                on_step(b, loss)
            if b % tcfg.log_interval == 0 and b > 0:
                cur = float(torch.stack(pending).mean())
                ms = timer.update((time.time() - t0) * 1000
                                  / len(pending))
                pending = []
                log(f"| epoch {state.epoch:3d} | {b:5d}/{n:5d} batches | lr "
                    f"{state.lr:02.3f} | ms/batch {ms:5.2f} | loss {cur:5.2f} "
                    f"| kl {float(kl):5.4f} | ppl {math.exp(min(cur, 30)):8.2f}")
                t0 = time.time()
        if tail is not None:
            d_t, t_t = tail
            dev = lambda a: torch.from_numpy(  # noqa: E731
                np.ascontiguousarray(a)).long().to(self.device)
            if cfg.uncertainty == "Variational":
                # the variational KL reads the activations and the
                # Transformer's noise gates on the window's length: the
                # short window runs at its true length, as in the JAX
                # package and the reference
                hidden, loss, _, _, _ = self.train_step(
                    state, hidden, dev(d_t), dev(t_t), kl_scale)
            else:
                # padded to seq_len, CE masked to the real tokens, KL scale
                # kept
                L, bsz = tcfg.seq_len, d_t.shape[1]
                data_p = np.zeros((L, bsz), dtype=np.int64)
                tgt_p = np.zeros((L, bsz), dtype=np.int64)
                m_p = np.zeros((L, bsz), dtype=np.float32)
                data_p[:len(d_t)], tgt_p[:len(d_t)] = d_t, t_t
                m_p[:len(d_t)] = 1.0
                hidden, loss, _, _, _ = self.train_step(
                    state, hidden, dev(data_p), dev(tgt_p), kl_scale,
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
    def _tree(self, state: TrainerState) -> dict:
        """The parameter tree whole (under tp the vocabulary shards
        gathered: every rank calls it)."""
        if self.mesh is None or self.mesh.tp == 1:
            return params_to_jax(state.model)
        return _unflatten({tuple(k.split(".")): train_parallel.full_leaf(
            self.mesh, k, p).cpu().numpy() for k, p in state.params.items()})

    def eval_model(self, state: TrainerState) -> torch.nn.Module:
        """The model ``evaluate`` reads: the trained one, or under tp a
        whole copy of it (every rank calls it)."""
        if self.mesh is None or self.mesh.tp == 1:
            return state.model
        return params_from_jax(build_model(self.mcfg),
                               self._tree(state)).to(self.device)

    def _load_tree(self, model, tree) -> None:
        """A whole parameter tree into ``model`` (this rank's rows of the
        vocabulary leaves under tp)."""
        if self.mesh is not None:
            tree = train_parallel.shard_tree(tree, self.mesh)
        params_from_jax(model, tree)

    def _reload_best(self, state: TrainerState) -> None:
        """The best checkpoint's parameters into the model: the port's own,
        or, in a run resumed from the JAX trainer's files, the JAX one."""
        self._load_tree(state.model, load_params(self.tcfg.save, self.mcfg))

    def _save(self, path: str, tree: dict, meta: dict) -> None:
        """Rank 0 writes; every rank waits for the file."""
        if self._primary():
            save_checkpoint(path, tree, meta=meta)
        if self.mesh is not None:
            barrier(self.mesh)

    # ---------------------------------------------------------------- resume
    def _save_resume(self, state: TrainerState) -> None:
        """``<save>.resume``: the parameter tree, the momentum buffers (a
        tree of the same shape, as the JAX package writes them), the state
        of the trainer's generator and the schedule, so that a run stopped
        after an epoch and resumed draws the same dropout masks and
        Bayesian seeds as the run that went on. Under a mesh the trees are
        whole and every rank's dropout stream is there too."""
        mom = state.opt_state.momentum
        if self.mesh is not None:
            mom = {k: train_parallel.full_leaf(self.mesh, k, v)
                   for k, v in mom.items()}
        blob = {"params": self._tree(state),
                "momentum": _unflatten({tuple(k.split(".")): v
                                        for k, v in mom.items()}),
                "generator": self.gen.get_state()}
        if self.mesh is not None:
            states = gather_object(self.mesh,
                                   self.streams.dropout.get_state())
            blob["dropout_generators"] = {str(r): g
                                          for r, g in enumerate(states)}
        self._save(self.tcfg.save + ".resume", blob,
                   {"epoch": state.epoch, "lr": state.lr,
                    "best_val_loss": state.best_val_loss,
                    "plateaus": state.plateaus})

    def _try_resume(self) -> Optional[TrainerState]:
        """The state of ``<save>.resume`` when ``resume`` is set and the
        file is there, else None. The file may be the port's own or the
        JAX trainer's (flax msgpack and its ``.json`` sidecar; told apart
        by ``load_params``). The JAX file holds no generator state: the
        trainer's generator then goes on from ``seed``, and the masks of
        the resumed epochs differ from those JAX draws. A rank's dropout
        stream goes on from the file where it holds one for every rank of
        the mesh, else from its seed."""
        path = self.tcfg.save + ".resume"
        if not (self.tcfg.resume and os.path.exists(path)):
            return None
        blob, meta = load_params(path, self.mcfg, with_meta=True)
        model = build_model(self.mcfg)
        if self.mesh is not None:
            train_parallel.shard_model(model, self.mesh)
        self._load_tree(model, blob["params"])
        model.to(self.device)
        params = dict(model.named_parameters())
        momentum = blob["momentum"]
        if self.mesh is not None:
            momentum = train_parallel.shard_tree(momentum, self.mesh)
        flat = {".".join(k): v for k, v in _flatten(momentum).items()}
        if set(flat) != set(params):
            raise KeyError(f"{path}: the momentum tree differs from the "
                           "model's parameters")
        momentum = {k: torch.as_tensor(np.array(flat[k]),
                                       dtype=p.dtype).to(self.device)
                    for k, p in params.items()}
        if "generator" in blob:
            self.gen.set_state(_byte_state(blob["generator"]))
        drops = blob.get("dropout_generators", {})
        if self.mesh is not None and len(drops) == self.mesh.size("all"):
            self.streams.dropout.set_state(
                _byte_state(drops[str(self.mesh.rank)]))
        tcfg = self.tcfg
        if tcfg.prior and tcfg.prior_path and tcfg.prior_kl:
            self.prior_w = self._prior_means(
                model, load_params(tcfg.prior_path, self.mcfg))
        best = meta.get("best_val_loss")
        return TrainerState(
            model=model, opt_state=OptState(momentum=momentum),
            lr=float(meta["lr"]),
            best_val_loss=None if best is None else float(best),
            plateaus=int(meta["plateaus"]), epoch=int(meta["epoch"]))

    def _evaluate(self, state: TrainerState, rows: np.ndarray) -> float:
        """``evaluate`` of the trained model; under a mesh rank 0's value on
        every rank, so that every rank takes the same schedule."""
        loss = self.evaluate(self.eval_model(state), rows)
        if self.mesh is None:
            return loss
        t = torch.tensor([loss], dtype=torch.float64, device=self.device)
        return float(broadcast(self.mesh, t)[0])

    def fit(self, corpus, log=print, on_step: Optional[Callable] = None):
        """Train on ``corpus`` (``data.corpus.Corpus`` or anything with
        ``train``, ``valid`` and ``test`` id streams), from ``<save>.resume``
        when ``resume`` is set and it is there. Returns (state,
        {"history": [{"epoch", "val_loss", "lr"}], "test_loss"}); the
        history of a resumed run holds its own epochs. Under a mesh every
        rank calls it; rank 0 alone logs, traces (``profile_dir``) and
        writes the files."""
        tcfg = self.tcfg
        primary = self._primary()
        if not primary:
            log = _quiet
        train_rows = batchify(apply_data_fraction(corpus.train,
                                                  tcfg.data_fraction),
                              tcfg.batch_size)
        val_rows = batchify(corpus.valid, tcfg.eval_batch_size)
        test_rows = batchify(corpus.test, tcfg.eval_batch_size)
        resumed = self._try_resume()
        state = resumed if resumed is not None else self.init_state()
        start_epoch = state.epoch + 1 if resumed is not None else 1
        if resumed is not None:
            log(f"resumed from epoch {state.epoch} (lr {state.lr})")
        history = []
        for epoch in range(start_epoch, tcfg.epochs + 1):
            state.epoch = epoch
            t0 = time.time()
            if tcfg.profile_dir and epoch == start_epoch and primary:
                # the first trained epoch, traced
                with trace(tcfg.profile_dir):
                    state = self.run_epoch(state, train_rows, log, on_step)
            else:
                state = self.run_epoch(state, train_rows, log, on_step)
            val_loss = self._evaluate(state, val_rows)
            log("-" * 89)
            log(f"| end of epoch {epoch:3d} | time: {time.time() - t0:5.2f}s "
                f"| valid loss {val_loss:5.2f} | valid ppl "
                f"{math.exp(min(val_loss, 30)):8.2f}")
            log("-" * 89)
            history.append({"epoch": epoch, "val_loss": val_loss,
                            "lr": state.lr})
            if state.best_val_loss is None or val_loss < state.best_val_loss:
                self._save(tcfg.save, self._tree(state),
                           {"epoch": epoch, "val_loss": val_loss,
                            "model_config": dataclasses.asdict(self.mcfg)})
                state.best_val_loss = val_loss
            else:
                # plateau: halve the LR, reload the best parameters, fresh
                # optimizer (momentum reset), count towards the early stop
                state.lr *= tcfg.lr_decay
                self._reload_best(state)
                state.opt_state = init_opt_state(state.params)
                state.plateaus += 1
            if tcfg.resume:
                self._save_resume(state)
            if state.plateaus >= tcfg.max_plateaus:
                break
        self._reload_best(state)
        test_loss = self._evaluate(state, test_rows)
        log("=" * 89)
        log(f"| End of training | test loss {test_loss:5.2f} | test ppl "
            f"{math.exp(min(test_loss, 30)):8.2f}")
        log("=" * 89)
        return state, {"history": history, "test_loss": test_loss}


def _quiet(*args, **kwargs) -> None:
    """The log of a rank other than 0."""


def _byte_state(a) -> torch.Tensor:
    """A generator state saved as an array, as ``set_state`` takes it."""
    return torch.from_numpy(np.array(a, dtype=np.uint8))
