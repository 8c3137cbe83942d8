"""Rank functions of tests/test_torch_port_parallel.py: each runs in a gloo
rank that ``parallel.multihost.spawn`` started, on the CPU with one thread,
and imports nothing of JAX (the test computes the JAX reference itself).
Each takes the test's payload (plain dicts of numpy arrays and
configuration keywords) and returns numpy results."""

import numpy as np
import torch

import bayeslms_tpu_torch as bt
from bayeslms_tpu_torch.core.checkpoint import params_from_jax, params_to_jax
from bayeslms_tpu_torch.models.lstm_lm import DropoutMasks, init_hidden
from bayeslms_tpu_torch.parallel.mesh import make_mesh
from bayeslms_tpu_torch.rescore.scorer import BatchScorer
from bayeslms_tpu_torch.train.loop import Trainer


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def train_steps(p):
    """Steps of a (dp, tp) mesh's trainer from the payload's parameters on
    its batches (whole batches, dropout masks and noise, as one device
    would take them). Returns, from every rank, the whole parameter tree
    after the steps, the momentum of rank 0's leaves and each step's
    (loss, mle, kl, gnorm)."""
    mesh = make_mesh(dp=p["dp"], tp=p["tp"], device="cpu")
    tr = Trainer(bt.ModelConfig(**p["cfg"]), bt.TrainConfig(**p["tcfg"]),
                 mesh=mesh)
    state = tr.init_state()
    tr._load_tree(state.model, p["params"])
    B = p["batches"][0]["data"].shape[1]
    cfg = tr.mcfg
    hidden = None if tr.is_tm else init_hidden(
        cfg.nlayers, tr.local_batch(B), cfg.nhid)
    stats = []
    for b in p["batches"]:
        masks = None
        if b.get("masks") is not None:
            masks = DropoutMasks(*(_t(m) for m in b["masks"]))
        noise = None if b.get("noise") is None else [_t(e)
                                                      for e in b["noise"]]
        hidden, loss, mle, kl, gnorm = tr.train_step(
            state, hidden, _t(b["data"]).long(), _t(b["target"]).long(),
            b["kl_scale"], mask=_t(b.get("mask")), dropout_masks=masks,
            noise=noise)
        stats.append((float(loss), float(mle), float(kl), float(gnorm)))
    return {"params": _flat(tr._tree(state)), "stats": stats,
            "momentum": {k: v.numpy() for k, v in
                         state.opt_state.momentum.items()},
            "hidden": None if hidden is None else [h.numpy()
                                                   for h in hidden]}


class _Corpus:
    def __init__(self, streams):
        self.train, self.valid, self.test = streams


def _fit(p, cfg, **tkw):
    tr = Trainer(bt.ModelConfig(**cfg),
                 bt.TrainConfig(**{**p["tcfg"], **tkw}), device="cpu")
    init = tr.init_state

    def init_state(seed=None):
        st = init(seed)
        tr._load_tree(st.model, p["params"])
        return st
    tr.init_state = init_state
    return tr.fit(_Corpus(p["streams"]), log=lambda *a: None)


def fit(p):
    """``Trainer.fit`` with ``dp_shards`` on the payload's id streams from
    the payload's parameters. Returns the history, the test loss and the
    trained parameters; with ``resume_dir``, also whether one epoch and a
    resumed second (dropout on, ``.resume`` files) end bit-equal to two
    straight epochs."""
    state, out = _fit(p, p["cfg"])
    res = {"history": out["history"], "test_loss": out["test_loss"],
           "params": _flat(params_to_jax(state.model))}
    if p.get("resume_dir"):
        cfg = dict(p["cfg"], dropout=0.2)
        d = p["resume_dir"]
        straight, _ = _fit(p, cfg, save=f"{d}/straight.ckpt")
        _fit(p, cfg, epochs=1, resume=True, save=f"{d}/resumed.ckpt")
        resumed, _ = _fit(p, cfg, resume=True, save=f"{d}/resumed.ckpt")
        a, b = (_flat(params_to_jax(x.model)) for x in (straight, resumed))
        res["resume_equal"] = all(np.array_equal(a[k], b[k]) for k in a)
    return res


def score(p):
    """``BatchScorer`` on a dp mesh for each of the payload's (model
    configuration, parameters, rescoring configuration) cases. Returns
    each pass's scores."""
    mesh = make_mesh(dp=p["dp"], tp=1, device="cpu")
    out = []
    for case in p["cases"]:
        sc = BatchScorer(bt.ModelConfig(**case["cfg"]), case["params"],
                         bt.RescoreConfig(**case["rcfg"]), mesh=mesh)
        out.append(sc.score_nbest(p["nbest"], p["w2i"],
                                  stream_fn=lambda k: k.split("-")[0]))
    return out
