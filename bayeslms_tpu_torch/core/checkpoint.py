"""Weight exchange with the JAX package and the reference (counterpart of
``bayeslms_tpu/core/checkpoint.py``).

The JAX parameter tree is nested dicts of arrays: ``{"embedding",
"decoder_b", "core": {"l0_w_ih", "l0_w_hh", "l0_b_ih", "l0_b_hh", "l1_..."}}``
for the standard LSTM, ``"core": {"weight_ih_mean_1", ...,
"weight_hh_lgstd_1", ...}`` for the Bayesian one, ``{"embedding",
"decoder_b", "layers_0": {"self_attn": {"qkv_net": {"kernel", "bias"}, ...},
"linear1", "linear2", "norm1", "norm2"}, ...}`` for the Transformer (the
GP-FFN layer's ``gpnn`` in place of ``linear1``);
float32, LSTM weights in the torch (4H, in) layout, the Transformer's dense
kernels in flax's (in, out). The port's modules name their parameters the
same way (``core.l0_w_ih``, ``layers_0.linear1.kernel``) and keep those
layouts, so the exchange only walks the tree.

Files:
- ``save_checkpoint`` / ``load_checkpoint``: the port's own, one
  ``torch.save`` of that tree (float32 CPU tensors) and a meta dict of
  plain values, read back with ``weights_only=True``;
- ``load_jax_checkpoint``: the JAX package's ``.ckpt`` (flax msgpack,
  read by ``flax_msgpack`` without msgpack or flax) and its ``.json``
  sidecar;
- ``load_torch_checkpoint``: the reference's ``model.pt``, a state_dict
  that ``import_torch_state_dict`` maps onto the tree;
- ``load_params``: any of the three, by its content.

A loaded tree goes into ``params_from_jax``, ``BatchScorer`` or
``partial_update`` (the prior / finetune workflow).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import flax_msgpack


def params_from_jax(model: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a JAX parameter tree into ``model``'s parameters, in place.
    Every parameter must be present with its exact shape."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = v

    walk(tree, "")
    params = dict(model.named_parameters())
    if set(flat) != set(params):
        raise KeyError(f"parameter trees differ: missing "
                       f"{sorted(set(params) - set(flat))}, unexpected "
                       f"{sorted(set(flat) - set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            v = torch.as_tensor(np.array(flat[name]))
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(v.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(v)
    return model


def params_to_jax(model: nn.Module) -> dict:
    """``model``'s parameters as the JAX parameter tree of numpy arrays."""
    tree: dict = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = p.detach().cpu().numpy().copy()
    return tree


def _map_leaves(tree: Mapping, fn) -> dict:
    return {k: _map_leaves(v, fn) if isinstance(v, Mapping) else fn(v)
            for k, v in tree.items()}


def save_checkpoint(path: str, params: Mapping,
                    meta: Optional[dict] = None) -> None:
    """Write the parameter tree (arrays or tensors) and ``meta`` to
    ``path``, through a temporary file and a rename, so that a reader (the
    trainer's reload of the best checkpoint) never sees a torn file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tree = _map_leaves(params, lambda v: torch.as_tensor(
        v.detach().cpu() if isinstance(v, torch.Tensor) else np.array(v)))
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save({"params": tree, "meta": meta}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Tuple[dict, Optional[dict]]:
    """(parameter tree of numpy arrays, meta) from ``save_checkpoint``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return _map_leaves(blob["params"], lambda t: t.numpy()), blob["meta"]


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: Mapping) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def partial_update(params: Mapping, prior_params: Mapping
                   ) -> Tuple[dict, List[str]]:
    """Overwrite every leaf of ``params`` that exists with the same path and
    shape in ``prior_params`` (the reference's key-filtered state_dict
    update for finetuning from a prior). Returns the merged tree (numpy
    leaves keep ``params``' dtypes) and the updated paths, "a/b"."""
    flat = _flatten(params)
    updated = []
    for k, v in _flatten(prior_params).items():
        if k in flat and np.shape(flat[k]) == np.shape(v):
            flat[k] = np.asarray(v, dtype=np.asarray(flat[k]).dtype)
            updated.append("/".join(map(str, k)))
    return _unflatten(flat), updated


_RNN_KEY = re.compile(r"rnn\.(weight|bias)_(ih|hh)_l(\d+)")
# a cell of a GPLSTM or VariationalLSTM stack (GaussRNNModel, model.py:1317-
# 1366; VariationalRNNModel, :2373-2423) and, within it, torch nn.LSTM names
_STACK_KEY = re.compile(r"rnn\.rnn\.(\d+)\.(.*)")
_STACK_LSTM_KEY = re.compile(r"(weight|bias)_(ih|hh)_l0")
# the legacy VLSTM's noise tables (model.py:2609-2613)
_VLEGACY_KEY = re.compile(r"rnn\.hiddens_(mean|lgstd)(_p)?")
_TM_KEY = re.compile(r"transformerlayers\.(?:layers\.)?(\d+)\.(.*)")
# a Transformer layer's reference names (torch TransformerEncoderLayer's
# in_proj/out_proj and the reference's self-built modules) -> (path under
# layers_N, transposed); the JAX package's table (core/checkpoint.py:146-200)
# without its variational rows
_TM_TABLE = {
    "self_attn.in_proj_weight": ("self_attn/qkv_net/kernel", True),
    "self_attn.in_proj_bias": ("self_attn/qkv_net/bias", False),
    "qkv_net.weight": ("self_attn/qkv_net/kernel", True),
    "qkv_net.bias": ("self_attn/qkv_net/bias", False),
    "self_attn.qkv_net.weight": ("self_attn/qkv_net/kernel", True),
    "self_attn.qkv_net.bias": ("self_attn/qkv_net/bias", False),
    "self_attn.out_proj.weight": ("self_attn/o_net/kernel", True),
    "self_attn.out_proj.bias": ("self_attn/o_net/bias", False),
    "self_attn.o_net.weight": ("self_attn/o_net/kernel", True),
    "self_attn.o_net.bias": ("self_attn/o_net/bias", False),
    "self_attn.q_net.weight": ("self_attn/q_net/kernel", True),
    "self_attn.q_net.bias": ("self_attn/q_net/bias", False),
    "self_attn.k_net.weight": ("self_attn/k_net/kernel", True),
    "self_attn.k_net.bias": ("self_attn/k_net/bias", False),
    "self_attn.v_net.weight": ("self_attn/v_net/kernel", True),
    "self_attn.v_net.bias": ("self_attn/v_net/bias", False),
    "self_attn.o_net.weight_mean": ("self_attn/o_net/weight_mean", False),
    "self_attn.o_net.weight_lgstd": ("self_attn/o_net/weight_lgstd", False),
    "linear1.weight": ("linear1/kernel", True),
    "linear1.bias": ("linear1/bias", False),
    "linear2.weight": ("linear2/kernel", True),
    "linear2.bias": ("linear2/bias", False),
    "linear2.weight_mean": ("linear2/weight_mean", False),
    "linear2.weight_lgstd": ("linear2/weight_lgstd", False),
    "norm1.weight": ("norm1/scale", False),
    "norm1.bias": ("norm1/bias", False),
    "norm2.weight": ("norm2/scale", False),
    "norm2.bias": ("norm2/bias", False),
    # the GP-FFN layer's GPNN (types 0-3) or GPNN2 (type 4, its read-out a
    # Linear)
    **{f"gpnn.{n}": (f"gpnn/{n}", False)
       for n in ("weights_mean", "weights_lgstd", "bias_mean", "bias_lgstd",
                 "coef_mean", "coef_lgstd", "frequency_mean",
                 "frequency_lgstd")},
    "gpnn.coef.weight": ("gpnn/coef_kernel", True),
    "gpnn.coef.bias": ("gpnn/coef_bias", False),
}


def import_torch_state_dict(state_dict: Mapping[str, "np.ndarray"],
                            cfg) -> dict:
    """Map a reference PyTorch state_dict onto the parameter tree:
    ``encoder.weight`` -> ``embedding``, ``decoder.bias`` -> ``decoder_b``
    (``decoder.weight`` only when untied, as ``decoder_w``); for the RNN
    family ``rnn.{weight,bias}_{ih,hh}_l{k}`` (torch nn.LSTM) ->
    ``core/l{k}_{w,b}_{ih,hh}`` and the Bayes(2)LSTM names
    ``rnn.*_{mean,lgstd}_*`` -> ``core/*``; for the Transformer the
    ``transformerlayers.[layers.]N.*`` names of ``_TM_TABLE`` ->
    ``layers_N/*`` (Linear weights transposed to flax (in, out) kernels;
    the GP-FFN layer's ``gpnn.*``, GPNN2's read-out ``gpnn.coef.*`` as
    ``coef_kernel`` (in, out) and ``coef_bias``) and the EMB projection's
    ``embed_{mean,lgstd}``; for the GP and
    variational stacks ``rnn.rnn.<i>.*`` as the JAX package maps them
    (``core/checkpoint.py:113-140`` there): a GP cell's
    ``{weights,bias}_{ih,hh}`` and ``gpnn.*`` -> ``core/cell<i>/...`` (the
    GPNN2 read-out ``gpnn.coef.{weight,bias}`` -> ``coef_kernel`` (in, out)
    and ``coef_bias``), a standard layer's ``{weight,bias}_{ih,hh}_l0`` ->
    ``core/std<i>/l_{w,b}_{ih,hh}``, a variational cell's flat names ->
    ``core/l<i>_*``, the legacy GaussLSTM's ``rnn.gpnn.*`` ->
    ``core/gpnn/*`` and the legacy VLSTM's ``rnn.hiddens_*`` -> ``core/*``.
    Keys with no counterpart are skipped; compose with ``partial_update``."""
    out: Dict[Tuple[str, ...], np.ndarray] = {}
    for k, v in state_dict.items():
        v = np.asarray(v)
        m = _RNN_KEY.fullmatch(k)
        tm = _TM_KEY.fullmatch(k)
        st = _STACK_KEY.match(k)
        if k == "encoder.weight":
            out[("embedding",)] = v
        elif k == "decoder.weight":
            if not cfg.tied:
                out[("decoder_w",)] = v
        elif k == "decoder.bias":
            out[("decoder_b",)] = v
        elif m:
            kind = "w" if m.group(1) == "weight" else "b"
            out[("core", f"l{m.group(3)}_{kind}_{m.group(2)}")] = v
        elif k.startswith("rnn.") and ("_mean_" in k or "_lgstd_" in k):
            out[("core", k[len("rnn."):])] = v
        elif k.startswith("rnn.gpnn."):
            out[("core", "gpnn", k[len("rnn.gpnn."):])] = v
        elif _VLEGACY_KEY.fullmatch(k):
            out[("core", k[len("rnn."):])] = v
        elif st:
            i, rest = st.group(1), st.group(2)
            lm = _STACK_LSTM_KEY.fullmatch(rest)
            if rest == "vnn.hidden_lgstd":
                out[("core", f"l{i}_vnn", "hidden_lgstd")] = v
            elif rest == "gpnn.coef.weight":
                out[("core", f"cell{i}", "gpnn", "coef_kernel")] = v.T
            elif rest == "gpnn.coef.bias":
                out[("core", f"cell{i}", "gpnn", "coef_bias")] = v
            elif rest.startswith("gpnn."):
                out[("core", f"cell{i}", "gpnn", rest[len("gpnn."):])] = v
            elif lm:
                kind = "w" if lm.group(1) == "weight" else "b"
                out[("core", f"std{i}", f"l_{kind}_{lm.group(2)}")] = v
            elif rest in ("weights_ih", "weights_hh", "bias_ih", "bias_hh"):
                if getattr(cfg, "uncertainty", None) == "Variational":
                    out[("core", f"l{i}_{rest}")] = v
                else:
                    out[("core", f"cell{i}", rest)] = v
        elif k in ("embed_mean", "embed_lgstd"):
            out[(k,)] = v
        elif tm and tm.group(2) in _TM_TABLE:
            path, transpose = _TM_TABLE[tm.group(2)]
            i = tm.group(1)
            out[(f"layers_{i}", *path.split("/"))] = v.T if transpose else v
    return _unflatten(out)


def load_torch_checkpoint(path: str, cfg) -> dict:
    """The reference's ``model.pt`` (a state_dict of tensors, read with
    ``weights_only=True``) as the parameter tree."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return import_torch_state_dict({k: v.numpy() for k, v in sd.items()},
                                   cfg)


def load_jax_checkpoint(path: str) -> Tuple[dict, Optional[dict]]:
    """(parameter tree of numpy arrays, meta) from the JAX package's
    ``save_checkpoint``: the msgpack ``path`` and its ``path.json``
    sidecar, when there is one."""
    with open(path, "rb") as f:
        params = flax_msgpack.restore(f.read())
    meta = None
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return params, meta


def load_params(path: str, cfg) -> dict:
    """The parameter tree of any checkpoint the port reads: its own
    (``save_checkpoint``), the reference's ``model.pt`` (both torch zip
    files) or the JAX package's msgpack ``.ckpt``."""
    with open(path, "rb") as f:
        is_zip = f.read(4) == b"PK\x03\x04"
    if not is_zip:
        return load_jax_checkpoint(path)[0]
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, Mapping) and "params" in blob:
        return _map_leaves(blob["params"], lambda t: t.numpy())
    return import_torch_state_dict({k: v.numpy() for k, v in blob.items()},
                                   cfg)
