"""Weight exchange with the JAX package (counterpart of
``bayeslms_tpu/core/checkpoint.py``).

The JAX parameter tree is nested dicts of arrays: ``{"embedding",
"decoder_b", "core": {"l0_w_ih", "l0_w_hh", "l0_b_ih", "l0_b_hh", "l1_..."}}``,
float32, LSTM weights already in the torch (4H, in) layout. The port's
module names its parameters the same way (``core.l0_w_ih``), so the
exchange only walks the tree.

``save_checkpoint`` / ``load_checkpoint`` keep the port's own files: one
``torch.save`` of that tree (float32 CPU tensors) and a meta dict of plain
values, read back with ``weights_only=True``; the loaded tree goes straight
into ``params_from_jax`` or ``BatchScorer``. Reading the JAX package's
msgpack ``.ckpt`` files is ROADMAP.md queue A item 1.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


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
        v.detach().cpu() if isinstance(v, torch.Tensor) else np.asarray(v)))
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save({"params": tree, "meta": meta}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Tuple[dict, Optional[dict]]:
    """(parameter tree of numpy arrays, meta) from ``save_checkpoint``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return _map_leaves(blob["params"], lambda t: t.numpy()), blob["meta"]
