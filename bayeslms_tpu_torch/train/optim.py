"""SGD with momentum and global-norm clipping, counterpart of
``bayeslms_tpu/train/optim.py``.

Reference: ``optim.SGD(lr, momentum=0.9)`` after
``clip_grad_norm_(parameters, clip)`` (train.py:418-420, :466); every
LR-halving plateau builds a fresh optimizer (momentum reset,
train.py:503-505), which is ``init_opt_state`` again. Where the JAX package
returns new trees, the port updates parameters and momentum buffers in
place; the arithmetic is the same.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional

import torch


class OptState(NamedTuple):
    momentum: Dict[str, torch.Tensor]  # parameter name -> buffer


def init_opt_state(params: Mapping[str, torch.Tensor]) -> OptState:
    return OptState(momentum={k: torch.zeros_like(p)
                              for k, p in params.items()})


@torch.no_grad()
def sgd_momentum_step(params: Mapping[str, torch.Tensor],
                      grads: Mapping[str, torch.Tensor], opt_state: OptState,
                      lr: float, clip: float, momentum: float = 0.9,
                      weight_decay: float = 0.0,
                      gnorm: Optional[torch.Tensor] = None):
    """gnorm = the global norm of ``grads``; scale = min(1, clip / (gnorm +
    1e-6)); g *= scale; g += wd * p (after the clip, as
    torch.optim.SGD(weight_decay=...) after clip_grad_norm_); buf = m * buf
    + g; p -= lr * buf. Updates ``params`` and the buffers in place;
    returns (opt_state, gnorm). The norm stays on the device: no host
    synchronisation. ``gnorm`` given replaces the norm of ``grads``: the
    tensor-parallel step's norm over every shard, so that every rank clips
    by one scale."""
    if gnorm is None:
        gnorm = torch.sqrt(sum(g.float().pow(2).sum()
                               for g in grads.values()))
    scale = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
    for k, p in params.items():
        g = grads[k] * scale
        if weight_decay:
            g = g + weight_decay * p
        buf = opt_state.momentum[k]
        buf.mul_(momentum).add_(g)
        p.sub_(lr * buf)
    return opt_state, gnorm
