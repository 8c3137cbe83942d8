"""DARTS architect, counterpart of ``bayeslms_tpu/nas/architect.py``: it
moves the architecture weights on the validation split.

The reference's ``Architect`` (architect.py): Adam over the arch weights
with default betas and the weight decay added into the gradient before
the moments (torch.optim.Adam(weight_decay=...)); first order, the
validation loss's gradient; second order, one virtual SGD step on the
network weights (clipped gradients plus ``network_weight_decay`` theta, at
the network lr), the validation gradient at the unrolled weights, and the
implicit term d/dalpha <grad_theta L_train(theta, alpha), v> at the
original weights, scaled by eta times the raw clip coefficient. The
reference approximates that term by finite differences; the JAX package
computes it exactly, and so does this module, with
``torch.autograd.grad(..., create_graph=True)`` (a double backward through
the supernet's forward).

``loss_fn(params, arch, batch, draws) -> scalar`` takes the network
weights as a {name: tensor} dict (``torch.func.functional_call``), so the
virtual step needs no copy of the module.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch


class ArchitectState(NamedTuple):
    arch: torch.Tensor
    m: torch.Tensor  # Adam's first moment
    v: torch.Tensor  # Adam's second moment
    count: int


def _clip_by_total(grads: Dict[str, torch.Tensor], max_norm: float
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The reference's ``_clip``: the grads scaled by min(1, coef), coef =
    max_norm / (norm + 1e-6), and the RAW coef returned either way (the
    second-order step scales its implicit term by eta * coef, so a small
    gradient norm amplifies it)."""
    norm = torch.sqrt(sum(g.pow(2).sum() for g in grads.values()))
    coef = max_norm / (norm + 1e-6)
    scale = torch.clamp(coef, max=1.0)
    return {k: g * scale for k, g in grads.items()}, coef


def _grads(out, wrt, **kw):
    got = torch.autograd.grad(out, wrt, allow_unused=True, **kw)
    return [torch.zeros_like(w) if g is None else g
            for w, g in zip(wrt, got)]


class Architect:
    def __init__(self, loss_fn: Callable, arch_lr: float = 3e-3,
                 arch_weight_decay: float = 1e-3, w_lr: float = 1.0,
                 network_weight_decay: float = 5e-7,
                 network_clip: float = 0.25, unrolled: bool = False):
        self.loss_fn = loss_fn
        self.arch_lr, self.arch_weight_decay = arch_lr, arch_weight_decay
        self.w_lr = w_lr
        self.network_weight_decay = network_weight_decay
        self.network_clip = network_clip
        self.unrolled = unrolled

    def init(self, arch: torch.Tensor) -> ArchitectState:
        arch = arch.detach().clone()
        return ArchitectState(arch, torch.zeros_like(arch),
                              torch.zeros_like(arch), 0)

    def _grad(self, params, arch, batch, draws, wrt, **kw):
        """Gradients of the loss with respect to ``wrt``; zeros for a
        tensor the loss does not reach (a search cell's ``b_hh``), as
        ``jax.grad`` gives."""
        loss = self.loss_fn(params, arch, batch, draws)
        return _grads(loss, wrt, **kw)

    def virtual_step(self, params: Dict[str, torch.Tensor], arch,
                     train_batch, draws):
        """One virtual SGD step: the clipped train gradients plus
        ``network_weight_decay`` theta, at the network lr. Returns the
        stepped weights (detached) and the raw clip coefficient."""
        names = list(params)
        g = dict(zip(names, self._grad(params, arch, train_batch, draws,
                                       [params[k] for k in names])))
        g, coef = _clip_by_total(g, self.network_clip)
        new_p = {k: (params[k] - self.w_lr * (
            g[k] + self.network_weight_decay * params[k])).detach()
            for k in names}
        return new_p, coef.detach()

    def arch_grad(self, params: Dict[str, torch.Tensor], arch: torch.Tensor,
                  train_batch, valid_batch, draws) -> torch.Tensor:
        """d L_valid / d alpha: first order at ``params``; second order
        through the unrolled step, exactly."""
        a = arch.detach().requires_grad_(True)
        if not self.unrolled:
            return self._grad(params, a, valid_batch, draws, [a])[0]
        new_p, coef = self.virtual_step(params, a.detach(), train_batch,
                                        draws)
        names = list(new_p)
        for p in new_p.values():
            p.requires_grad_(True)
        # the validation gradient at the unrolled weights, with respect to
        # alpha and to those weights (v, clipped)
        grads = self._grad(new_p, a, valid_batch, draws,
                           [a] + [new_p[k] for k in names])
        dalpha = grads[0]
        v, _ = _clip_by_total(dict(zip(names, grads[1:])), self.network_clip)
        # the implicit term: d/da <grad_theta L_train(theta, a), v> at the
        # original weights
        p0 = {k: params[k].detach().requires_grad_(True) for k in names}
        g = self._grad(p0, a, train_batch, draws,
                       [p0[k] for k in names], create_graph=True)
        dot = sum((gi * v[k].detach()).sum() for gi, k in zip(g, names))
        implicit, = _grads(dot, [a])
        return dalpha - self.w_lr * coef * implicit

    def step(self, state: ArchitectState, params, train_batch, valid_batch,
             draws) -> ArchitectState:
        """One Adam step on the arch weights (torch.optim.Adam's
        arithmetic: betas (0.9, 0.999), eps 1e-8, the decay in the
        gradient)."""
        b1, b2, eps = 0.9, 0.999, 1e-8
        with torch.enable_grad():
            g = self.arch_grad(params, state.arch, train_batch, valid_batch,
                               draws)
        with torch.no_grad():
            g = g + self.arch_weight_decay * state.arch
            m = b1 * state.m + (1.0 - b1) * g
            v = b2 * state.v + (1.0 - b2) * g * g
            n = state.count + 1
            m_hat = m / (1.0 - b1 ** n)
            v_hat = v / (1.0 - b2 ** n)
            arch = state.arch - self.arch_lr * m_hat / (torch.sqrt(v_hat)
                                                        + eps)
        return ArchitectState(arch, m, v, n)
