"""AdamW with f32 master weights, written out as the reference writes it.

Mixed-precision contract (Micikevicius et al. 2017): parameters and
optimizer moments stay f32; gradients may arrive in half and are upcast
before the moment update.  The update folds in a global-norm clip
(``grad_clip_norm``, with ``+1e-9``), bias correction from the f32 step
count, and lr-scaled decoupled weight decay ``p - lr·(upd + wd·p)``.
``torch.optim.AdamW`` and ``clip_grad_norm_`` order and round these
steps differently, so they are not used.

Parameters, gradients and moments are dicts of tensors keyed by name;
every sum over them runs in sorted-key order, the order in which the
reference flattens its parameter dict.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

Tree = Mapping[str, torch.Tensor]


class AdamWState(NamedTuple):
    count: torch.Tensor          # int32 scalar
    mu: Dict[str, torch.Tensor]  # first moments, f32, keyed like the params
    nu: Dict[str, torch.Tensor]  # second moments


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    grad_clip_norm: Optional[float] = 1.0

    def init(self, params: Tree) -> AdamWState:
        """Zero moments on the parameters' devices."""
        device = next(iter(params.values())).device
        zeros = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu=zeros,
            nu={k: v.clone() for k, v in zeros.items()},
        )

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState,
               params: Tree) -> Tuple[Dict[str, torch.Tensor], AdamWState]:
        """Returns (new_params, new_state); the inputs are not modified."""
        keys = sorted(params)
        scale = self._clip_scale(grads)
        count = state.count + 1
        hats = self._hats(count)
        new_params, mu, nu = {}, {}, {}
        for k in keys:
            new_params[k], mu[k], nu[k] = self._leaf(params[k], state.mu[k], state.nu[k],
                                                     grads[k], scale, hats, inplace=False)
        return new_params, AdamWState(count=count, mu=mu, nu=nu)

    @torch.no_grad()
    def update_(self, grads: Dict[str, torch.Tensor], state: AdamWState,
                params: Tree) -> AdamWState:
        """:meth:`update` written into ``params`` and ``state`` in place, a
        leaf at a time (the reference's donated step): the same ops in the
        same order, so the same bits.  Each gradient is dropped from
        ``grads`` once its leaf is updated.  Returns ``state``."""
        scale = self._clip_scale(grads)
        hats = self._hats(state.count.add_(1))
        for k in sorted(params):
            self._leaf(params[k], state.mu[k], state.nu[k], grads.pop(k), scale, hats,
                       inplace=True)
        return state

    def _clip_scale(self, grads: Tree) -> Optional[torch.Tensor]:
        """The global-norm clip's factor (None without a clip)."""
        if self.grad_clip_norm is None:
            return None
        return torch.clamp(self.grad_clip_norm / (global_norm(grads) + 1e-9), max=1.0)

    def _hats(self, count: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The bias corrections of the moments at step ``count``."""
        c = count.to(torch.float32)
        return 1.0 / (1 - torch.pow(self.b1, c)), 1.0 / (1 - torch.pow(self.b2, c))

    def _leaf(self, p, mu, nu, g, scale, hats, inplace: bool):
        """One leaf's (parameter, mu, nu) after the step: new tensors, or
        ``p``, ``mu`` and ``nu`` written in place.  ``b1 * mu + (1 - b1) * g``
        and ``mu.mul_(b1).add_((1 - b1) * g)`` round alike."""
        g = g.to(torch.float32)
        if scale is not None:
            g = g * scale
        b1, b2 = self.b1, self.b2
        if inplace:
            mu = mu.mul_(b1).add_((1 - b1) * g)
            nu = nu.mul_(b2).add_((1 - b2) * (g * g))
        else:
            mu = b1 * mu + (1 - b1) * g
            nu = b2 * nu + (1 - b2) * (g * g)
        del g
        upd = (mu * hats[0]) / (torch.sqrt(nu * hats[1]) + self.eps)
        new = (p - self.lr * (upd + self.weight_decay * p)).to(p.dtype)
        return (p.copy_(new) if inplace else new), mu, nu


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, leaves in
    sorted-key order."""
    total = 0
    for k in sorted(tree):
        total = total + torch.sum(torch.square(tree[k].to(torch.float32)))
    return torch.sqrt(total)


def all_finite(tree: Tree) -> torch.Tensor:
    """A bool scalar tensor: every element of every leaf is finite."""
    return torch.stack([torch.isfinite(tree[k].to(torch.float32)).all()
                        for k in sorted(tree)]).all()
