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
        g = {k: grads[k].to(torch.float32) for k in keys}
        if self.grad_clip_norm is not None:
            gnorm = global_norm(g)
            scale = torch.clamp(self.grad_clip_norm / (gnorm + 1e-9), max=1.0)
            g = {k: v * scale for k, v in g.items()}

        count = state.count + 1
        b1, b2 = self.b1, self.b2
        mu = {k: b1 * state.mu[k] + (1 - b1) * g[k] for k in keys}
        nu = {k: b2 * state.nu[k] + (1 - b2) * (g[k] * g[k]) for k in keys}
        c = count.to(torch.float32)
        mu_hat_scale = 1.0 / (1 - torch.pow(b1, c))
        nu_hat_scale = 1.0 / (1 - torch.pow(b2, c))

        def step(p, m, v):
            upd = (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + self.eps)
            return (p - self.lr * (upd + self.weight_decay * p)).to(p.dtype)

        new_params = {k: step(params[k], mu[k], nu[k]) for k in keys}
        return new_params, AdamWState(count=count, mu=mu, nu=nu)


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
