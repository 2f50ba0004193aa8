"""Pre-FFT numerical stabilisers (paper Section 4.3, Appendix B.5/B.6).

A local pre-activation before each forward FFT keeps the half transform
finite; ``tanh`` wins (Table 3): it is near identity at 0 and bounds the
sup-norm M and the Lipschitz constant L of the Theorem 3.1/3.2 bounds.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


class _Tanh(torch.autograd.Function):
    """``tanh`` whose backward is JAX's, ``e + e·y`` with ``e = g·(1 − y)``,
    op by op in the activation's dtype.  PyTorch's own ``tanh_backward`` rounds
    ``g·(1 − y²)`` once, which differs from the reference in ~46 % of
    bf16/fp16 elements."""

    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        e = g * (1.0 - y)
        return e + e * y


def tanh_stabilizer(x: torch.Tensor) -> torch.Tensor:
    """The paper's choice: |tanh(x)| <= 1 bounds the FFT input."""
    return _Tanh.apply(x)


def hard_clip_stabilizer(x: torch.Tensor, limit: float = 3.0) -> torch.Tensor:
    """hard-clip baseline from Table 3."""
    return torch.clamp(x, -limit, limit)


def sigma_clip_stabilizer(x: torch.Tensor, k: float = 2.0) -> torch.Tensor:
    """2σ-clip baseline from Table 3: clip to mean ± k·std (per sample,
    population std as ``jnp.std``)."""
    dims = tuple(range(1, x.ndim))
    mu = torch.mean(x, dim=dims, keepdim=True)
    sd = torch.std(x, dim=dims, keepdim=True, correction=0)
    return torch.clamp(x, mu - k * sd, mu + k * sd)


def fixed_scale_stabilizer(x: torch.Tensor, divisor: float = 10.0) -> torch.Tensor:
    """Pointwise division baseline (Appendix B.6)."""
    return x / divisor


STABILIZERS = {
    None: lambda x: x,
    "none": lambda x: x,
    "tanh": tanh_stabilizer,
    "hard_clip": hard_clip_stabilizer,
    "sigma_clip": sigma_clip_stabilizer,
    "fixed_scale": fixed_scale_stabilizer,
}


def get_stabilizer(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    try:
        return STABILIZERS[name]
    except KeyError:
        raise KeyError(
            f"unknown stabilizer {name!r}; have {sorted(k for k in STABILIZERS if k)}"
        ) from None
