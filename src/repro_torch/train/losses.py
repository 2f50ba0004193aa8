"""Losses.  Relative L² only: the Sobolev H¹ loss comes with the
Navier–Stokes (TFNO) slice."""
from __future__ import annotations

import torch


def relative_l2(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Mean over batch of ||pred - target||₂ / ||target||₂."""
    dims = tuple(range(1, pred.ndim))
    num = torch.sqrt(torch.sum((pred - target) ** 2, dim=dims))
    den = torch.sqrt(torch.sum(target ** 2, dim=dims)) + eps
    return torch.mean(num / den)
