"""Losses: relative L² and Sobolev H¹ (the paper trains with H¹ on NS).

H¹ uses spectral derivatives (exact for periodic fields), as the
reference and the neuraloperator implementation it builds on do.
"""
from __future__ import annotations

import math

import torch


def relative_l2(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Mean over batch of ||pred - target||₂ / ||target||₂."""
    dims = tuple(range(1, pred.ndim))
    num = torch.sqrt(torch.sum((pred - target) ** 2, dim=dims))
    den = torch.sqrt(torch.sum(target ** 2, dim=dims)) + eps
    return torch.mean(num / den)


def _spectral_grad_sq(f: torch.Tensor) -> torch.Tensor:
    """Σ_d ||∂f/∂x_d||² per sample, via FFT (periodic). f: (B, C, *spatial)."""
    dims = tuple(range(1, f.ndim))
    total = 0.0
    for ax in range(2, f.ndim):
        n = f.shape[ax]
        k = torch.fft.fftfreq(n, d=1.0 / n, device=f.device) * 2.0 * math.pi
        shape = [1] * f.ndim
        shape[ax] = n
        fk = torch.fft.fft(f, dim=ax)
        df = torch.fft.ifft(1j * k.reshape(shape) * fk, dim=ax).real
        total = total + torch.sum(df ** 2, dim=dims)
    return total


def relative_h1(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Relative H¹ = sqrt(||e||² + ||∇e||²) / sqrt(||t||² + ||∇t||²)."""
    dims = tuple(range(1, pred.ndim))
    e = pred - target
    num = torch.sum(e ** 2, dim=dims) + _spectral_grad_sq(e)
    den = torch.sum(target ** 2, dim=dims) + _spectral_grad_sq(target)
    return torch.mean(torch.sqrt(num) / (torch.sqrt(den) + eps))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean CE for the LM pool. logits (B, S, V) f32, labels (B, S).
    On a DTensor, V is made whole first and the batch and sequence shards
    stay: DTensor's gather of the gold logit on a V-sharded tensor fails,
    and on torch 2.11 the loss's gradient over a sharded V came out NaN."""
    logits = _whole_v(logits.to(torch.float32))
    m = logits.amax(-1, keepdim=True)
    logz = torch.log(torch.sum(torch.exp(logits - m), -1))
    logz = logz + logits.amax(-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    return torch.mean(logz - gold)


def _whole_v(logits: torch.Tensor) -> torch.Tensor:
    """logits with no mesh dim sharding their last dim (the identity on a
    plain tensor and where none does)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(logits, DTensor):
        return logits
    vd = logits.ndim - 1
    placements = [Replicate() if isinstance(p, Shard) and p.dim % logits.ndim == vd else p
                  for p in logits.placements]
    if placements == list(logits.placements):
        return logits
    return logits.redistribute(logits.device_mesh, placements)
