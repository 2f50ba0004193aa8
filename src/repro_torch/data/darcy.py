"""Darcy flow dataset: -∇·(a(x)∇u(x)) = f, u|∂D = 0  (paper §B.2).

Coefficients a(x) are piecewise-constant pushforwards of a GRF (12 where
the GRF is positive, 3 elsewhere, the Li et al. 2021 construction), the
forcing is f ≡ 1, and the solution comes from conjugate gradients on the
5-point finite-difference operator with harmonic-mean face coefficients.
Everything runs batched on the device of the tensors it is given.
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve_device

from .grf import grf_2d


def _face_harmonic(a: torch.Tensor, dim: int) -> torch.Tensor:
    n = a.shape[dim]
    a0, a1 = a.narrow(dim, 0, n - 1), a.narrow(dim, 1, n - 1)
    return 2.0 * a0 * a1 / (a0 + a1)


def darcy_matvec(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Apply A = -∇·(a∇·) to interior fields ``u`` (..., n, n) with
    coefficients ``a`` of the same shape; Dirichlet boundary."""
    n = u.shape[-1]
    h = 1.0 / (n + 1)
    up = torch.nn.functional.pad(u, (1, 1, 1, 1))
    edge = torch.arange(-1, n + 1, device=a.device).clamp(0, n - 1)
    ap = a[..., edge, :][..., :, edge]          # edge padding
    ax = _face_harmonic(ap, -2)  # (n+1, n+2) faces along x
    ay = _face_harmonic(ap, -1)  # (n+2, n+1)
    # flux divergence
    fx = ax * (up[..., 1:, :] - up[..., :-1, :])
    fy = ay * (up[..., :, 1:] - up[..., :, :-1])
    div = ((fx[..., 1:, 1:-1] - fx[..., :-1, 1:-1])
           + (fy[..., 1:-1, 1:] - fy[..., 1:-1, :-1]))
    return -div / (h * h)


def _dot(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return (p * q).sum(dim=(-2, -1))


def _cg(a: torch.Tensor, b: torch.Tensor, tol: float, maxiter: int) -> torch.Tensor:
    """Conjugate gradients on every field of the batch at once, with the
    stopping rule of ``jax.scipy.sparse.linalg.cg``: x0 = 0, stop once
    ``‖r‖² ≤ tol²·‖b‖²`` or after ``maxiter`` iterations.  A field that
    stops is frozen while the others go on, as a vmapped ``while_loop``
    freezes it, so each field gets the answer it gets alone.  Whether any
    field is still going is read back every 16 iterations (a device sync
    each time)."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    gamma = _dot(r, r)
    atol2 = tol * tol * _dot(b, b)
    k = torch.zeros(b.shape[:-2], dtype=torch.int64, device=b.device)
    for it in range(maxiter):
        active = (gamma > atol2) & (k < maxiter)
        if it % 16 == 0 and not bool(active.any()):
            break
        ap_ = darcy_matvec(a, p)
        alpha = gamma / _dot(p, ap_)
        live = active[..., None, None]
        x = torch.where(live, x + alpha[..., None, None] * p, x)
        r_new = r - alpha[..., None, None] * ap_
        gamma_new = _dot(r_new, r_new)
        beta = gamma_new / gamma
        p = torch.where(live, r_new + beta[..., None, None] * p, p)
        r = torch.where(live, r_new, r)
        gamma = torch.where(active, gamma_new, gamma)
        k = k + active.to(k.dtype)
    return x


#: CG's relative tolerance, as the reference's solve_darcy sets it
CG_TOL = 1e-6


def solve_darcy(a: torch.Tensor, n: int, maxiter: int = 500) -> torch.Tensor:
    """CG-solve -∇·(a∇u) = 1 for coefficient fields ``a`` (..., n, n), on
    ``a``'s device, to ``CG_TOL``."""
    if a.shape[-2:] != (n, n):
        raise ValueError(f"coefficients {tuple(a.shape)} are not (..., {n}, {n})")
    f = torch.ones_like(a, dtype=torch.float32)
    u = _cg(a.to(torch.float32), f, CG_TOL, maxiter)
    return u


def sample_darcy_batch(generator: torch.Generator, n: int, batch: int,
                       maxiter: int = 500, device: DeviceLike = None):
    """Returns (a, u): coefficients (B, 1, n, n) and solutions (B, 1, n, n),
    f32 on ``device`` (CUDA unless the caller names another), where the CG
    solve runs.  The GRF noise is drawn from ``generator`` on its own
    device, so a CPU generator gives the same fields on every device.

    Both channels are whitened to O(1), the standard neuraloperator
    preprocessing the paper inherits: the tanh stabiliser is ~identity
    near 0 but saturates on the raw piecewise-{3,12} coefficients."""
    dev = resolve_device(device)
    g = grf_2d(generator, n, alpha=2.0, tau=3.0, batch=batch).to(dev)
    a = torch.where(g > 0, 12.0, 3.0).to(torch.float32)
    u = solve_darcy(a, n, maxiter)
    a = (a - 7.5) / 4.5          # whiten {3,12} -> {-1,+1}
    u = (u - 5e-3) / 5e-3        # interior solution scale for f≡1
    return a[:, None], u[:, None]
