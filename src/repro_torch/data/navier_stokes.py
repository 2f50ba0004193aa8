"""2-D Navier-Stokes (vorticity form, unit torus) pseudo-spectral solver.

The paper's dataset (§B.2): Re=500, forcing f ~ N(0, 27(-Δ+9I)^{-4}),
ω(0)=0, learn G: f ↦ ω(T) with T=5.  Crank-Nicolson for the viscous term
+ Heun for the advection term, 2/3-rule dealiasing (Chandler & Kerswell
2013), as the JAX reference writes it, in complex64, batched over fields
on the device of the forcing it is given.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import DeviceLike, resolve_device

from .grf import grf_2d


def _wavenumbers(n: int, device):
    k = torch.fft.fftfreq(n, d=1.0 / n, device=device) * 2.0 * math.pi
    kx, ky = k[:, None], k[None, :]
    k2 = kx ** 2 + ky ** 2
    k2_inv = torch.where(k2 > 0, 1.0 / torch.clamp(k2, min=1e-12), torch.zeros_like(k2))
    # 2/3 dealias mask
    cutoff = n // 3
    fx = torch.abs(torch.fft.fftfreq(n, d=1.0 / n, device=device))
    mask = (fx[:, None] <= cutoff) & (fx[None, :] <= cutoff)
    return kx, ky, k2, k2_inv, mask


def _nonlinear(w_hat, kx, ky, k2_inv, mask):
    """-(u·∇)ω in spectral space with dealiasing."""
    psi_hat = w_hat * k2_inv                               # -Δψ = ω
    u = torch.fft.ifft2(1j * ky * psi_hat).real            # u =  ∂ψ/∂y
    v = torch.fft.ifft2(-1j * kx * psi_hat).real           # v = -∂ψ/∂x
    wx = torch.fft.ifft2(1j * kx * w_hat).real
    wy = torch.fft.ifft2(1j * ky * w_hat).real
    adv = u * wx + v * wy
    return -torch.fft.fft2(adv) * mask


@torch.no_grad()
def solve_ns_vorticity(f: torch.Tensor, n: int, T: float = 5.0, Re: float = 500.0,
                       steps: int = 512) -> torch.Tensor:
    """Integrate ω_t + u·∇ω = (1/Re)Δω + f from ω(0)=0 to t=T for every
    forcing of ``f`` (..., n, n) at once, on ``f``'s device.  Returns
    ω(T) (..., n, n) in float32."""
    if f.shape[-2:] != (n, n):
        raise ValueError(f"forcing {tuple(f.shape)} is not (..., {n}, {n})")
    nu = 1.0 / Re
    dt = T / steps
    kx, ky, k2, k2_inv, mask = _wavenumbers(n, f.device)
    f_hat = torch.fft.fft2(f.to(torch.float32)) * mask
    # Crank-Nicolson viscous factors
    cn_a = 1.0 - 0.5 * dt * nu * (-k2)
    cn_b = 1.0 + 0.5 * dt * nu * (-k2)
    w_hat = torch.zeros_like(f_hat)
    for _ in range(steps):
        n1 = _nonlinear(w_hat, kx, ky, k2_inv, mask)
        w_pred = (w_hat * cn_b + dt * (n1 + f_hat)) / cn_a
        n2 = _nonlinear(w_pred, kx, ky, k2_inv, mask)
        w_hat = (w_hat * cn_b + dt * (0.5 * (n1 + n2) + f_hat)) / cn_a
    return torch.fft.ifft2(w_hat).real


def sample_ns_batch(generator: torch.Generator, n: int, batch: int, T: float = 5.0,
                    steps: int = 512, device: DeviceLike = None):
    """Returns (f, w): forcings (B, 1, n, n) and solutions ω(T) (B, 1, n, n),
    f32 on ``device`` (CUDA unless the caller names another), where the
    solver runs.  The forcing is drawn from ``generator`` on its own
    device, so a CPU generator gives the same fields on every device."""
    dev = resolve_device(device)
    f = grf_2d(generator, n, alpha=4.0, tau=3.0, sigma=27.0 ** 0.5, batch=batch).to(dev)
    w = solve_ns_vorticity(f, n, T=T, steps=steps)
    return f[:, None], w[:, None]
