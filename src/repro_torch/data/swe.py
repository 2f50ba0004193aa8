"""Spherical shallow-water dataset (paper §B.2, Bonev et al. 2023 style).

The *linearised* rotating shallow-water equations on the sphere
(gravity-wave dynamics about a state of rest):

    ∂φ/∂t = -Φ̄ ∇·u
    ∂u/∂t = -∇φ - f k̂×u,       f = 2Ω sin(lat)

on the Gauss-Legendre lat-lon grid, with a spectral (SHT) hyperdiffusion
filter each step for stability, as the JAX reference writes them, batched
over fields on the device of the initial field.  Random smooth initial
geopotentials come from ``grf_sphere``; the learning task is
φ(0) ↦ (φ, u, v)(T).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.sht import legendre_matrices, sht_forward, sht_inverse

from .grf import grf_sphere


def _latitudes(nlat: int, device) -> torch.Tensor:
    _, x, _ = legendre_matrices(nlat, 8, 8)
    lat = np.arcsin(np.clip(x, -1, 1))  # Gauss-Legendre latitudes
    return torch.from_numpy(lat.astype(np.float32)).to(device)


@torch.no_grad()
def solve_swe_linear(phi0: torch.Tensor, nlat: int, nlon: int, steps: int = 200,
                     dt: float = 150.0, phibar: float = 3.0e4, omega: float = 7.292e-5,
                     radius: float = 6.371e6, lmax: int = 24):
    """Integrate ``steps`` forward steps from the geopotential anomaly
    ``phi0`` (..., nlat, nlon) at rest, every field at once, on ``phi0``'s
    device.  Returns (phi, u, v) at T, float32."""
    if phi0.shape[-2:] != (nlat, nlon):
        raise ValueError(f"phi0 {tuple(phi0.shape)} is not (..., {nlat}, {nlon})")
    lmax = min(lmax, nlat, nlon // 2 + 1)
    lat = _latitudes(nlat, phi0.device)
    coslat = torch.cos(lat)[:, None]
    fcor = 2.0 * omega * torch.sin(lat)[:, None]
    dlon = 2.0 * math.pi / nlon
    dlat = torch.gradient(lat)[0][:, None]
    l = torch.arange(lmax, device=phi0.device)[:, None]
    damp = torch.exp(-1e-2 * (l / lmax) ** 4 * 16)

    def ddlon(a):
        return (torch.roll(a, -1, dims=-1) - torch.roll(a, 1, dims=-1)) / (2 * dlon)

    def ddlat(a):
        # non-uniform Gauss latitudes: central differences, one-sided ends
        return torch.gradient(a, dim=-2)[0] / dlat

    def filt(a):
        return sht_inverse(sht_forward(a, lmax, lmax) * damp, nlat, nlon)

    phi = phi0.to(torch.float32)
    u, v = torch.zeros_like(phi), torch.zeros_like(phi)
    for _ in range(steps):
        div = (ddlon(u) / coslat + ddlat(v * coslat) / coslat) / radius
        dphix = ddlon(phi) / (radius * coslat)
        dphiy = ddlat(phi) / radius
        phi_n = phi - dt * phibar * div
        u_n = u + dt * (-dphix + fcor * v)
        v_n = v + dt * (-dphiy - fcor * u)
        phi, u, v = filt(phi_n), filt(u_n), filt(v_n)
    return phi, u, v


def sample_swe_batch(generator: torch.Generator, nlat: int, nlon: int, batch: int,
                     steps: int = 200, device: DeviceLike = None):
    """Returns (x, y): inputs (B, 3, nlat, nlon) = (φ0, 0, 0) and targets
    (B, 3, nlat, nlon) = (φ, u, v)(T), each channel normalised to O(1),
    f32 on ``device`` (CUDA unless the caller names another), where the
    solver runs.  The initial fields are drawn from ``generator`` on its
    own device, so a CPU generator gives the same fields on every
    device."""
    dev = resolve_device(device)
    phi0 = grf_sphere(generator, nlat, nlon, lmax=min(16, nlat // 2), batch=batch).to(dev)
    phi0 = phi0 * 1e2  # geopotential anomaly scale (m²/s²)
    phi, u, v = solve_swe_linear(phi0, nlat, nlon, steps=steps)
    zero = torch.zeros_like(phi0)
    x = torch.stack([phi0, zero, zero], dim=1)
    y = torch.stack([phi, u, v], dim=1)
    scale = torch.tensor([1e2, 1.0, 1.0], device=dev)[None, :, None, None]
    return x / 1e2, y / scale
