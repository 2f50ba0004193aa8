"""Gaussian random fields on the periodic unit torus, sampled spectrally,
and smooth random fields on the sphere.

The measure N(0, σ²(-Δ + τ²I)^(-α)) is the standard source of PDE
coefficients (Li et al. 2021; Kossaifi et al. 2023).  Same covariance as
the JAX reference's ``grf_2d`` and ``grf_sphere``; the numbers differ,
since the noise comes from a ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def grf_2d(
    generator: torch.Generator,
    n: int,
    alpha: float = 4.0,
    tau: float = 9.0,
    sigma: Optional[float] = None,
    batch: int = 1,
) -> torch.Tensor:
    """Sample ``batch`` float32 fields of shape (n, n) from
    N(0, σ²(-Δ+τ²)^{-α}), on the generator's device.  σ defaults to
    τ^(α-1), which keeps the field variance O(1)."""
    dev = generator.device
    k = torch.fft.fftfreq(n, d=1.0 / n, device=dev)
    k2 = (k[:, None] ** 2 + k[None, :] ** 2) * (2 * math.pi) ** 2
    if sigma is None:
        sigma = tau ** (0.5 * (2 * alpha - 2.0))
    # sqrt of the covariance spectrum, zero mean
    sqrt_eig = sigma * (k2 + tau ** 2) ** (-alpha / 2.0)
    sqrt_eig[0, 0] = 0.0
    noise = torch.complex(
        torch.randn((batch, n, n), generator=generator, device=dev),
        torch.randn((batch, n, n), generator=generator, device=dev),
    )
    field = torch.fft.ifft2(noise * sqrt_eig[None]).real * n
    return field.to(torch.float32)


def sphere_field(re: torch.Tensor, im: torch.Tensor, nlat: int, nlon: int,
                 decay: float = 2.0) -> torch.Tensor:
    """The field synthesised from unit noise ``re``/``im`` (batch, lmax,
    mmax) on ``re``'s device: coefficients with power-law decay
    ``(1 + l)^-decay``, zero for m > l, and a real m = 0 column (a real
    field's zonal coefficients are real)."""
    from repro_torch.models.sht import sht_inverse

    lmax, mmax = re.shape[-2:]
    l = torch.arange(lmax, device=re.device)[:, None]
    m = torch.arange(mmax, device=re.device)[None, :]
    amp = (1.0 + l.to(torch.float32)) ** (-decay)
    valid = (m <= l).to(torch.float32)
    coeffs = torch.complex(re * amp * valid, im * amp * valid)
    coeffs[..., 0] = coeffs[..., 0].real.to(torch.complex64)
    return sht_inverse(coeffs, nlat, nlon)


def grf_sphere(generator: torch.Generator, nlat: int, nlon: int, lmax: int = 16,
               decay: float = 2.0, batch: int = 1) -> torch.Tensor:
    """``batch`` random smooth float32 fields (nlat, nlon) on the
    Gauss-Legendre grid, on the generator's device: SHT synthesis of
    random degree < ``lmax`` coefficients with power-law decay."""
    dev = generator.device
    re = torch.randn((batch, lmax, lmax), generator=generator, device=dev)
    im = torch.randn((batch, lmax, lmax), generator=generator, device=dev)
    return sphere_field(re, im, nlat, nlon, decay)
