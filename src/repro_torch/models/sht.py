"""Real spherical harmonic transform (SHT): a longitude FFT and a
Legendre matrix product per order m, on a Gauss-Legendre grid.

The SFNO's substrate, as the JAX reference builds it: fully normalised
spherical harmonics Y_lm = P̄_lm(cosθ)e^{imφ} with ∫|Y_lm|²dΩ = 1; the
Gauss-Legendre latitudes make the analysis/synthesis round trip exact for
band-limited fields (lmax <= nlat - 1).

The Legendre matrix P̄ is real, so each transform is two real batched
matrix products (one for the real and one for the imaginary part, folded
into one ``torch.bmm`` per order) where the reference multiplies a complex
einsum whose weight has a zero imaginary part: the same terms, half the
work.  They are plain large matrix products outside any kernel, as the
reference leaves them to XLA.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def legendre_matrices(nlat: int, lmax: int, mmax: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Precompute (P, x, w): P[m, l, lat] = P̄_lm(x_lat) (0 for l < m),
    Gauss-Legendre nodes x and weights w.  float64 numpy for stability."""
    x, w = np.polynomial.legendre.leggauss(nlat)
    P = np.zeros((mmax, lmax, nlat), dtype=np.float64)
    sin2 = 1.0 - x * x
    # p̄_mm via upward recurrence in m
    pmm = np.full(nlat, math.sqrt(1.0 / (4.0 * math.pi)))
    for m in range(mmax):
        if m > 0:
            pmm = -np.sqrt((2.0 * m + 1.0) / (2.0 * m)) * np.sqrt(sin2) * pmm
        if m < lmax:
            P[m, m] = pmm
        if m + 1 < lmax:
            P[m, m + 1] = x * math.sqrt(2.0 * m + 3.0) * pmm
        for l in range(m + 2, lmax):
            a = math.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = math.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            P[m, l] = a * (x * P[m, l - 1] - b * P[m, l - 2])
    return P, x, w


@functools.lru_cache(maxsize=16)
def _device_matrix(nlat: int, lmax: int, mmax: int, device: torch.device,
                   weighted: bool) -> torch.Tensor:
    """P (synthesis) or P·w (analysis), (m, l, lat) in f32 on ``device``,
    rounded from float64 once, as the reference rounds them."""
    P, _, w = legendre_matrices(nlat, lmax, mmax)
    a = P * w[None, None, :] if weighted else P
    return torch.from_numpy(a.astype(np.float32)).to(device)


def _by_order(z: torch.Tensor) -> torch.Tensor:
    """(N, rows, m) complex -> (m, rows, 2N) real: the operand of one real
    matrix product per order, real and imaginary parts side by side."""
    N, rows, m = z.shape
    return torch.view_as_real(z).permute(2, 1, 0, 3).reshape(m, rows, 2 * N)


def _from_order(a: torch.Tensor) -> torch.Tensor:
    """(m, rows, 2N) real -> (N, rows, m, 2): the inverse of ``_by_order``
    before the complex view."""
    m, rows, n2 = a.shape
    return a.reshape(m, rows, n2 // 2, 2).permute(2, 1, 0, 3)


def sht_forward(f: torch.Tensor, lmax: int, mmax: int, precision=None) -> torch.Tensor:
    """Analysis: f (..., nlat, nlon) real -> coeffs (..., lmax, mmax) complex64.

    coeffs[l,m] = Σ_lat w_lat P̄_lm(x_lat) · (2π/nlon)·rfft(f)[lat, m]

    ``precision`` is an optional resolved ``SitePrecision`` (a
    ``*/spectral/fft_in`` site): the transform itself runs in f32, and the
    output spectrum is boundary-quantised onto the site's storage grid
    (Thm 3.2's representation error).
    """
    *batch, nlat, nlon = f.shape
    if mmax > nlon // 2 + 1:
        raise ValueError(f"mmax={mmax} exceeds the {nlon // 2 + 1} orders of {nlon} longitudes")
    Pw = _device_matrix(nlat, lmax, mmax, f.device, True)          # (m, l, lat)
    Fm = torch.fft.rfft(f.float(), dim=-1) * (2.0 * math.pi / nlon)
    Fm = Fm[..., :mmax].reshape(-1, nlat, mmax)                      # (N, lat, m)
    c = torch.bmm(Pw, _by_order(Fm))                                 # (m, l, 2N)
    coeffs = torch.view_as_complex(_from_order(c).contiguous()).reshape(*batch, lmax, mmax)
    if precision is not None:
        coeffs = precision.quantize(coeffs)
    return coeffs


def sht_inverse(coeffs: torch.Tensor, nlat: int, nlon: int) -> torch.Tensor:
    """Synthesis: coeffs (..., lmax, mmax) -> f (..., nlat, nlon) real f32.

    The real field is G_0 + 2·Re Σ_{m>0} G_m e^{imφ}, a C2R transform of
    G scaled by nlon.  A C2R transform is defined only for a real zero
    (and Nyquist) bin, and the contraction leaves G_0 complex: pocketfft
    (the CPU, and the reference) reads its real part, cuFFT does not.  The
    imaginary parts of those bins are dropped first, so every device
    computes what the reference does."""
    *batch, lmax, mmax = coeffs.shape
    P = _device_matrix(nlat, lmax, mmax, coeffs.device, False)      # (m, l, lat)
    c = coeffs.to(torch.complex64).reshape(-1, lmax, mmax)           # (N, l, m)
    G = _from_order(torch.bmm(P.transpose(1, 2), _by_order(c)))     # (N, lat, m, 2)
    nfreq = nlon // 2 + 1
    G = G[:, :, :nfreq]   # orders beyond the grid's Nyquist cannot be realised
    keep = torch.ones(G.shape[2], dtype=G.dtype, device=G.device)
    keep[0] = 0.0
    if nlon % 2 == 0 and G.shape[2] == nfreq:
        keep[-1] = 0.0
    G = torch.complex(G[..., 0], G[..., 1] * keep)
    # irfft zero-pads to nfreq bins, applies the hermitian doubling and 1/nlon
    f = torch.fft.irfft(G, n=nlon, dim=-1) * float(nlon)
    return f.reshape(*batch, nlat, nlon)
