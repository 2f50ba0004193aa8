"""Empirical estimators and bounds for the paper's theory (Section 3,
App. A), and the elementwise budget the kernel comparisons use.

* ``disc_error``: Eq. (1), |∫_D v φ_ω dx − Σ_j v(ξ_j) φ_ω(ξ_j) |Q_j||,
  the discretisation error of the Fourier transform on the lattice Q_d.
* ``prec_error``: Eq. (2), the additional error from evaluating the sum
  with quantised values q(v(ξ)) q(φ(ξ)).
* Closed-form worst-case bounds:
    Thm 3.1:  c1 √d M n^{-2/d}  <=  sup Disc  <=  c2 √d (|ω|+L) M n^{-1/d}
    Thm 3.2:  sup Prec <= c ε M            (c = 4 in the paper's proof)
    Thm A.1/A.2: analogous bounds for general (non-Fourier) integrands.
* ``contract_budget``: the tolerance between two evaluations of a
  contraction (the reference harness's ``assert_within_budget``).
* ``store_budget``: the tighter one between two evaluations that sum in
  f32 from the same operands and differ only in the order of the sums
  and the one rounding of the stored result.

The estimators are numpy on the host, as in the reference.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from .precision import PrecisionSystem

F32_EPS = 2.0 ** -23


# -- lattice: Q_d with n = m^d cells, ξ_j = lower corner of Q_j -----------------------
def lattice(m: int, d: int) -> np.ndarray:
    """Return the (m^d, d) array of ξ_j = (i_1/m, ..., i_d/m)."""
    axes = [np.arange(m) / m for _ in range(d)]
    grid = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.reshape(-1) for g in grid], axis=-1)


def fourier_basis(xi: np.ndarray, omega: float) -> np.ndarray:
    """φ_ω(x) = exp(2πi <ω·1, x>) with scalar frequency applied isotropically."""
    phase = 2.0 * math.pi * omega * xi.sum(axis=-1)
    return np.exp(1j * phase)


# -- empirical errors -------------------------------------------------------------------
def riemann_sum(v: Callable[[np.ndarray], np.ndarray], m: int, d: int, omega: float) -> complex:
    xi = lattice(m, d)
    vals = v(xi) * fourier_basis(xi, omega)
    return complex(vals.sum() / (m ** d))


def disc_error(v: Callable[[np.ndarray], np.ndarray], m: int, d: int, omega: float,
               ref_multiplier: int = 8) -> float:
    """Eq. (1), with the true integral estimated on an 8x finer lattice."""
    coarse = riemann_sum(v, m, d, omega)
    fine = riemann_sum(v, m * ref_multiplier, d, omega)
    return abs(fine - coarse)


def prec_error(v: Callable[[np.ndarray], np.ndarray], m: int, d: int, omega: float,
               q: Optional[PrecisionSystem] = None, dtype: str = "float16") -> float:
    """Eq. (2): quantise both v(ξ) and φ_ω(ξ), then compare the sums.

    With ``q=None`` the quantiser is numpy's cast to ``dtype`` (the "true
    difference in precision between float32 and float16" of the paper's
    Fig. 7); otherwise the (a0, ε, T) system ``q``."""
    xi = lattice(m, d)
    vals = v(xi).astype(np.float64)
    phi = fourier_basis(xi, omega)
    exact = (vals * phi).sum() / (m ** d)
    if q is not None:
        # quantised at f32, as the reference's jnp arrays are
        qv, qpr, qpi = (q.quantize(torch.tensor(a, dtype=torch.float32)).double().numpy()
                        for a in (vals, phi.real, phi.imag))
    else:
        dt = np.dtype(dtype)
        qv = vals.astype(dt).astype(np.float64)
        qpr = phi.real.astype(dt).astype(np.float64)
        qpi = phi.imag.astype(dt).astype(np.float64)
    approx = (qv * (qpr + 1j * qpi)).sum() / (m ** d)
    return abs(exact - approx)


# -- closed-form bounds -------------------------------------------------------------------
def disc_upper_bound(n: int, d: int, omega: float, L: float, M: float, c2: float = 2.0) -> float:
    """Thm 3.1 upper: c2 √d (M|ω| + L) n^{-1/d}."""
    return c2 * math.sqrt(d) * (M * abs(omega) + L) * n ** (-1.0 / d)


def disc_lower_bound(n: int, d: int, M: float, c1: Optional[float] = None) -> float:
    """Thm 3.1 lower (ω=1, v = x_1···x_d): d/(3·2^d·π^{d-2}) · n^{-2/d}·M."""
    if c1 is None:
        c1 = d / (3.0 * 2 ** d * math.pi ** (d - 2))
    return c1 * M * n ** (-2.0 / d)


def prec_upper_bound(eps: float, M, c: float = 4.0):
    """Thm 3.2: c · ε · M  (the paper's proof gives c = 4)."""
    return c * eps * M


def prec_lower_bound(eps: float, M: float) -> float:
    """Thm A.2 lower: ε M / 4."""
    return 0.25 * eps * M


def general_disc_upper_bound(n: int, d: int, L: float) -> float:
    """Thm A.1 upper: L √d n^{-1/d}."""
    return L * math.sqrt(d) * n ** (-1.0 / d)


def crossover_mesh_size(eps: float, d: int, M: float = 1.0, L: float = 1.0,
                        omega: float = 1.0) -> float:
    """Mesh size n* where the discretisation upper bound falls to the
    precision bound: below n* half precision is 'free'.  The paper quotes
    n* ~ 1e6 for d=3, fp16 (ε≈1e-4)."""
    # c2 √d (M|ω|+L) n^{-1/d} = 4 ε M   =>  n* = (c2 √d (M|ω|+L) / (4εM))^d
    c2 = 2.0
    return (c2 * math.sqrt(d) * (M * abs(omega) + L) / (4.0 * eps * M)) ** d


def estimate_lipschitz_and_bound(field: np.ndarray) -> tuple:
    """Given a sampled field on a uniform grid (any d), estimate (L, M)."""
    M = float(np.abs(field).max())
    L = 0.0
    for ax in range(field.ndim):
        diff = np.abs(np.diff(field, axis=ax)) * field.shape[ax]
        if diff.size:
            L = max(L, float(diff.max()))
    return L, M


def contract_budget(eps: float, M, stages: int = 1, f32_c: float = 32.0,
                    atol: float = 1e-5):
    """Elementwise tolerance between two evaluations of a contraction whose
    operand-magnitude contraction is ``M``: each requantising stage may
    contribute ``prec_upper_bound(eps, M)``, f32 summation order
    ``f32_c·ε_f32·M``.  The reference harness's ``assert_within_budget``
    (tests/helpers.py)."""
    return stages * prec_upper_bound(eps, M) + f32_c * F32_EPS * M + atol


def store_budget(eps: float, want, M, f32_c: float = 32.0, atol: float = 1e-5):
    """Elementwise tolerance between two evaluations that multiply the same
    operands exactly, sum in f32 in different orders (δ <= the f32 term of
    ``contract_budget(F32_EPS, M)``) and round the result once to a format
    of unit roundoff ``eps``, ``want`` being one of the stored results.
    Rounding a and b to nearest gives |r(a) - r(b)| <= δ + ε|a| + ε|b|,
    and |b| <= |want|/(1-ε), |a| <= |b| + δ: hence at most one ulp of
    ``want`` beyond the f32 order term.  A wrong result of the size of the
    output itself is outside it, where ``contract_budget(eps, M)`` is not:
    that one allows a full requantising stage of the nested sum."""
    want = want.abs() if isinstance(want, torch.Tensor) else np.abs(want)
    return (2 * eps / (1 - eps) * want
            + (1 + eps) * contract_budget(F32_EPS, M, stages=0, f32_c=f32_c, atol=atol))
