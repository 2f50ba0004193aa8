"""Numeric-format primitives: the grids the precision rules quantise onto.

* ``FORMAT_EPS`` / ``FORMAT_MAX`` / ``FORMAT_TINY``: relative spacing,
  largest finite magnitude and smallest normal magnitude per format.
* ``simulate_fp8``: clip to an fp8 format's range, then round the
  mantissa (Appendix B.11).
* ``quantize_complex``: round-trip complex64 through split-real half
  storage, the representation error Theorem 3.2 bounds.
* ``PrecisionSystem`` / ``precision_system_for``: the paper's (a0, ε, T)
  system (Definition 3.1) and the one that approximates a named format.
"""
from __future__ import annotations

import dataclasses
import math

import torch

FORMAT_EPS = {
    "float64": 2.0 ** -52,
    "float32": 2.0 ** -23,
    "bfloat16": 2.0 ** -8,
    "float16": 2.0 ** -11,
    "fp8_e4m3": 2.0 ** -3,
    "fp8_e5m2": 2.0 ** -2,
}

FORMAT_MAX = {
    "float32": 3.4028235e38,
    "bfloat16": 3.3895314e38,
    "float16": 65504.0,
    "fp8_e4m3": 448.0,
    "fp8_e5m2": 57344.0,
}

FORMAT_TINY = {
    "float64": 2.2250738585072014e-308,
    "float32": 1.1754944e-38,
    "bfloat16": 1.1754944e-38,
    "float16": 6.103515625e-05,
    "fp8_e4m3": 2.0 ** -6,
    "fp8_e5m2": 2.0 ** -14,
}

_MANT_BITS = {"fp8_e4m3": 3, "fp8_e5m2": 2}


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the key of the FORMAT tables."""
    return str(dtype).removeprefix("torch.")


def simulate_fp8(x: torch.Tensor, fmt: str = "fp8_e5m2") -> torch.Tensor:
    """Simulated fp8: clip to the format's range, round the mantissa
    (Appendix B.11)."""
    clipped = torch.clamp(x, -FORMAT_MAX[fmt], FORMAT_MAX[fmt])
    return _round_mantissa(clipped, fmt)


def _round_mantissa(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """Round the ``frexp`` mantissa to the format's bits, with no exponent
    floor: the result keeps f32's exponent range, unlike a cast to
    ``torch.float8_*``, whose subnormals round small values differently.
    f32 subnormal inputs flush to signed zero, as the reference's
    ``frexp``/``ldexp`` do under XLA."""
    scale = float(1 << (_MANT_BITS[fmt] + 1))
    x = x.to(torch.float32)
    m, e = torch.frexp(x)
    y = torch.ldexp(torch.round(m * scale) / scale, e)
    return torch.where(x.abs() < FORMAT_TINY["float32"], x * 0.0, y)


def quantize_complex(c: torch.Tensor, dtype) -> torch.Tensor:
    """Round-trip a complex64 tensor through half-precision split-real
    storage: the representation error bounded by Theorem 3.2."""
    if dtype in (torch.float32, None):
        return c
    return torch.complex(c.real.to(dtype).float(), c.imag.to(dtype).float())


@dataclasses.dataclass(frozen=True)
class PrecisionSystem:
    """The paper's ``(a0, eps, T)``-precision system.

    ``S = {0} ∪ {±a0 (1+eps)^i : 0 <= i <= T}`` with ``q(x) = argmin_{y∈S}|x-y|``.
    """

    a0: float
    eps: float
    T: int

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """Round ``x`` to the nearest representable value, in ``x``'s dtype."""
        sign = torch.sign(x)
        mag = torch.abs(x)
        # index of the geometric grid point: i = round(log(mag/a0) / log(1+eps))
        # the constants at x's dtype, as JAX's weak types round them
        eps = torch.tensor(self.eps, dtype=x.dtype)
        log_ratio = torch.log(torch.clamp(mag, min=1e-300) / self.a0)
        i = torch.clamp(torch.round(log_ratio / torch.log1p(eps)), 0, self.T)
        q = self.a0 * torch.pow(1.0 + eps, i)
        # values below a0/2 snap to 0 (underflow)
        q = torch.where(mag < self.a0 / 2, torch.zeros_like(q), q)
        return sign * q


def precision_system_for(fmt: str) -> PrecisionSystem:
    """Build an (a0, eps, T)-system approximating a named float format."""
    eps = FORMAT_EPS[fmt]
    vmax = FORMAT_MAX.get(fmt, 3.4e38)
    a0 = FORMAT_TINY.get(fmt, 1e-30)  # smallest normal
    T = int(math.log(vmax / a0) / math.log1p(eps))
    return PrecisionSystem(a0=a0, eps=eps, T=T)
