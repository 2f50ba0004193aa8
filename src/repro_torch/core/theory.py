"""Closed-form error bounds of the paper (the part the kernel tolerance
checks need)."""
from __future__ import annotations

F32_EPS = 2.0 ** -23


def prec_upper_bound(eps: float, M, c: float = 4.0):
    """Thm 3.2: c · ε · M  (the paper's proof gives c = 4)."""
    return c * eps * M


def contract_budget(eps: float, M, stages: int = 1, f32_c: float = 32.0,
                    atol: float = 1e-5):
    """Elementwise tolerance between two evaluations of a contraction whose
    operand-magnitude contraction is ``M``: each requantising stage may
    contribute ``prec_upper_bound(eps, M)``, f32 summation order
    ``f32_c·ε_f32·M``.  The reference harness's ``assert_within_budget``
    (tests/helpers.py)."""
    return stages * prec_upper_bound(eps, M) + f32_c * F32_EPS * M + atol
