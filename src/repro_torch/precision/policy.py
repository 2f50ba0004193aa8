"""Rules-based precision policies and resolved per-site precision.

A :class:`PrecisionPolicy` is a named rule set over the shared site table
(:mod:`repro_torch.precision.rules`); ``policy.at(site)`` resolves one
site to a :class:`SitePrecision` carrying the ``stabilize`` and
``quantize`` helpers of the spectral pipeline and the dtype views the
contraction needs (``spectral_dtype`` / ``spectral_is_half``).

Canonical sites of the serving path:

  ``fno/dense``, ``fno/layer<i>/dense``   real-valued AMP set (lift, skips,
                                          projections)
  ``fno/layer<i>/spectral/fft_in``        stabilise + boundary-quantise
  ``fno/layer<i>/spectral/contract``      spectral contraction storage/accum
  ``fno/layer<i>/spectral/fft_out``       iFFT output storage
  ``fno/proj_out``                        output head (f32)
  ``serve/operator``                      operator-inference transport dtype
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.precision import dtype_name

from .rules import Entry, SiteRule, normalize_entries, resolve_fields
from .scope import site_scope


@dataclasses.dataclass(frozen=True)
class SitePrecision:
    """The fully resolved precision of one site."""

    site: str = dataclasses.field(compare=False)
    compute: Optional[Any] = None
    accum: Any = torch.float32
    stabilizer: Optional[str] = None
    quantize_fmt: Optional[str] = None
    loss_scaling: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.compute if self.compute is not None else torch.float32

    @property
    def spectral_dtype(self) -> Optional[torch.dtype]:
        """Split-real storage dtype for spectral data; None => complex64."""
        return self.compute if self.quantize_fmt is not None else None

    @property
    def spectral_is_half(self) -> bool:
        return self.quantize_fmt is not None

    def stabilize(self, x: torch.Tensor) -> torch.Tensor:
        """Apply the site's pre-FFT stabiliser.  Only active when the site
        quantises: the stabiliser exists to keep the half forward
        transform finite."""
        if self.quantize_fmt is None or not self.stabilizer:
            return x
        from repro_torch.core.stabilizer import get_stabilizer

        with site_scope(self.site):
            return get_stabilizer(self.stabilizer)(x)

    def quantize(self, c: torch.Tensor) -> torch.Tensor:
        """Round a complex tensor onto this site's storage grid: the half
        round trip (Thm 3.2's representation error) or the simulated fp8
        grid (Appendix B.11).  Identity when the site is full precision.

        Feeds the autoprec tap either way (a no-op without a collector):
        the values before quantisation carry the site's range, also while
        the site runs at f32, which is what the controller needs to decide
        a demotion; the values after it give the measured Thm 3.2 error."""
        from repro_torch.autoprec.telemetry import fmt_of, tap

        if self.quantize_fmt is None:
            tap(self.site, c, fmt=fmt_of(self))
            return c
        from repro_torch.core.precision import quantize_complex, simulate_fp8

        with site_scope(self.site):
            if self.quantize_fmt == "half":
                q = quantize_complex(c, self.compute)
            else:
                q = torch.complex(simulate_fp8(c.real, self.quantize_fmt),
                                  simulate_fp8(c.imag, self.quantize_fmt))
        tap(self.site, c, fmt=fmt_of(self), quantized=q)
        return q

    def contract(self, expr: str, *operands, objective: str = "memory", cache=None):
        """Memory-greedy contraction at this site's storage and
        accumulation dtypes (:func:`repro_torch.core.contraction.contract`).
        Taps the activation operand against the site's storage format."""
        from repro_torch.autoprec.telemetry import fmt_of, tap
        from repro_torch.core.contraction import contract

        if operands:
            tap(self.site, operands[0], fmt=fmt_of(self))
        with site_scope(self.site):
            return contract(expr, *operands, policy=self, objective=objective, cache=cache)


def resolve_site(site: str, rules: Tuple[Entry, ...]) -> SitePrecision:
    f = resolve_fields(site, rules)
    return SitePrecision(
        site=site,
        compute=f["compute"],
        accum=f["accum"],
        stabilizer=f["stabilize"],
        quantize_fmt=f["quantize"],
        loss_scaling=bool(f["loss_scaling"]),
    )


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """A named overlay of site rules over the shared DEFAULT_RULES table."""

    name: str
    rules: Tuple[Entry, ...] = ()

    def at(self, site: str) -> SitePrecision:
        return resolve_site(site, self.rules)

    def with_rules(self, *entries, name: Optional[str] = None) -> "PrecisionPolicy":
        """A new policy with ``entries`` layered on top (highest priority)."""
        return PrecisionPolicy(
            name=name or self.name, rules=normalize_entries(entries) + self.rules)


# ---------------------------------------------------------------------------
# Registry: the paper's settings as rule sets over the shared table
# ---------------------------------------------------------------------------


def _amp_rules(half) -> Tuple[Entry, ...]:
    return (
        ("*/dense", SiteRule(compute=half)),
        ("serve/kv_cache", SiteRule(compute=half)),
        ("serve/paged/kv_blocks", SiteRule(compute=half)),
    )


def _spectral_rules(half, quantize: str = "half") -> Tuple[Entry, ...]:
    return (("*/spectral/*", SiteRule(compute=half, quantize=quantize, stabilize="tanh")),)


_SCALE = (("train/loss_scale", SiteRule(loss_scaling=True)),)

FULL = PrecisionPolicy(name="full")
AMP_FP16 = PrecisionPolicy(name="amp_fp16", rules=_amp_rules(torch.float16) + _SCALE)
AMP_BF16 = PrecisionPolicy(name="amp_bf16", rules=_amp_rules(torch.bfloat16))
MIXED_FNO_FP16 = PrecisionPolicy(
    name="mixed_fno_fp16",
    rules=_spectral_rules(torch.float16) + _amp_rules(torch.float16) + _SCALE,
)
MIXED_FNO_BF16 = PrecisionPolicy(
    name="mixed_fno_bf16",
    rules=_spectral_rules(torch.bfloat16) + _amp_rules(torch.bfloat16),
)
# FNO block half, rest full: the "Half-Prec FNO only" bar in Fig. 3.
HALF_FNO_ONLY = PrecisionPolicy(
    name="half_fno_only", rules=_spectral_rules(torch.float16) + _SCALE
)
# Simulated fp8 spectral pipelines (Appendix B.11): split-real fp16
# storage whose values are rounded onto the fp8 grid at the FFT boundary.
SIM_FP8_E4M3 = PrecisionPolicy(
    name="sim_fp8_e4m3",
    rules=_spectral_rules(torch.float16, quantize="fp8_e4m3") + _SCALE,
)
SIM_FP8_E5M2 = PrecisionPolicy(
    name="sim_fp8_e5m2",
    rules=_spectral_rules(torch.float16, quantize="fp8_e5m2") + _SCALE,
)

POLICIES = {
    p.name: p
    for p in [
        FULL,
        AMP_FP16,
        AMP_BF16,
        MIXED_FNO_FP16,
        MIXED_FNO_BF16,
        HALF_FNO_ONLY,
        SIM_FP8_E4M3,
        SIM_FP8_E5M2,
    ]
}


def get_policy(name: str) -> PrecisionPolicy:
    try:
        return POLICIES[name]
    except KeyError:
        raise KeyError(
            f"unknown precision policy {name!r}; have {sorted(POLICIES)}"
        ) from None


#: Sites worth surfacing in reports.
CANONICAL_SITES = (
    "params",
    "model/dense",
    "model/spectral/fft_in",
    "model/spectral/contract",
    "model/spectral/fft_out",
    "model/proj_out",
    "lm/router",
    "serve/kv_cache",
    "serve/paged/kv_blocks",
    "serve/paged/pool",
    "serve/sampler",
    "serve/operator",
    "train/loss_scale",
)


def describe(policy: PrecisionPolicy) -> dict:
    """A JSON-friendly site table of ``policy``: which canonical site runs
    at which formats (dtype names as ``"bfloat16"``, ``"float32"``)."""
    out = {}
    for site in CANONICAL_SITES:
        s = policy.at(site)
        out[site] = {
            "compute": None if s.compute is None else dtype_name(s.compute),
            "accum": dtype_name(s.accum),
            "stabilize": s.stabilizer,
            "quantize": s.quantize_fmt,
            "loss_scaling": s.loss_scaling,
        }
    return out
