"""Site-pattern precision rule table: the one place where *precision
sites* map onto numeric formats.

Models never pick a dtype; they name a *site*, a slash-separated address
such as ``"fno/layer2/spectral/contract"`` or ``"serve/operator"``, and a
rule table maps site patterns onto :class:`SiteRule` entries (compute
dtype, accumulation dtype, stabiliser, boundary quantisation, loss
scaling).  A policy is a named overlay of rules over the shared
:data:`DEFAULT_RULES` table, and :func:`precision_rules` pushes scoped,
thread-local overrides on top.

Resolution is field-wise, first-match-wins: for each field of
``SiteRule`` the first entry (scoped overrides, then the policy's rules,
then ``DEFAULT_RULES``) whose pattern matches the site and whose field is
not :data:`UNSET` supplies the value.  Patterns use fnmatch semantics, so
``"*/spectral/contract"`` matches any model's contraction site and
``"fno/layer3/*"`` addresses one FNO layer.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import threading
from contextlib import contextmanager
from typing import Any, Iterator, Sequence, Tuple

import torch


class _Unset:
    """Sentinel distinguishing "rule does not speak to this field" from an
    explicit ``None`` (which means "full precision" / "off")."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "UNSET"


UNSET = _Unset()

#: SiteRule fields, in resolution order.
RULE_FIELDS = ("compute", "accum", "stabilize", "quantize", "loss_scaling")


@dataclasses.dataclass(frozen=True)
class SiteRule:
    """One rule-table entry.  Every field defaults to :data:`UNSET` so an
    overlay can override one aspect of a site without clobbering the rest.

    Fields (set explicitly to ``None`` to force full precision / off):

      compute:      storage/compute dtype at the site; ``None`` => f32
                    real / complex64 spectral (full precision).
      accum:        contraction accumulation dtype (f32).
      stabilize:    pre-FFT stabiliser name ('tanh' | 'hard_clip' |
                    'sigma_clip' | 'fixed_scale' | None).
      quantize:     boundary quantisation grid: ``None`` (off), ``"half"``
                    (split-real storage at ``compute``), or a simulated
                    fp8 format name ('fp8_e4m3' | 'fp8_e5m2').
      loss_scaling: whether training under this rule set needs dynamic
                    loss scaling (fp16 family yes, bf16 no).
    """

    compute: Any = UNSET
    accum: Any = UNSET
    stabilize: Any = UNSET
    quantize: Any = UNSET
    loss_scaling: Any = UNSET


Entry = Tuple[str, SiteRule]

#: Rule forcing a site back to full precision.
FULL_PRECISION = SiteRule(compute=None, stabilize=None, quantize=None)

#: The shared base table.  Master weights and reduction-sensitive ops stay
#: f32, every contraction accumulates in f32, loss scaling is off unless a
#: rule set turns it on.
DEFAULT_RULES: Tuple[Entry, ...] = (
    ("params", SiteRule(compute=torch.float32)),
    ("*/router", SiteRule(compute=torch.float32)),
    ("*/proj_out", SiteRule(compute=torch.float32)),
    ("serve/sampler", SiteRule(compute=torch.float32)),
    ("serve/operator", SiteRule(compute=torch.float32)),
    ("train/loss_scale", SiteRule(loss_scaling=False)),
    (
        "*",
        SiteRule(
            compute=None,
            accum=torch.float32,
            stabilize=None,
            quantize=None,
            loss_scaling=False,
        ),
    ),
)


def site_matches(pattern: str, site: str) -> bool:
    """fnmatch-style pattern match (``*`` crosses ``/`` boundaries)."""
    return pattern == site or fnmatch.fnmatchcase(site, pattern)


def normalize_entries(entries: Sequence) -> Tuple[Entry, ...]:
    """Accept (pattern, SiteRule) or (pattern, dict) pairs."""
    out = []
    for e in entries:
        try:
            pattern, r = e
        except (TypeError, ValueError):
            raise TypeError(
                f"rule entry must be a (pattern, SiteRule) pair, got {e!r}"
            ) from None
        if isinstance(r, dict):
            r = SiteRule(**r)
        if not isinstance(r, SiteRule):
            raise TypeError(f"rule for {pattern!r} must be a SiteRule, got {type(r)}")
        out.append((str(pattern), r))
    return tuple(out)


_local = threading.local()


def current_overrides() -> Tuple[Entry, ...]:
    """The active scoped-override entries (innermost scope first)."""
    return getattr(_local, "overrides", ())


@contextmanager
def precision_rules(*entries) -> Iterator[None]:
    """Scope-local precision overrides, taking precedence over the active
    policy's own rules for the dynamic scope of the ``with`` block:

    >>> with precision_rules(("fno/layer3/*", FULL_PRECISION)):
    ...     y = fno_apply(model, x, cfg, get_policy("mixed_fno_bf16"))

    PyTorch runs eagerly, so the rules apply to every call made inside the
    scope.
    """
    norm = normalize_entries(entries)
    prev = current_overrides()
    _local.overrides = norm + prev
    try:
        yield
    finally:
        _local.overrides = prev


def resolve_fields(site: str, rules: Tuple[Entry, ...]) -> dict:
    """Field-wise first-match resolution of ``site`` through the scoped
    overrides, then ``rules`` (a policy's overlay), then DEFAULT_RULES.
    Returns a dict with every field of :class:`SiteRule` filled in."""
    fields = {f: UNSET for f in RULE_FIELDS}
    missing = len(RULE_FIELDS)
    for pattern, rule in current_overrides() + tuple(rules) + DEFAULT_RULES:
        if not site_matches(pattern, site):
            continue
        for f in RULE_FIELDS:
            if fields[f] is UNSET:
                v = getattr(rule, f)
                if v is not UNSET:
                    fields[f] = v
                    missing -= 1
        if not missing:
            break
    # the catch-all in DEFAULT_RULES guarantees completion; guard against
    # a caller stripping it
    for f, default in (
        ("compute", None),
        ("accum", torch.float32),
        ("stabilize", None),
        ("quantize", None),
        ("loss_scaling", False),
    ):
        if fields[f] is UNSET:
            fields[f] = default
    return fields
