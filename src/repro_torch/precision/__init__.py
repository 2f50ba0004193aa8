"""repro_torch.precision: site-addressed mixed-precision rules.

  PrecisionPolicy / get_policy / POLICIES   named rule sets
  SitePrecision                             a resolved site
  SiteRule / FULL_PRECISION / DEFAULT_RULES rule-table entries
  precision_rules(...)                      scoped overrides
  describe / CANONICAL_SITES                a policy's site table
"""
from .rules import (  # noqa: F401
    DEFAULT_RULES,
    FULL_PRECISION,
    UNSET,
    SiteRule,
    precision_rules,
    resolve_fields,
)
from .policy import (  # noqa: F401
    AMP_BF16,
    AMP_FP16,
    CANONICAL_SITES,
    FULL,
    HALF_FNO_ONLY,
    MIXED_FNO_BF16,
    MIXED_FNO_FP16,
    POLICIES,
    SIM_FP8_E4M3,
    SIM_FP8_E5M2,
    PrecisionPolicy,
    SitePrecision,
    describe,
    get_policy,
)
