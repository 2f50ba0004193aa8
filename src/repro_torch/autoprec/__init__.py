"""repro_torch.autoprec: runtime numerics telemetry and bound-guided
adaptive precision.

Where the rule tables say *which format runs where*, autoprec **measures**
what flows through each spectral site at runtime (amax, exponent
histograms, overflow / underflow counts, measured quantisation error) and
**decides** which sites may run below f32: it demotes a group only while
the observed range and the Thm 3.1/3.2 budgets leave room, and promotes it
back on overflow streaks.

Public API:
  tap / TraceCollector / collecting             scoped site taps
  SiteStats / SiteWindow / TelemetryAggregator  device stats, host windows
  telemetry_active / merge_stacked / fmt_of     integration helpers
  AutoPrecisionController / ControllerConfig    telemetry -> rule overlays
  certify (submodule)                           empirical bound certification
"""
from .telemetry import (  # noqa: F401
    SiteStats,
    SiteWindow,
    TelemetryAggregator,
    TraceCollector,
    collecting,
    fmt_of,
    merge_stacked,
    tap,
    telemetry_active,
)
from .controller import (  # noqa: F401
    AutoPrecisionController,
    ControllerConfig,
    group_of,
)
