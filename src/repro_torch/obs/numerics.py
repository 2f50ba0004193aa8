"""Structured numerics-event stream: precision causality on the same
timeline as performance.

The paper's claim is a *joint* statement — precision error stays inside
the Thm 3.1/3.2 budget **while** memory and throughput improve — so the
events that justify a precision decision must interleave with the spans
that measure its cost.  ``numerics_event`` is the one funnel: every
emission bumps ``repro_numerics_events_total{kind=...}`` in the metrics
registry (always on, cheap) and, when tracing is enabled, records an
instant event in the trace ring under the ``numerics`` category so the
Chrome export shows it on the run timeline.

Event kinds (the stable vocabulary; attrs carry the numbers that
justified the decision):

  ``autoprec_demote``    controller demoted a site group — attrs carry
                         the ε budget, the decayed-peak amax, and the
                         candidate format's ε (Thm 3.2 vs Thm 3.1);
  ``autoprec_promote``   overflow streak promoted a group back to fp32;
  ``overflow_streak``    a telemetry window saw overflows at a group;
  ``loss_scale_halved``  non-finite grads halved the dynamic loss scale;
  ``loss_scale_grown``   the growth interval raised it back;
  ``tile_cache_hit`` / ``tile_cache_miss`` / ``tile_cache_stale``
                         calibration-cache lookup outcomes at kernel
                         tile resolution (every call of a tuned wrapper:
                         the port compiles nothing);
  ``oracle_reject``      a tuned tile candidate failed the einsum
                         oracle's Thm 3.2 gate;
  ``nonfinite_logits``   ``LMEngine`` (``telemetry=True``) observed
                         non-finite logits in a tick's rows.
"""
from __future__ import annotations

from typing import Optional

from . import trace
from .metrics import registry

KINDS = (
    "autoprec_demote",
    "autoprec_promote",
    "overflow_streak",
    "loss_scale_halved",
    "loss_scale_grown",
    "tile_cache_hit",
    "tile_cache_miss",
    "tile_cache_stale",
    "oracle_reject",
    "nonfinite_logits",
)

EVENT_CATEGORY = "numerics"


def numerics_event(kind: str, site: Optional[str] = None, **attrs) -> None:
    """Record one numerics event: counter always, trace event when the
    ring is enabled.  ``site`` is the precision-site / control-group
    address the event attributes to (same address space as the rule
    tables)."""
    if kind not in KINDS:
        raise ValueError(f"unknown numerics event kind {kind!r}; "
                         f"known: {KINDS}")
    registry().counter("repro_numerics_events_total", kind=kind).inc()
    if trace.is_enabled():
        if site is not None:
            attrs["site"] = site
        trace.event(f"numerics/{kind}", category=EVENT_CATEGORY, **attrs)


# -- wiring helpers (keep call sites one-liners) ----------------------------


def autoprec_decision(group: str, old_fmt: str, new_fmt: str, *,
                      eps_budget: float, amax: float,
                      fmt_eps: Optional[float] = None,
                      step: Optional[int] = None) -> None:
    """A controller format change with the budget numbers that justified
    it — the record the acceptance criterion wants visible in Perfetto."""
    kind = ("autoprec_promote" if new_fmt == "float32"
            else "autoprec_demote")
    numerics_event(kind, site=group, from_fmt=old_fmt, to_fmt=new_fmt,
                   eps_budget=eps_budget, amax=amax,
                   **({} if fmt_eps is None else {"fmt_eps": fmt_eps}),
                   **({} if step is None else {"step": step}))


def loss_scale_event(kind: str, scale: float,
                     step: Optional[int] = None) -> None:
    numerics_event(kind, scale=scale,
                   **({} if step is None else {"step": step}))


def tile_cache_event(outcome: str, family: str, key: str) -> None:
    numerics_event(f"tile_cache_{outcome}", family=family, key=key)


def oracle_reject(key: str, *, max_err: float, budget_min: float,
                  worst_excess: float) -> None:
    numerics_event("oracle_reject", key=key, max_err=max_err,
                   budget_min=budget_min, worst_excess=worst_excess)
