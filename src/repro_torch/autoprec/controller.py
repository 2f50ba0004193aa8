"""Bound-guided adaptive precision control (the decision half of autoprec).

Turns runtime telemetry (:mod:`repro_torch.autoprec.telemetry`) into
precision-rule overlays over a base policy.  It demotes a site group
below f32 only while

1. **theory budget**: the Thm 3.2 worst case for the candidate format,
   ``4 ε``, stays within ``target_fraction`` of the Thm 3.1
   discretisation bound at the current grid (both relative, on the
   unit-normalised field: the data pipeline whitens to O(1) and the tanh
   stabiliser enforces ``M <= 1``, so amax feeds the range checks while
   the ε-versus-n trade is resolution-driven: finer grids earn tighter
   formats);
2. **dynamic range**: the observed (decayed-peak) amax times
   ``range_margin`` fits the format's largest finite value, and the
   exponent histogram puts at most ``underflow_limit`` of the non-zero
   mass below its smallest normal;
3. **hysteresis**: the group has been overflow-clean for
   ``demote_patience`` consecutive updates and is not inside the
   ``cooldown`` after a change.

``promote_streak`` consecutive dirty windows promote the group straight
back to f32 and start a cooldown.  Decisions are grouped per spectral
pipeline (``fno/layer2/spectral`` covers its ``fft_in``, ``contract`` and
``fft_out`` taps) and emitted as ordinary rule entries, so the trainer
and the operator engine pick them up through ``policy.at(site)``.  A
format that needs loss scaling (the fp16 family) switches the
``train/loss_scale`` site on in the same overlay.

Each decision and each overflow streak goes to the numerics-event stream
(``repro_torch.obs.autoprec_decision`` and ``numerics_event``) with the
budget numbers that justified it, as in the reference; no decision
depends on them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core import theory
from repro_torch.core.precision import FORMAT_EPS, FORMAT_MAX, FORMAT_TINY
from repro_torch.obs import autoprec_decision, numerics_event
from repro_torch.precision import FULL_PRECISION, PrecisionPolicy, SiteRule, get_policy
from repro_torch.precision.rules import site_matches

from .telemetry import SiteWindow

#: Formats that need dynamic loss scaling in training.
_NEEDS_LOSS_SCALING = ("float16", "fp8_e4m3", "fp8_e5m2")


def group_of(site: str) -> str:
    """Collapse a tap site onto its control group: the three spectral
    stages of one layer decide together (``fno/layer2/spectral/fft_in`` ->
    ``fno/layer2/spectral``); other sites stand alone."""
    head, sep, _ = site.rpartition("/spectral/")
    return head + "/spectral" if sep else site


@dataclasses.dataclass
class ControllerConfig:
    """Knobs of the adaptive controller (see the module docstring)."""

    target_fraction: float = 0.5     # precision budget as a fraction of
                                     # the Thm 3.1 discretisation bound
    grid_points: Optional[int] = None  # n, points of the physical grid;
                                       # engines pass it per window
    spatial_dim: int = 2             # d in the Thm 3.1 rate n^{-1/d}
    omega: float = 1.0               # characteristic frequency |ω|
    rel_lipschitz: float = 1.0       # L/M of the unit-normalised field
    range_margin: float = 4.0        # amax headroom a format must cover
    underflow_limit: float = 0.01    # max fraction below smallest normal
    demote_patience: int = 2         # clean updates before a demotion
    promote_streak: int = 2          # dirty updates before a promotion
    cooldown: int = 3                # updates after any change in which
                                     # no demotion may happen
    amax_decay: float = 0.9          # decayed-peak amax tracking
    interval: int = 10               # trainer steps between updates
    #: Candidate formats, cheapest first; f32 is the implicit fallback.
    formats: Tuple[str, ...] = ("fp8_e4m3", "fp8_e5m2", "bfloat16", "float16")
    #: The control groups the controller may touch.
    control: Tuple[str, ...] = ("*/spectral",)


@dataclasses.dataclass
class SiteState:
    """Per-group hysteresis state."""

    fmt: str = "float32"
    amax: float = 0.0            # decayed peak
    clean: int = 0               # consecutive overflow-free updates
    overflow_streak: int = 0     # consecutive dirty updates
    cooldown: int = 0
    eps_budget: float = 0.0      # last ε ceiling (for reports)


def _rules_for(pattern: str, fmt: str) -> Tuple[Tuple[str, SiteRule], ...]:
    """The rule entries that realise one format decision for a group."""
    if fmt == "float32":
        return ((pattern, FULL_PRECISION),)
    if fmt in ("bfloat16", "float16"):
        dt = torch.bfloat16 if fmt == "bfloat16" else torch.float16
        return ((pattern, SiteRule(compute=dt, quantize="half", stabilize="tanh")),)
    # simulated fp8: split-real fp16 storage rounded onto the fp8 grid
    return ((pattern, SiteRule(compute=torch.float16, quantize=fmt, stabilize="tanh")),)


class AutoPrecisionController:
    """Telemetry in, precision-rule overlays out.

    ``update(window)`` consumes a telemetry window (site ->
    :class:`~repro_torch.autoprec.telemetry.SiteWindow`) and returns True
    when the overlay changed.  ``policy()`` is the base policy with the
    current overlay on top, named ``<base>+auto<version>``.
    """

    def __init__(self, base: Union[str, PrecisionPolicy] = "full",
                 config: Optional[ControllerConfig] = None, **overrides):
        self.base = get_policy(base) if isinstance(base, str) else base
        if config is None:
            config = ControllerConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.sites: Dict[str, SiteState] = {}
        self.version = 0
        self.updates = 0
        self.last_change_update = -1
        self.last_change_step: Optional[int] = None
        self._policy_cache: Optional[PrecisionPolicy] = None

    # -- bound-guided format choice -------------------------------------------
    def eps_budget(self, grid_points: Optional[int] = None) -> float:
        """The ε ceiling: ``target_fraction`` of the relative Thm 3.1
        discretisation bound, over Thm 3.2's constant 4 (M = 1,
        L = rel_lipschitz)."""
        cfg = self.config
        n = grid_points or cfg.grid_points or 64 ** cfg.spatial_dim
        disc = theory.disc_upper_bound(n, cfg.spatial_dim, cfg.omega, L=cfg.rel_lipschitz,
                                       M=1.0)
        return cfg.target_fraction * disc / 4.0

    def _format_ok(self, fmt: str, state: SiteState, window: SiteWindow,
                   budget: float) -> bool:
        if FORMAT_EPS[fmt] > budget:
            return False
        if state.amax * self.config.range_margin > FORMAT_MAX[fmt]:
            return False
        if window.fraction_below(FORMAT_TINY[fmt]) > self.config.underflow_limit:
            return False
        return True

    def _choose(self, state: SiteState, window: SiteWindow, budget: float) -> str:
        for fmt in self.config.formats:
            if self._format_ok(fmt, state, window, budget):
                return fmt
        return "float32"

    # -- the update loop -------------------------------------------------------
    def _controlled(self, group: str) -> bool:
        return any(site_matches(p, group) for p in self.config.control)

    def update(self, window: Dict[str, SiteWindow], grid_points: Optional[int] = None,
               step: Optional[int] = None) -> bool:
        """Consume one telemetry window; True when the overlay changed."""
        self.updates += 1
        groups: Dict[str, SiteWindow] = {}
        for site, w in window.items():
            g = group_of(site)
            if not self._controlled(g):
                continue
            if g in groups:
                groups[g].merge(w)
            else:
                groups[g] = dataclasses.replace(w, hist=w.hist.copy())

        budget = self.eps_budget(grid_points)
        changed = False
        for g, w in sorted(groups.items()):
            st = self.sites.setdefault(g, SiteState())
            st.eps_budget = budget
            st.amax = max(w.amax, self.config.amax_decay * st.amax)
            if st.cooldown > 0:
                st.cooldown -= 1
            if w.overflow > 0:
                st.overflow_streak += 1
                st.clean = 0
                numerics_event("overflow_streak", site=g, streak=st.overflow_streak,
                               amax=st.amax, **({} if step is None else {"step": step}))
                if st.overflow_streak >= self.config.promote_streak and st.fmt != "float32":
                    old = st.fmt
                    st.fmt = "float32"
                    st.cooldown = self.config.cooldown
                    st.overflow_streak = 0
                    changed = True
                    autoprec_decision(g, old, "float32", eps_budget=budget, amax=st.amax,
                                      step=step)
                continue
            st.overflow_streak = 0
            st.clean += 1
            if st.clean < self.config.demote_patience or st.cooldown > 0:
                continue
            best = self._choose(st, w, budget)
            if best != st.fmt:
                old = st.fmt
                st.fmt = best
                st.cooldown = self.config.cooldown
                changed = True
                autoprec_decision(g, old, best, eps_budget=budget, amax=st.amax,
                                  fmt_eps=FORMAT_EPS.get(best), step=step)
        if changed:
            self.version += 1
            self.last_change_update = self.updates
            self.last_change_step = step
            self._policy_cache = None
        return changed

    # -- outputs ---------------------------------------------------------------
    def overlay(self) -> Tuple[Tuple[str, SiteRule], ...]:
        """The current decisions as rule entries (highest priority when
        stacked onto the base policy)."""
        entries = []
        needs_scaling = False
        for g in sorted(self.sites):
            st = self.sites[g]
            entries.extend(_rules_for(f"{g}/*", st.fmt))
            needs_scaling |= st.fmt in _NEEDS_LOSS_SCALING
        if needs_scaling:
            entries.append(("train/loss_scale", SiteRule(loss_scaling=True)))
        return tuple(entries)

    def policy(self) -> PrecisionPolicy:
        if self._policy_cache is None:
            self._policy_cache = self.base.with_rules(
                *self.overlay(), name=f"{self.base.name}+auto{self.version}")
        return self._policy_cache

    def describe(self) -> dict:
        """JSON-friendly decision report (engine stats, reports)."""
        return {
            "base": self.base.name,
            "version": self.version,
            "updates": self.updates,
            "last_change_update": self.last_change_update,
            "last_change_step": self.last_change_step,
            "sites": {
                g: {
                    "fmt": st.fmt,
                    "amax": st.amax,
                    "eps_budget": st.eps_budget,
                    "clean": st.clean,
                    "cooldown": st.cooldown,
                }
                for g, st in sorted(self.sites.items())
            },
        }
