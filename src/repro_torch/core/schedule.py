"""Precision scheduling (paper Section 4.4, Table 1).

The paper's schedule: the first 25 % of training fully mixed (half FNO
block + AMP), the middle 50 % AMP only, the final 25 % full precision.
Early gradients are large and tolerate coarse arithmetic; late updates
are small and benefit from full precision.

A schedule is a piecewise-constant stack of rule overlays over a base
policy: each phase is either a registry rule-set name
(``"mixed_fno_fp16"``) or a raw tuple of ``(site_pattern, SiteRule)``
entries layered onto ``base``.  Phase policies carry stable, distinct
names, so a trainer can key per-phase state by them.  ``auto`` hands the
formats to the auto-precision controller instead.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from repro_torch.precision import PrecisionPolicy, get_policy
from repro_torch.precision.rules import normalize_entries

#: A phase overlay: a registry policy name, or rule entries over ``base``.
Overlay = Union[str, tuple]


@dataclasses.dataclass(frozen=True)
class PrecisionSchedule:
    """Piecewise-constant precision-rule overlays over normalised progress.

    ``phases`` is a tuple of (end_fraction, overlay), end-exclusive and
    strictly increasing, final end_fraction == 1.0.
    """

    phases: Tuple[Tuple[float, Overlay], ...]
    base: str = "full"
    #: ``"static"``: the piecewise-constant phases above; ``"auto"``: the
    #: trainer supersedes the phases with an
    #: ``repro_torch.autoprec.AutoPrecisionController`` over ``base``, so
    #: per-site formats follow runtime telemetry and the Thm 3.1/3.2 budgets.
    mode: str = "static"
    #: Auto mode only: the grid size n the Thm 3.1 budget is evaluated at
    #: (the training resolution, e.g. 128 * 128); the trainer cannot infer
    #: it from an opaque loss_fn, and the controller's fallback is a 64^d
    #: grid.
    grid_points: Optional[int] = None

    def __post_init__(self):
        if self.mode not in ("static", "auto"):
            raise ValueError(f"mode must be 'static' or 'auto', got {self.mode!r}")
        ends = [e for e, _ in self.phases]
        if sorted(ends) != ends or ends[-1] != 1.0:
            raise ValueError(f"phase ends must increase to 1.0, got {ends}")
        for _, overlay in self.phases:
            if not isinstance(overlay, str):
                normalize_entries(overlay)  # raise early on malformed entries

    def _phase_policy(self, idx: int) -> PrecisionPolicy:
        _, overlay = self.phases[idx]
        if isinstance(overlay, str):
            return get_policy(overlay)
        return get_policy(self.base).with_rules(
            *overlay, name=f"{self.base}+overlay{idx}")

    def policy_at(self, step: int, total_steps: int) -> PrecisionPolicy:
        frac = (step + 0.5) / max(total_steps, 1)
        for idx, (end, _) in enumerate(self.phases):
            if frac < end:
                return self._phase_policy(idx)
        return self._phase_policy(len(self.phases) - 1)

    def phase_boundaries(self, total_steps: int):
        """[(start_step, end_step, policy), ...] of the non-empty phases."""
        out = []
        prev = 0.0
        for idx, (end, _) in enumerate(self.phases):
            s, e = int(prev * total_steps), int(end * total_steps)
            if e > s:
                out.append((s, e, self._phase_policy(idx)))
            prev = end
        return out

    @classmethod
    def paper_default(cls, half: str = "fp16") -> "PrecisionSchedule":
        mixed = f"mixed_fno_{half}"
        amp = f"amp_{half}"
        return cls(phases=((0.25, mixed), (0.75, amp), (1.0, "full")))

    @classmethod
    def constant(cls, name: str) -> "PrecisionSchedule":
        return cls(phases=((1.0, name),))

    @classmethod
    def auto(cls, base: str = "full",
             grid_points: Optional[int] = None) -> "PrecisionSchedule":
        """Auto-precision: instead of fixed phases, the trainer measures
        per-site numerics at runtime and a controller demotes and promotes
        sites against the theory budgets.  Pass ``grid_points`` (the
        training resolution) so the Thm 3.1 budget is evaluated at the
        real grid.  ``policy_at`` outside a trainer gives the base policy."""
        return cls(phases=((1.0, base),), base=base, mode="auto", grid_points=grid_points)
