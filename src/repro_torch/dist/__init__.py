"""repro_torch.dist: the declarative distribution layer on DeviceMesh/DTensor.

Two halves, one rule table:

* :mod:`repro_torch.dist.constrain`: ambient-mesh DTensor redistribution
  taking *logical* axis names, used inside models (the identity on plain
  tensors and off-mesh).
* :mod:`repro_torch.dist.sharding`: spec derivation over parameter,
  batch and cache trees with divisibility-checked fallback chains, and
  their placement as DTensors, used by launch and serving code.

Models never name a physical mesh axis; the logical->physical mapping
lives in :mod:`repro_torch.dist.rules` and is overridable per scope.
"""
from .constrain import (  # noqa: F401
    ambient_mesh,
    constrain,
    constrain_bhsd,
    constrain_bsd,
    constrain_spatial,
    constrain_tokens,
    logical_axis_size,
    use_mesh,
)
from .rules import DEFAULT_RULES, axis_rules, current_rules  # noqa: F401
from .sharding import (  # noqa: F401
    batch_specs,
    cache_specs,
    distribute,
    dp_axes,
    fno_param_specs,
    lm_param_specs,
    pick_spec,
    replication_report,
    to_placements,
)
