"""repro_torch.tune — on-device kernel autotuner with a persistent,
oracle-validated calibration cache.

The pieces:

  space    legal tile candidates per kernel family: the port's launch
           tiles (the fused layer's batch tile, ``ls_mix``'s splits),
           legal by the port's own scratch and shared-memory estimators
  measure  median-of-k forward + backward walls with CUDA events on the
           card (the CPU times the plain versions), GB/s + roofline
           fraction at the H100's HBM rate
  oracle   the admission gate: every candidate vs its float64 oracle
           under the Thm 3.2 ``stages·4εM + c·ε_f32·M`` budget
  cache    versioned JSON keyed by (family, shape, dtype, device name,
           kernel_version); atomic writes, stale/corrupt detection,
           graceful fallback to the heuristic

``python -m repro_torch.tune {tune,validate,report}`` drives the loop;
``cache.activate(path)`` or ``$REPRO_CALIBRATION_STATE`` makes the
winners reach ``repro_torch.kernels.ops`` tile resolution everywhere.
"""
from .cache import (  # noqa: F401
    CalibrationCache,
    CalibrationError,
    activate,
    active_cache,
    backend_of,
    entry_key,
    load,
    safe_load,
    save,
)
from .space import Candidate, candidates, legal_blocks, tile_scratch_bytes  # noqa: F401

__all__ = [
    "CalibrationCache", "CalibrationError", "activate", "active_cache",
    "backend_of", "entry_key", "load", "safe_load", "save",
    "Candidate", "candidates", "legal_blocks", "tile_scratch_bytes",
]
