"""repro_torch.analyze — static numerics & precision linter of the port.

Four passes, the reference's (``repro.analyze``), over what the port
runs and what it declares:

  dataflow  the dtype flow of model forwards and Trainer steps per
            registry policy, recorded as they run (the ATen ops PyTorch
            dispatches and the kernels the port launches): half
            accumulation, fp16 overflow reachability, round-trip casts,
            fp32 residues on demoted sites;
  sites     AST scan of site literals + rule-table cross-checks
            (orphans, dead patterns, shadowed entries);
  kernels   the launch plans of the spectral kernels (batch tiles,
            splits, shared memory, L2 scratch) and calibration states;
  obs       AST scan for hand-rolled counters in instrumented subtrees
            that never reference repro_torch.obs.

``python -m repro_torch.analyze`` runs everything, writes
``build/analyze.json`` and exits nonzero on unsuppressed error-severity
findings; ``allowlist.toml`` beside this file holds the reviewed
allowlist.
"""
from .findings import (  # noqa: F401
    ERROR,
    WARNING,
    Finding,
    Suppression,
    dedupe,
    load_suppressions,
    partition,
    summarize,
)
from .dataflow import (  # noqa: F401
    analyze_records,
    dtype_trace,
    model_findings,
    project,
    recording,
    trace_findings,
    trainer_findings,
)
from .sites import (  # noqa: F401
    rule_table_findings,
    shadowed_entries,
    site_universe,
    sites_pass,
)
from .kernels import calibration_pass, kernels_pass, record_launches  # noqa: F401
from .obscov import obs_coverage_pass  # noqa: F401
