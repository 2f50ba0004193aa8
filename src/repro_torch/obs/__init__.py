"""repro_torch.obs — unified tracing, metrics & numerics-event layer.

One spine for the evidence the paper's claim needs at production scale:

* :mod:`repro_torch.obs.trace` — host-side span/event tracing
  (ring-buffered, free when disabled) around the eager host calls;
* :mod:`repro_torch.obs.metrics` — the typed Counter/Gauge/Histogram registry
  every ``stats()`` surface publishes into; ``snapshot()`` is the single
  machine-readable source for engine/trainer stats;
* :mod:`repro_torch.obs.numerics` — the structured numerics-event stream
  (autoprec decisions with their budget numbers, overflow streaks,
  loss-scale moves, tile-cache outcomes, oracle rejects) interleaved
  with the performance timeline;
* :mod:`repro_torch.obs.export` — Chrome ``trace_event`` JSON (Perfetto),
  Prometheus text exposition, JSONL run logs, and the shared
  benchmark-result header — all written atomically.

``python -m repro_torch.obs`` renders a run summary table from a JSONL
log and converts it to a Chrome trace or Prometheus snapshot.

Span taxonomy (the reference's; the paged engine's ``ttft`` waits for
the paged serving slice): ``train/step``, ``train/data``,
``train/telemetry``, ``train/controller``, ``serve/tick``,
``serve/prefill``, ``serve/decode``, ``serve/operator/batch``, the
``serve/prefill_complete`` event, plus the per-request async ``request``
phase correlated by uid.  Metric names follow ``repro_<subsystem>_<name>``.
"""
from .export import (  # noqa: F401
    RESULT_SCHEMA_VERSION,
    chrome_trace,
    prometheus_text,
    read_jsonl,
    result_header,
    run_records,
    validate_chrome_trace,
    write_chrome_trace,
    write_json_atomic,
    write_jsonl,
    write_prometheus,
    write_result,
    write_text_atomic,
)
from .metrics import (  # noqa: F401
    DEFAULT_EDGES_MS,
    MAX_LABEL_SETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    metric_names,
    registry,
)
from .numerics import (  # noqa: F401
    KINDS,
    autoprec_decision,
    loss_scale_event,
    numerics_event,
    oracle_reject,
    tile_cache_event,
)
from .trace import (  # noqa: F401
    begin,
    clear,
    disable,
    dropped,
    enable,
    end,
    event,
    is_enabled,
    snapshot,
    span,
)
