"""Typed metrics registry: Counter / Gauge / Histogram with a bounded
label space and one ``snapshot()`` that is the export source for every
engine/trainer ``stats()`` surface.

Naming convention (enforced): ``repro_<subsystem>_<name>`` — lowercase,
``[a-z0-9_]``.  Labels are explicit keyword pairs at instrument lookup
(``counter("repro_kernels_calls_total", family="dense")``); the registry
caps distinct label sets per metric name (``MAX_LABEL_SETS``) so a bug
can never grow unbounded cardinality, which is the classic way a metrics
layer takes a service down.

Histograms use *fixed* bucket edges declared at creation — snapshots are
therefore constant-shape, and the Prometheus exposition
(:mod:`repro_torch.obs.export`) can emit cumulative ``_bucket{le=...}`` series
without remembering state.

Two bridges tie the existing accounting surfaces in:

* ``publish(prefix, mapping)`` flattens a nested ``stats()`` dict into
  gauges ``repro_<prefix>_<path>`` (numbers only; strings/None are
  skipped).  ``EngineBase.stats()`` and the Trainer publish through it,
  so the registry snapshot is the single machine-readable source while
  the dict return stays for callers and tests.
* ``register_external(name, snapshot_fn, reset_fn)`` adopts counters
  that live elsewhere (``repro_torch.kernels.ops.tile_resolution_stats``): they show
  up under ``snapshot()["external"]`` and ``reset()`` resets them too —
  the stats-counter-hygiene contract bench scripts rely on between
  warmup and measurement legs.
"""
from __future__ import annotations

import re
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^repro(_[a-z0-9]+)+$")

#: distinct label sets allowed per metric name before lookups raise
MAX_LABEL_SETS = 64

#: default histogram bucket edges (ms-scale latencies)
DEFAULT_EDGES_MS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                    500.0, 1000.0, 2000.0, 5000.0)


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} violates the repro_<subsystem>_<name> "
            f"convention (lowercase, [a-z0-9_])")
    return name


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing within a reset window."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    """Fixed-edge histogram: per-bucket counts plus sum/count."""

    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: Sequence[float]):
        self.edges = tuple(float(e) for e in edges)
        if list(self.edges) != sorted(set(self.edges)):
            raise ValueError(f"bucket edges must be strictly increasing, "
                             f"got {edges}")
        self.counts = [0] * (len(self.edges) + 1)   # +inf overflow bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        for i, e in enumerate(self.edges):
            if v <= e:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def _zero(self) -> None:
        self.counts = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0


class MetricsRegistry:
    """Instrument store keyed by (name, sorted label pairs)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, tuple], Counter] = {}
        self._gauges: Dict[Tuple[str, tuple], Gauge] = {}
        self._hists: Dict[Tuple[str, tuple], Histogram] = {}
        self._label_sets: Dict[str, set] = {}
        self._external: Dict[str, Tuple[Callable[[], Any],
                                        Optional[Callable[[], None]]]] = {}

    # -- instrument lookup ---------------------------------------------------
    def _key(self, name: str, labels: Dict[str, str]) -> Tuple[str, tuple]:
        _check_name(name)
        lk = _label_key(labels)
        seen = self._label_sets.setdefault(name, set())
        if lk not in seen:
            if len(seen) >= MAX_LABEL_SETS:
                raise ValueError(
                    f"metric {name!r} exceeded {MAX_LABEL_SETS} distinct "
                    f"label sets — unbounded label cardinality is a bug")
            seen.add(lk)
        return (name, lk)

    def counter(self, name: str, **labels) -> Counter:
        key = self._key(name, labels)
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = self._key(name, labels)
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                g = self._gauges[key] = Gauge()
        return g

    def histogram(self, name: str, edges: Sequence[float] = DEFAULT_EDGES_MS,
                  **labels) -> Histogram:
        key = self._key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram(edges)
            elif h.edges != tuple(float(e) for e in edges):
                raise ValueError(
                    f"histogram {name!r} re-declared with different edges")
        return h

    # -- stats() bridge ------------------------------------------------------
    def publish(self, prefix: str, mapping: Dict[str, Any]) -> None:
        """Flatten a nested stats dict into gauges
        ``repro_<prefix>_<path>``; non-numeric leaves are skipped."""
        base = f"repro_{prefix}".lower()

        def walk(prefix: str, m: Dict[str, Any]):
            for k, v in m.items():
                part = re.sub(r"[^a-z0-9]+", "_",
                              str(k).lower()).strip("_") or "x"
                full = f"{prefix}_{part}"
                if isinstance(v, dict):
                    walk(full, v)
                elif isinstance(v, bool):
                    self.gauge(full).set(float(v))
                elif isinstance(v, (int, float)):
                    self.gauge(full).set(float(v))

        walk(base, mapping)

    def register_external(self, name: str,
                          snapshot_fn: Callable[[], Any],
                          reset_fn: Optional[Callable[[], None]] = None
                          ) -> None:
        """Adopt a counter surface that lives outside the registry:
        ``snapshot()`` includes its ``snapshot_fn()`` output and
        ``reset()`` calls its ``reset_fn`` (the hygiene contract)."""
        _check_name(name)
        self._external[name] = (snapshot_fn, reset_fn)

    # -- snapshot / reset ----------------------------------------------------
    @staticmethod
    def _series(key: Tuple[str, tuple]) -> str:
        name, labels = key
        if not labels:
            return name
        inner = ",".join(f'{k}="{v}"' for k, v in labels)
        return f"{name}{{{inner}}}"

    def snapshot(self) -> Dict[str, Any]:
        """The single source for engine/trainer stats export: every
        instrument's current value, JSON-friendly and stable-ordered."""
        with self._lock:
            out: Dict[str, Any] = {
                "counters": {self._series(k): c.value
                             for k, c in sorted(self._counters.items())},
                "gauges": {self._series(k): g.value
                           for k, g in sorted(self._gauges.items())},
                "histograms": {
                    self._series(k): {
                        "edges": list(h.edges),
                        "counts": list(h.counts),
                        "sum": h.sum,
                        "count": h.count,
                    }
                    for k, h in sorted(self._hists.items())
                },
            }
        ext = {}
        for name, (snap, _reset) in sorted(self._external.items()):
            try:
                ext[name] = snap()
            except Exception as e:  # snapshot must never take a run down
                ext[name] = {"error": repr(e)}
        if ext:
            out["external"] = ext
        return out

    def reset(self) -> None:
        """Zero every instrument and reset registered external counters
        (bench scripts call this between warmup and measurement)."""
        with self._lock:
            for c in self._counters.values():
                c.value = 0.0
            for g in self._gauges.values():
                g.value = 0.0
            for h in self._hists.values():
                h._zero()
        for _name, (_snap, reset_fn) in self._external.items():
            if reset_fn is not None:
                reset_fn()

    def clear(self) -> None:
        """Drop every instrument and external registration (tests)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._label_sets.clear()
        self._external.clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry every subsystem registers into."""
    return _REGISTRY


def metric_names(snapshot: Optional[Dict[str, Any]] = None) -> List[str]:
    """Sorted series names of a snapshot (the schema-golden observable:
    key drift in any ``stats()`` surface changes this list)."""
    snap = snapshot if snapshot is not None else _REGISTRY.snapshot()
    names: List[str] = []
    for kind in ("counters", "gauges", "histograms"):
        names.extend(snap.get(kind, {}))
    names.extend(snap.get("external", {}))
    return sorted(names)
