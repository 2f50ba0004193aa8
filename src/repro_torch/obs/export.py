"""Exporters: Chrome ``trace_event`` JSON, Prometheus text exposition,
JSONL event logs, and the shared benchmark-result header.

Every writer here is atomic in the :mod:`repro_torch.tune.cache` style —
serialise to a temp file in the target directory, fsync, ``os.replace``
— so a crashed run leaves either the old artifact or the new one, never
a torn file that a dashboard or CI artifact-upload step then chokes on.

The JSONL record vocabulary (one JSON object per line) is the on-disk
mirror of the trace-ring vocabulary plus two framing records:

  ``{"kind": "meta", ...}``     the :func:`result_header` for the run
  ``{"kind": "span"|"event"|"b"|"e", ...}``   trace records verbatim
  ``{"kind": "metrics", "snapshot": {...}}``  final registry snapshot

so a single ``--obs-trace out.jsonl`` file carries the whole story and
``python -m repro_torch.obs`` can render both the timeline (→ Chrome trace)
and the metrics table from it.
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
from datetime import datetime, timezone
from typing import Any, Dict, Iterable, List, Optional

#: schema version of benchmark-result files and obs JSONL logs
RESULT_SCHEMA_VERSION = 1


# ---------------------------------------------------------------------------
# Atomic writers (the tune/cache.py pattern)
# ---------------------------------------------------------------------------

def _write_atomic(path: str, text: str) -> str:
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".obs-", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def write_json_atomic(path: str, payload: Any) -> str:
    """Atomically write ``payload`` as pretty-printed JSON."""
    return _write_atomic(path, json.dumps(payload, indent=2, sort_keys=True,
                                          default=str) + "\n")


def write_text_atomic(path: str, text: str) -> str:
    """Atomically write ``text`` (Prometheus exposition, reports)."""
    return _write_atomic(path, text)


# ---------------------------------------------------------------------------
# Shared benchmark-result header
# ---------------------------------------------------------------------------

def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except (OSError, subprocess.SubprocessError):
        return None


def _card() -> Dict[str, Optional[str]]:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (its first line), or
    None where the tool is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return {"nvidia_smi": None, "power_limit": None}
    line = out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None
    limit = line.rsplit(",", 1)[1].strip() if line and "," in line else None
    return {"nvidia_smi": line, "power_limit": limit}


def result_header(**extra) -> Dict[str, Any]:
    """The metadata header every result file carries: schema version, the
    device the run used (``cuda`` or ``cpu``; a caller that ran on the
    CPU with a card present passes ``device="cpu"``), the torch and CUDA
    versions, on a card its name and power limit, the git sha, the UTC
    timestamp, and the ``REPRO_*`` environment that shaped the run — the
    fields that make numbers comparable across PRs."""
    import torch

    device = str(extra.pop("device", None)
                 or ("cuda" if torch.cuda.is_available() else "cpu"))
    hdr: Dict[str, Any] = {
        "schema_version": RESULT_SCHEMA_VERSION,
        "device": device,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
    if device.startswith("cuda"):
        hdr["device_name"] = torch.cuda.get_device_name(torch.device(device))
        hdr.update(_card())
    hdr.update({
        "git_sha": _git_sha(),
        "timestamp_utc": datetime.now(timezone.utc).isoformat(
            timespec="seconds"),
        "env": {k: v for k, v in sorted(os.environ.items())
                if k.startswith("REPRO_")},
    })
    hdr.update(extra)
    return hdr


def write_result(path: str, payload: Dict[str, Any], **meta) -> str:
    """Atomically write a benchmark-result JSON with the shared header
    under ``"meta"`` (existing top-level keys of ``payload`` are kept;
    a pre-existing ``"meta"`` key is merged under the header)."""
    doc = dict(payload)
    hdr = result_header(**meta)
    prior = doc.get("meta")
    if isinstance(prior, dict):
        hdr = {**prior, **hdr}
    doc["meta"] = hdr
    return write_json_atomic(path, doc)


# ---------------------------------------------------------------------------
# JSONL event logs
# ---------------------------------------------------------------------------

def write_jsonl(path: str, records: Iterable[Dict[str, Any]]) -> str:
    """Atomically write one JSON object per line."""
    lines = [json.dumps(r, sort_keys=True, default=str) for r in records]
    return _write_atomic(path, "\n".join(lines) + ("\n" if lines else ""))


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def run_records(trace_records: Iterable[Dict[str, Any]],
                snapshot: Optional[Dict[str, Any]] = None,
                **meta) -> List[Dict[str, Any]]:
    """Frame trace records into the JSONL run vocabulary: a ``meta``
    header first, the timeline verbatim, a final ``metrics`` record."""
    recs: List[Dict[str, Any]] = [{"kind": "meta", **result_header(**meta)}]
    recs.extend(trace_records)
    if snapshot is not None:
        recs.append({"kind": "metrics", "snapshot": snapshot})
    return recs


# ---------------------------------------------------------------------------
# Chrome trace_event JSON (Perfetto-loadable)
# ---------------------------------------------------------------------------

_TIMELINE_KINDS = ("span", "event", "b", "e")


def chrome_trace(records: Iterable[Dict[str, Any]],
                 process_name: str = "repro") -> Dict[str, Any]:
    """Convert trace records (``trace.snapshot()`` dicts or JSONL rows)
    to the Chrome ``trace_event`` JSON object format.

    Spans become ``ph:"X"`` complete events, instants ``ph:"i"``, and
    async begin/end pairs ``ph:"b"``/``ph:"e"`` correlated by ``id`` —
    Perfetto renders the latter as per-request async tracks.  ts/dur are
    microseconds per the spec.
    """
    evs: List[Dict[str, Any]] = [{
        "ph": "M", "pid": 1, "tid": 0, "name": "process_name",
        "args": {"name": process_name},
    }]
    tids = {}
    for rec in records:
        kind = rec.get("kind")
        if kind not in _TIMELINE_KINDS:
            continue
        tid = tids.setdefault(rec.get("tid", 0), len(tids) + 1)
        ts_us = rec.get("ts_ns", 0) / 1000.0
        args = dict(rec.get("attrs") or {})
        ev: Dict[str, Any] = {
            "name": rec.get("name", "?"), "pid": 1, "tid": tid, "ts": ts_us,
        }
        if kind == "span":
            ev["ph"] = "X"
            ev["dur"] = rec.get("dur_ns", 0) / 1000.0
            ev["cat"] = rec.get("category") or "span"
            if rec.get("parent") is not None:
                args["parent"] = rec["parent"]
        elif kind == "event":
            ev["ph"] = "i"
            ev["s"] = "t"
            ev["cat"] = rec.get("category") or "event"
        else:  # b / e
            ev["ph"] = kind
            ev["cat"] = rec.get("category") or "async"
            ev["id"] = str(rec.get("id"))
        if args:
            ev["args"] = args
        evs.append(ev)
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, records: Iterable[Dict[str, Any]],
                       **kw) -> str:
    return write_json_atomic(path, chrome_trace(records, **kw))


def validate_chrome_trace(doc: Dict[str, Any]) -> List[str]:
    """Schema check against the trace_event object format; returns a
    list of defects (empty == valid).  Used by the export tests and the
    CLI so a malformed trace fails loudly before someone drags it into
    Perfetto."""
    errs: List[str] = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["top level must be {'traceEvents': [...]}"]
    open_async: Dict[tuple, int] = {}
    for i, ev in enumerate(doc["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "b", "e", "M", "B", "E"):
            errs.append(f"{where}: unknown ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            errs.append(f"{where}: missing name")
        if ph != "M":
            if not isinstance(ev.get("ts"), (int, float)):
                errs.append(f"{where}: missing numeric ts")
            if "pid" not in ev or "tid" not in ev:
                errs.append(f"{where}: missing pid/tid")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            errs.append(f"{where}: complete event missing dur")
        if ph in ("b", "e"):
            if "id" not in ev:
                errs.append(f"{where}: async event missing id")
            else:
                key = (ev.get("cat"), ev.get("name"), ev["id"])
                open_async[key] = open_async.get(key, 0) + (
                    1 if ph == "b" else -1)
    for key, n in open_async.items():
        if n > 0:
            errs.append(f"async {key} has {n} unmatched begin(s)")
    return errs


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _split_series(series: str):
    """``name{k="v",...}`` -> (name, 'k="v",...'); bare name -> (name, '')."""
    if "{" in series:
        name, inner = series.split("{", 1)
        return name, inner.rstrip("}")
    return series, ""


def _with_label(inner: str, extra: str) -> str:
    return f"{inner},{extra}" if inner else extra


def prometheus_text(snapshot: Dict[str, Any]) -> str:
    """Render a registry snapshot in the Prometheus text exposition
    format (``# TYPE`` headers; histograms as cumulative
    ``_bucket{le=...}`` + ``_sum`` + ``_count``)."""
    lines: List[str] = []
    typed = set()

    def type_line(name: str, kind: str):
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for series, v in snapshot.get("counters", {}).items():
        name, inner = _split_series(series)
        type_line(name, "counter")
        lines.append(f"{name}{{{inner}}} {v:g}" if inner
                     else f"{name} {v:g}")
    for series, v in snapshot.get("gauges", {}).items():
        name, inner = _split_series(series)
        type_line(name, "gauge")
        lines.append(f"{name}{{{inner}}} {v:g}" if inner
                     else f"{name} {v:g}")
    for series, h in snapshot.get("histograms", {}).items():
        name, inner = _split_series(series)
        type_line(name, "histogram")
        cum = 0
        for edge, c in zip(h["edges"], h["counts"][:-1], strict=True):
            cum += c
            lab = _with_label(inner, f'le="{edge:g}"')
            lines.append(f"{name}_bucket{{{lab}}} {cum}")
        cum += h["counts"][-1]
        lab = _with_label(inner, 'le="+Inf"')
        lines.append(f"{name}_bucket{{{lab}}} {cum}")
        lines.append(f"{name}_sum{{{inner}}} {h['sum']:g}" if inner
                     else f"{name}_sum {h['sum']:g}")
        lines.append(f"{name}_count{{{inner}}} {h['count']}" if inner
                     else f"{name}_count {h['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(path: str, snapshot: Dict[str, Any]) -> str:
    return write_text_atomic(path, prometheus_text(snapshot))
