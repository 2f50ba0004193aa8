"""``python -m repro_torch.obs`` — run-summary table and format conversion.

Subcommands::

    summary RUN.jsonl            span/event/metrics summary of one run
    chrome  RUN.jsonl OUT.json   convert the JSONL log to a Chrome
                                 trace_event file (load in Perfetto)
    prom    RUN.jsonl OUT.prom   dump the run's final metrics snapshot
                                 in Prometheus text exposition format

A run log is the JSONL file written by ``--obs-trace``
(``repro_torch.examples.train_darcy``): a ``meta`` header, the
span/event timeline, and a final ``metrics`` snapshot record.
"""
from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from . import export


def _load(path: str) -> Tuple[Optional[dict], List[dict], Optional[dict]]:
    """Split a run log into (meta, timeline records, metrics snapshot)."""
    meta, timeline, snap = None, [], None
    for rec in export.read_jsonl(path):
        kind = rec.get("kind")
        if kind == "meta":
            meta = rec
        elif kind == "metrics":
            snap = rec.get("snapshot")
        elif kind in ("span", "event", "b", "e"):
            timeline.append(rec)
    return meta, timeline, snap


def _fmt_ns(ns: float) -> str:
    if ns >= 1e9:
        return f"{ns / 1e9:.3f}s"
    if ns >= 1e6:
        return f"{ns / 1e6:.2f}ms"
    return f"{ns / 1e3:.1f}us"


def _table(rows: List[List[str]], header: List[str]) -> str:
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*header), fmt.format(*("-" * w for w in widths))]
    lines += [fmt.format(*map(str, r)) for r in rows]
    return "\n".join(lines)


def cmd_summary(args) -> int:
    meta, timeline, snap = _load(args.run)
    if meta:
        print(f"run: device={meta.get('device')} "
              f"torch={meta.get('torch_version')} "
              f"cuda={meta.get('cuda_version')} "
              f"sha={(meta.get('git_sha') or '?')[:12]} "
              f"at={meta.get('timestamp_utc')}")
    # spans: count / total / mean per name
    agg: Dict[str, List[float]] = defaultdict(list)
    n_events: Dict[str, int] = defaultdict(int)
    for rec in timeline:
        if rec.get("kind") == "span":
            agg[rec["name"]].append(float(rec.get("dur_ns", 0)))
        elif rec.get("kind") == "event":
            n_events[rec["name"]] += 1
    if agg:
        rows = []
        for name, durs in sorted(agg.items(),
                                 key=lambda kv: -sum(kv[1])):
            rows.append([name, len(durs), _fmt_ns(sum(durs)),
                         _fmt_ns(sum(durs) / len(durs)),
                         _fmt_ns(max(durs))])
        print()
        print(_table(rows, ["span", "count", "total", "mean", "max"]))
    if n_events:
        print()
        print(_table(sorted([[k, v] for k, v in n_events.items()],
                            key=lambda r: -r[1]),
                     ["event", "count"]))
    if snap:
        rows = []
        for series, v in snap.get("counters", {}).items():
            rows.append([series, "counter", f"{v:g}"])
        for series, v in snap.get("gauges", {}).items():
            rows.append([series, "gauge", f"{v:g}"])
        for series, h in snap.get("histograms", {}).items():
            rows.append([series, "histogram",
                         f"count={h['count']} sum={h['sum']:g}"])
        for name, val in snap.get("external", {}).items():
            rows.append([name, "external", str(val)])
        if rows:
            print()
            print(_table(rows, ["metric", "type", "value"]))
    if not timeline and not snap:
        print("no trace records or metrics snapshot in this log",
              file=sys.stderr)
        return 1
    return 0


def cmd_chrome(args) -> int:
    _meta, timeline, _snap = _load(args.run)
    doc = export.chrome_trace(timeline)
    errs = export.validate_chrome_trace(doc)
    if errs:
        for e in errs:
            print(f"invalid trace: {e}", file=sys.stderr)
        return 1
    export.write_json_atomic(args.out, doc)
    n = len(doc["traceEvents"]) - 1  # minus the process_name metadata
    print(f"wrote {args.out} ({n} trace events)")
    return 0


def cmd_prom(args) -> int:
    _meta, _timeline, snap = _load(args.run)
    if snap is None:
        print("run log has no metrics snapshot record", file=sys.stderr)
        return 1
    export.write_prometheus(args.out, snap)
    print(f"wrote {args.out}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="observability run logs: summarise and convert")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summary", help="span/event/metrics summary")
    s.add_argument("run", help="JSONL run log (--obs-trace output)")
    s.set_defaults(fn=cmd_summary)

    c = sub.add_parser("chrome", help="convert JSONL -> Chrome trace JSON")
    c.add_argument("run")
    c.add_argument("out", help="output trace_event JSON path")
    c.set_defaults(fn=cmd_chrome)

    pr = sub.add_parser("prom", help="dump Prometheus text exposition")
    pr.add_argument("run")
    pr.add_argument("out", help="output .prom path")
    pr.set_defaults(fn=cmd_prom)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
