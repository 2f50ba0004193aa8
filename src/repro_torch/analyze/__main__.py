"""CLI: ``python -m repro_torch.analyze``: run every pass, print the
findings table, write ``build/analyze.json``, exit 1 on any unsuppressed
error-severity finding.

    python -m repro_torch.analyze                  # on the card
    python -m repro_torch.analyze --device cpu     # the plain versions

The dataflow and kernels passes run on ``--device``: the card (the
default) records the kernels the port launches there, and raises when
there is none; ``cpu`` records the kernels' plain versions and plans the
launches without launching.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List

from .findings import ERROR, Finding, dedupe, load_suppressions, partition, summarize

_PKG = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.normpath(os.path.join(_PKG, "..", "..", ".."))
DEFAULT_OUT = os.path.join(_REPO_ROOT, "build", "analyze.json")
DEFAULT_SUPPRESSIONS = os.path.join(_PKG, "allowlist.toml")
DEFAULT_SRC = os.path.normpath(os.path.join(_PKG, "..", ".."))

MODELS = ("fno", "tfno", "sfno")
PATHS = {"both": (False, True), "staged": (False,), "fused": (True,)}


def run_dataflow(policies: List[str], models: List[str], fused_paths, trainer: bool,
                 device) -> List[Finding]:
    """Every model under every policy on every path (the fused path only
    for the dense FNO), and one Trainer step per policy and path."""
    from repro_torch.precision import get_policy

    from .dataflow import model_findings, trainer_findings

    findings: List[Finding] = []
    for name in policies:
        policy = get_policy(name)
        for model in models:
            for fused in fused_paths:
                if fused and model != "fno":
                    continue
                findings.extend(model_findings(model, policy, fused, device=device))
        if trainer:
            for fused in fused_paths:
                findings.extend(trainer_findings(policy, fused, device=device))
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analyze",
        description="static numerics & precision linter of the port (recorded dtype "
                    "flow, site rules, launch plans)")
    ap.add_argument("--policies", nargs="*", default=None,
                    help="registry policies to run (default: all)")
    ap.add_argument("--models", nargs="*", default=list(MODELS), choices=MODELS,
                    help="models to run")
    ap.add_argument("--paths", choices=tuple(PATHS), default="both",
                    help="which spectral paths to run: staged, fused (the dense FNO), "
                         "or both")
    ap.add_argument("--no-trainer", action="store_true",
                    help="skip the Trainer-step runs")
    ap.add_argument("--skip", nargs="*", default=[],
                    choices=("dataflow", "sites", "kernels", "calibration", "obs"),
                    help="passes to skip")
    ap.add_argument("--device", default=None,
                    help="where the dataflow and kernels passes run: cuda (the default; "
                         "raises without a card) or cpu")
    ap.add_argument("--calibration-state", default=None,
                    help="calibration-state JSON to lint for tile coverage (default: "
                         "$REPRO_CALIBRATION_STATE; skipped when neither is set)")
    ap.add_argument("--out", default=DEFAULT_OUT, help="findings report path (JSON)")
    ap.add_argument("--suppressions", default=DEFAULT_SUPPRESSIONS,
                    help="reviewed-allowlist TOML (missing file = empty)")
    ap.add_argument("--src", default=DEFAULT_SRC,
                    help="source root holding the repro_torch package, for the AST scans")
    ap.add_argument("--max-print", type=int, default=20,
                    help="cap on individually printed findings per severity")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.precision import POLICIES

    device = resolve_device(args.device)
    policies = args.policies or sorted(POLICIES)
    fused_paths = PATHS[args.paths]

    findings: List[Finding] = []
    if "dataflow" not in args.skip:
        print(f"[analyze] dataflow on {device}: {len(policies)} policies x "
              f"{len(args.models)} models x {len(fused_paths)} paths"
              + ("" if args.no_trainer else " + trainer steps"))
        findings.extend(run_dataflow(policies, args.models, fused_paths,
                                     not args.no_trainer, device))
    if "sites" not in args.skip:
        root = os.path.join(args.src, "repro_torch")
        print(f"[analyze] sites: AST scan of {root} + rule tables")
        from .sites import sites_pass

        findings.extend(sites_pass(root))
    if "kernels" not in args.skip:
        print(f"[analyze] kernels: launch plans of the spectral families on {device}")
        from .kernels import kernels_pass

        findings.extend(kernels_pass(device))
    if "obs" not in args.skip:
        print(f"[analyze] obs: counter-registry coverage scan of {args.src}")
        from .obscov import obs_coverage_pass

        findings.extend(obs_coverage_pass(args.src))
    if "calibration" not in args.skip:
        from repro_torch.tune.cache import ENV_VAR

        cal_path = args.calibration_state or os.environ.get(ENV_VAR)
        if cal_path:
            print(f"[analyze] calibration: tile coverage of {cal_path}")
            from .kernels import calibration_pass

            findings.extend(calibration_pass(cal_path))

    findings = dedupe(findings)
    suppressions = load_suppressions(args.suppressions)
    active, suppressed = partition(findings, suppressions)
    summary = summarize(active)

    print()
    print(f"{'pass':<10} {'check':<26} {'severity':<9} count")
    for row in summary["by_check"]:
        print(f"{row['pass']:<10} {row['check']:<26} {row['severity']:<9} {row['count']}")
    if not summary["by_check"]:
        print("(no findings)")
    print(f"\n{summary['errors']} error(s), {summary['warnings']} warning(s); "
          f"{len(suppressed)} suppressed via {os.path.relpath(args.suppressions, _REPO_ROOT)}")

    errors = [f for f in active if f.severity == ERROR]
    for sev, rows in (("error", errors), ("warning", [f for f in active if f.severity != ERROR])):
        for f in rows[:args.max_print]:
            loc = f" site={f.site}" if f.site else ""
            print(f"  [{sev}] {f.check} @ {f.where}{loc}: {f.detail}")
        if len(rows) > args.max_print:
            print(f"  ... {len(rows) - args.max_print} more {sev}(s); see "
                  f"{os.path.relpath(args.out, _REPO_ROOT)}")

    report = {
        "policies": policies,
        "models": list(args.models),
        "paths": ["fused" if f else "staged" for f in fused_paths],
        "device": str(device),
        "summary": summary,
        "findings": [f.to_json() for f in active],
        "suppressed": [f.to_json() for f in suppressed],
    }
    from repro_torch.obs import write_result

    write_result(args.out, report)
    print(f"\nwrote {args.out}")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
