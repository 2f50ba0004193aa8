"""Finding records and the reviewed-suppression (allowlist) machinery.

Every analyzer pass emits :class:`Finding` rows; the CLI partitions them
against the suppression file (the package's own ``allowlist.toml``) and
exits nonzero only on *unsuppressed* ``error``-severity findings.  A
suppression is a reviewed statement that a specific finding is
intentional — e.g. the ``f32→half→f32`` round trip inside
``quantize_complex`` IS Theorem 3.2's boundary quantiser, not wasted
bandwidth — so it must name the check and carry a reason.
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Dict, List, Optional, Sequence, Tuple

ERROR = "error"
WARNING = "warning"
SEVERITIES = (ERROR, WARNING)

#: Pass names, in report order.
PASSES = ("dataflow", "sites", "kernels", "obs")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer result.

    pass_name: which pass produced it ("dataflow" | "sites" | "kernels" | "obs").
    check:     stable slug of the rule that fired (suppression key).
    severity:  "error" gates CI; "warning" is informational.
    site:      precision-site address the finding attributes to, when the
               pass could recover one (``site_scope``, rule pattern);
               None for findings without a site (e.g. kernel structure).
    where:     locator — "model/policy" for traces, "file:line" for the
               AST passes, the kernel family for the kernels pass.
    detail:    human-readable specifics.
    """

    pass_name: str
    check: str
    severity: str
    site: Optional[str]
    where: str
    detail: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def dedupe(findings: Sequence[Finding]) -> List[Finding]:
    """Drop exact duplicates, keeping first-seen order."""
    seen = set()
    out = []
    for f in findings:
        key = (f.pass_name, f.check, f.severity, f.site, f.where, f.detail)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Suppression:
    """One ``[[suppress]]`` table from the allowlist file.

    ``check`` matches exactly; ``site`` / ``where`` are optional fnmatch
    patterns (absent = match anything, including findings with no site).
    ``reason`` is required — an allowlist entry without a rationale is a
    review failure, not a review.
    """

    check: str
    reason: str
    site: Optional[str] = None
    where: Optional[str] = None

    def matches(self, f: Finding) -> bool:
        if self.check != f.check:
            return False
        if self.site is not None:
            if f.site is None or not fnmatch.fnmatchcase(f.site, self.site):
                return False
        if self.where is not None:
            if not fnmatch.fnmatchcase(f.where, self.where):
                return False
        return True


def _parse_minimal_toml(text: str) -> dict:
    """Just enough TOML for the suppression file on Python 3.10 (no
    ``tomllib``): ``[[suppress]]`` table arrays of string key/values.
    Anything fancier should use a real parser — raise rather than guess."""
    out: Dict[str, list] = {}
    current: Optional[dict] = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("[[") and line.endswith("]]"):
            name = line[2:-2].strip()
            current = {}
            out.setdefault(name, []).append(current)
            continue
        if "=" in line and current is not None:
            key, _, val = line.partition("=")
            key, val = key.strip(), val.strip()
            # strip a trailing comment outside the quotes
            if val and val[0] in "\"'":
                quote = val[0]
                end = val.find(quote, 1)
                if end < 0:
                    raise ValueError(
                        f"allowlist:{lineno}: unterminated string")
                current[key] = val[1:end]
                continue
        raise ValueError(
            f"allowlist:{lineno}: unsupported syntax {raw!r} — the "
            f"fallback parser handles only [[suppress]] tables with "
            f"string values"
        )
    return out


def load_suppressions(path: str) -> Tuple[Suppression, ...]:
    """Load ``[[suppress]]`` entries; missing file = empty allowlist."""
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
    except FileNotFoundError:
        return ()
    try:
        import tomllib  # Python 3.11+

        data = tomllib.loads(raw.decode("utf-8"))
    except ModuleNotFoundError:
        data = _parse_minimal_toml(raw.decode("utf-8"))
    entries = []
    for i, tbl in enumerate(data.get("suppress", [])):
        if "check" not in tbl or "reason" not in tbl:
            raise ValueError(
                f"{path}: suppress entry #{i + 1} needs both 'check' and "
                f"'reason' keys, got {sorted(tbl)}"
            )
        unknown = set(tbl) - {"check", "reason", "site", "where"}
        if unknown:
            raise ValueError(
                f"{path}: suppress entry #{i + 1} has unknown keys "
                f"{sorted(unknown)}"
            )
        entries.append(Suppression(**tbl))
    return tuple(entries)


def partition(
    findings: Sequence[Finding], suppressions: Sequence[Suppression]
) -> Tuple[List[Finding], List[Finding]]:
    """Split into (active, suppressed)."""
    active, suppressed = [], []
    for f in findings:
        (suppressed if any(s.matches(f) for s in suppressions) else active
         ).append(f)
    return active, suppressed


def summarize(findings: Sequence[Finding]) -> dict:
    """Per-(pass, check, severity) counts for the report table."""
    counts: Dict[Tuple[str, str, str], int] = {}
    for f in findings:
        key = (f.pass_name, f.check, f.severity)
        counts[key] = counts.get(key, 0) + 1
    return {
        "total": len(findings),
        "errors": sum(1 for f in findings if f.severity == ERROR),
        "warnings": sum(1 for f in findings if f.severity == WARNING),
        "by_check": [
            {"pass": p, "check": c, "severity": s, "count": n}
            for (p, c, s), n in sorted(counts.items())
        ],
    }
