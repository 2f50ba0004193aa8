"""Site-rule pass: cross-check code-level site literals against the rule
tables, and the rule tables against the canonical site vocabulary.

Three checks:

  orphan-site (error)       a ``policy.at("...")`` / ``site="..."`` /
      ``tap("...")`` / ``site_scope("...")`` string literal in
      ``src/repro_torch/`` that no canonical site
      pattern can ever match — a typo'd address silently resolves
      through the ``"*"`` catch-all to full precision, which is exactly
      the "declared precision doesn't hold" bug this pass exists for.
  pattern-no-match (error)  a rule-table pattern (DEFAULT_RULES or any
      registry policy overlay) that matches no site in the canonical
      universe — dead configuration.
  shadowed-rule (error)     a rule entry every one of whose set fields
      is, at every site its pattern matches, already supplied by an
      earlier entry *of the same table* (field-wise first-match
      resolution never reads it).  Overlays shadowing DEFAULT_RULES are
      by design and not flagged; an entry dead within its own table is
      a bug.

f-string literals contribute their constant fragments with ``*`` holes
(``f"fno/layer{i}/spectral"`` -> ``fno/layer*/spectral``); a literal is
recognised if some hole filling (and, for prefix-style literals, some
known stage suffix) lands on a canonical pattern.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.precision.policy import CANONICAL_SITES, POLICIES
from repro_torch.precision.rules import DEFAULT_RULES, RULE_FIELDS, UNSET, site_matches

from .findings import ERROR, Finding

#: Model prefixes the "model/..." canonical sites generalise over.
_MODEL_PREFIXES = ("model", "fno", "tfno", "sfno", "lm", "gino", "unet")
#: Pipeline-stage suffixes that prefix-style literals get completed with
#: (``site=f"fno/layer{i}/spectral"`` is a prefix; the callee appends the
#: stage).  Completion only applies to ``.../spectral`` prefixes: blindly
#: appending stages to arbitrary literals would let ``*/<stage>`` match
#: any junk prefix and the orphan check would never fire.
_STAGE_SUFFIXES = ("/fft_in", "/contract", "/fft_out")
#: Candidate strings substituted into f-string holes when testing whether
#: *some* runtime value could make the literal canonical.
_HOLE_FILLERS = ("0", "layer0", "fno", "fno/layer0",
                 "fno/layer0/spectral", "model/spectral", "lm/ssd/spectral")


def canonical_patterns() -> Tuple[str, ...]:
    """CANONICAL_SITES, with the ``model/`` entries generalised to any
    model prefix (``model/dense`` covers ``fno/dense``,
    ``fno/layer3/dense``, ...)."""
    pats: List[str] = []
    for s in CANONICAL_SITES:
        pats.append(s)
        if s.startswith("model/"):
            pats.append("*/" + s[len("model/"):])
    return tuple(pats)


def site_universe() -> Tuple[str, ...]:
    """A concrete expansion of the canonical vocabulary: every canonical
    site, plus the per-model / per-layer forms the ``model/*`` entries
    stand for.  Used to give fnmatch patterns something real to match."""
    sites = set(CANONICAL_SITES)
    for s in CANONICAL_SITES:
        if not s.startswith("model/"):
            continue
        suffix = s[len("model/"):]
        for m in _MODEL_PREFIXES:
            if m == "model":
                continue
            sites.add(f"{m}/{suffix}")
            for layer in range(8):
                sites.add(f"{m}/layer{layer}/{suffix}")
    # the LM's spectral SSD mixer addresses spectral stages under a
    # non-layer scope
    for stage in ("fft_in", "contract", "fft_out"):
        sites.add(f"lm/ssd/spectral/{stage}")
    return tuple(sorted(sites))


def _is_recognized(literal_pattern: str) -> bool:
    """True if some hole filling + stage suffix of the literal matches a
    canonical pattern (i.e. the literal can address a real site)."""
    pats = canonical_patterns()
    holes = literal_pattern.count("*")
    fillers = _HOLE_FILLERS if holes else ("",)
    for filler in fillers:
        concrete = literal_pattern.replace("*", filler)
        if any(site_matches(p, concrete) for p in pats):
            return True
        if concrete.split("/")[-1] == "spectral":
            for suffix in _STAGE_SUFFIXES:
                if any(site_matches(p, concrete + suffix) for p in pats):
                    return True
    return False


# ---------------------------------------------------------------------------
# AST scan for site literals
# ---------------------------------------------------------------------------


def _literal_pattern(node: ast.expr) -> Optional[str]:
    """A site pattern from a Constant-str or JoinedStr node (f-string
    holes become ``*``); None for anything non-literal."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                parts.append("*")
        return "".join(parts)
    return None


class _SiteVisitor(ast.NodeVisitor):
    def __init__(self) -> None:
        self.literals: List[Tuple[int, str]] = []  # (lineno, pattern)

    def _add(self, node: ast.expr) -> None:
        pat = _literal_pattern(node)
        if pat is not None and pat:
            self.literals.append((node.lineno, pat))

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if (isinstance(func, ast.Attribute) and func.attr == "at"
                and node.args):
            self._add(node.args[0])
        if isinstance(func, ast.Name) and func.id in ("tap", "site_scope") \
                and node.args:
            self._add(node.args[0])
        # repro_torch.obs numerics events carry a ``site=`` attribute naming an
        # *event location* (e.g. "serve/logits"), not a precision-site
        # address — a different namespace this check must not police.
        callee = (func.attr if isinstance(func, ast.Attribute)
                  else func.id if isinstance(func, ast.Name) else None)
        if callee != "numerics_event":
            for kw in node.keywords:
                if kw.arg == "site":
                    self._add(kw.value)
        self.generic_visit(node)

    def _defaults(self, node) -> None:
        args = node.args
        pos = args.posonlyargs + args.args
        for arg, default in zip(pos[len(pos) - len(args.defaults):],
                                args.defaults, strict=True):
            if arg.arg == "site":
                self._add(default)
        for arg, default in zip(args.kwonlyargs, args.kw_defaults, strict=True):
            if arg.arg == "site" and default is not None:
                self._add(default)

    def visit_FunctionDef(self, node) -> None:
        self._defaults(node)
        self.generic_visit(node)

    def visit_AsyncFunctionDef(self, node) -> None:
        self._defaults(node)
        self.generic_visit(node)


def scan_site_literals(root: str) -> List[Tuple[str, int, str]]:
    """All site string literals under ``root``: (relpath, lineno, pattern).
    Syntax errors are reported by raising — the lint gate should fail
    loudly on an unparseable tree, not skip it."""
    out: List[Tuple[str, int, str]] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames
            if d not in ("__pycache__", ".git", ".ruff_cache"))
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path, "r", encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=path)
            v = _SiteVisitor()
            v.visit(tree)
            rel = os.path.relpath(path, root)
            out.extend((rel, lineno, pat) for lineno, pat in v.literals)
    return out


def orphan_site_findings(root: str) -> List[Finding]:
    findings = []
    for rel, lineno, pat in scan_site_literals(root):
        if not _is_recognized(pat):
            findings.append(Finding(
                pass_name="sites", check="orphan-site", severity=ERROR,
                site=pat, where=f"{rel}:{lineno}",
                detail=f"site literal {pat!r} matches no canonical site "
                       f"pattern — it would resolve through the '*' "
                       f"catch-all to full precision",
            ))
    return findings


# ---------------------------------------------------------------------------
# Rule-table checks
# ---------------------------------------------------------------------------


def _set_fields(rule) -> Tuple[str, ...]:
    return tuple(f for f in RULE_FIELDS if getattr(rule, f) is not UNSET)


def shadowed_entries(rules: Sequence, universe: Sequence[str]
                     ) -> List[Tuple[int, str, Tuple[str, ...]]]:
    """Indices of entries dead under field-wise first-match resolution
    *within this table*: every set field at every matched universe site
    is already supplied by an earlier entry.  Returns
    (index, pattern, dead_fields) tuples."""
    dead = []
    for k, (pattern, rule) in enumerate(rules):
        fields = _set_fields(rule)
        if not fields:
            continue
        matched = [u for u in universe if site_matches(pattern, u)]
        if not matched:
            continue  # pattern-no-match reports this separately
        live = False
        for u in matched:
            for f in fields:
                supplied = any(
                    site_matches(p_earlier, u)
                    and getattr(r_earlier, f) is not UNSET
                    for p_earlier, r_earlier in rules[:k]
                )
                if not supplied:
                    live = True
                    break
            if live:
                break
        if not live:
            dead.append((k, pattern, fields))
    return dead


def rule_table_findings(
    tables: Optional[Dict[str, Sequence]] = None
) -> List[Finding]:
    """pattern-no-match + shadowed-rule over every rule table.  The
    default tables are DEFAULT_RULES and each registry policy's overlay
    (each checked on its own: an overlay shadowing the base table is the
    design, an entry dead within its own table is a bug)."""
    if tables is None:
        tables = {"DEFAULT_RULES": DEFAULT_RULES}
        for name, pol in POLICIES.items():
            if pol.rules:
                tables[f"policy:{name}"] = pol.rules
    universe = site_universe()
    findings = []
    for table_name, rules in tables.items():
        for pattern, _rule in rules:
            if not any(site_matches(pattern, u) for u in universe):
                findings.append(Finding(
                    pass_name="sites", check="pattern-no-match",
                    severity=ERROR, site=pattern, where=table_name,
                    detail=f"rule pattern {pattern!r} matches no canonical "
                           f"site — dead configuration",
                ))
        for k, pattern, fields in shadowed_entries(rules, universe):
            findings.append(Finding(
                pass_name="sites", check="shadowed-rule", severity=ERROR,
                site=pattern, where=f"{table_name}[{k}]",
                detail=f"entry {k} ({pattern!r}, fields {list(fields)}) is "
                       f"shadowed dead: earlier entries supply every set "
                       f"field at every site it matches",
            ))
    return findings


def sites_pass(src_root: str) -> List[Finding]:
    return orphan_site_findings(src_root) + rule_table_findings()
