"""Obs-coverage pass: find hand-rolled counters invisible to repro_torch.obs.

The observability layer's contract is that ``repro_torch.obs.registry()``'s
``snapshot()`` is the single source of runtime statistics: every counter
a subsystem keeps must either live in the registry directly, be adopted
via ``register_external``, or be flattened into gauges through
``publish()`` by the code path that owns it.  A ``self._hits += 1``
in a module that never touches ``repro_torch.obs`` is a stat that silently
falls outside every snapshot, Prometheus scrape and run log.

One check:

  counter-outside-registry (warning)  an ``x += ...`` on a counter-named
      ``self`` attribute (``_n_*``, ``*_hits``, ``*_total``, ...) in a
      module under the instrumented subtrees (serve / train / kernels /
      tune / autoprec) that never imports or references
      ``repro_torch.obs``.  Modules that do reference it are trusted to
      route their counters (that is the wiring convention this pass
      enforces); intentionally-internal tallies are reviewed into the
      allowlist (``allowlist.toml``).

Findings are per (file, attribute): the first mutation site of each
attribute is reported, not every increment.
"""
from __future__ import annotations

import ast
import os
import re
from typing import List, Optional, Tuple

from .findings import WARNING, Finding

#: Subtrees (relative to the source root's ``repro_torch`` package) whose
#: modules are expected to route counters through the obs registry.
INSTRUMENTED_SUBTREES = ("serve", "train", "kernels", "tune", "autoprec")

#: Attribute-name shape that marks an integer tally (as opposed to an
#: accumulator like ``_wall_s`` or a cursor like ``_pos``).
_COUNTER_RE = re.compile(
    r"(^|_)(n|num|count|counts|total|totals|hits|hit|misses|miss|stale|"
    r"evictions|drops|dropped|ticks|calls|rejects|rejected|overflows?|"
    r"streaks?)(_|$)")


def _references_obs(tree: ast.AST) -> bool:
    """True if the module imports ``repro_torch.obs`` (any spelling; a
    relative import from a subtree module is ``from ..obs import``)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name == "repro_torch.obs"
                   or a.name.startswith("repro_torch.obs.")
                   for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level == 0:
                if mod == "repro_torch.obs" or mod.startswith("repro_torch.obs."):
                    return True
                if mod == "repro_torch" and any(a.name == "obs" for a in node.names):
                    return True
            elif node.level == 2:
                if mod == "obs" or mod.startswith("obs."):
                    return True
                if not mod and any(a.name == "obs" for a in node.names):
                    return True
    return False


def _counter_attr(target: ast.expr) -> Optional[str]:
    """The counter-like ``self`` attribute a ``+=`` target mutates, or
    None.  Covers ``self._hits += 1`` and ``self._counts[k] += 1``."""
    if isinstance(target, ast.Subscript):
        target = target.value
    if (isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
            and _COUNTER_RE.search(target.attr)):
        return target.attr
    return None


def _module_counter_mutations(tree: ast.AST) -> List[Tuple[int, str]]:
    """(lineno, attr) of the first ``+=`` per counter-like attribute."""
    first: dict = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.AugAssign)
                and isinstance(node.op, ast.Add)):
            continue
        attr = _counter_attr(node.target)
        if attr is not None and attr not in first:
            first[attr] = node.lineno
    return sorted((lineno, attr) for attr, lineno in first.items())


def obs_coverage_pass(src_root: str) -> List[Finding]:
    """Scan the instrumented subtrees under ``src_root`` (the directory
    containing the ``repro_torch`` package)."""
    findings: List[Finding] = []
    for subtree in INSTRUMENTED_SUBTREES:
        root = os.path.join(src_root, "repro_torch", subtree)
        if not os.path.isdir(root):
            continue
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
                if _references_obs(tree):
                    continue
                rel = os.path.relpath(path, src_root)
                for lineno, attr in _module_counter_mutations(tree):
                    findings.append(Finding(
                        pass_name="obs", check="counter-outside-registry",
                        severity=WARNING, site=None,
                        where=f"{rel}:{lineno}",
                        detail=f"counter {attr!r} is mutated in a module "
                               f"that never references repro_torch.obs — it "
                               f"is invisible to registry().snapshot(); "
                               f"route it via publish()/register_external "
                               f"or review it into the allowlist",
                    ))
    return findings
