"""The port's linter: AST rules and suppression resolution over a file
set, the counterpart of dtdl_tpu/analysis/lint.py.

This is the static half of the port's audit (the dynamic half, the
program audit, lives in program_audit.py and contracts.py).  It parses
every ``.py`` under the given paths, runs the per-file and cross-file
rules of dtdl_tpu_torch/analysis/rules/, resolves ``# audit: ok[rule]
reason`` suppressions and returns the surviving findings.  Pure ``ast``:
nothing is imported or executed, so linting the whole package takes
about a second on one CPU core and runs inside the CPU tests
(tests/test_torch_analysis_gate.py) and as the gate (``python -m
dtdl_tpu_torch.analysis``).
"""

from __future__ import annotations

import ast
import os
import pathlib

from dtdl_tpu_torch.analysis import rules as rules_pkg
from dtdl_tpu_torch.analysis.findings import (Finding, apply_suppressions,
                                              render_report,
                                              scan_suppressions)
from dtdl_tpu_torch.analysis.rules import ParsedModule

__all__ = ["lint_paths", "rule_docs", "render_report", "Finding"]

_SKIP_DIRS = {"__pycache__", ".git"}

#: rule ids reported by the PROGRAM audit (program_audit.py,
#: contracts.py) and by the suppression machinery itself, part of the one
#: catalog.  Program-audit findings are keyed by program name, not
#: file:line: they are resolved by fixing the program or by a deliberate
#: ``--rebase``, never by inline comments.  The JAX ids of the jaxpr and
#: HLO audits are listed with their counterparts.
EXTRA_RULES = {
    "program-host-sync": "host sync inside an audited program (a scalar "
                         "read, or an op whose output size needs the "
                         "host)",
    "program-d2h-copy": "device-to-host copy inside an audited program",
    "program-cuda-sync": "synchronizing CUDA call inside an audited "
                         "program (set_sync_debug_mode('error'), on the "
                         "card)",
    "program-storage-moved": "a state or KV-pool storage replaced by the "
                             "call (copied every step instead of updated "
                             "in place)",
    "census-drift": "program census diverged from the checked-in "
                    "baseline",
    "jaxpr-callback": "JAX rule (a host callback traced into a "
                      "program); in the port: program-host-sync and "
                      "program-d2h-copy",
    "jaxpr-const-capture": "JAX rule (a large constant captured by a "
                           "traced closure); in the port: none (eager "
                           "code captures nothing)",
    "hlo-undonated": "JAX rule (a donated input not aliased); in the "
                     "port: program-storage-moved",
    "hlo-host-transfer": "JAX rule (a compiled program talks to the "
                         "host); in the port: program-d2h-copy and "
                         "program-cuda-sync",
    "lint-syntax": "unparseable source file",
    "suppress-no-reason": "suppression without a justification",
    "suppress-stale": "suppression that matches no finding",
    "suppress-unknown": "suppression naming a rule id that does not "
                        "exist",
}


def rule_docs() -> dict:
    """``{rule_id: one-line doc}``: the full catalog (AST rules, program
    audit, meta rules, and JAX's ids with their counterparts; ``python -m
    dtdl_tpu_torch.analysis --list-rules`` prints it)."""
    return dict(sorted({**rules_pkg.registry(), **EXTRA_RULES}.items()))


def _iter_files(paths):
    for p in paths:
        p = pathlib.Path(p)
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not any(part in _SKIP_DIRS for part in f.parts):
                    yield f


def _rel(path: pathlib.Path, root) -> str:
    try:
        return path.resolve().relative_to(
            pathlib.Path(root).resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def _iter_sources(paths, root=None):
    """Yield ``(repo_relative_path, pathlib.Path)`` for every unique
    .py under ``paths``; parsing (and syntax errors) happen in
    :func:`lint_paths`."""
    root = root or os.getcwd()
    seen = set()
    for f in _iter_files(paths):
        rel = _rel(f, root)
        if rel in seen:
            continue
        seen.add(rel)
        yield rel, f


def lint_paths(paths, *, root=None, only_rules=None) -> list[Finding]:
    """Lint ``paths`` (files or directories); returns unsuppressed
    findings.  ``only_rules`` restricts to a rule-id subset (prefix
    match, like suppressions), for tests and targeted runs."""
    findings: list[Finding] = []
    sups = []
    modules = []
    for rel, f in _iter_sources(paths, root=root):
        try:
            source = f.read_text()
            tree = ast.parse(source, filename=rel)
        except (SyntaxError, UnicodeDecodeError) as e:
            findings.append(Finding(
                "lint-syntax", rel, getattr(e, "lineno", 0) or 0,
                f"unparseable: {e.__class__.__name__}: {e}"))
            continue
        mod = ParsedModule(path=rel, tree=tree, source=source)
        modules.append(mod)
        if "audit:" in source:      # tokenizing is most of a file's cost
            sups.extend(scan_suppressions(rel, source))
    for mod in modules:
        for chk in rules_pkg.file_checks():
            findings.extend(chk(mod))
    for chk in rules_pkg.repo_checks():
        findings.extend(chk(modules))
    out = apply_suppressions(findings, sups,
                             known_rules=set(rule_docs()))
    if only_rules is not None:
        # post-filter: suppression resolution always runs over the full
        # rule set (so staleness is judged against reality), then the
        # caller's rule subset selects what to report
        only = tuple(only_rules)
        out = [f for f in out
               if any(f.rule == r or f.rule.startswith(r + "-")
                      for r in only)]
    return out
