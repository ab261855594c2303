"""Findings, rule ids and the suppression grammar of the port's audit,
the port's own copy of dtdl_tpu/analysis/findings.py.

Every check in :mod:`dtdl_tpu_torch.analysis` (the AST linter, lint.py,
and the program audit, program_audit.py) reports through one currency: a
:class:`Finding` with a stable kebab-case ``rule`` id, a location and a
one-line message.  Rule ids are the contract surface: tests assert on
them, suppressions name them, and the gate (``python -m
dtdl_tpu_torch.analysis``) exits non-zero on any finding that no
suppression covers.

**Suppression grammar.**  A finding on line N is suppressed by a comment
on line N or line N-1 of the form::

    # audit: ok[rule-id] one-line justification

The justification is mandatory: a suppression without a reason is itself
a finding (``suppress-no-reason``), and a suppression that matches no
finding is flagged stale (``suppress-stale``), so dead annotations cannot
pile up after the code they excused is gone.  ``rule-id`` may be a full id
(``host-sync-item``) or a prefix group (``host-sync``): the prefix covers
every rule of the group, for lines that trip several sibling patterns.
"""

from __future__ import annotations

import dataclasses
import re

#: the one suppression spelling; groups: rule id, justification
SUPPRESS_RE = re.compile(
    r"#\s*audit:\s*ok\[(?P<rule>[a-z0-9-]+)\]\s*(?P<reason>.*)$")

#: rule ids of the suppression machinery itself (never suppressible)
META_RULES = ("suppress-no-reason", "suppress-stale", "suppress-unknown")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one location.

    ``rule`` is the stable id (``lint.rule_docs()`` is the catalog);
    ``path`` is repo-relative where possible (a program's name for a
    program-audit finding); ``line`` is 1-based (0 for whole-file or
    whole-program findings); ``message`` is the one-line diagnosis.
    ``detail`` carries optional machine-readable context (e.g. the census
    field a drift came from).
    """

    rule: str
    path: str
    line: int
    message: str
    detail: dict | None = dataclasses.field(default=None, compare=False)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.message}"


@dataclasses.dataclass(frozen=True)
class Suppression:
    """One ``# audit: ok[rule] reason`` annotation in a source file."""

    rule: str
    path: str
    line: int
    reason: str

    def covers(self, finding: Finding) -> bool:
        """A suppression covers findings of its rule (or rule-group
        prefix) on its own line or the line directly below it — the
        comment-above-the-statement idiom."""
        if finding.path != self.path:
            return False
        if finding.line not in (self.line, self.line + 1):
            return False
        return (finding.rule == self.rule
                or finding.rule.startswith(self.rule + "-"))


def scan_suppressions(path: str, source: str) -> list[Suppression]:
    """All suppression annotations in ``source`` (1-based lines).

    Tokenizes so only real ``#`` comments count — a docstring that
    *describes* the suppression syntax (this module's does) is not a
    suppression."""
    import io
    import tokenize

    out = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = SUPPRESS_RE.search(tok.string)
            if m:
                out.append(Suppression(
                    rule=m.group("rule"), path=path, line=tok.start[0],
                    reason=m.group("reason").strip()))
    except tokenize.TokenError:    # pragma: no cover - truncated file
        pass
    return out


def apply_suppressions(findings: list[Finding],
                       sups: list[Suppression],
                       known_rules=None) -> list[Finding]:
    """Resolve suppressions against findings.

    Returns the surviving findings: unsuppressed originals, plus the
    meta-findings of the suppression machinery — a reason-less
    suppression, a stale one (covers nothing), and (when
    ``known_rules`` is given) one naming a rule id that does not exist,
    which would otherwise silently suppress nothing forever.
    """
    out = []
    used: set[Suppression] = set()
    for f in findings:
        hit = next((s for s in sups if s.covers(f)), None)
        if hit is None:
            out.append(f)
        else:
            used.add(hit)
    for s in sups:
        if not s.reason:
            out.append(Finding("suppress-no-reason", s.path, s.line,
                               f"suppression of [{s.rule}] carries no "
                               f"justification"))
        if known_rules is not None and s.rule not in known_rules and \
                not any(r.startswith(s.rule + "-") for r in known_rules):
            out.append(Finding("suppress-unknown", s.path, s.line,
                               f"suppression names unknown rule "
                               f"[{s.rule}]"))
        elif s not in used:
            out.append(Finding("suppress-stale", s.path, s.line,
                               f"suppression of [{s.rule}] matches no "
                               f"finding — remove it"))
    return out


def render_report(findings: list[Finding], *, header: str = "") -> str:
    """Human report: findings grouped by rule, stable order."""
    lines = []
    if header:
        lines.append(header)
    by_rule: dict[str, list[Finding]] = {}
    for f in findings:
        by_rule.setdefault(f.rule, []).append(f)
    for rule in sorted(by_rule):
        lines.append(f"[{rule}] x{len(by_rule[rule])}")
        for f in sorted(by_rule[rule], key=lambda f: (f.path, f.line)):
            lines.append("  " + f.render())
    return "\n".join(lines)
