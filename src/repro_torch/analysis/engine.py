"""Run the rule registry over a :class:`~repro_torch.analysis.project.Project`.

The engine owns suppression semantics: a rule reports *every* violation;
the engine then splits findings into active vs suppressed against each
file's ``# repro_torch: ignore[RULE] why`` comments, and emits the
``SUPPRESS`` meta-findings (unknown rule id in the brackets, ``*`` in
place of a rule id, missing justification text) so a suppression can
never silently rot or silence more than it names.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from .core import RULES, Finding, Rule, SourceFile
from .project import Project

__all__ = ["AnalysisResult", "run_analysis"]

SUPPRESS_RULE = "SUPPRESS"


@dataclass
class AnalysisResult:
    findings: list[Finding] = field(default_factory=list)    # active
    suppressed: list[Finding] = field(default_factory=list)
    n_files: int = 0
    seconds: float = 0.0

    @property
    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def as_dict(self) -> dict:
        return {"version": 1,
                "files": self.n_files,
                "seconds": round(self.seconds, 3),
                "counts": self.counts,
                "findings": [f.as_dict() for f in self.findings],
                "suppressed": [f.as_dict() for f in self.suppressed]}


def _select_rules(select: list[str] | None) -> list[Rule]:
    if not select:
        return list(RULES.values())
    unknown = [r for r in select if r not in RULES]
    if unknown:
        raise ValueError(f"unknown rule id(s): {', '.join(unknown)} "
                         f"(known: {', '.join(sorted(RULES))})")
    return [RULES[r] for r in select]


def _suppression_findings(src: SourceFile) -> list[Finding]:
    out = []
    for sups in src.suppressions.values():
        for sup in sups:
            bad = [r for r in sup.rules
                   if r != "*" and r != SUPPRESS_RULE and r not in RULES]
            if not sup.rules:
                out.append(Finding(src.rel, sup.line, 1, SUPPRESS_RULE,
                                   "suppression names no rule: use "
                                   "`# repro_torch: ignore[RULE] reason`"))
            if "*" in sup.rules:
                out.append(Finding(src.rel, sup.line, 1, SUPPRESS_RULE,
                                   "suppression names `*`: name each "
                                   "rule it silences"))
            for r in bad:
                out.append(Finding(src.rel, sup.line, 1, SUPPRESS_RULE,
                                   f"suppression names unknown rule "
                                   f"{r!r} (known: "
                                   f"{', '.join(sorted(RULES))})"))
            if not sup.justification:
                out.append(Finding(
                    src.rel, sup.line, 1, SUPPRESS_RULE,
                    "suppression has no justification text: every "
                    "`# repro_torch: ignore[...]` must say why the "
                    "finding is acceptable"))
    return out


def run_analysis(paths: list, select: list[str] | None = None
                 ) -> AnalysisResult:
    """Analyse ``paths`` (files and/or directory trees) with the selected
    rules (default: all registered)."""
    from . import rules as _rules            # noqa: F401  (registers rules)
    t0 = time.perf_counter()
    project = Project.load(paths)
    rules = _select_rules(select)

    raw: list[Finding] = []
    for rule in rules:
        if rule.scope == "project":
            raw.extend(rule.check_project(project))
            continue
        for src in project.files:
            if src.is_test and not rule.include_tests:
                continue
            raw.extend(rule.check(src, project))

    result = AnalysisResult(n_files=len(project.files))
    for f in sorted(raw):
        src = project.by_rel.get(f.path)
        sup = src.suppression_for(f.line, f.rule) if src else None
        if sup is not None:
            sup.used = True
            result.suppressed.append(f)
        else:
            result.findings.append(f)

    # meta-rule: malformed suppressions are findings themselves (and are
    # not suppressible — a bad suppression must be fixed, not hidden)
    if select is None or SUPPRESS_RULE in select:
        for src in project.files:
            result.findings.extend(_suppression_findings(src))
    result.findings.sort()
    result.seconds = time.perf_counter() - t0
    return result
