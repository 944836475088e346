"""Reporters + baseline filtering for the analysis CLI.

Two output forms: the human one (``path:line:col: RULE message``, one per
line, ruff-style) and a versioned JSON document (``--json``).

A *baseline* is simply a previous run's JSON report: ``--baseline old.json``
drops findings already present there (matched on (rule, path, message) —
line numbers drift too easily to key on), so the pass can be adopted on a
tree with known debt and still fail CI on anything *new*.
"""

from __future__ import annotations

import json
from pathlib import Path

from .engine import AnalysisResult
from .core import Finding

__all__ = ["render_text", "write_json", "load_baseline", "apply_baseline"]


def render_text(result: AnalysisResult, show_suppressed: bool = False) -> str:
    lines = [f.render() for f in result.findings]
    if show_suppressed:
        lines += [f"{f.render()}  [suppressed]" for f in result.suppressed]
    n = len(result.findings)
    tail = (f"repro_torch.analysis: {n} finding(s)"
            f" ({len(result.suppressed)} suppressed)"
            f" across {result.n_files} files"
            f" in {result.seconds:.2f}s")
    lines.append(tail if n
                 else f"repro_torch.analysis OK — {tail.split(': ')[1]}")
    return "\n".join(lines)


def write_json(result: AnalysisResult, path: str | Path) -> None:
    Path(path).write_text(json.dumps(result.as_dict(), indent=2) + "\n")


def load_baseline(path: str | Path) -> set[tuple[str, str, str]]:
    doc = json.loads(Path(path).read_text())
    return {(f["rule"], f["path"], f["message"])
            for f in doc.get("findings", [])}


def apply_baseline(result: AnalysisResult,
                   baseline: set[tuple[str, str, str]]) -> int:
    """Drop baselined findings in place; returns how many were dropped."""
    keep: list[Finding] = []
    dropped = 0
    for f in result.findings:
        if (f.rule, f.path, f.message) in baseline:
            dropped += 1
        else:
            keep.append(f)
    result.findings = keep
    return dropped
