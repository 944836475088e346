"""Rule ``DEPRECATED_SURFACE`` — internal use of the deprecated serving
surfaces.

The port's service keeps the reference's two compatibility shims, each
behind a ``DeprecationWarning``: legacy keyword construction
(``DetectorService(det, pods=..., ...)`` instead of a
:class:`~repro_torch.serve.detector_service.ServiceConfig`) and dict-key
access to the typed stats (``svc.stats()["energy"]`` instead of
``svc.stats().energy``).  The port's own code (its package, examples,
scripts and ``chip_smoke.py``) must not lean on them — that is how a
deprecation quietly becomes permanent.  Tests are exempt via the engine
(they pin the shims' behaviour until removal).
"""

from __future__ import annotations

import ast

from ..core import Finding, Rule, SourceFile, register

# the module that defines the shims is allowed to mention them
_SHIM_MODULES = ("repro_torch.serve.detector_service",
                 "repro_torch.serve.stats")


@register
class DeprecatedSurfaceRule(Rule):
    id = "DEPRECATED_SURFACE"
    summary = ("internal use of deprecated serving surfaces (legacy "
               "DetectorService kwargs, dict-style stats()[...] access)")

    def check(self, src: SourceFile, project) -> list[Finding]:
        if src.module in _SHIM_MODULES:
            return []
        findings: list[Finding] = []
        # names bound (anywhere in the file) to a `.stats()` call result;
        # scope-insensitive on purpose: a false *miss* is worse than the
        # rare shadowed name, and `stats`-named locals that are not
        # service stats are plain lists/dicts nobody subscripts via shim
        stats_names: set[str] = set()
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Assign) and _is_stats_call(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        stats_names.add(tgt.id)
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Subscript):
                base = node.value
                direct = _is_stats_call(base)
                via_name = (isinstance(base, ast.Name)
                            and base.id in stats_names)
                if direct or via_name:
                    findings.append(Finding(
                        src.rel, node.lineno, node.col_offset + 1, self.id,
                        "dict-style stats()[...] access is deprecated "
                        "internally — use the typed fields "
                        "(stats().energy, stats().tail, ...)"))
            elif isinstance(node, ast.Call):
                name = node.func.id if isinstance(node.func, ast.Name) \
                    else (node.func.attr
                          if isinstance(node.func, ast.Attribute) else None)
                if name == "DetectorService":
                    legacy = [kw.arg for kw in node.keywords
                              if kw.arg not in (None, "config")]
                    if legacy:
                        findings.append(Finding(
                            src.rel, node.lineno, node.col_offset + 1,
                            self.id,
                            f"legacy DetectorService keyword(s) "
                            f"{legacy} are deprecated — pass "
                            f"DetectorService(det, ServiceConfig(...))"))
        return findings


def _is_stats_call(node: ast.expr) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "stats"
            and not node.args and not node.keywords)
