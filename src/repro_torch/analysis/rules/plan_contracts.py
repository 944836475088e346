"""Plan-IR contract rules.

The :mod:`repro_torch.plan` compiler is, as in the reference, the *only*
place pyramid geometry, segmentation, capacity ladders, and tail-backend
decisions are computed; the engines are thin executors over the typed IR.
These rules keep that true statically:

- ``TAIL_BACKEND``: every tail-backend string literal (keyword arguments
  named ``tail_backend``/``backend``, and ``== "..."`` comparisons
  against ``*backend`` names) must come from the single allowed set —
  ``repro_torch.kernels.packed_tail.BACKENDS`` plus ``"auto"``.  A typo
  like ``"pallass"`` otherwise only explodes at runtime, deep inside an
  executor.  Tests are checked too: a deliberately bad literal belongs in
  a fixture or a temporary file.
- ``PLAN_GEOMETRY``: constructing the IR types (``SegmentPlan``,
  ``SlotLayout``, ``CascadePlan``, ...) anywhere outside
  ``src/repro_torch/plan/`` is hand-rolled geometry — it must go through
  ``compile_plan`` / ``compile_level_plan``.
- ``LANE_BLOCK``: a literal ``(8, 128)`` anywhere but
  ``src/repro_torch/kernels/autotune.py`` hardcodes the lane-block /
  tile shape.  The autotuner module is the single home of
  ``DEFAULT_TILE`` and the candidate tables it races; every other file —
  kernels included — imports from that table or reads the tuned shape
  off the compiled plan (``plan.head_tile`` / ``plan.lane_block``).
"""

from __future__ import annotations

import ast

from ..core import Finding, Rule, SourceFile, register

# fallback when repro_torch.kernels.packed_tail is outside the scanned set
_DEFAULT_BACKENDS = ("gather", "bulk", "pallas")
_BACKENDS_MODULE = "repro_torch.kernels.packed_tail"

_IR_TYPES = ("CascadePlan", "LevelWavePlan", "LevelPlan", "SegmentPlan",
             "SlotLayout", "StreamStatePlan")
# repro: ignore[LANE_BLOCK] the port rule's own definition of the flagged shape
_LANE_BLOCK = (8, 128)  # repro_torch: ignore[LANE_BLOCK] the rule's own flagged shape


def _call_name(func: ast.expr) -> str | None:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _in_dirs(rel: str, *prefixes: str) -> bool:
    return any(rel.startswith(p) for p in prefixes)


@register
class TailBackendRule(Rule):
    id = "TAIL_BACKEND"
    summary = ("tail-backend string literal outside the allowed set "
               "(kernels.packed_tail.BACKENDS + 'auto')")
    include_tests = True

    def _allowed(self, project) -> frozenset[str]:
        backends = project.constant_tuple(_BACKENDS_MODULE, "BACKENDS") \
            or _DEFAULT_BACKENDS
        return frozenset(backends) | {"auto"}

    def check(self, src: SourceFile, project) -> list[Finding]:
        allowed = self._allowed(project)
        findings = []

        def flag(node: ast.expr, value: str) -> None:
            findings.append(Finding(
                src.rel, node.lineno, node.col_offset + 1, self.id,
                f"backend literal {value!r} is not in the allowed set "
                f"{tuple(sorted(allowed))} "
                f"(from {_BACKENDS_MODULE}.BACKENDS)"))

        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg in ("tail_backend", "backend") \
                            and isinstance(kw.value, ast.Constant) \
                            and isinstance(kw.value.value, str) \
                            and kw.value.value not in allowed:
                        flag(kw.value, kw.value.value)
            elif isinstance(node, ast.Compare) and len(node.ops) == 1 \
                    and isinstance(node.ops[0], (ast.Eq, ast.NotEq)):
                sides = (node.left, node.comparators[0])
                names = [s for s in sides if isinstance(s, ast.Name)
                         and s.id.endswith("backend")] \
                    + [s for s in sides if isinstance(s, ast.Attribute)
                       and s.attr.endswith("backend")]
                lits = [s for s in sides if isinstance(s, ast.Constant)
                        and isinstance(s.value, str)]
                if names and lits and lits[0].value not in allowed:
                    flag(lits[0], lits[0].value)
        return findings


@register
class PlanGeometryRule(Rule):
    id = "PLAN_GEOMETRY"
    summary = ("plan-IR construction outside src/repro_torch/plan/ — go "
               "through compile_plan/compile_level_plan")

    def check(self, src: SourceFile, project) -> list[Finding]:
        if _in_dirs(src.rel, "src/repro_torch/plan/"):
            return []
        findings = []
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call):
                name = _call_name(node.func)
                if name in _IR_TYPES:
                    findings.append(Finding(
                        src.rel, node.lineno, node.col_offset + 1, self.id,
                        f"hand-rolled plan-IR construction `{name}(...)` "
                        f"outside src/repro_torch/plan/ — geometry must come "
                        f"from compile_plan/compile_level_plan"))
        return findings


@register
class LaneBlockRule(Rule):
    id = "LANE_BLOCK"
    summary = ("hardcoded (8, 128) lane-block/tile literal outside "
               "kernels/autotune.py")

    def check(self, src: SourceFile, project) -> list[Finding]:
        if src.rel == "src/repro_torch/kernels/autotune.py":
            return []      # the single home of the tile/candidate literals
        findings = []
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Tuple) \
                    and len(node.elts) == len(_LANE_BLOCK) \
                    and all(isinstance(e, ast.Constant) and e.value == v
                            for e, v in zip(node.elts, _LANE_BLOCK)):
                findings.append(Finding(
                    src.rel, node.lineno, node.col_offset + 1, self.id,
                    "hardcoded (8, 128) lane-block/tile shape — import "
                    "repro_torch.kernels.autotune's DEFAULT_TILE / candidate "
                    "tables (or read the tuned shape off the compiled "
                    "plan) instead"))
        return findings
