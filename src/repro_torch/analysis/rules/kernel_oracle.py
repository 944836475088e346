"""Kernel-twin coverage rules (cross-file).

Every hand-written kernel of the port is only trusted because a plain
PyTorch twin reproduces it (the ``*_ref`` functions in ``kernels/ref.py``
/ ``kernels/ops.py``) and tests race the two — on the CPU through the
wrappers' plain versions, on the card in ``tests/test_torch_cuda.py``.
That convention is the whole verification story — so it is enforced:

- ``KERNEL_REF_TWIN``: every public kernel wrapper of
  ``repro_torch.kernels.ops`` (its ``__all__``, minus the ``*_ref`` names
  themselves and the names ``ops`` re-exports from ``.native``, which
  are the launch counters, not kernels) must have a ``<name>_ref`` twin
  defined in ``repro_torch.kernels.ref`` or ``repro_torch.kernels.ops``.
- ``KERNEL_REF_TEST``: for each (kernel, twin) pair, at least one
  ``tests/test_torch_*.py`` file must reference *both* names — a twin
  nobody races the kernel against is dead weight, and a kernel nobody
  checks against its twin is unverified.

The ``tests/`` tree is located relative to the ``ops.py`` file itself
(the nearest ancestor holding a ``src`` directory), so fixture trees
that mirror the repo layout exercise the rule hermetically.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from ..core import Finding, Rule, SourceFile, register

_OPS_MODULE = "repro_torch.kernels.ops"
_REF_MODULE = "repro_torch.kernels.ref"
_NATIVE_MODULE = "repro_torch.kernels.native"
_TEST_GLOB = "**/test_torch_*.py"


def _public_names(src: SourceFile) -> dict[str, int]:
    """``__all__`` entries -> line of their def (fallback: module line 1);
    if no ``__all__``, every top-level non-underscore function."""
    def_lines = {stmt.name: stmt.lineno for stmt in src.tree.body
                 if isinstance(stmt, ast.FunctionDef)}
    for stmt in src.tree.body:
        if isinstance(stmt, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == "__all__"
                        for t in stmt.targets):
            try:
                names = ast.literal_eval(stmt.value)
            except (ValueError, SyntaxError):
                break
            return {n: def_lines.get(n, stmt.lineno) for n in names}
    return {n: ln for n, ln in def_lines.items() if not n.startswith("_")}


def _defined_names(src: SourceFile) -> set[str]:
    """Top-level defs + simple-name assignments (aliases count as twins)."""
    out = set()
    for stmt in src.tree.body:
        if isinstance(stmt, ast.FunctionDef):
            out.add(stmt.name)
        elif isinstance(stmt, ast.Assign):
            out.update(t.id for t in stmt.targets
                       if isinstance(t, ast.Name))
    return out


def _native_names(src: SourceFile) -> set[str]:
    """Names ``ops`` imports from the launch-counter module ``.native``."""
    out = set()
    for stmt in src.tree.body:
        if isinstance(stmt, ast.ImportFrom) and (
                (stmt.level == 1 and stmt.module == "native")
                or (stmt.level == 0 and stmt.module == _NATIVE_MODULE)):
            out.update(al.asname or al.name for al in stmt.names)
    return out


def kernel_pairs(ops: SourceFile, ref: SourceFile | None
                 ) -> list[tuple[str, str | None, int]]:
    """``(kernel, twin or None, line)`` for every public kernel wrapper of
    ``ops``, in name order; the twin is None when neither ``ops`` nor
    ``ref`` defines ``<kernel>_ref``."""
    twins = _defined_names(ops)
    if ref is not None:
        twins |= _defined_names(ref)
    skip = _native_names(ops)
    out = []
    for name, line in sorted(_public_names(ops).items()):
        if name.endswith("_ref") or name in skip:
            continue                 # a twin, or a launch counter
        twin = f"{name}_ref"
        out.append((name, twin if twin in twins else None, line))
    return out


def _tests_dir(ops_path: Path) -> Path | None:
    for anc in ops_path.parents:
        if (anc / "src").is_dir():
            t = anc / "tests"
            return t if t.is_dir() else None
    return None


@register
class KernelOracleRule(Rule):
    id = "KERNEL_REF_TWIN"
    summary = ("public kernel wrapper in kernels/ops.py without a "
               "*_ref twin in kernels/ref.py or ops.py")
    scope = "project"

    def check_project(self, project) -> list[Finding]:
        ops = project.modules.get(_OPS_MODULE)
        if ops is None:
            return []
        ref = project.modules.get(_REF_MODULE)
        return [Finding(ops.rel, line, 1, self.id,
                        f"public kernel `{name}` has no `{name}_ref` "
                        f"twin in {_REF_MODULE} or {_OPS_MODULE}")
                for name, twin, line in kernel_pairs(ops, ref)
                if twin is None]


@register
class KernelOracleTestRule(Rule):
    id = "KERNEL_REF_TEST"
    summary = ("kernel/twin pair never referenced together by any "
               "tests/test_torch_*.py file")
    scope = "project"

    def check_project(self, project) -> list[Finding]:
        ops = project.modules.get(_OPS_MODULE)
        if ops is None:
            return []
        ref = project.modules.get(_REF_MODULE)
        tests = _tests_dir(ops.path)
        if tests is None:
            return []
        test_texts = {p: p.read_text()
                      for p in sorted(tests.glob(_TEST_GLOB))
                      if "__pycache__" not in p.relative_to(tests).parts
                      and "fixtures" not in p.relative_to(tests).parts}
        findings = []
        for name, twin, line in kernel_pairs(ops, ref):
            if twin is None:
                continue             # KERNEL_REF_TWIN owns the missing case
            pat_k = re.compile(rf"\b{re.escape(name)}\b")
            pat_r = re.compile(rf"\b{re.escape(twin)}\b")
            # the kernel name is a prefix of the twin's, so only count
            # kernel mentions that are not actually the twin's
            if not any(pat_r.search(t)
                       and pat_k.search(re.sub(pat_r, "", t))
                       for t in test_texts.values()):
                findings.append(Finding(
                    ops.rel, line, 1, self.id,
                    f"no tests/test_torch_*.py file references both "
                    f"`{name}` and its twin `{twin}` — add a "
                    f"kernel-vs-twin test"))
        return findings
