"""Rule ``DEAD_STORE`` — assignment overwritten before any use.

A copy of ``repro.analysis.rules.dead_store``; the bug class it catches
shipped in the reference's ``repro/kernels/ops.py``::

    ii2p = _pad_to(ii2, 1, 1)      # dead: overwritten two lines later
    ...
    ii2p = jnp.pad(ii2, ...)

Neither pyflakes nor ruff's stable rule set flags a plain local that is
re-assigned before being read (F841 only fires on bindings never used at
all; PLW0127/PLW0128 only cover self-/same-statement assignment), so
this rule fills exactly that gap: ruff owns never-used and
self-assignment, this rule owns overwritten-before-use.

The rule is deliberately conservative — it only reports when the two
assignments are *siblings* in the same statement list and no statement in
between (walked recursively, so nested uses count) reads, deletes, or
re-binds-with-use the name.  ``_``-prefixed names and
``global``/``nonlocal`` names are exempt.
"""

from __future__ import annotations

import ast

from ..core import Finding, Rule, SourceFile, register


def _simple_target(stmt: ast.stmt) -> str | None:
    """Name assigned by a simple single-target assignment, else None."""
    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
            and isinstance(stmt.targets[0], ast.Name):
        return stmt.targets[0].id
    if isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
            and isinstance(stmt.target, ast.Name):
        return stmt.target.id
    return None


def _reads(node: ast.AST, name: str) -> bool:
    """Does ``node`` (walked recursively) read, delete, or otherwise touch
    ``name`` in any way that makes the earlier binding observable?  A
    ``break``/``continue`` anywhere in between also counts: inside a loop
    body it can skip the overwrite, leaving the earlier binding live for
    the next iteration or the code after the loop (conservative — value
    expressions can never contain them, so this only suppresses reports)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id == name and \
                not isinstance(sub.ctx, ast.Store):
            return True
        if isinstance(sub, (ast.Global, ast.Nonlocal)) and name in sub.names:
            return True
        if isinstance(sub, ast.AugAssign) and \
                isinstance(sub.target, ast.Name) and sub.target.id == name:
            return True
        if isinstance(sub, (ast.Break, ast.Continue)):
            return True
    return False


def _scoped_out(body: list[ast.stmt], name: str) -> bool:
    """True if any statement in the body declares ``name`` global/nonlocal
    (then the store is observable outside this scope)."""
    return any(isinstance(s, (ast.Global, ast.Nonlocal)) and name in s.names
               for s in body)


@register
class DeadStoreRule(Rule):
    id = "DEAD_STORE"
    summary = ("assignment overwritten before any use (the ops.py "
               "`ii2p = _pad_to(...)` bug class)")
    include_tests = True

    def check(self, src: SourceFile, project) -> list[Finding]:
        findings: list[Finding] = []
        self._check_body(src.tree.body, src, findings)
        return findings

    def _check_body(self, body: list[ast.stmt], src: SourceFile,
                    findings: list[Finding]) -> None:
        last_assign: dict[str, int] = {}
        for i, stmt in enumerate(body):
            name = _simple_target(stmt)
            if name is not None and not name.startswith("_") \
                    and name in last_assign and not _scoped_out(body, name):
                j = last_assign[name]
                between = body[j + 1:i]
                value = stmt.value
                if not any(_reads(s, name) for s in between) and \
                        not (value is not None and _reads(value, name)):
                    findings.append(Finding(
                        src.rel, body[j].lineno, body[j].col_offset + 1,
                        self.id,
                        f"`{name}` assigned but overwritten at line "
                        f"{stmt.lineno} before any use"))
            if name is not None:
                last_assign[name] = i
            else:
                # compound/attribute/tuple targets and any other statement
                # that stores the name (for/with/try as targets, nested
                # defs, ...) invalidate tracking for it (conservative)
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Name) and \
                            isinstance(sub.ctx, ast.Store):
                        last_assign.pop(sub.id, None)

        # recurse into nested statement lists (new straight-line blocks)
        for stmt in body:
            for field in ("body", "orelse", "finalbody"):
                sub_body = getattr(stmt, field, None)
                if sub_body:
                    self._check_body(sub_body, src, findings)
            for handler in getattr(stmt, "handlers", []) or []:
                self._check_body(handler.body, src, findings)
