"""Core types of the port's static-analysis pass.

The framework is deliberately stdlib-only (``ast`` + ``re``): the pass
must run on a fresh checkout before any third-party dependency is
installed, and must never import the runtime packages it analyses (a
broken ``repro_torch.core`` should not take the linter down with it, and
importing ``repro_torch.launch.dryrun`` starts a fake process group).
It keeps its own copy of everything it shares with ``repro.analysis``.

Three ideas, one file:

- :class:`Finding` — one diagnostic, anchored at (path, line, col).
- :class:`SourceFile` — a parsed file plus its suppression comments
  (``# repro_torch: ignore[RULE] justification``; the reference gate's
  ``# repro: ignore[...]`` marker is not one, so each gate sees only its
  own suppressions).  A suppression on a code
  line covers that line; a suppression on a comment-only line covers the
  next line.  Suppressions *require* justification text — an empty
  reason is itself a finding (rule ``SUPPRESS``).
- :class:`Rule` + the registry — rules self-register via
  :func:`register`; the engine (:mod:`repro_torch.analysis.engine`) iterates
  the registry, so adding a rule is one module with one class.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["MARKER", "Finding", "Suppression", "SourceFile", "Rule",
           "RULES", "register", "rule_ids"]

# suppression comment syntax: hash, then "repro_torch:", then
# "ignore[RULE_A, RULE_B]", then the (mandatory) justification text
MARKER = "repro_torch:"
_SUPPRESS_RE = re.compile(
    r"#\s*repro_torch:\s*ignore\[([A-Za-z0-9_*,\s]*)\]\s*(.*)$")


@dataclass(frozen=True, order=True)
class Finding:
    """One diagnostic.  ``path`` is repo-root-relative (posix)."""
    path: str
    line: int
    col: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def as_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "col": self.col,
                "rule": self.rule, "message": self.message}


@dataclass
class Suppression:
    """One ``# repro_torch: ignore[...]`` comment."""
    line: int                 # line the comment sits on
    applies_to: int           # line whose findings it suppresses
    rules: tuple[str, ...]    # rule ids named in the brackets ("*" = all)
    justification: str
    used: bool = False

    def covers(self, rule: str) -> bool:
        return "*" in self.rules or rule in self.rules


@dataclass
class SourceFile:
    """A parsed source file: AST + raw lines + suppression comments."""
    path: Path                       # absolute
    rel: str                         # repo-root-relative posix path
    text: str
    tree: ast.Module
    is_test: bool
    module: str | None = None        # dotted module name when under src/
    suppressions: dict[int, list[Suppression]] = field(default_factory=dict)

    @classmethod
    def load(cls, path: Path, rel: str, module: str | None = None
             ) -> "SourceFile | None":
        try:
            text = path.read_text()
            tree = ast.parse(text, filename=str(path))
        except (OSError, SyntaxError, ValueError):
            return None              # ruff owns syntax errors; skip the file
        name = path.name
        parts = rel.split("/")
        # fixture files are *inputs* to the analyzer's own tests — every
        # rule must run on them, so they do not count as tests
        in_fixtures = "fixtures" in parts
        is_test = not in_fixtures and (
            parts[0] == "tests"
            or name.startswith("test_") or name == "conftest.py")
        src = cls(path, rel, text, tree, is_test, module)
        src._scan_suppressions()
        return src

    def _scan_suppressions(self) -> None:
        if MARKER not in self.text:      # fast path: nothing to tokenize
            return
        # tokenize, not a line regex: the marker quoted inside a docstring
        # (e.g. this framework's own docs) is not a suppression
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.text).readline))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return
        lines = self.text.splitlines()
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rules = tuple(r.strip() for r in m.group(1).split(",")
                          if r.strip())
            i = tok.start[0]
            # a comment-only line shields the *next* line (the common shape
            # for statements too long to carry a trailing comment)
            code = lines[i - 1][:tok.start[1]].strip()
            target = i if code else i + 1
            sup = Suppression(i, target, rules, m.group(2).strip())
            self.suppressions.setdefault(target, []).append(sup)

    def suppression_for(self, line: int, rule: str) -> Suppression | None:
        for sup in self.suppressions.get(line, ()):
            if sup.covers(rule):
                return sup
        return None


class Rule:
    """Base class: subclasses set the class attributes and implement
    :meth:`check` (scope ``"file"``, called once per file) or
    :meth:`check_project` (scope ``"project"``, called once per run with
    the whole file set — for cross-file contracts).
    """

    id: str = ""
    summary: str = ""                # one line, shown by --list-rules
    scope: str = "file"              # "file" | "project"
    include_tests: bool = False      # file-scope: also run on tests/

    def check(self, src: SourceFile, project) -> list[Finding]:
        return []

    def check_project(self, project) -> list[Finding]:
        return []


RULES: dict[str, Rule] = {}


def register(cls: type[Rule]) -> type[Rule]:
    """Class decorator: instantiate and add to the registry."""
    rule = cls()
    assert rule.id and rule.id not in RULES, rule.id
    RULES[rule.id] = rule
    return cls


def rule_ids() -> tuple[str, ...]:
    return tuple(sorted(RULES))
