"""Project model: the file set one analysis run sees, plus the cheap
cross-file lookups rules need (module names, top-level symbol tables,
import resolution).

Module naming is derived from each file's own path — the segment after a
``src/`` directory becomes the dotted module name
(``src/repro_torch/plan/ir.py`` -> ``repro_torch.plan.ir``) — so fixture
trees that mirror the repo layout
(``tests/fixtures/torch_analysis/.../src/repro_torch/kernels/ops.py``)
resolve exactly like the real tree and cross-file rules can be
unit-tested in isolation.

:func:`default_paths` is the port's tree, which a run with no paths scans.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

from .core import SourceFile

__all__ = ["Project", "ModuleSymbols", "default_paths"]

# directories never walked when a *directory* is scanned (explicitly named
# files are always analysed — that is how the fixture tests drive rules
# over deliberately-violating snippets)
_SKIP_DIRS = {"__pycache__", "fixtures", ".git", ".venv", "node_modules"}

# the port's tree: its package, its tests, examples and scripts, and the
# card's smoke script (globs relative to the repository root)
DEFAULT_GLOBS = ("src/repro_torch", "tests/test_torch_*.py",
                 "examples/torch_*.py", "scripts/port_*.py", "chip_smoke.py")


def default_paths(root: str | Path = ".") -> list[Path]:
    """The files and directories of :data:`DEFAULT_GLOBS` under ``root``
    that exist, in glob order."""
    root = Path(root)
    out: list[Path] = []
    for pattern in DEFAULT_GLOBS:
        out.extend(sorted(root.glob(pattern)))
    return out


def _module_name(path: Path) -> str | None:
    """Dotted module name for a file under a ``src/`` root, else None."""
    parts = path.parts
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "src":
            mod = list(parts[i + 1:])
            if not mod:
                return None
            mod[-1] = mod[-1][:-3] if mod[-1].endswith(".py") else mod[-1]
            if mod[-1] == "__init__":
                mod = mod[:-1]
            return ".".join(mod) if mod else None
    return None


def _project_root(path: Path) -> Path:
    """Nearest ancestor that looks like a repo root (has ``src``), else the
    file's own directory."""
    for anc in path.parents:
        if (anc / "src").is_dir():
            return anc
    return path.parent


@dataclass
class ModuleSymbols:
    """Top-level bindings of one module (functions, classes, constants)."""
    src: SourceFile
    functions: dict[str, ast.FunctionDef] = field(default_factory=dict)
    classes: dict[str, ast.ClassDef] = field(default_factory=dict)
    constants: dict[str, ast.expr] = field(default_factory=dict)
    # import alias -> dotted module ("import x.y as z", "from a import mod")
    module_aliases: dict[str, str] = field(default_factory=dict)
    # imported name -> (module, original name) ("from a.b import f as g")
    imported: dict[str, tuple[str, str]] = field(default_factory=dict)

    @classmethod
    def build(cls, src: SourceFile) -> "ModuleSymbols":
        ms = cls(src)
        pkg = (src.module or "").rsplit(".", 1)[0] if src.module else ""
        for stmt in src.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ms.functions[stmt.name] = stmt
            elif isinstance(stmt, ast.ClassDef):
                ms.classes[stmt.name] = stmt
            elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                ms.constants[stmt.targets[0].id] = stmt.value
            elif isinstance(stmt, ast.Import):
                for al in stmt.names:
                    ms.module_aliases[al.asname or al.name.split(".")[0]] = \
                        al.name
            elif isinstance(stmt, ast.ImportFrom):
                base = stmt.module or ""
                if stmt.level:        # relative import -> anchor on package
                    up = pkg.split(".") if pkg else []
                    up = up[:len(up) - (stmt.level - 1)] if stmt.level > 1 \
                        else up
                    base = ".".join(up + ([stmt.module] if stmt.module
                                          else []))
                for al in stmt.names:
                    name = al.asname or al.name
                    ms.imported[name] = (base, al.name)
                    ms.module_aliases.setdefault(name,
                                                 f"{base}.{al.name}")
        return ms


class Project:
    """The analysed file set plus cross-file lookup tables."""

    def __init__(self, files: list[SourceFile], root: Path):
        self.files = files
        self.root = root
        self.by_rel: dict[str, SourceFile] = {f.rel: f for f in files}
        self.modules: dict[str, SourceFile] = {
            f.module: f for f in files if f.module}
        self._symbols: dict[str, ModuleSymbols] = {}

    @classmethod
    def load(cls, paths: list[str | Path]) -> "Project":
        seen: dict[Path, None] = {}
        for p in paths:
            p = Path(p).resolve()
            if p.is_dir():
                for f in sorted(p.rglob("*.py")):
                    if not _SKIP_DIRS.intersection(f.relative_to(p).parts):
                        seen.setdefault(f, None)
            elif p.suffix == ".py":
                seen.setdefault(p, None)
        root = _project_root(next(iter(seen))) if seen else Path.cwd()
        files = []
        for f in seen:
            try:
                rel = f.relative_to(root).as_posix()
            except ValueError:
                rel = f.as_posix()
            src = SourceFile.load(f, rel, _module_name(f))
            if src is not None:
                files.append(src)
        return cls(files, root)

    # ------------------------------------------------------------- lookups
    def symbols(self, module: str) -> ModuleSymbols | None:
        """Symbol table of a scanned module (cached), else None."""
        if module not in self.modules:
            return None
        if module not in self._symbols:
            self._symbols[module] = ModuleSymbols.build(self.modules[module])
        return self._symbols[module]

    def symbols_for(self, src: SourceFile) -> ModuleSymbols:
        if src.module and src.module in self.modules:
            return self.symbols(src.module)          # type: ignore[return-value]
        key = f"<file:{src.rel}>"
        if key not in self._symbols:
            self._symbols[key] = ModuleSymbols.build(src)
        return self._symbols[key]

    def constant_tuple(self, module: str, name: str) -> tuple | None:
        """Literal tuple/list constant ``name`` from ``module`` (e.g. the
        packed-tail ``BACKENDS`` allow-set), else None."""
        ms = self.symbols(module)
        if ms is None or name not in ms.constants:
            return None
        try:
            val = ast.literal_eval(ms.constants[name])
        except (ValueError, SyntaxError):
            return None
        return tuple(val) if isinstance(val, (tuple, list)) else None
