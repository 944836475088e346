"""Trace-safety rules: host-Python control flow on tensor values in the
port's programs, and the port's cache hazards.

The reference keeps single/batch/stream bit-identical by compiling *pure*
programs under ``jax.jit`` and ``pallas_call``.  The port runs the same
programs eagerly, so nothing raises when one of them branches on a
tensor's value: on the card a host ``if`` on a tensor, ``.item()``,
``.tolist()``, ``.cpu()`` or ``bool()`` is a device-to-host sync that
stalls the launch queue, and under the dry run's ``FakeTensorMode``
(``repro_torch.launch.dryrun``) it raises.  These rules find them
statically.

``TRACE_BRANCH`` / ``TRACE_CONCRETE`` implement a small interprocedural
taint pass over the scanned file set:

1. *Roots*: the functions of :data:`ROOTS` — one row per ``jax.jit`` /
   ``pallas_call`` site of the reference, naming the port function that
   does that site's work and which of its parameters carry per-call
   tensors — and the ``forward`` / ``backward`` bodies of every
   ``torch.autograd.Function`` subclass (``backward``'s gradients; of
   ``forward``'s arguments, those whose gradient slot in ``backward``'s
   return is not a literal ``None``).
2. *Propagation*: taint flows through assignments and into callees the
   pass can resolve (same scope chain, module level, ``from x import y``
   and module attributes within the scanned set, ``self.method``, names
   bound to ``functools.partial(f, ...)`` or to a factory call that
   returns a nested def, ``torch.utils.checkpoint.checkpoint(f, ...)``
   and ``shard_map(f, ...)(...)``).  Static projections break taint:
   ``.shape``/``.ndim``/``.dtype``/``.device``/``.is_cuda``/``.size()``/
   ``.dim()``/``.numel()``/``.stride()`` and the other metadata reads of
   :data:`_STATIC_ATTRS`, ``len()``, ``isinstance()``, ``x is None``.
3. *Findings*: host branches (``if``/``while``/``assert``/ternary) on
   tainted tests, and concretizing calls on tainted values.

``JIT_CACHE`` is a companion pattern rule over the port's two caches:
``torch.compile`` called inside a loop or applied to a lambda that is
invoked inline (a fresh compiled callable, and a recompile, per call),
and a kernel handle ``native.Kernel(...)`` built anywhere but at a
module's top level (the handle registers itself in ``native.KERNELS`` by
its source's stem and holds the resolved symbol and the launch count;
built per call, it resets both).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import NamedTuple

from ..core import Finding, Rule, SourceFile, register

__all__ = ["Root", "ROOTS", "resolve_qualname"]

_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "size",
                 "dim", "numel", "stride", "sharding", "name",
                 # a DTensor's layout (the reference's `.sharding`)
                 "placements", "device_mesh",
                 # metadata reads that touch no element either
                 "is_contiguous", "data_ptr", "element_size", "itemsize",
                 "is_floating_point", "is_complex", "requires_grad",
                 "layout", "nbytes", "storage_offset", "get_device"}
_STATIC_FUNCS = {"len", "isinstance", "type", "range", "enumerate",
                 "hasattr", "getattr", "id", "repr", "str", "print"}
_CONCRETIZE_FUNCS = {"bool", "int", "float", "complex"}
_CONCRETIZE_METHODS = {"item", "tolist", "cpu", "numpy", "__bool__",
                       "__float__"}
_NUMPY_CONCRETIZE = {"asarray", "array", "float32", "float64", "int32",
                     "int64"}
_PARTIAL = ("functools.partial", "partial")
_CHECKPOINT = ("torch.utils.checkpoint.checkpoint", "checkpoint")
_FUNCTION_BASES = ("torch.autograd.Function",
                   "torch.autograd.function.Function")
_MAX_DEPTH = 12                      # nested-def inline analysis guard


# ----------------------------------------------------------------- roots
class Root(NamedTuple):
    """One reference ``jax.jit`` / ``pallas_call`` site and the port's
    counterpart.  ``targets`` are ``"module:Qual.name"`` strings (a
    nested def is named through its enclosing defs and classes); every
    def of that qualified name is a root (a name defined in both arms of
    an ``if`` is two defs).  ``traced`` are the parameters that carry the
    per-call tensors (the detector's cascade and a model's config are
    per-program constants, as the reference's factories close over them).
    ``why`` says which of the port's functions the row names."""
    site: str
    targets: tuple[str, ...]
    traced: tuple[str, ...]
    why: str


_ENGINE = "repro_torch.core.engine:Detector"
_STREAM = "repro_torch.stream.engine:StreamEngine"
_OPS = "repro_torch.kernels.ops"
_CELL_STEPS = ("repro_torch.launch.cells:build_cell.train_fn",
               "repro_torch.launch.cells:build_cell.prefill_fn",
               "repro_torch.launch.cells:build_cell.decode_fn")
_CELL_TRACED = ("state", "batch", "params", "tokens", "token", "cache",
                "prefix_embeds")
_TAIL_LANES = ("ii_flat", "img", "base", "stride", "ys", "xs", "inv_sigma",
               "n_live")

ROOTS: tuple[Root, ...] = (
    Root("src/repro/core/engine.py:321",
         (f"{_ENGINE}._build_level_fn.level_fn",), ("img", "limits"),
         "the level program detect runs over a (B, h, w) stack"),
    Root("src/repro/core/engine.py:328",
         (f"{_ENGINE}._build_level_fn.level_fn",), ("img", "limits"),
         "the port's level program takes the batch axis itself, so the "
         "reference's vmapped copy is the same function"),
    Root("src/repro/core/engine.py:567",
         (f"{_ENGINE}._build_batch_fn.head_fn",
          f"{_ENGINE}._build_batch_fn.tail_fn"),
         ("stack", "valid_hw", "alive_flat", "inv_flat", "ii_flat",
          "counts"),
         "the packed batch program, split into its head and tail halves"),
    Root("src/repro/core/features.py:78",
         ("repro_torch.core.features:run_cascade_windows",),
         ("ii", "ii_pair", "ys", "xs"),
         "the semantic reference over a window list"),
    Root("src/repro/core/training/adaboost.py:96",
         ("repro_torch.core.training.adaboost:_feature_values",),
         ("windows", "rect_xywh", "rect_w"),
         "normalized feature values, chunked over features"),
    Root("src/repro/core/training/adaboost.py:142",
         ("repro_torch.core.training.adaboost:_best_stump",),
         ("vals_sorted", "order", "w", "y"),
         "the weighted best stump, all on the inputs' device"),
    Root("src/repro/kernels/ops.py:48",
         (f"{_OPS}:integral_image",), ("img",), "kernel S's wrapper"),
    Root("src/repro/kernels/ops.py:65",
         (f"{_OPS}:window_inv_sigma_grid",), ("ii_pair",),
         "kernel D's wrapper"),
    Root("src/repro/kernels/ops.py:135",
         (f"{_OPS}:integral_image_batch",), ("imgs",),
         "kernel S's batch wrapper"),
    Root("src/repro/kernels/ops.py:152",
         (f"{_OPS}:window_inv_sigma_grid_batch",), ("ii_pairs",),
         "kernel D's batch wrapper"),
    Root("src/repro/kernels/ops.py:339",
         (f"{_OPS}:tile_change_mask",), ("prev", "cur"),
         "the stream's tile scoring"),
    Root("src/repro/kernels/ops.py:354",
         (f"{_OPS}:changed_window_map",),
         ("changed", "ty0", "ty1", "tx0", "tx1"),
         "the stream's changed-window map"),
    Root("src/repro/kernels/integral_image.py:93",
         ("repro_torch.kernels.integral_image:sat_tables",), ("imgs",),
         "kernel S's launch (its plain version on CPU tensors)"),
    Root("src/repro/kernels/autotune.py:125",
         ("repro_torch.kernels.autotune:measure_head.split_head",),
         ("img", "gy", "gx"), "the tuner's split head"),
    Root("src/repro/kernels/autotune.py:133",
         (f"{_OPS}:fused_head",), ("img",),
         "the tuner times ops.fused_head per candidate tile"),
    Root("src/repro/kernels/autotune.py:179",
         ("repro_torch.kernels.packed_tail:stage_sums",), _TAIL_LANES,
         "the tuner times packed_tail.stage_sums per lane block"),
    Root("src/repro/kernels/packed_tail.py:289",
         ("repro_torch.kernels.packed_tail:stage_sums",), _TAIL_LANES,
         "the backend race times packed_tail.stage_sums per backend"),
    Root("src/repro/stream/engine.py:223",
         (f"{_STREAM}._build_fn.frame_fn",), ("stack", "mask_flat"),
         "the host path's incremental tail"),
    Root("src/repro/stream/engine.py:274",
         (f"{_STREAM}.refresh_state.refresh",), ("state", "frame"),
         "the device state's full refresh"),
    Root("src/repro/stream/engine.py:296",
         (f"{_STREAM}.provisional_refresh.refresh",), ("state", "frame"),
         "the device state's provisional refresh"),
    Root("src/repro/stream/engine.py:463",
         (f"{_STREAM}._build_stream_fn.step",), ("state", "frame", "out"),
         "the device-resident stream step"),
    Root("src/repro/serve/serve_step.py:58",
         ("repro_torch.serve.serve_step:make_prefill_step.prefill_step",),
         ("params", "tokens", "cache", "prefix_embeds"), "LM prefill"),
    Root("src/repro/serve/serve_step.py:59",
         ("repro_torch.serve.serve_step:make_decode_step.decode_step",),
         ("params", "token", "cache"), "LM decode"),
    Root("src/repro/launch/train.py:45",
         ("repro_torch.train.train_step:make_train_step.train_step",),
         ("state", "batch"), "the training step train_loop runs"),
    Root("src/repro/launch/cells.py:152", _CELL_STEPS, _CELL_TRACED,
         "the step functions build_cell returns (the dry-run contract)"),
    Root("src/repro/launch/dryrun.py:45", _CELL_STEPS, _CELL_TRACED,
         "dryrun.run_cell runs build_cell's step under FakeTensorMode"),
    # the five Pallas kernels: their wrappers launch the CUDA kernels on
    # the card and run the plain versions on CPU tensors
    Root("src/repro/kernels/fused_head.py:124",
         ("repro_torch.kernels.fused_head:tile_pass",),
         ("ii", "ii2", "iic"), "kernel A's launch"),
    Root("src/repro/kernels/haar_stage.py:71",
         ("repro_torch.kernels.haar_stage:stage_sums",), ("ii", "inv"),
         "kernel B's launch"),
    Root("src/repro/kernels/packed_window.py:95",
         ("repro_torch.kernels.packed_window:stage_sums",),
         ("ii_flat", "img", "base", "stride", "ys", "xs", "inv", "n_live"),
         "kernel C's launch"),
    Root("src/repro/kernels/integral_image.py:59",
         ("repro_torch.kernels.integral_image:sat_tables",), ("imgs",),
         "kernel S's launch"),
    Root("src/repro/kernels/window_variance.py:44",
         ("repro_torch.kernels.window_variance:inv_sigma_grid",),
         ("ii2", "iic"), "kernel D's launch"),
)


def _child_defs(node: ast.AST, name: str) -> list:
    """Defs and classes called ``name`` directly in ``node``'s body,
    looking through compound statements but not into other scopes."""
    out = []
    stack = list(getattr(node, "body", []))
    while stack:
        stmt = stack.pop(0)
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if stmt.name == name:
                out.append(stmt)
            continue
        for fld in ("body", "orelse", "finalbody"):
            stack.extend(getattr(stmt, fld, []) or [])
        for handler in getattr(stmt, "handlers", []) or []:
            stack.extend(handler.body)
    return out


def resolve_qualname(tree: ast.Module, qual: str) -> list:
    """Every function def of ``tree`` at the dotted ``qual``
    (``Class.method.nested``), in source order."""
    nodes: list = [tree]
    for part in qual.split("."):
        nodes = [d for n in nodes for d in _child_defs(n, part)]
    return [n for n in nodes
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


# --------------------------------------------------------------- scopes
@dataclass
class _Scope:
    node: ast.AST                    # Module | FunctionDef | Lambda
    parent: "_Scope | None"
    defs: dict[str, ast.FunctionDef] = field(default_factory=dict)
    assigns: dict[str, ast.expr] = field(default_factory=dict)

    def resolve(self, name: str):
        """Nearest binding of ``name``: a def node or an assigned expr."""
        s: _Scope | None = self
        while s is not None:
            if name in s.defs:
                return s.defs[name], s
            if name in s.assigns:
                return s.assigns[name], s
            s = s.parent
        return None, None


def _build_scopes(src: SourceFile) -> dict[int, _Scope]:
    """Map id(function node) -> its enclosing :class:`_Scope` tree."""
    scopes: dict[int, _Scope] = {}

    def walk(node: ast.AST, scope: _Scope) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope.defs.setdefault(child.name, child)
                inner = _Scope(child, scope)
                scopes[id(child)] = inner
                walk(child, inner)
            elif isinstance(child, ast.Lambda):
                inner = _Scope(child, scope)
                scopes[id(child)] = inner
                walk(child, inner)
            elif isinstance(child, ast.ClassDef):
                walk(child, scope)   # methods resolve in the outer scope
            else:
                if isinstance(child, ast.Assign) \
                        and len(child.targets) == 1 \
                        and isinstance(child.targets[0], ast.Name):
                    scope.assigns[child.targets[0].id] = child.value
                walk(child, scope)

    root = _Scope(src.tree, None)
    scopes[id(src.tree)] = root
    walk(src.tree, root)
    return scopes


def _alias_map(src: SourceFile) -> dict[str, str]:
    """name -> dotted module, over *all* imports in the file (module and
    function scope: the engines import their kernel modules lazily)."""
    pkg = (src.module or "").rsplit(".", 1)[0] if src.module else ""
    if src.module and src.path.name == "__init__.py":
        pkg = src.module
    out: dict[str, str] = {}
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Import):
            for al in node.names:
                out[al.asname or al.name.split(".")[0]] = \
                    al.name if al.asname else al.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                up = pkg.split(".") if pkg else []
                if node.level > 1:
                    up = up[:len(up) - (node.level - 1)]
                base = ".".join(up + ([node.module] if node.module else []))
            for al in node.names:
                out[al.asname or al.name] = f"{base}.{al.name}"
    return out


def _dotted(node: ast.expr, aliases: dict[str, str]) -> str | None:
    """Dotted name of an expression like ``torch.compile`` /
    ``native.Kernel``, with the leading alias expanded through the file's
    imports."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    head = aliases.get(node.id, node.id)
    return ".".join([head] + list(reversed(parts)))


def _param_names(fn: ast.FunctionDef | ast.Lambda) -> list[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def _positional(fn: ast.FunctionDef | ast.Lambda) -> list[str]:
    return [p.arg for p in fn.args.posonlyargs + fn.args.args]


def _is_method(fn) -> bool:
    """A def whose first parameter is ``self`` / ``cls``."""
    pos = _positional(fn) if isinstance(fn, ast.FunctionDef) else []
    return bool(pos) and pos[0] in ("self", "cls")


def _function_traced(cls: ast.ClassDef) -> dict[str, set[str]]:
    """Traced parameters of an autograd ``Function``'s forward/backward:
    all of backward's but ``ctx``; forward's whose gradient slot in
    backward's returned tuple is not a literal None."""
    methods = {s.name: s for s in cls.body
               if isinstance(s, ast.FunctionDef)
               and s.name in ("forward", "backward")}
    out: dict[str, set[str]] = {}
    bwd = methods.get("backward")
    if bwd is not None:
        out["backward"] = set(_param_names(bwd)[1:])
    fwd = methods.get("forward")
    if fwd is None:
        return out
    params = _positional(fwd)[1:]
    traced = set(_param_names(fwd)[1:])
    if bwd is not None:
        for node in ast.walk(bwd):
            if isinstance(node, ast.Return) \
                    and isinstance(node.value, ast.Tuple):
                slots = node.value.elts
                traced = {p for i, p in enumerate(params)
                          if i >= len(slots)
                          or not (isinstance(slots[i], ast.Constant)
                                  and slots[i].value is None)}
                break
    out["forward"] = traced
    return out


@dataclass(frozen=True)
class _FuncKey:
    rel: str
    line: int
    name: str


@dataclass
class _Target:
    fn: ast.FunctionDef | ast.Lambda
    src: SourceFile
    scope: _Scope


class _Callee(NamedTuple):
    """A resolved call target: the def, its file and defining scope,
    how many leading parameters the call does not pass (``self``, the
    positional arguments a ``partial`` bound) and the names a ``partial``
    bound by keyword."""
    fn: ast.FunctionDef | ast.Lambda
    src: SourceFile
    scope: _Scope | None
    skip: int = 0
    bound: frozenset = frozenset()


# ------------------------------------------------------------ the rules
def _shared_pass(project) -> list[Finding]:
    """Both TRACE_* rules share one taint pass; cache it on the project so
    ``--select`` of either rule (or both) runs the analysis exactly once."""
    cached = getattr(project, "_trace_pass_findings", None)
    if cached is None:
        cached = _TracePass(project).run()
        project._trace_pass_findings = cached
    return cached


@register
class TraceBranchRule(Rule):
    id = "TRACE_BRANCH"
    summary = ("host `if`/`while`/`assert`/ternary on a tensor value "
               "inside a root (ROOTS, autograd.Function bodies)")
    scope = "project"

    def check_project(self, project) -> list[Finding]:
        return [f for f in _shared_pass(project) if f.rule == self.id]


@register
class TraceConcreteRule(Rule):
    id = "TRACE_CONCRETE"
    summary = ("bool()/int()/float()/.item()/.tolist()/.cpu()/.numpy()/"
               ".to('cpu')/np.asarray() on a tensor value inside a root")
    scope = "project"

    def check_project(self, project) -> list[Finding]:
        return [f for f in _shared_pass(project) if f.rule == self.id]


class _TracePass:
    """One whole-project taint pass emitting TRACE_BRANCH and
    TRACE_CONCRETE findings."""

    def __init__(self, project):
        self.project = project
        self.scopes: dict[str, dict[int, _Scope]] = {}
        self.aliases: dict[str, dict[str, str]] = {}
        self.taint: dict[_FuncKey, set[str]] = {}
        self.targets: dict[_FuncKey, _Target] = {}
        self.worklist: list[_FuncKey] = []
        self.findings: set[Finding] = set()

    # ------------------------------------------------------------ setup
    def _file_scopes(self, src: SourceFile) -> dict[int, _Scope]:
        if src.rel not in self.scopes:
            self.scopes[src.rel] = _build_scopes(src)
        return self.scopes[src.rel]

    def _file_aliases(self, src: SourceFile) -> dict[str, str]:
        if src.rel not in self.aliases:
            self.aliases[src.rel] = _alias_map(src)
        return self.aliases[src.rel]

    def run(self) -> list[Finding]:
        self._table_roots()
        for src in self.project.files:
            if not src.is_test:
                self._function_roots(src)
        guard = 0
        while self.worklist and guard < 10000:
            guard += 1
            key = self.worklist.pop()
            tgt = self.targets[key]
            _FunctionAnalysis(self, tgt, set(self.taint[key])).run()
        return sorted(self.findings)

    def _add_target(self, fn, src: SourceFile, scope: _Scope,
                    tainted: set[str]) -> None:
        key = _FuncKey(src.rel, fn.lineno, getattr(fn, "name", "<lambda>"))
        known = self.taint.setdefault(key, set())
        if tainted - known or key not in self.targets:
            known |= tainted
            self.targets[key] = _Target(fn, src, scope)
            if key not in self.worklist:
                self.worklist.append(key)

    def _add_def(self, fn, src: SourceFile, tainted: set[str]) -> None:
        inner = self._file_scopes(src).get(id(fn))
        scope = inner.parent if inner is not None else None
        self._add_target(fn, src, scope or self._file_scopes(src)[
            id(src.tree)], tainted & set(_param_names(fn)))

    # ------------------------------------------------------------ roots
    def _table_roots(self) -> None:
        for row in ROOTS:
            for target in row.targets:
                module, qual = target.split(":")
                src = self.project.modules.get(module)
                if src is None or src.is_test:
                    continue
                for fn in resolve_qualname(src.tree, qual):
                    self._add_def(fn, src, set(row.traced))

    def _function_roots(self, src: SourceFile) -> None:
        aliases = self._file_aliases(src)
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ClassDef) or not any(
                    _dotted(b, aliases) in _FUNCTION_BASES
                    for b in node.bases):
                continue
            traced = _function_traced(node)
            for stmt in node.body:
                if isinstance(stmt, ast.FunctionDef) and stmt.name in traced:
                    self._add_def(stmt, src, traced[stmt.name])

    def _resolve_name(self, name: str, src: SourceFile, scope: _Scope,
                      aliases):
        """Resolve ``name`` to (node, file, scope): a def/lambda/expr from
        the lexical scope chain (nested defs, local bindings, module
        level), else a scanned imported module."""
        node, sc = scope.resolve(name)
        if node is not None:
            return node, src, sc
        target = aliases.get(name)
        if target and "." in target:
            return self._module_function(target)
        return None

    def _module_function(self, dotted: str):
        mod, sym = dotted.rsplit(".", 1)
        ms = self.project.symbols(mod)
        if ms and sym in ms.functions:
            fsrc = self.project.modules[mod]
            fscopes = self._file_scopes(fsrc)
            return ms.functions[sym], fsrc, fscopes[id(fsrc.tree)]
        return None


def _returned_def(fn, scope: _Scope, scopes: dict[int, _Scope],
                  depth: int = 0):
    """The nested def/lambda a factory function returns (possibly through
    a wrapper call, or a chain of factory calls — the engines cache
    ``self._fns[key] = self._build_fn(plan)`` and return the cache slot,
    so unresolvable returns fall back to following the factories the
    function calls), else None."""
    if depth > 3 or not isinstance(fn, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
        return None
    inner_scope = scopes.get(id(fn))
    if inner_scope is None:
        return None
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and node.value is not None:
            val = node.value
            if isinstance(val, ast.Tuple) and val.elts:
                val = val.elts[0]    # return step_fn, inputs
            if isinstance(val, ast.Call) and val.args:
                val = val.args[0]    # return wrap(inner)
            if isinstance(val, ast.Name):
                target, sc = inner_scope.resolve(val.id)
                if isinstance(target, ast.FunctionDef):
                    return target, sc
            if isinstance(val, ast.Lambda):
                return val, scopes.get(id(val), inner_scope).parent
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name):
            bname = f.id
        elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id in ("self", "cls"):
            bname = f.attr
        else:
            continue
        target, sc = inner_scope.resolve(bname)
        if isinstance(target, ast.FunctionDef) and target is not fn:
            got = _returned_def(target, sc, scopes, depth + 1)
            if got is not None:
                return got
    return None


# ------------------------------------------------- per-function analysis
class _FunctionAnalysis:
    """Taint one function body; emit findings; enqueue tainted callees."""

    def __init__(self, owner: _TracePass, tgt: _Target,
                 tainted: set[str], depth: int = 0):
        self.owner = owner
        self.tgt = tgt
        self.src = tgt.src
        self.aliases = owner._file_aliases(tgt.src)
        self.scopes = owner._file_scopes(tgt.src)
        self.taint = set(tainted)
        self.depth = depth
        fn = tgt.fn
        self.fname = getattr(fn, "name", "<lambda>")
        self.body = (fn.body if isinstance(fn.body, list) else
                     [ast.Expr(fn.body)])
        self._seen: set = set()

    # --------------------------------------------------------- helpers
    def is_tainted(self, node: ast.expr | None) -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.taint
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self.is_tainted(node.value)
        if isinstance(node, ast.Call):
            fname = _dotted(node.func, self.aliases)
            if fname in _STATIC_FUNCS:
                return False
            parts = [node.func] + list(node.args) \
                + [kw.value for kw in node.keywords]
            return any(self.is_tainted(p) for p in parts)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False         # `x is None` is static
            return any(self.is_tainted(c)
                       for c in [node.left] + node.comparators)
        if isinstance(node, ast.Subscript):
            return self.is_tainted(node.value) or self.is_tainted(node.slice)
        if isinstance(node, (ast.BoolOp, ast.BinOp, ast.UnaryOp, ast.IfExp,
                             ast.Tuple, ast.List, ast.Set, ast.Dict,
                             ast.Starred, ast.JoinedStr, ast.FormattedValue,
                             ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp, ast.Slice, ast.NamedExpr)):
            return any(self.is_tainted(c)
                       for c in ast.iter_child_nodes(node)
                       if isinstance(c, ast.expr))
        return False

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        self.owner.findings.add(Finding(
            self.src.rel, node.lineno, node.col_offset + 1, rule, message))

    # ------------------------------------------------------------- run
    def run(self) -> None:
        # two forward passes so loop-carried taint stabilises before the
        # reporting pass
        self._pass_body(self.body, report=False)
        self._pass_body(self.body, report=True)

    def _assign_names(self, target: ast.expr) -> list[str]:
        if isinstance(target, ast.Name):
            return [target.id]
        if isinstance(target, (ast.Tuple, ast.List)):
            return [n for e in target.elts for n in self._assign_names(e)]
        if isinstance(target, ast.Starred):
            return self._assign_names(target.value)
        return []

    def _pass_body(self, body: list[ast.stmt], report: bool) -> None:
        for stmt in body:
            self._pass_stmt(stmt, report)

    def _pass_stmt(self, stmt: ast.stmt, report: bool) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return                   # analysed when called
        if isinstance(stmt, ast.Assign):
            tainted = self.is_tainted(stmt.value)
            for t in stmt.targets:
                for name in self._assign_names(t):
                    (self.taint.add if tainted
                     else self.taint.discard)(name)
            if report:
                self._scan_expr(stmt.value)
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                tainted = self.is_tainted(stmt.value)
                for name in self._assign_names(stmt.target):
                    (self.taint.add if tainted
                     else self.taint.discard)(name)
                if report:
                    self._scan_expr(stmt.value)
            return
        if isinstance(stmt, ast.AugAssign):
            if self.is_tainted(stmt.value):
                self.taint.update(self._assign_names(stmt.target))
            if report:
                self._scan_expr(stmt.value)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            if report and self.is_tainted(stmt.test):
                kind = "if" if isinstance(stmt, ast.If) else "while"
                self._emit(stmt, "TRACE_BRANCH",
                           f"host `{kind}` on a tensor value inside "
                           f"`{self.fname}` — a device-to-host sync (an "
                           f"error under FakeTensorMode); branch on "
                           f"shapes or use torch.where")
            if report:
                self._scan_expr(stmt.test)
            self._pass_body(stmt.body, report)
            self._pass_body(stmt.orelse, report)
            return
        if isinstance(stmt, ast.Assert):
            if report and self.is_tainted(stmt.test):
                self._emit(stmt, "TRACE_BRANCH",
                           f"host `assert` on a tensor value inside "
                           f"`{self.fname}` — a device-to-host sync; "
                           f"assert on static shapes only")
            return
        if isinstance(stmt, ast.For):
            if self.is_tainted(stmt.iter):
                self.taint.update(self._assign_names(stmt.target))
            if report:
                self._scan_expr(stmt.iter)
            self._pass_body(stmt.body, report)
            self._pass_body(stmt.orelse, report)
            return
        if isinstance(stmt, ast.With):
            if report:
                for item in stmt.items:
                    self._scan_expr(item.context_expr)
            self._pass_body(stmt.body, report)
            return
        if isinstance(stmt, ast.Try):
            self._pass_body(stmt.body, report)
            for h in stmt.handlers:
                self._pass_body(h.body, report)
            self._pass_body(stmt.orelse, report)
            self._pass_body(stmt.finalbody, report)
            return
        if isinstance(stmt, (ast.Return, ast.Expr)):
            if report and stmt.value is not None:
                self._scan_expr(stmt.value)
            return
        if isinstance(stmt, ast.Raise):
            return                   # raising is host-side by definition

    # ----------------------------------------------------- expressions
    def _scan_expr(self, expr: ast.expr) -> None:
        """Reporting walk: ternaries, concretization calls and call-edge
        propagation."""
        for node in ast.walk(expr):
            if isinstance(node, ast.IfExp) and self.is_tainted(node.test):
                self._emit(node, "TRACE_BRANCH",
                           f"host ternary on a tensor value inside "
                           f"`{self.fname}` — a device-to-host sync; use "
                           f"torch.where")
            if not isinstance(node, ast.Call):
                continue
            self._check_concretize(node)
            self._propagate_call(node)

    def _concretizes(self, call: ast.Call) -> str | None:
        """What the call is, if it materialises a tainted value on the
        host."""
        func = call.func
        if isinstance(func, ast.Name) and func.id in _CONCRETIZE_FUNCS:
            if any(self.is_tainted(a) for a in call.args):
                return f"`{func.id}()`"
            return None
        if not isinstance(func, ast.Attribute):
            return None
        if func.attr in _CONCRETIZE_METHODS and self.is_tainted(func.value):
            return f"`.{func.attr}()`"
        if func.attr == "to" and self.is_tainted(func.value) and (
                any(isinstance(a, ast.Constant) and a.value == "cpu"
                    for a in call.args[:1])
                or any(kw.arg == "device" and isinstance(kw.value,
                                                         ast.Constant)
                       and kw.value.value == "cpu"
                       for kw in call.keywords)):
            return '`.to("cpu")`'
        if func.attr in _NUMPY_CONCRETIZE \
                and isinstance(func.value, ast.Name) \
                and self.aliases.get(func.value.id, "") == "numpy" \
                and any(self.is_tainted(a) for a in call.args):
            return f"`np.{func.attr}()`"
        return None

    def _check_concretize(self, call: ast.Call) -> None:
        what = self._concretizes(call)
        if what is None:
            return
        # a conversion of a value already brought to the host
        # (`x.cpu().numpy()`, `int(x.item())`) is the same sync
        func = call.func
        inner = [func.value] if isinstance(func, ast.Attribute) else []
        inner += call.args[:1]
        if any(isinstance(n, ast.Call) and self._concretizes(n)
               for n in inner):
            return
        self._emit(call, "TRACE_CONCRETE",
                   f"{what} on a tensor value inside `{self.fname}` is a "
                   f"device-to-host sync (an error under FakeTensorMode)")

    # ---------------------------------------------------- call edges
    def _propagate_call(self, call: ast.Call) -> None:
        name = _dotted(call.func, self.aliases)
        # checkpoint(f, *args): f runs on the call's arguments
        if name in _CHECKPOINT and call.args:
            callee = self._resolve_callable(call.args[0])
            if callee is not None:
                self._map_args(callee, call.args[1:], call.keywords)
            return
        if isinstance(call.func, ast.Call):
            inner = call.func
            inner_name = _dotted(inner.func, self.aliases) or ""
            # partial(f, a)(b) and shard_map(f, mesh, ...)(b)
            if inner.args and (inner_name in _PARTIAL
                               or inner_name.endswith("shard_map")):
                callee = self._resolve_callable(inner.args[0])
                if callee is not None and inner_name in _PARTIAL:
                    callee = callee._replace(
                        skip=callee.skip + len(inner.args) - 1,
                        bound=callee.bound | {kw.arg for kw in
                                              inner.keywords if kw.arg})
                    self._map_args(callee, list(inner.args[1:]),
                                   inner.keywords, skip_bound=False)
                if callee is not None:
                    self._map_args(callee, call.args, call.keywords)
            return
        callee = self._resolve_callable(call.func)
        if callee is not None:
            self._map_args(callee, call.args, call.keywords)

    def _map_args(self, callee: _Callee, args, keywords,
                  skip_bound: bool = True) -> None:
        """Taint the callee's parameters that receive tainted arguments."""
        fn = callee.fn
        pos = _positional(fn)
        if skip_bound:
            pos = pos[callee.skip:]
        else:                        # the partial's own bound arguments
            pos = pos[callee.skip - len(args):]
        params = set(_param_names(fn))
        tainted: set[str] = set()
        for i, arg in enumerate(args):
            if isinstance(arg, ast.Starred):
                if self.is_tainted(arg.value):
                    tainted.update(pos[i:])
                break
            if i < len(pos) and self.is_tainted(arg):
                tainted.add(pos[i])
        for kw in keywords:
            if kw.arg is None:
                if self.is_tainted(kw.value):
                    tainted.update(params)
            elif kw.arg in params and self.is_tainted(kw.value):
                tainted.add(kw.arg)
        if skip_bound:
            tainted -= callee.bound
        if tainted:
            self._analyze_callee(callee, tainted)

    def _resolve_callable(self, expr: ast.expr,
                          depth: int = 0) -> _Callee | None:
        """The def a callable expression names: a lambda, the lexical
        scope chain, ``self.method``, a name bound to ``partial(...)`` or
        to a factory call, then scanned imports and module attributes."""
        if depth > 3:
            return None
        if isinstance(expr, ast.Lambda):
            sc = self.scopes.get(id(expr))
            return _Callee(expr, self.src, sc.parent if sc else None)
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) \
                    and expr.value.id in ("self", "cls"):
                scope = self.scopes.get(id(self.tgt.fn)) \
                    or self.scopes[id(self.src.tree)]
                node, sc = scope.resolve(expr.attr)
                if isinstance(node, ast.FunctionDef) and _is_method(node):
                    return _Callee(node, self.src, sc, skip=1)
                return None
            target = _dotted(expr, self.aliases)
            if target and "." in target:
                got = self.owner._module_function(target)
                if got is not None:
                    return _Callee(got[0], got[1], got[2])
            return None
        if isinstance(expr, ast.Name):
            scope = self.scopes.get(id(self.tgt.fn)) \
                or self.scopes[id(self.src.tree)]
            resolved = self.owner._resolve_name(expr.id, self.src, scope,
                                                self.aliases)
            if resolved is None:
                return None
            node, fsrc, fscope = resolved
            if isinstance(node, (ast.FunctionDef, ast.Lambda)):
                return _Callee(node, fsrc, fscope)
            if isinstance(node, ast.Call) and fsrc is self.src:
                return self._resolve_bound_call(node, depth)
        return None

    def _resolve_bound_call(self, call: ast.Call,
                            depth: int) -> _Callee | None:
        """A name bound to ``partial(f, ...)`` or to a factory's result."""
        name = _dotted(call.func, self.aliases)
        if name in _PARTIAL and call.args:
            callee = self._resolve_callable(call.args[0], depth + 1)
            if callee is None:
                return None
            return callee._replace(
                skip=callee.skip + len(call.args) - 1,
                bound=callee.bound | {kw.arg for kw in call.keywords
                                      if kw.arg})
        factory = self._resolve_callable(call.func, depth + 1)
        if factory is None or not isinstance(factory.fn, ast.FunctionDef):
            return None
        scopes = self.owner._file_scopes(factory.src)
        inner = _returned_def(factory.fn, factory.scope, scopes)
        if inner is None:
            return None
        return _Callee(inner[0], factory.src, inner[1])

    def _analyze_callee(self, callee: _Callee, tainted: set[str]) -> None:
        if callee.src.rel != self.src.rel:
            # cross-file: go through the shared worklist
            self.owner._add_def(callee.fn, callee.src, tainted)
            return
        # local / nested def: closure taint flows in, params shadow
        if self.depth >= _MAX_DEPTH:
            return
        fn = callee.fn
        params = set(_param_names(fn))
        closure_taint = (self.taint - params) | tainted
        key = (id(fn), frozenset(closure_taint))
        if key in self._seen:
            return
        self._seen.add(key)
        sub = _FunctionAnalysis(
            self.owner,
            _Target(fn, self.src,
                    callee.scope or self.scopes[id(self.src.tree)]),
            closure_taint, self.depth + 1)
        sub._seen = self._seen
        sub.run()


# -------------------------------------------------------------- caches
_KERNEL_CLASS = "repro_torch.kernels.native.Kernel"
_NATIVE_MODULE = "repro_torch.kernels.native"


@register
class JitCacheRule(Rule):
    id = "JIT_CACHE"
    summary = ("cache hazards: torch.compile in a loop or of an "
               "inline-invoked lambda; native.Kernel(...) built anywhere "
               "but at a module's top level")

    def check(self, src: SourceFile, project) -> list[Finding]:
        aliases = _alias_map(src)
        findings: list[Finding] = []

        def is_compile(call: ast.Call) -> bool:
            return _dotted(call.func, aliases) == "torch.compile"

        def is_kernel(call: ast.Call) -> bool:
            name = _dotted(call.func, aliases)
            return name == _KERNEL_CLASS or (
                src.module == _NATIVE_MODULE and name == "Kernel")

        def walk(node: ast.AST, in_loop: bool, in_func: bool,
                 parent_call: ast.Call | None) -> None:
            for child in ast.iter_child_nodes(node):
                child_in_loop = in_loop or isinstance(
                    node, (ast.For, ast.While)) and child in (
                        getattr(node, "body", ()) or [])
                child_in_func = in_func or isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.Lambda, ast.ClassDef))
                if isinstance(child, ast.Call):
                    if is_compile(child):
                        if child_in_loop:
                            findings.append(Finding(
                                src.rel, child.lineno,
                                child.col_offset + 1, self.id,
                                "torch.compile called inside a loop — "
                                "each iteration builds a fresh compiled "
                                "callable with its own cache; hoist it "
                                "out and pass loop state as arguments"))
                        elif child_in_func and parent_call is not None \
                                and parent_call.func is child \
                                and child.args \
                                and isinstance(child.args[0], ast.Lambda):
                            findings.append(Finding(
                                src.rel, child.lineno,
                                child.col_offset + 1, self.id,
                                "torch.compile(<lambda>) invoked inline "
                                "— the lambda is a new object every "
                                "call, so every call recompiles; define "
                                "the function once and compile it once"))
                    elif is_kernel(child) and (child_in_func
                                               or child_in_loop):
                        findings.append(Finding(
                            src.rel, child.lineno, child.col_offset + 1,
                            self.id,
                            "native.Kernel(...) built inside a function "
                            "or loop — each build re-registers the "
                            "source in native.KERNELS and drops the "
                            "resolved symbol and the launch count; build "
                            "the handle once at the module's top level"))
                    walk(child, child_in_loop, child_in_func, child)
                else:
                    walk(child, child_in_loop, child_in_func, None)

        walk(src.tree, False, False, None)
        return findings
