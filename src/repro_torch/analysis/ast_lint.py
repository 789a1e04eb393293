"""AST lint of the port (counterpart of ``repro/analysis/ast_lint.py``):
rules PIPA001-003.

Purely syntactic: this pass imports nothing of the code it reads and runs
none of it.  Eager PyTorch has no jit region, so the reference's "inside a
jitted function" becomes "inside a registered hot-path function"
(``HOT_FUNCTIONS``: the programs ``hotpath_audit`` runs and their helpers,
each with its declared host-sync sites).

  PIPA001  Python ``if``/``while`` on a tensor expression inside a
           registered hot-path function: an implicit ``bool(tensor)``, a
           host sync that no declaration names.
  PIPA002  a host-sync call (``.item()``, ``.tolist()``, ``.cpu()``,
           ``.numpy()``, or ``bool``/``int``/``float`` of a tensor
           expression), or a Python number written through a tensor index
           (``t[idx] = 0``: the card copies it to the device), inside a
           registered hot-path function beyond the sites it declares, or a
           declared site the source no longer has.
           ``hotpath_audit``'s PIPJ001 counts the syncs a run makes; this
           rule holds the sites in the source.
  PIPA003  mutable default argument (list/dict/set literal or
           constructor), over all of ``src/repro_torch``, ``chip_smoke.py``
           and ``examples/torch_*.py``.

A tensor expression reads one of the function's tensor names: its
positional parameters (not ``self``, not annotated with a Python scalar
type), and every local assigned from a tensor expression or a ``torch.*``
call.  Keyword-only parameters are options (``beam``, ``metric``, ...).
Shape metadata (``.shape``, ``.dtype``, ``.device``, ...), ``len``/
``isinstance``-like calls and ``is None`` tests are never tensor reads,
and the result of a host cast (``bool(t)``) is a host value: the cast is
PIPA002's site, not PIPA001's.

No PIPA004: eager PyTorch has no ``static_argnames`` (``lint.NOT_PORTED``).
"""
from __future__ import annotations

import ast
import pathlib

from repro_torch.analysis.lint import Finding

# Registered hot-path functions, by file: function -> its declared host-sync
# sites, one entry a site (the kind: "bool", "int", "float", ".item",
# ".tolist", ".cpu", ".numpy", or "[]=number": a Python number written
# through a tensor index, which the card copies to the device).  Adding a
# sync to one of these functions is this line and its budget in
# hotpath_audit.default_programs.
HOT_FUNCTIONS: dict[str, dict[str, tuple[str, ...]]] = {
    "src/repro_torch/core/beam_search.py": {
        # the early-exit test: one bool() a step, so a converged batch stops;
        # the picked slots marked visited, vis[rows, pos] = True
        "_beam_search_multi": ("bool", "[]=number"),
        "merge_block": (),
        "_live": (),
    },
    "src/repro_torch/core/pipnn.py": {"_stream_step": (), "_chunk_edges": ()},
    "src/repro_torch/core/hashprune.py": {
        "merge_segmented_edges": (), "merge_flat_edges": (), "hashprune_flat": (),
        "reservoir_as_edges": (),
    },
    "src/repro_torch/core/robust_prune.py": {
        "final_prune_step": (), "prune_reservoir_block": (), "robust_prune_mask": (),
    },
    "src/repro_torch/distributed/serving.py": {"cross_shard_topk": ()},
}

SAFE_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                        "requires_grad", "is_sparse"})
SAFE_CALLS = frozenset({"len", "isinstance", "hasattr", "getattr", "callable", "type",
                        "id", "range", "enumerate", "zip"})
SCALAR_TYPES = frozenset({"int", "float", "bool", "str"})
HOST_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
HOST_CAST_FUNCS = frozenset({"bool", "int", "float"})
TORCH_NAMES = frozenset({"torch"})
MUTABLE_CTORS = frozenset({"list", "dict", "set"})


def _param_names(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    return ([p.arg for p in a.posonlyargs] + [p.arg for p in a.args]
            + [p.arg for p in a.kwonlyargs])


def _tensor_params(fn: ast.FunctionDef) -> set[str]:
    """Positional parameters that may hold tensors: not ``self``, not
    annotated with a Python scalar type."""
    out = set()
    for p in fn.args.posonlyargs + fn.args.args:
        ann = p.annotation
        if p.arg in ("self", "cls"):
            continue
        if isinstance(ann, ast.Name) and ann.id in SCALAR_TYPES:
            continue
        out.add(p.arg)
    return out


def _is_host_cast(node: ast.Call) -> bool:
    f = node.func
    return ((isinstance(f, ast.Name) and f.id in HOST_CAST_FUNCS)
            or (isinstance(f, ast.Attribute) and f.attr in HOST_SYNC_METHODS))


class _TensorUse(ast.NodeVisitor):
    """Does this expression read a tensor in a value position?"""

    def __init__(self, tensors: frozenset):
        self.tensors = tensors
        self.hit = False

    def visit_Name(self, node: ast.Name):
        if node.id in self.tensors:
            self.hit = True

    def visit_Attribute(self, node: ast.Attribute):
        if node.attr in SAFE_ATTRS:
            return
        if isinstance(node.value, ast.Name) and node.value.id in TORCH_NAMES:
            return          # torch.float32, torch.inf: module attributes
        self.visit(node.value)

    def visit_Call(self, node: ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id in SAFE_CALLS:
            return
        if _is_host_cast(node):
            return          # a host value: the cast is PIPA002's site
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id in TORCH_NAMES:
            self.hit = True     # torch.* makes a tensor
            return
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return          # `t is None`: host logic
        self.generic_visit(node)


def _uses_tensor(node: ast.expr, tensors) -> bool:
    v = _TensorUse(frozenset(tensors))
    v.visit(node)
    return v.hit


def _number(node) -> bool:
    """A Python number or bool literal (``True``, ``-1``, ``0.0``)."""
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        node = node.operand
    return isinstance(node, ast.Constant) and isinstance(node.value, (bool, int, float))


def _sync_kind(node: ast.Call, tensors) -> str | None:
    """The host-sync kind of a call on a tensor expression, or None."""
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in HOST_SYNC_METHODS \
            and _uses_tensor(f.value, tensors):
        return "." + f.attr
    if isinstance(f, ast.Name) and f.id in HOST_CAST_FUNCS and node.args \
            and _uses_tensor(node.args[0], tensors):
        return f.id
    return None


def _lint_hot_function(fn: ast.FunctionDef, declared: tuple[str, ...], path: str,
                       findings: list[Finding]) -> None:
    tensors = _tensor_params(fn)
    sites: list[tuple[str, int]] = []

    def bind(targets, is_tensor: bool) -> None:
        # names bound by the assignment (a subscript or attribute target
        # writes into an object and binds nothing)
        for t in targets:
            if isinstance(t, ast.Name):
                (tensors.add if is_tensor else tensors.discard)(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                bind(t.elts, is_tensor)
            elif isinstance(t, ast.Starred):
                bind([t.value], is_tensor)

    def calls(node) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                kind = _sync_kind(sub, tensors)
                if kind is not None:
                    sites.append((kind, sub.lineno))

    def scan(stmts) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                if isinstance(stmt, ast.Assign) and _number(stmt.value):
                    for t in stmt.targets:
                        if isinstance(t, ast.Subscript) and _uses_tensor(t.slice, tensors):
                            sites.append(("[]=number", stmt.lineno))
                if stmt.value is not None:
                    calls(stmt.value)
                    targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                    is_t = _uses_tensor(stmt.value, tensors)
                    if isinstance(stmt, ast.AugAssign):
                        is_t = is_t or _uses_tensor(stmt.target, tensors)
                    bind(targets, is_t)
                continue
            if isinstance(stmt, (ast.If, ast.While)):
                calls(stmt.test)
                if _uses_tensor(stmt.test, tensors):
                    kind = "if" if isinstance(stmt, ast.If) else "while"
                    findings.append(Finding(
                        "PIPA001", path, stmt.lineno, fn.name,
                        f"Python '{kind}' on a tensor expression: an implicit bool() host "
                        f"sync no declaration names; make it a tensor op (torch.where) or "
                        f"an explicit, declared bool()"))
                scan(stmt.body)
                scan(stmt.orelse)
                continue
            if isinstance(stmt, ast.For):
                calls(stmt.iter)
                bind([stmt.target], _uses_tensor(stmt.iter, tensors))
                scan(stmt.body)
                scan(stmt.orelse)
                continue
            if isinstance(stmt, ast.With):
                for item in stmt.items:
                    calls(item.context_expr)
                scan(stmt.body)
                continue
            if isinstance(stmt, ast.Try):
                scan(stmt.body)
                for h in stmt.handlers:
                    scan(h.body)
                scan(stmt.orelse)
                scan(stmt.finalbody)
                continue
            if isinstance(stmt, ast.FunctionDef):
                # a nested def: its own parameters shadow, and its body is
                # part of the function's
                saved = set(tensors)
                tensors.difference_update(_param_names(stmt))
                scan(stmt.body)
                tensors.clear()
                tensors.update(saved)
                continue
            calls(stmt)

    scan(fn.body)
    left = list(declared)
    for kind, line in sites:
        if kind in left:
            left.remove(kind)
            continue
        findings.append(Finding(
            "PIPA002", path, line, fn.name,
            f"host sync {kind} on a tensor expression in a hot-path function, not among "
            f"its declared sync sites {declared or '()'}: declare it in "
            f"ast_lint.HOT_FUNCTIONS and its budget in hotpath_audit, or remove it"))
    for kind in left:
        findings.append(Finding(
            "PIPA002", path, fn.lineno, fn.name,
            f"declared host-sync site {kind} is not in the source: a stale declaration "
            f"(remove it from ast_lint.HOT_FUNCTIONS and the program's budget)"))


def _lint_mutable_defaults(tree: ast.Module, path: str, findings: list[Finding]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        defaults = list(node.args.defaults) + \
            [d for d in node.args.kw_defaults if d is not None]
        for d in defaults:
            bad = isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(d, ast.Call) and isinstance(d.func, ast.Name)
                and d.func.id in MUTABLE_CTORS and not d.args and not d.keywords)
            if bad:
                findings.append(Finding(
                    "PIPA003", path, d.lineno, node.name,
                    "mutable default argument — use None and create "
                    "inside the function"))


def lint_source(src: str, path: str,
                hot: dict[str, tuple[str, ...]] | None = None) -> list[Finding]:
    """Lint one module's source; ``path`` is used verbatim in findings.
    ``hot`` names the module's hot-path functions with their declared sync
    sites (default: none, so only PIPA003 applies)."""
    findings: list[Finding] = []
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        findings.append(Finding("PIPA001", path, e.lineno or 0, "<module>",
                                f"syntax error prevents linting: {e.msg}"))
        return findings
    _lint_mutable_defaults(tree, path, findings)
    if hot:
        defs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
        for name, declared in hot.items():
            if name not in defs:
                findings.append(Finding(
                    "PIPA002", path, 0, name,
                    "registered hot-path function not found at the module's top level: "
                    "update ast_lint.HOT_FUNCTIONS"))
                continue
            _lint_hot_function(defs[name], declared, path, findings)
    return findings


def port_files(root: pathlib.Path) -> list[pathlib.Path]:
    """The files the port's lint reads: its package, ``chip_smoke.py`` and
    its examples."""
    root = pathlib.Path(root)
    files = [p for p in sorted((root / "src" / "repro_torch").rglob("*.py"))
             if "__pycache__" not in p.parts]
    files.append(root / "chip_smoke.py")
    files += sorted((root / "examples").glob("torch_*.py"))
    return [p for p in files if p.exists()]


def lint_port(root: pathlib.Path, hot_functions: dict | None = None) -> list[Finding]:
    """PIPA003 over every port file, PIPA001/002 over the registered hot-path
    functions (``HOT_FUNCTIONS`` unless given)."""
    root = pathlib.Path(root)
    hot_functions = HOT_FUNCTIONS if hot_functions is None else hot_functions
    findings: list[Finding] = []
    for py in port_files(root):
        rel = py.relative_to(root).as_posix()
        findings += lint_source(py.read_text(), rel, hot_functions.get(rel))
    for rel in sorted(set(hot_functions) - {p.relative_to(root).as_posix()
                                            for p in port_files(root)}):
        findings.append(Finding("PIPA002", rel, 0, "<module>",
                                "registered hot-path file does not exist"))
    return findings
