"""Port-safety lint: AST rules over the ``repro_torch`` source tree.

Counterpart of the reference's ``verify/lint.py``, whose rules guard
jit tracing.  The port has no tracer; what it must not do is stall the
card on the bank round's path, choose a device or a path from the
environment, or hide a kernel behind a fallback.  This pass makes
those rules checkable: it walks every module, marks tensor parameters,
propagates taint through assignments, and flags:

``host-sync``        on the bank round's path -- modules under
                     ``core/`` and ``kernels/``, and
                     ``CompiledDesign.mul`` in ``designs/compile.py`` --
                     an ``if`` / ``while`` / conditional expression /
                     ``assert`` on a value computed from a parameter
                     annotated ``torch.Tensor``, or ``int()`` /
                     ``float()`` / ``bool()`` / ``.item()`` /
                     ``.tolist()`` / ``.cpu()`` / ``.numpy()`` of one:
                     each reads the card's data on the host and waits
                     for it (the counterpart of the reference's
                     traced-value rules).  The static metadata
                     ``shape`` / ``ndim`` / ``dtype`` / ``device`` and
                     ``numel()`` / ``size()`` / ``len()`` /
                     ``is_contiguous()`` / ``data_ptr()`` (and the
                     port's ``is_aligned``, built on it) launder taint,
                     as do ``is`` / ``is not``: they read no tensor
                     data.  The model path (whose
                     one ``tolist()`` a step is counted by
                     ``chip_smoke.py``) is outside the rule.
``scheduler-state``  a ``Scheduler.schedule`` method writing ``self``
                     attributes -- per-call state breaks the static
                     (cts, n_ops) -> assignment contract the bank's
                     dispatch closures rely on (as in the reference)
``env-read``         an ``os.environ`` / ``getenv`` read outside
                     :data:`ENV_ALLOWED` (the counterpart of the
                     reference's ``interpret-env``): no variable may
                     choose a device or a path
``cuda-fallback``    a ``try`` whose handler calls a ``*_ref`` plain
                     version, or a ``try`` around ``_build.launch`` or a
                     ``launcher`` whose handler neither raises nor
                     re-raises: the port's "no fallback hides the device
                     or a kernel" rule
``foreign-import``   an import of ``jax``, ``jaxlib`` or ``repro`` (the
                     port stands alone; ``tests/test_torch_isolation.py``
                     checks it as well)
"""
from __future__ import annotations

import ast
import pathlib

from .intervals import Violation

#: attribute reads on a tensor that read no tensor data
STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "device"})
#: calls on a tensor that read no tensor data: its methods, and the
#: port's alignment test ``kernels/_row_tiles.is_aligned``, which reads
#: ``data_ptr()`` only
STATIC_CALLS = frozenset({"numel", "size", "is_contiguous", "data_ptr",
                          "is_aligned"})
#: builtins that force a Python scalar out of a tensor
_CASTS = frozenset({"int", "float", "bool"})
#: tensor methods that copy the data to the host
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
#: directories whose modules are the bank round's path
_ROUND_DIRS = frozenset({"core", "kernels"})
#: modules (path suffixes) that may read the environment, and why
ENV_ALLOWED = {
    # torch's launcher (torchrun) tells each process its world size and
    # card through these variables; nothing else does
    "runtime/trainer.py": "torchrun's WORLD_SIZE and LOCAL_RANK",
    # where autotune fronts are cached, as the reference's
    # REPRO_AUTOTUNE_CACHE: a path for files, not for the computation
    "autotune/cache.py": "the autotune cache directory",
}
FOREIGN = frozenset({"jax", "jaxlib", "repro"})


def _norm(path: str) -> str:
    return str(path).replace("\\", "/")


def _on_round_path(path: str) -> bool:
    """A module under ``core/`` or ``kernels/``."""
    return bool(_ROUND_DIRS & set(pathlib.PurePosixPath(_norm(path))
                                  .parent.parts))


def _is_tensor_annotation(ann) -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.Attribute) and ann.attr == "Tensor":
        return True
    if isinstance(ann, ast.Name) and ann.id == "Tensor":
        return True
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.replace(" ", "").endswith("Tensor")
    return False


def _tensor_params(fn) -> set:
    args = fn.args
    return {a.arg for a in (list(args.posonlyargs) + list(args.args)
                            + list(args.kwonlyargs))
            if _is_tensor_annotation(a.annotation)}


class _TaintWalker(ast.NodeVisitor):
    """One function body: propagate taint, record host syncs."""

    def __init__(self, path: str, fn):
        self.path = path
        self.fn = fn
        self.tainted = _tensor_params(fn)
        self.violations = []

    # ------------------------------------------------------ taint queries
    def _expr_tainted(self, node) -> bool:
        """Does evaluating ``node`` yield a value read from a tensor?"""
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                return False              # metadata launders taint
            return self._expr_tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self._expr_tainted(node.value)
        if isinstance(node, ast.Call):
            f = node.func
            name = f.id if isinstance(f, ast.Name) else getattr(
                f, "attr", None)
            if name == "len" or name in STATIC_CALLS:
                return False
            parts = [f] + list(node.args) + [kw.value
                                             for kw in node.keywords]
            return any(self._expr_tainted(p) for p in parts)
        if isinstance(node, ast.BinOp):
            return (self._expr_tainted(node.left)
                    or self._expr_tainted(node.right))
        if isinstance(node, ast.UnaryOp):
            return self._expr_tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self._expr_tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False              # identity reads no data
            return (self._expr_tainted(node.left)
                    or any(self._expr_tainted(c) for c in node.comparators))
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self._expr_tainted(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return (self._expr_tainted(node.body)
                    or self._expr_tainted(node.orelse)
                    or self._expr_tainted(node.test))
        if isinstance(node, ast.Starred):
            return self._expr_tainted(node.value)
        return False

    def _flag(self, node, detail: str) -> None:
        self.violations.append(Violation(
            "lint", "host-sync",
            f"{self.path}:{node.lineno} in {self.fn.name}", detail))

    # ------------------------------------------------- taint propagation
    def _assign_targets(self, target, tainted: bool) -> None:
        if isinstance(target, ast.Name):
            if tainted:
                self.tainted.add(target.id)
            else:
                self.tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._assign_targets(elt, tainted)

    def visit_Assign(self, node: ast.Assign) -> None:
        value = node.value
        for t in node.targets:
            if isinstance(t, (ast.Tuple, ast.List)) and isinstance(
                    value, (ast.Tuple, ast.List)) and len(t.elts) == len(
                    value.elts):           # a, b = x, y: pair by pair
                for target, part in zip(t.elts, value.elts):
                    self._assign_targets(target, self._expr_tainted(part))
            else:
                self._assign_targets(t, self._expr_tainted(value))
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if self._expr_tainted(node.value):
            self._assign_targets(node.target, True)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._assign_targets(node.target,
                                 self._expr_tainted(node.value))
        self.generic_visit(node)

    # ------------------------------------------------------------- rules
    def visit_If(self, node: ast.If) -> None:
        if self._expr_tainted(node.test):
            self._flag(node, "`if` on a tensor's value waits for the card "
                       "and branches on its data; use torch.where")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        if self._expr_tainted(node.test):
            self._flag(node, "`while` on a tensor's value waits for the "
                       "card every iteration")
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        if self._expr_tainted(node.test):
            self._flag(node, "conditional expression on a tensor's value; "
                       "use torch.where")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        if self._expr_tainted(node.test):
            self._flag(node, "assert on a tensor's value waits for the "
                       "card; check shapes instead")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Name) and f.id in _CASTS and node.args \
                and self._expr_tainted(node.args[0]):
            self._flag(node, f"{f.id}() of a tensor's value copies it to "
                       f"the host and waits for the card")
        elif isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS \
                and self._expr_tainted(f.value):
            self._flag(node, f".{f.attr}() copies a tensor to the host and "
                       f"waits for the card")
        self.generic_visit(node)

    # nested defs get their own walker; don't descend with parent taint
    def visit_FunctionDef(self, node) -> None:
        if node is not self.fn:
            return
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef


def _round_functions(tree: ast.Module, path: str):
    """The functions the host-sync rule walks: all of a module on the
    round's path, else ``CompiledDesign.mul`` of ``designs/compile.py``."""
    if _on_round_path(path):
        yield from (n for n in ast.walk(tree) if isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef)))
    elif _norm(path).endswith("designs/compile.py"):
        for cls in tree.body:
            if isinstance(cls, ast.ClassDef) and cls.name == "CompiledDesign":
                yield from (n for n in cls.body if isinstance(
                    n, ast.FunctionDef) and n.name == "mul")


def _scheduler_state_writes(tree: ast.Module, path: str) -> list:
    """Flag ``self.x = ...`` inside any ``schedule`` method."""
    out = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        for fn in cls.body:
            if not isinstance(fn, ast.FunctionDef) or \
                    fn.name != "schedule":
                continue
            for node in ast.walk(fn):
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        out.append(Violation(
                            "lint", "scheduler-state",
                            f"{path}:{node.lineno} in "
                            f"{cls.name}.schedule",
                            f"schedule() writes self.{t.attr}: per-call "
                            f"state makes the (cts, n_ops) -> assignment "
                            f"map non-static and breaks the bank's "
                            f"cached dispatch"))
    return out


def _names_environ(expr) -> bool:
    return ((isinstance(expr, ast.Attribute) and expr.attr == "environ")
            or (isinstance(expr, ast.Name) and expr.id == "environ"))


def _env_reads(tree: ast.Module, path: str) -> list:
    """Flag environment reads outside :data:`ENV_ALLOWED`: any
    ``os.environ`` use (subscript, ``get``, iteration) and any
    ``getenv`` call, whatever the key."""
    norm = _norm(path)
    if any(norm.endswith(allowed) for allowed in ENV_ALLOWED):
        return []
    out = []
    for node in ast.walk(tree):
        read = None
        if _names_environ(node):
            read = "os.environ"
        elif isinstance(node, ast.Call) and (
                (isinstance(node.func, ast.Attribute)
                 and node.func.attr == "getenv")
                or (isinstance(node.func, ast.Name)
                    and node.func.id == "getenv")):
            read = "getenv"
        if read is not None:
            out.append(Violation(
                "lint", "env-read", f"{path}:{node.lineno}",
                f"reads {read}: no environment variable may choose a "
                f"device or a path (allowed only in "
                f"{sorted(ENV_ALLOWED)})"))
    return out


def _called_names(nodes) -> set:
    """Names and attribute names of every call under ``nodes``."""
    out = set()
    for root in nodes:
        for node in ast.walk(root):
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Name):
                    out.add(f.id)
                elif isinstance(f, ast.Attribute):
                    out.add(f.attr)
    return out


def _raises(nodes) -> bool:
    return any(isinstance(n, ast.Raise) for root in nodes
               for n in ast.walk(root))


def _fallbacks(tree: ast.Module, path: str) -> list:
    """Flag a ``try`` that falls back to a plain version, or swallows a
    failed launch."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        launches = bool({"launch", "launcher"} & _called_names(node.body))
        for handler in node.handlers:
            called = _called_names(handler.body)
            plain = sorted(n for n in called if n.endswith("_ref"))
            if plain:
                out.append(Violation(
                    "lint", "cuda-fallback", f"{path}:{handler.lineno}",
                    f"exception handler falls back to {plain[0]}(): a "
                    f"failed kernel must raise, not run the plain version"))
            elif launches and not _raises(handler.body):
                out.append(Violation(
                    "lint", "cuda-fallback", f"{path}:{handler.lineno}",
                    "exception handler around a kernel launch neither "
                    "raises nor re-raises: the failure would be hidden"))
    return out


def _foreign_imports(tree: ast.Module, path: str) -> list:
    out = []
    for node in ast.walk(tree):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        for mod in mods:
            if mod.split(".")[0] in FOREIGN:
                out.append(Violation(
                    "lint", "foreign-import", f"{path}:{node.lineno}",
                    f"imports {mod}: the port imports torch, numpy and "
                    f"the standard library only"))
    return out


def lint_source(source: str, path: str = "<string>") -> list:
    """Lint one module's source text; returns Violations."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Violation("lint", "syntax-error", f"{path}:{e.lineno}",
                          str(e))]
    out = []
    for fn in _round_functions(tree, path):
        walker = _TaintWalker(path, fn)
        walker.visit(fn)
        out.extend(walker.violations)
    out.extend(_scheduler_state_writes(tree, path))
    out.extend(_env_reads(tree, path))
    out.extend(_fallbacks(tree, path))
    out.extend(_foreign_imports(tree, path))
    return out


def lint_file(path) -> list:
    p = pathlib.Path(path)
    return lint_source(p.read_text(), str(p))


def lint_tree(root) -> list:
    """Lint every ``*.py`` under ``root`` (deterministic order)."""
    rootp = pathlib.Path(root)
    out = []
    for p in sorted(rootp.rglob("*.py")):
        out.extend(lint_file(p))
    return out
