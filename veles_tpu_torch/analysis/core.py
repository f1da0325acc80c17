"""Shared infrastructure for the veles-lint passes.

Everything here is pure stdlib ``ast`` work — importing this package
must never pull in jax (the tier-1 run-clean gate executes with no
accelerator runtime at all), so passes receive pre-parsed
:class:`Module` objects and report :class:`Finding`s instead of
touching the live framework.

A **pass** subclasses :class:`Pass` and implements :meth:`Pass.run`
(per module) and/or :meth:`Pass.finalize` (whole-project, for
cross-module facts like dead config keys).  Findings are keyed for the
baseline by ``(code, path, context, detail)`` — never by line number,
so unrelated edits don't churn the baseline file.
"""

import ast
import dataclasses
from pathlib import Path

__all__ = ["Finding", "Module", "Project", "Pass", "run_passes",
           "dotted", "parent_chain", "attach_parents", "ScopeTracker"]


@dataclasses.dataclass
class Finding:
    """One reported hazard.

    ``context`` is the enclosing ``Class.method`` / function qualname
    (``<module>`` at top level); ``detail`` the stable token the
    finding is about (attribute name, config key, callee...).  The
    pair keys the baseline: line numbers deliberately do not."""

    code: str
    path: str          # repo-relative posix path
    line: int
    col: int
    context: str
    detail: str
    message: str
    baselined: bool = False
    reason: str = ""   # baseline reason, when baselined

    @property
    def key(self):
        return "%s %s::%s::%s" % (self.code, self.path, self.context,
                                  self.detail)

    def as_dict(self):
        return {
            "code": self.code, "path": self.path, "line": self.line,
            "col": self.col, "context": self.context,
            "detail": self.detail, "message": self.message,
            "key": self.key, "baselined": self.baselined,
            "reason": self.reason or None,
        }

    def __str__(self):
        mark = " [baselined: %s]" % self.reason if self.baselined else ""
        return "%s:%d:%d: %s [%s] %s%s" % (
            self.path, self.line, self.col, self.code, self.context,
            self.message, mark)


class Module:
    """One parsed source file: text, AST (with parent links), and the
    repo-relative path every finding reports."""

    def __init__(self, path, relpath, text=None):
        self.path = Path(path)
        self.relpath = str(relpath)
        self.text = self.path.read_text() if text is None else text
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=self.relpath)
        attach_parents(self.tree)

    @property
    def imports_threading(self):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                if any(a.name.split(".")[0] == "threading"
                       for a in node.names):
                    return True
            elif isinstance(node, ast.ImportFrom):
                if (node.module or "").split(".")[0] == "threading":
                    return True
        return False


class Project:
    """The scanned module set plus a scratch dict passes share
    (e.g. the C-pass stores config declarations here)."""

    def __init__(self, modules):
        self.modules = list(modules)
        self.shared = {}

    def module(self, relpath):
        for m in self.modules:
            if m.relpath == relpath:
                return m
        return None


class Pass:
    """Base class: ``CODES`` maps each finding code to its one-line
    description (the docs and ``--list-codes`` render from it)."""

    NAME = "?"
    CODES = {}

    def run(self, module, project):
        """Per-module findings (may also stash facts in
        ``project.shared`` for :meth:`finalize`)."""
        return []

    def finalize(self, project):
        """Whole-project findings, after every module ran."""
        return []

    def finding(self, module, node, code, context, detail, message):
        return Finding(code=code, path=module.relpath,
                       line=getattr(node, "lineno", 0),
                       col=getattr(node, "col_offset", 0),
                       context=context, detail=detail, message=message)


# -- AST helpers -------------------------------------------------------------

def attach_parents(tree):
    """Annotate every node with ``_parent`` (None at the root)."""
    tree._parent = None
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._parent = node
    return tree


def parent_chain(node):
    """The node's ancestors, innermost first."""
    node = getattr(node, "_parent", None)
    while node is not None:
        yield node
        node = getattr(node, "_parent", None)


def dotted(node):
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node):
    """Dotted callee name of a Call, else None."""
    return dotted(node.func) if isinstance(node, ast.Call) else None


def enclosing_function(node):
    """The innermost FunctionDef/AsyncFunctionDef containing ``node``
    (None at module level)."""
    for p in parent_chain(node):
        if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return p
    return None


def qualname_of(node):
    """``Class.method`` / ``fn.<locals>.inner`` style context string
    for the statement containing ``node``."""
    names = []
    for p in parent_chain(node):
        if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            names.append(p.name)
    return ".".join(reversed(names)) or "<module>"


def with_lock_names(node):
    """Names of every lock guarding ``node``: for each enclosing
    ``with X:`` / ``with X(...):``, the dotted name of X (call or
    bare).  ``with self._lock:``, ``with lock:``, ``with
    self._cv:`` all count — lock identity is checked by the caller."""
    held = []
    for p in parent_chain(node):
        if isinstance(p, (ast.With, ast.AsyncWith)):
            for item in p.items:
                ctx = item.context_expr
                name = dotted(ctx) or call_name(ctx)
                if name:
                    held.append(name)
    return held


class ScopeTracker(ast.NodeVisitor):
    """Visitor base that maintains ``self.scope`` — a list of
    enclosing (kind, name) pairs — while walking the tree.  Passes
    subclass it instead of re-implementing qualname bookkeeping."""

    def __init__(self):
        self.scope = []

    @property
    def qualname(self):
        return ".".join(n for _, n in self.scope) or "<module>"

    @property
    def enclosing_class(self):
        for kind, name in reversed(self.scope):
            if kind == "class":
                return name
        return None

    def visit_ClassDef(self, node):
        self.scope.append(("class", node.name))
        self.generic_visit(node)
        self.scope.pop()

    def _visit_func(self, node):
        self.scope.append(("function", node.name))
        self.generic_visit(node)
        self.scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func


def collect_modules(paths, root=None):
    """Parse every ``*.py`` under ``paths`` into Modules.  ``root``
    anchors the repo-relative names (defaults to the common parent of
    the scanned paths' package)."""
    files = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    files = [f for f in files if "__pycache__" not in f.parts]
    if root is None:
        root = Path(common_root(files)) if files else Path.cwd()
    modules = []
    errors = []
    for f in files:
        try:
            rel = f.resolve().relative_to(Path(root).resolve())
        except ValueError:
            rel = f.name
        try:
            modules.append(Module(f, Path(rel).as_posix()))
        except SyntaxError as e:
            errors.append((Path(rel).as_posix(), str(e)))
    return modules, errors


def common_root(files):
    parts = None
    for f in files:
        fp = f.resolve().parent.parts
        if parts is None:
            parts = list(fp)
        else:
            n = 0
            for a, b in zip(parts, fp):
                if a != b:
                    break
                n += 1
            parts = parts[:n]
    return str(Path(*parts)) if parts else "."


def run_passes(passes, modules):
    """Run every pass over every module; returns (findings, project)."""
    project = Project(modules)
    findings = []
    for p in passes:
        for m in project.modules:
            findings.extend(p.run(m, project))
    for p in passes:
        findings.extend(p.finalize(project))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return findings, project
