"""F-series — fault-injection point hygiene.

The :mod:`veles_tpu_torch.faults` registry is only useful while its
injection surface stays *discoverable*: operators arm points by name
(``VELES_FAULTS="router.forward=..."``) against the table in
``docs/robustness.md``, and chaos tests grep the tree for the call
sites.  Both break silently — an undocumented point is unarmable by
anyone who didn't read the diff that added it, and a computed point
name (f-string, ``%``-format, concatenation) matches neither the doc
table nor a grep nor, reliably, the fnmatch patterns specs are
written against.  This pass checks both statically:

- **F601** — a literal ``faults.fire(...)`` point name that does not
  appear (backticked) in the ``docs/robustness.md`` fault-point
  table.  The doc is the operator's armed-points contract; every
  hazard site belongs in it.
- **F602** — a ``faults.fire(...)`` whose point argument is not a
  string literal.  Armed point names must be fnmatch-stable
  literals: dynamic VALUES belong in the ``key=`` argument (that is
  what scopes a spec to one replica/worker), never in the point.

Both forms of a fire site are recognized: the direct call
(``faults.fire("point", key)``) and the executor indirection the
router uses to keep hangs off the event loop
(``run_in_executor(None, faults.fire, "point", key)``).
"""

import ast
from pathlib import Path

from veles_tpu_torch.analysis.core import Pass, dotted, qualname_of

#: where the armed-points contract lives, relative to the repo root
DOC_PATH = Path("docs") / "robustness.md"


def _fire_point_node(call):
    """The point-argument AST node of a ``faults.fire`` site, or
    None when ``call`` is not one.  Handles the direct call and the
    ``run_in_executor(None, faults.fire, <point>, ...)``
    indirection (the callable rides as an argument and the point is
    the argument after it)."""
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr == "fire":
        recv = dotted(func.value)
        if recv is not None and recv.split(".")[-1] == "faults":
            return call.args[0] if call.args else None
    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Attribute) and arg.attr == "fire":
            recv = dotted(arg.value)
            if recv is not None \
                    and recv.split(".")[-1] == "faults" \
                    and i + 1 < len(call.args):
                return call.args[i + 1]
    return None


def _project_root(project):
    """The scanned tree's root: any module's absolute path with its
    repo-relative path stripped off the tail."""
    for m in project.modules:
        rel = Path(m.relpath).parts
        parts = Path(m.path).parts
        if len(parts) >= len(rel) and parts[-len(rel):] == rel:
            return Path(*parts[:-len(rel)])
    return None


class FaultPointsPass(Pass):
    NAME = "fault-points"
    CODES = {
        "F601": "faults.fire point is not documented in the "
                "docs/robustness.md fault-point table — an "
                "undocumented injection point is unarmable by "
                "operators and invisible to chaos-test greps",
        "F602": "faults.fire point name is not a string literal — "
                "armed points must be fnmatch-stable literals "
                "(dynamic values belong in the key= argument, "
                "which scopes specs to one caller)",
    }

    def run(self, module, project):
        findings = []
        sites = project.shared.setdefault("fault_fire_sites", [])
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            point = _fire_point_node(node)
            if point is None:
                continue
            if isinstance(point, ast.Constant) \
                    and isinstance(point.value, str):
                sites.append((point.value, module, node))
            else:
                findings.append(self.finding(
                    module, node, "F602", qualname_of(node),
                    ast.unparse(point)[:60],
                    "faults.fire point must be a string literal "
                    "(got %s) — put the dynamic part in key=, "
                    "keeping the injection surface documented and "
                    "greppable" % type(point).__name__))
        return findings

    def finalize(self, project):
        findings = []
        sites = project.shared.get("fault_fire_sites", [])
        if not sites:
            return findings
        root = _project_root(project)
        doc = root / DOC_PATH if root is not None else None
        try:
            text = doc.read_text()
        except (OSError, AttributeError):
            text = ""
        for point, module, node in sites:
            if "`%s`" % point in text:
                continue
            findings.append(self.finding(
                module, node, "F601", qualname_of(node), point,
                "fault point %r is missing from the %s fault-point "
                "table — document it (backticked) so operators can "
                "arm it" % (point, DOC_PATH.as_posix())))
        return findings
