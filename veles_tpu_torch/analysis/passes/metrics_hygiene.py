"""M-series — metric-family hygiene at registry call sites.

The metrics registry is ``getLogger``-style get-or-create: modules
declare the families they touch without coordinating, and
``_get_or_create`` silently IGNORES the ``labelnames`` of every call
after the first — so two call sites declaring the same family with
different label sets never crash; whichever module imports first
wins, and the loser's ``.labels(...)`` calls raise (or, worse,
export under the wrong schema).  Likewise nothing enforces the
naming convention the dashboards/federation rollups key on.  This
pass checks both statically:

- **M501** — a registry family name (first argument of
  ``metrics.counter/gauge/histogram``) that is not ``veles_``-
  prefixed snake_case (``^veles(_[a-z0-9]+)+$``).  The federation
  merger, the fleet dashboards and the alert-rule grammar all select
  on the ``veles_`` namespace — an off-convention family is
  invisible to all of them.
- **M502** — one family declared with DIFFERENT label sets across
  call sites.  Only the first registration's ``labelnames`` takes
  effect, so every other declaration is dead text that will
  eventually disagree with reality.
- **M503** — a family declared with a ``tenant`` label in a module
  that never routes the label value through the admission-layer
  cardinality bounder (no ``….label(…)`` call anywhere in the
  module).  Tenant ids are CALLER-chosen strings; exporting them raw
  as label values is an unbounded-cardinality hole — every distinct
  id mints a new time series in the registry, the federation merge
  and the tsdb ring.  ``TenantAdmission.label()`` caps the set
  (first-N stable, rest folded into ``"other"``), so the static
  proxy for "bounded" is: the registering module contains at least
  one call whose attribute name is ``label``.

Only calls whose receiver is a registry (``metrics.…`` /
``registry.…``) with a literal string name are checked — direct
``Histogram(...)`` constructions are instance-local (not exported
families) and stay out of scope, as do dynamic names.
"""

import ast
import re

from veles_tpu_torch.analysis.core import Finding, Pass, dotted, qualname_of

#: the exported-family naming convention (M501)
_NAME_RE = re.compile(r"^veles(_[a-z0-9]+)+$")

#: registry get-or-create methods and the receivers that make a call
#: a REGISTRY call (vs. numpy.histogram or a constructor)
_METHODS = ("counter", "gauge", "histogram")
_RECEIVERS = ("metrics", "registry")


def _labelnames(call):
    """The call's declared labelnames as a sorted tuple — () when
    omitted, None when dynamic (non-literal)."""
    node = None
    for kw in call.keywords:
        if kw.arg == "labelnames":
            node = kw.value
            break
    else:
        if len(call.args) >= 3:   # (name, help, labelnames)
            node = call.args[2]
    if node is None:
        return ()
    if isinstance(node, (ast.Tuple, ast.List)) and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str)
            for e in node.elts):
        return tuple(sorted(e.value for e in node.elts))
    return None


class MetricsHygienePass(Pass):
    NAME = "metrics-hygiene"
    CODES = {
        "M501": "exported metric family name is not veles_-prefixed "
                "snake_case — invisible to the fleet federation "
                "rollups, dashboards and alert-rule selectors that "
                "key on the veles_ namespace",
        "M502": "metric family declared with different label sets "
                "across call sites — the registry honors only the "
                "FIRST registration, so the others are dead text "
                "whose .labels() calls can raise at runtime",
        "M503": "tenant-labeled metric family registered in a module "
                "with no cardinality-bounder .label() call — raw "
                "caller-chosen tenant ids mint unbounded label "
                "series; route values through "
                "TenantAdmission.label()",
    }

    def run(self, module, project):
        findings = []
        sites = project.shared.setdefault("metric_sites", {})
        tenant_decls = []
        has_bounder_call = False
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute):
                continue
            if node.func.attr == "label":
                # any `<something>.label(...)` counts as routing
                # through the cardinality bounder (M503)
                has_bounder_call = True
            if node.func.attr not in _METHODS:
                continue
            recv = dotted(node.func.value)
            if recv is None \
                    or recv.split(".")[-1] not in _RECEIVERS:
                continue
            if not node.args or not isinstance(
                    node.args[0], ast.Constant) \
                    or not isinstance(node.args[0].value, str):
                continue
            name = node.args[0].value
            if not _NAME_RE.match(name):
                findings.append(self.finding(
                    module, node, "M501", qualname_of(node), name,
                    "metric family %r is not veles_-prefixed "
                    "snake_case (^veles(_[a-z0-9]+)+$) — rename it "
                    "into the exported namespace" % name))
            labels = _labelnames(node)
            if labels is not None:
                sites.setdefault(name, []).append(
                    (labels, module, node))
                if "tenant" in labels:
                    tenant_decls.append((name, node))
        if not has_bounder_call:
            for name, node in tenant_decls:
                findings.append(self.finding(
                    module, node, "M503", qualname_of(node), name,
                    "family %r carries a 'tenant' label but this "
                    "module never calls a cardinality bounder "
                    "(.label(...)) — raw tenant ids make label "
                    "cardinality unbounded; fold values through "
                    "TenantAdmission.label() first" % name))
        return findings

    def finalize(self, project):
        findings = []
        sites = project.shared.get("metric_sites", {})
        for name, decls in sorted(sites.items()):
            label_sets = sorted({labels for labels, _, _ in decls})
            if len(label_sets) <= 1:
                continue
            rendered = " vs ".join(str(tuple(s)) for s in label_sets)
            for labels, module, node in decls:
                findings.append(Finding(
                    code="M502", path=module.relpath,
                    line=node.lineno, col=node.col_offset,
                    context=qualname_of(node), detail=name,
                    message="family %r declared with inconsistent "
                            "label sets across call sites (%s) — "
                            "only the first registration wins; make "
                            "every site agree" % (name, rendered)))
        return findings
