"""T-series — jit purity.

Inside a traced function, Python runs ONCE (at trace time): side
effects silently stop repeating, host reads of traced values either
crash or bake a stale constant into the executable, and a ``jax.jit``
that never routes through ``telemetry.track_jit`` compiles outside
the registry's cost accounting.  The codes:

- **T201** — Python side effect inside a jitted function (``global``
  statement, ``print``/``open``/``input``, ``time.*``, stdlib
  ``random.*`` / ``numpy.random.*``, ``self.attr = ...`` stores).
- **T202** — tracer concretization: ``float()/int()/bool()`` or
  ``.item()/.tolist()`` on a non-constant value inside a jitted
  function (fails under jit, or silently freezes a trace-time value).
- **T203** — ``jax.jit`` site not wrapped by ``track_jit`` (the
  compile would escape ``veles_jit_*`` metrics and cost accounting;
  formerly tests/test_jit_guard.py).
- **T204** — a required stable entry-point registration
  (``track_jit("<name>", ...)``) is missing from its module — bench
  and the compile dashboards key on these names.
"""

import ast
from pathlib import Path

from veles_tpu_torch.analysis.core import (
    Pass, call_name, dotted, parent_chain, qualname_of)

#: the package whose modules T204 asserts nothing over: the port runs
#: eagerly and compiles no serving entry point to register
EAGER_PACKAGE = "veles_tpu_torch"

#: (relpath, stable name) registrations that must exist — serving's
#: compiled entry points; an unregistered paged-attention jit would
#: silently escape cost accounting (formerly
#: test_jit_guard.SERVING_ENTRY_POINTS)
REQUIRED_REGISTRATIONS = (
    ("serving/engine.py", "serving.slot_step"),
    ("serving/engine.py", "serving.paged_step"),
    ("serving/engine.py", "serving.verify_step"),
    ("serving/engine.py", "serving.sample_first"),
    ("serving/engine.py", "serving.paged_step_tp"),
    ("serving/draft.py", "serving.draft_step"),
    ("serving/draft.py", "serving.draft_train"),
    ("serving/prefill.py", "serving.prefill"),
    ("serving/prefill.py", "serving.prefill_chunk"),
    ("serving/openai_api.py", "serving.embed_pool"),
    ("serving/kv_slots.py", "serving.kv_insert_row"),
    ("serving/kv_slots.py", "serving.kv_insert_blocks"),
    ("serving/kv_slots.py", "serving.kv_gather_blocks"),
    ("serving/kv_slots.py", "serving.kv_quant_insert_blocks"),
    ("serving/kv_slots.py", "serving.kv_quant_gather_blocks"),
    ("serving/kv_slots.py", "serving.kv_export_blocks"),
    ("serving/kv_slots.py", "serving.kv_import_blocks"),
)

def _is_trackjit_name(name):
    """``track_jit`` under any import alias (``telemetry.track_jit``,
    a leading-underscore local alias, ...)."""
    return bool(name) and name.split(".")[-1].lstrip("_") == "track_jit"


#: callables that concretize a traced value
_CONCRETIZERS = ("float", "int", "bool")
_CONCRETIZE_METHODS = ("item", "tolist")

#: dotted-prefix calls that are host side effects under trace
_EFFECT_PREFIXES = ("time.", "random.", "numpy.random.", "np.random.",
                    "os.")
_EFFECT_BUILTINS = ("print", "open", "input")


def is_jax_jit_call(node):
    """True for ``jax.jit(...)`` and ``functools.partial(jax.jit,
    ...)`` call nodes."""
    name = call_name(node)
    if name == "jax.jit":
        return True
    if name in ("functools.partial", "partial") and node.args:
        return dotted(node.args[0]) == "jax.jit"
    return False


def _is_jit_decorator(dec):
    if dotted(dec) == "jax.jit":
        return True
    return isinstance(dec, ast.Call) and is_jax_jit_call(dec)


def jit_sites(tree):
    """Every ``jax.jit`` occurrence: ``(node, kind)`` where kind is
    ``"call"`` (a Call expression) or ``"decorator"`` (on a def)."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and is_jax_jit_call(node):
            out.append((node, "call"))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if _is_jit_decorator(dec):
                    out.append((node, "decorator"))
    return out


def jitted_functions(tree):
    """FunctionDef/Lambda nodes that get traced: jit-decorated defs,
    local defs passed to ``jax.jit(f, ...)`` by name, and lambdas
    inlined into a jit call.  Nested defs inside a traced function
    are traced too — callers should walk the returned nodes' full
    subtrees."""
    defs = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
    jitted = []
    for node, kind in jit_sites(tree):
        if kind == "decorator":
            jitted.append(node)
            continue
        args = list(node.args)
        # functools.partial(jax.jit, ...) carries no function yet —
        # the wrapped def is found through its decorator form instead
        if call_name(node) in ("functools.partial", "partial"):
            continue
        if not args:
            continue
        target = args[0]
        if isinstance(target, ast.Lambda):
            jitted.append(target)
        elif isinstance(target, ast.Name):
            jitted.extend(defs.get(target.id, ()))
    return jitted


def _in_jitted(node, jitted_set):
    return any(p in jitted_set for p in parent_chain(node)) \
        or node in jitted_set


def _const_free(node):
    """False when the expression is trivially static (literals,
    ``.shape``/``.ndim``/``.dtype`` reads, ``len()``)."""
    if isinstance(node, ast.Constant):
        return False
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in (
                "shape", "ndim", "dtype"):
            return False
        if isinstance(sub, ast.Call) and dotted(sub.func) == "len":
            return False
    return True


class PurityPass(Pass):
    NAME = "purity"
    CODES = {
        "T201": "Python side effect inside a jitted function "
                "(runs once at trace time, then never again)",
        "T202": "tracer concretization (float/int/bool/.item on a "
                "traced value) inside a jitted function",
        "T203": "jax.jit site not routed through telemetry.track_jit "
                "(compiles escape veles_jit_* accounting)",
        "T204": "required stable track_jit entry-point registration "
                "missing from its module",
    }

    def run(self, module, project):
        findings = []
        for fn in set(jitted_functions(module.tree)):
            findings.extend(self._check_purity(module, fn))
        findings.extend(self._check_tracked(module))
        return findings

    # -- T201 / T202 -----------------------------------------------------

    def _check_purity(self, module, fn):
        findings = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Global):
                findings.append(self.finding(
                    module, node, "T201", qualname_of(node),
                    "global:" + ",".join(node.names),
                    "`global %s` inside a jitted function — the "
                    "rebind happens at trace time only"
                    % ", ".join(node.names)))
            elif isinstance(node, ast.Call):
                findings.extend(self._check_call(module, node))
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets \
                    if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    name = dotted(t)
                    if name and name.startswith("self."):
                        findings.append(self.finding(
                            module, node, "T201", qualname_of(node),
                            name,
                            "attribute store `%s = ...` inside a "
                            "jitted function mutates host state at "
                            "trace time only" % name))
        return findings

    def _check_call(self, module, node):
        name = dotted(node.func)
        if name is None:
            return []
        if name in _EFFECT_BUILTINS or any(
                name.startswith(p) for p in _EFFECT_PREFIXES):
            return [self.finding(
                module, node, "T201", qualname_of(node), name,
                "`%s(...)` inside a jitted function is a trace-time "
                "side effect (jax.random / in-graph ops are the "
                "traced equivalents)" % name)]
        if name in _CONCRETIZERS and node.args \
                and _const_free(node.args[0]):
            return [self.finding(
                module, node, "T202", qualname_of(node), name,
                "`%s(...)` on a traced value concretizes the tracer "
                "(ConcretizationTypeError, or a stale trace-time "
                "constant)" % name)]
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _CONCRETIZE_METHODS \
                and not node.args:
            return [self.finding(
                module, node, "T202", qualname_of(node),
                "." + node.func.attr,
                "`.%s()` on a traced value concretizes the tracer"
                % node.func.attr)]
        return []

    # -- T203 -------------------------------------------------------------

    def _check_tracked(self, module):
        findings = []
        rebound = self._trackjit_rebinds(module.tree)
        for node, kind in jit_sites(module.tree):
            if kind == "call" and self._is_decorator(node):
                continue  # reported once, as the decorator site
            if kind == "decorator":
                if node.name in rebound:
                    continue
                findings.append(self.finding(
                    module, node, "T203", qualname_of(node), node.name,
                    "jit-decorated `%s` is never rebound through "
                    "track_jit(name, ...) — its compiles escape the "
                    "registry" % node.name))
            else:
                if any(isinstance(p, ast.Call)
                       and _is_trackjit_name(call_name(p))
                       for p in parent_chain(node)):
                    continue
                findings.append(self.finding(
                    module, node, "T203", qualname_of(node), "jax.jit",
                    "jax.jit site not wrapped with track_jit(name, "
                    "jax.jit(...)) — compiles escape veles_jit_* "
                    "metrics and cost accounting"))
        return findings

    @staticmethod
    def _is_decorator(call):
        parent = getattr(call, "_parent", None)
        return isinstance(parent, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)) \
            and call in parent.decorator_list

    @staticmethod
    def _trackjit_rebinds(tree):
        """Names handed to a ``track_jit(...)`` call anywhere in the
        module — ``NAME = track_jit("...", NAME)`` module rebinds
        (ops/random.py, ops/gemm.py) and ``return track_jit("...",
        decorated)`` builder returns (models/generate.py)."""
        out = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and _is_trackjit_name(
                    call_name(node)):
                for arg in node.args:
                    if isinstance(arg, ast.Name):
                        out.add(arg.id)
        return out

    # -- T204 -------------------------------------------------------------

    def finalize(self, project):
        findings = []
        for relpath, name in REQUIRED_REGISTRATIONS:
            module = None
            for m in project.modules:
                if m.relpath.endswith(relpath):
                    module = m
                    break
            if module is None:  # subset scan — nothing to assert
                continue
            if EAGER_PACKAGE in Path(module.relpath).parts \
                    or EAGER_PACKAGE in module.path.resolve().parts:
                # the port's serving modules compile nothing
                continue
            if 'track_jit("%s"' % name not in module.text:
                findings.append(self.finding(
                    module, module.tree, "T204", "<registry>", name,
                    "%s must register its compiled entry point as "
                    'track_jit("%s", jax.jit(...)) — bench and the '
                    "compile dashboards key on that name"
                    % (relpath, name)))
        return findings
