"""D-series — donated-buffer / host-view aliasing.

On XLA:CPU the host/device boundary is *one allocation wide*:
``jax.device_put`` borrows small numpy buffers zero-copy, and
``numpy.asarray(device_array)`` returns a read-only view of the
device buffer.  Donating (``donate_argnums``) a buffer that the host
still references — or holding a host view across a step that donates
it — lets XLA reuse/free memory the host side reads or owns: the
nondeterministic glibc heap-corruption family documented against the
``models/gd.py`` span step (see ROUND6_NOTES.md).  The codes:

- **D101** — an argument passed at a donated position is read again
  after the call (the buffer is dead the moment the call dispatches).
- **D102** — a host view of a device buffer (``numpy.asarray`` over a
  ``devmem``-carrying expression) is RETAINED (stored on self / a
  global, or returned) instead of consumed transiently.
- **D103** — a module- or class-level strong reference to a jitted
  closure (``NAME = jax.jit(...)`` / ``track_jit(...)`` at import
  time) — the executable and everything its closure pins live for
  the process; prefer building lazily inside the owning object (the
  ``track_jit`` lifetime note).
"""

import ast

from veles_tpu_torch.analysis.core import (
    Pass, call_name, dotted, parent_chain, qualname_of)
from veles_tpu_torch.analysis.passes.purity import (
    _is_trackjit_name, is_jax_jit_call)


def _donate_spec(call):
    """(argnums, argnames) donated by a ``jax.jit`` call, or None."""
    nums, names = (), ()
    for kw in call.keywords:
        if kw.arg == "donate_argnums":
            nums = tuple(_const_ints(kw.value))
        elif kw.arg == "donate_argnames":
            names = tuple(_const_strs(kw.value))
    return (nums, names) if nums or names else None


def _const_ints(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [e.value for e in node.elts
                if isinstance(e, ast.Constant)
                and isinstance(e.value, int)]
    return []


def _const_strs(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [e.value for e in node.elts
                if isinstance(e, ast.Constant)
                and isinstance(e.value, str)]
    return []


def _donating_jit_calls(tree):
    """Every ``jax.jit(..., donate_argnums=...)`` call node with its
    donation spec."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and is_jax_jit_call(node):
            spec = _donate_spec(node)
            if spec is not None:
                out.append((node, spec))
    return out


def _enclosing_method(node):
    for p in parent_chain(node):
        if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return p
    return None


class DonationPass(Pass):
    NAME = "donation"
    CODES = {
        "D101": "argument at a donated position is read after the "
                "call (the donated buffer is already dead)",
        "D102": "host view of a device buffer retained (stored or "
                "returned) — aliases memory a later donated step may "
                "reuse or free",
        "D103": "module/class-level strong reference to a jitted "
                "closure (executable + closure pinned for the "
                "process lifetime)",
    }

    def run(self, module, project):
        findings = []
        findings.extend(self._check_read_after_donate(module))
        findings.extend(self._check_host_views(module))
        findings.extend(self._check_global_jit_refs(module))
        return findings

    # -- D101 -------------------------------------------------------------

    def _callable_specs(self, tree):
        """Donation specs reachable from call sites in this module:
        ``name`` -> (argnums, argnames), where name is a plain
        function name, ``self.attr``, or resolved one level through
        ``self.attr = self._build()`` / builders whose return value
        is a donating jit (the gd.py idiom)."""
        specs = {}
        # direct: X = [track_jit(...,] jax.jit(f, donate...) [)]
        # and builder methods whose return wraps a donating jit
        builders = {}
        for call, spec in _donating_jit_calls(tree):
            assign = ret = None
            for p in parent_chain(call):
                if isinstance(p, ast.Assign):
                    assign = p
                    break
                if isinstance(p, ast.Return):
                    ret = p
                    break
                if isinstance(p, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                    break
            if assign is not None:
                for t in assign.targets:
                    name = dotted(t)
                    if name:
                        specs[name] = spec
            elif ret is not None:
                method = _enclosing_method(ret)
                if method is not None:
                    builders[method.name] = spec
        # one hop: X = <builder>() / self.attr = self.<builder>()
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                callee = dotted(node.value.func) or ""
                bname = callee.split(".")[-1]
                if bname in builders and callee in (
                        bname, "self." + bname):
                    for t in node.targets:
                        name = dotted(t)
                        if name:
                            specs[name] = builders[bname]
        return specs

    def _check_read_after_donate(self, module):
        findings = []
        specs = self._callable_specs(module.tree)
        if not specs:
            return findings
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name not in specs:
                continue
            argnums, argnames = specs[name]
            donated = []
            for i in argnums:
                if i < len(node.args):
                    donated.append(node.args[i])
            for kw in node.keywords:
                if kw.arg in argnames:
                    donated.append(kw.value)
            fn = _enclosing_method(node)
            if fn is None:
                continue
            stmt = node
            while getattr(stmt, "_parent", None) is not None \
                    and stmt._parent is not fn:
                stmt = stmt._parent
            for arg in donated:
                expr = dotted(arg)
                if not expr:
                    continue
                hit = self._load_after(fn, stmt, expr)
                if hit is not None:
                    findings.append(self.finding(
                        module, hit, "D101", qualname_of(node),
                        "%s->%s" % (name, expr),
                        "`%s` was donated to `%s` above (its buffer "
                        "is dead after dispatch) but is read again "
                        "here" % (expr, name)))
        return findings

    @staticmethod
    def _load_after(fn, call_stmt, expr):
        """First Load of dotted ``expr`` in ``fn`` lexically after
        ``call_stmt`` ends (assignments to it don't count; a
        multi-line call's own arguments are part of the call)."""
        line = getattr(call_stmt, "end_lineno", None) \
            or call_stmt.lineno
        best = None
        for node in ast.walk(fn):
            if not isinstance(node, (ast.Attribute, ast.Name)):
                continue
            if not isinstance(getattr(node, "ctx", None), ast.Load):
                continue
            if node.lineno <= line:
                continue
            if dotted(node) != expr:
                continue
            # skip loads that are just the target of a re-assignment
            # chain (`x.devmem = new` parses devmem as Store; inner
            # `x` is a Load — ignore prefix loads inside a Store)
            parent = getattr(node, "_parent", None)
            skip = False
            while isinstance(parent, ast.Attribute):
                if isinstance(parent.ctx, ast.Store):
                    skip = True
                    break
                parent = getattr(parent, "_parent", None)
            if skip:
                continue
            if best is None or node.lineno < best.lineno:
                best = node
        return best

    # -- D102 -------------------------------------------------------------

    @staticmethod
    def _mentions_devmem(node):
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute) and "devmem" in sub.attr:
                return True
            if isinstance(sub, ast.Name) and "devmem" in sub.id:
                return True
        return False

    def _check_host_views(self, module):
        findings = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            if call_name(node) not in ("numpy.asarray", "np.asarray"):
                continue
            if not node.args or not self._mentions_devmem(node.args[0]):
                continue
            retained = None
            for p in parent_chain(node):
                if isinstance(p, ast.Assign):
                    for t in p.targets:
                        name = dotted(t)
                        if name and (name.startswith("self.")
                                     or _enclosing_method(p) is None):
                            retained = ("stored as `%s`" % name, name)
                    break
                if isinstance(p, ast.Return):
                    m = _enclosing_method(p)
                    retained = ("returned from `%s`"
                                % (m.name if m else "<module>"),
                                "return")
                    break
                if isinstance(p, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                    break
            if retained is None:
                continue  # transient consumption is the safe idiom
            how, detail = retained
            findings.append(self.finding(
                module, node, "D102", qualname_of(node), detail,
                "host view `numpy.asarray(<devmem>)` %s — it aliases "
                "the device buffer; a later donated step can reuse or "
                "free that memory while this view still reads it "
                "(copy with numpy.array, or detach before donation)"
                % how))
        return findings

    # -- D103 -------------------------------------------------------------

    def _check_global_jit_refs(self, module):
        findings = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Assign):
                continue
            if _enclosing_method(node) is not None:
                continue  # function-local jit builds own their lifetime
            culprit = None
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Call) and (
                        is_jax_jit_call(sub)
                        or _is_trackjit_name(call_name(sub))):
                    culprit = sub
                    break
            if culprit is None:
                continue
            targets = ", ".join(
                filter(None, (dotted(t) for t in node.targets)))
            findings.append(self.finding(
                module, node, "D103", qualname_of(node),
                targets or "<assign>",
                "module/class-level `%s = ...jit...` holds a strong "
                "reference to the jitted closure for the process "
                "lifetime — executables and closure captures can "
                "never be freed (track_jit lifetime note); build "
                "lazily inside the owning object instead" % targets))
        return findings
