"""C-series — ``root.common.*`` config-key discipline.

``Config`` autovivifies: reading a mistyped key silently returns an
empty subtree (falsy) and writing one silently creates it, so typos
never crash — they just disable the feature they meant to configure.
The pass rebuilds the declared key tree from ``config.py``'s
``root.common.update({...})`` literal (plus any module-level
``root.common.X = ...`` assignments there) and checks every access in
the scanned tree against it:

- **C401** — a ``root.common...`` access (attribute chain read or
  write, ``.get("k")``, ``.get_dict("k")``, including one-hop
  forwarder helpers like ``_serving_conf`` and local aliases like
  ``cfg = root.common.health``) that does not resolve to a declared
  key.  An EMPTY dict literal in config.py declares an *open*
  subtree (user-supplied keys, e.g. ``publishing.confluence``) whose
  children all resolve.
- **C402** — a declared key that no scanned module ever reads (dead
  default).  Suppressed under subtrees consumed wholesale
  (``get_dict`` of the subtree, iteration, non-getter alias use) or
  read dynamically (``.get(variable)``).
"""

import ast

from veles_tpu_torch.analysis.core import (
    Finding, Pass, call_name, dotted, qualname_of)

_GETTERS = ("get", "get_dict")
_NON_KEY_ATTRS = _GETTERS + ("update", "protect", "print_",
                             "__content__")


class _DeclTree:
    """Declared config keys under ``root.common``: ``leaves`` maps a
    dotted path to its declaration line, ``subtrees`` the interior
    nodes; an empty dict literal declares an OPEN subtree whose
    content is user-supplied."""

    def __init__(self):
        self.leaves = {}
        self.subtrees = {"": 0}
        self.open_subtrees = set()
        self.path = None      # config module relpath

    def declare_dict(self, node, prefix=""):
        for k, v in zip(node.keys, node.values):
            if not isinstance(k, ast.Constant) \
                    or not isinstance(k.value, str):
                continue
            path = ("%s.%s" % (prefix, k.value)) if prefix else k.value
            if isinstance(v, ast.Dict):
                self.subtrees[path] = k.lineno
                if not v.keys:
                    self.open_subtrees.add(path)
                self.declare_dict(v, path)
            else:
                self.leaves[path] = k.lineno

    def declare_leaf(self, path, lineno):
        parts = path.split(".")
        for i in range(1, len(parts)):
            self.subtrees.setdefault(".".join(parts[:i]), lineno)
        self.leaves[path] = lineno

    def resolves(self, path):
        if path in self.leaves or path in self.subtrees:
            return True
        parts = path.split(".")
        for i in range(len(parts), 0, -1):
            if ".".join(parts[:i]) in self.open_subtrees:
                return True
        return False


class _Access:
    """One config access: ``kind`` is ``read`` (leaf value), ``store``
    (validated, but not a read for dead-key purposes) or ``dynamic``
    (subtree consumed wholesale / non-literal key — suppresses C402
    below ``path``)."""

    __slots__ = ("path", "module", "node", "kind")

    def __init__(self, path, module, node, kind="read"):
        self.path = path
        self.module = module
        self.node = node
        self.kind = kind


class ConfigKeysPass(Pass):
    NAME = "config-keys"
    CODES = {
        "C401": "root.common.* access does not resolve to a key "
                "declared in config.py (autovivification hides the "
                "typo: the feature silently stays at its default)",
        "C402": "config key declared in config.py but never read "
                "anywhere in the scanned tree (dead default)",
    }

    def run(self, module, project):
        return []  # all work happens cross-module, in finalize()

    def finalize(self, project):
        decl = self._declarations(project)
        if decl is None:
            return []  # subset scan without config.py — nothing to do
        accesses = []
        for m in project.modules:
            if m.relpath == decl.path:
                continue
            accesses.extend(self._collect(m))
        findings = []
        dynamic_roots = set()
        read_paths = set()
        for a in accesses:
            if a.path and not decl.resolves(a.path):
                findings.append(Finding(
                    code="C401", path=a.module.relpath,
                    line=a.node.lineno, col=a.node.col_offset,
                    context=qualname_of(a.node), detail=a.path,
                    message="`root.common.%s` is not declared in "
                            "config.py — a typo here autovivifies an "
                            "empty node and the intended default "
                            "silently wins (declare the key with its "
                            "default)" % a.path))
            if a.kind == "dynamic":
                dynamic_roots.add(a.path)
            elif a.kind == "read":
                read_paths.add(a.path)
        for leaf, lineno in sorted(decl.leaves.items()):
            if leaf in read_paths:
                continue
            if any(leaf == d or leaf.startswith(d + ".")
                   for d in dynamic_roots):
                continue
            # an ancestor subtree consumed wholesale covers the leaf;
            # a read below the leaf means it is really a subtree
            if any(leaf.startswith(p + ".") or p.startswith(leaf + ".")
                   for p in read_paths):
                continue
            findings.append(Finding(
                code="C402", path=decl.path, line=lineno, col=0,
                context="<config>", detail=leaf,
                message="config key `root.common.%s` is declared "
                        "with a default but never read in the "
                        "scanned tree (dead default — wire it up or "
                        "drop it)" % leaf))
        return findings

    # -- declarations ------------------------------------------------------

    def _declarations(self, project):
        for m in project.modules:
            if not m.relpath.endswith("config.py") \
                    or "root.common.update" not in m.text:
                continue
            decl = _DeclTree()
            decl.path = m.relpath
            for node in ast.walk(m.tree):
                if isinstance(node, ast.Call) \
                        and dotted(node.func) == "root.common.update" \
                        and node.args \
                        and isinstance(node.args[0], ast.Dict):
                    decl.declare_dict(node.args[0])
                elif isinstance(node, ast.Assign):
                    for t in node.targets:
                        name = dotted(t) or ""
                        if name.startswith("root.common."):
                            decl.declare_leaf(
                                name[len("root.common."):],
                                node.lineno)
            return decl
        return None

    # -- access collection -------------------------------------------------

    @staticmethod
    def _chain_under_common(node):
        name = dotted(node)
        if name is None:
            return None
        if name == "root.common":
            return ""
        if name.startswith("root.common."):
            return name[len("root.common."):]
        return None

    def _collect(self, module):
        accesses = []
        aliases = self._aliases(module)        # (scope id, name) -> path
        alias_nodes = {}                       # Assign nodes to skip
        for (scope, name), (path, assign) in aliases.items():
            alias_nodes[id(assign.value)] = (scope, name, path)
        forwarders = self._forwarders(module)
        dynamic_aliases = self._dynamic_alias_uses(module, aliases)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                accesses.extend(self._call_access(
                    module, node, aliases, forwarders))
            elif isinstance(node, ast.Attribute):
                accesses.extend(self._attr_access(
                    module, node, alias_nodes))
        accesses.extend(dynamic_aliases)
        return accesses

    def _attr_access(self, module, node, alias_nodes):
        parent = getattr(node, "_parent", None)
        if isinstance(parent, ast.Attribute):
            return []  # not maximal: the outer chain reports
        path = self._chain_under_common(node)
        if not path:
            return []
        last = path.split(".")[-1]
        if last in _NON_KEY_ATTRS:
            return []  # receiver handled in _call_access
        if isinstance(getattr(node, "ctx", None), ast.Store):
            return [_Access(path, module, node, "store")]
        if id(node) in alias_nodes:
            # alias assignment: its literal .get uses are collected
            # at the call sites; non-getter uses were pre-collected
            # as dynamic
            return [_Access(path, module, node, "alias")]
        if isinstance(parent, ast.For) and parent.iter is node:
            return [_Access(path, module, node, "dynamic")]
        if isinstance(parent, ast.Assign) and parent.value is node:
            # a non-alias assignment of a whole subtree (e.g. into an
            # attribute) — consumed wholesale
            return [_Access(path, module, node, "dynamic")]
        return [_Access(path, module, node, "read")]

    def _call_access(self, module, node, aliases, forwarders):
        name = call_name(node)
        if name is None:
            return []
        fname = name.split(".")[-1]
        if fname in forwarders and node.args:
            base = forwarders[fname]
            k = node.args[0]
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                return [_Access("%s.%s" % (base, k.value) if base
                                else k.value, module, node)]
            return [_Access(base, module, node, "dynamic")]
        if fname not in _GETTERS \
                or not isinstance(node.func, ast.Attribute):
            return []
        base_node = node.func.value
        base = self._chain_under_common(base_node)
        if base is None:
            root_name = dotted(base_node)
            scope = self._scope_id(node)
            hit = aliases.get((scope, root_name)) \
                or aliases.get((None, root_name))
            if hit is None:
                return []
            base = hit[0]
        if not node.args:
            return []
        k = node.args[0]
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            path = "%s.%s" % (base, k.value) if base else k.value
            return [_Access(path, module, node)]
        return [_Access(base, module, node, "dynamic")]

    # -- alias helpers -----------------------------------------------------

    @staticmethod
    def _scope_id(node):
        from veles_tpu_torch.analysis.core import enclosing_function
        fn = enclosing_function(node)
        return id(fn) if fn is not None else None

    def _aliases(self, module):
        """(scope id, name) -> (path, assign node) for ``cfg =
        root.common.<path>`` assignments."""
        out = {}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Attribute):
                name = dotted(node.value) or ""
                if not name.startswith("root.common."):
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[(self._scope_id(node), t.id)] = (
                            name[len("root.common."):], node)
        return out

    def _dynamic_alias_uses(self, module, aliases):
        """Alias names used OTHER than as ``alias.get("literal")``
        receivers consume the subtree wholesale — mark dynamic."""
        out = []
        by_scope = {}
        for (scope, name), (path, assign) in aliases.items():
            by_scope.setdefault(name, []).append((scope, path, assign))
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Name) \
                    or not isinstance(getattr(node, "ctx", None),
                                      ast.Load) \
                    or node.id not in by_scope:
                continue
            parent = getattr(node, "_parent", None)
            if isinstance(parent, ast.Attribute) \
                    and parent.attr in _GETTERS:
                continue  # getter receiver: handled per call site
            scope = self._scope_id(node)
            for ascope, path, assign in by_scope[node.id]:
                if ascope == scope:
                    out.append(_Access(path, module, node, "dynamic"))
        return out

    @staticmethod
    def _forwarders(module):
        """One-hop helpers: ``def f(name, default): return
        root.common.<p>.get(name, default)`` — call sites with a
        literal first argument then read ``<p>.<literal>``."""
        out = {}
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            rets = [s for s in ast.walk(node)
                    if isinstance(s, ast.Return)]
            if len(rets) != 1 or rets[0].value is None:
                continue
            call = rets[0].value
            if not isinstance(call, ast.Call):
                continue
            cname = call_name(call) or ""
            if not cname.startswith("root.common.") \
                    or cname.split(".")[-1] not in _GETTERS:
                continue
            if not call.args or not isinstance(call.args[0], ast.Name):
                continue
            params = [a.arg for a in node.args.args]
            if call.args[0].id not in params:
                continue
            base = cname[len("root.common."):]
            base = base.rsplit(".", 1)[0] if "." in base else ""
            out[node.name] = base
        return out
