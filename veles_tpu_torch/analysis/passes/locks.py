"""L-series — lock discipline in threaded modules.

The pass only looks at modules that import ``threading`` (the
prefetch pipeline, the serving scheduler, telemetry, the DCN
coordinator...).  Within those it reconstructs, per class:

- the **lock attributes** (``self._lock = threading.Lock()`` /
  ``RLock`` / ``Condition``), plus module-level locks;
- the **thread-side methods**: every ``threading.Thread(target=...)``
  entry point and everything reachable from one through ``self.m()``
  calls;
- every **attribute write** (``self.x = ...``, ``self.x[...] = ...``,
  mutating calls like ``self.x.append(...)``) and whether it happens
  under a ``with <lock>:`` block.  Methods named ``*_locked`` are
  treated as called-with-lock-held (the repo's convention).

The codes:

- **L301** — an attribute written both from a thread target and from
  other code, with at least one of those writes outside any lock.
- **L302** — a check-then-act on shared state outside a lock:
  ``if x in d: ... d[x] = ...``, lazy-init ``if self.x is None:
  self.x = ...`` (including the early-``return`` variant), and
  boolean latches ``if not self.x: self.x = True`` — the race
  ``compile_tracker``'s ``_cost_lock`` guards against.

``__init__`` / ``init_unpickled`` writes are construction-time and
ignored.
"""

import ast

from veles_tpu_torch.analysis.core import (
    Pass, call_name, dotted, parent_chain, with_lock_names)

_LOCK_FACTORIES = ("threading.Lock", "threading.RLock",
                   "threading.Condition")
_MUTATORS = ("append", "appendleft", "add", "remove", "discard",
             "pop", "popleft", "clear", "update", "extend",
             "setdefault", "insert")
_CTOR_METHODS = ("__init__", "init_unpickled", "__new__")


def _self_attr(node):
    """``x`` for ``self.x`` (exactly one level), else None."""
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


class _ClassModel:
    def __init__(self, node):
        self.node = node
        self.methods = {
            n.name: n for n in node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        self.lock_attrs = set()
        self.thread_targets = set()

    def scan(self):
        for m in self.methods.values():
            for node in ast.walk(m):
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node)
                if name in _LOCK_FACTORIES:
                    assign = getattr(node, "_parent", None)
                    if isinstance(assign, ast.Assign):
                        for t in assign.targets:
                            attr = _self_attr(t)
                            if attr:
                                self.lock_attrs.add(attr)
                elif name and name.split(".")[-1] == "Thread":
                    for kw in node.keywords:
                        if kw.arg != "target":
                            continue
                        tgt = dotted(kw.value) or ""
                        if tgt.startswith("self."):
                            self.thread_targets.add(
                                tgt.split(".", 1)[1])
        return self

    def thread_side(self):
        """Methods reachable from a Thread target via self.m()."""
        seen = set(t for t in self.thread_targets
                   if t in self.methods)
        frontier = list(seen)
        while frontier:
            m = frontier.pop()
            for node in ast.walk(self.methods[m]):
                if isinstance(node, ast.Call):
                    callee = dotted(node.func) or ""
                    if callee.startswith("self."):
                        name = callee.split(".")[1]
                        if name in self.methods and name not in seen:
                            seen.add(name)
                            frontier.append(name)
        return seen


class LocksPass(Pass):
    NAME = "locks"
    CODES = {
        "L301": "attribute written from a Thread target and from "
                "other code without a common lock",
        "L302": "check-then-act on shared state outside a lock "
                "(if-in/lazy-init/latch races)",
    }

    def run(self, module, project):
        if not module.imports_threading:
            return []
        findings = []
        module_locks = self._module_locks(module.tree)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                model = _ClassModel(node).scan()
                findings.extend(self._check_class(
                    module, model, module_locks))
        return findings

    @staticmethod
    def _module_locks(tree):
        """Module- and class-body-level lock names (``_lock =
        threading.Lock()`` at either level)."""
        locks = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and call_name(node.value) in _LOCK_FACTORIES:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        locks.add(t.id)
        return locks

    # -- write collection -------------------------------------------------

    def _is_locked(self, node, model, module_locks, method):
        if method.name.endswith("_locked"):
            return True  # repo convention: caller holds the lock
        for held in with_lock_names(node):
            tail = held.split(".")[-1]
            if tail in model.lock_attrs or tail in module_locks \
                    or held in module_locks:
                return True
        return False

    def _attr_writes(self, method):
        """(attr, node) pairs for every write to a ``self.``
        attribute in ``method`` — assignments, subscript stores,
        deletes, and mutating calls (append/pop/...)."""
        out = []
        for node in ast.walk(method):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets \
                    if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    attr = _self_attr(t)
                    if attr:
                        out.append((attr, node))
                    elif isinstance(t, ast.Subscript):
                        attr = _self_attr(t.value)
                        if attr:
                            out.append((attr, node))
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        attr = _self_attr(t.value)
                        if attr:
                            out.append((attr, node))
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATORS:
                attr = _self_attr(node.func.value)
                if attr:
                    out.append((attr, node))
        return out

    # -- L301 -------------------------------------------------------------

    def _check_class(self, module, model, module_locks):
        findings = []
        thread_side = model.thread_side()
        if thread_side:
            findings.extend(self._check_shared_writes(
                module, model, module_locks, thread_side))
        findings.extend(self._check_check_then_act(
            module, model, module_locks))
        return findings

    def _check_shared_writes(self, module, model, module_locks,
                             thread_side):
        per_attr = {}   # attr -> {"thread": [...], "main": [...]}
        for name, method in model.methods.items():
            if name in _CTOR_METHODS:
                continue
            side = "thread" if name in thread_side else "main"
            for attr, node in self._attr_writes(method):
                if attr in model.lock_attrs:
                    continue
                locked = self._is_locked(node, model, module_locks,
                                         method)
                per_attr.setdefault(attr, {"thread": [], "main": []})[
                    side].append((node, locked, name))
        findings = []
        for attr, sides in sorted(per_attr.items()):
            if not sides["thread"] or not sides["main"]:
                continue
            unlocked = [(n, m) for n, lk, m in
                        sides["thread"] + sides["main"] if not lk]
            if not unlocked:
                continue
            node, method = unlocked[0]
            t_m = sorted({m for _, _, m in sides["thread"]})
            m_m = sorted({m for _, _, m in sides["main"]})
            findings.append(self.finding(
                module, node, "L301",
                "%s.%s" % (model.node.name, method), attr,
                "`self.%s` is written from the thread side (%s) AND "
                "from other code (%s) but this write holds no lock "
                "— guard every write with a common lock"
                % (attr, ", ".join(t_m), ", ".join(m_m))))
        return findings

    # -- L302 -------------------------------------------------------------

    def _check_check_then_act(self, module, model, module_locks):
        findings = []
        for name, method in model.methods.items():
            if name in _CTOR_METHODS:
                continue
            for node in ast.walk(method):
                if not isinstance(node, ast.If):
                    continue
                if self._is_locked(node, model, module_locks, method):
                    continue
                hit = self._ctca_pattern(node, method)
                if hit is not None:
                    attr, kind = hit
                    findings.append(self.finding(
                        module, node, "L302",
                        "%s.%s" % (model.node.name, name), attr,
                        "check-then-act (%s) on `self.%s` outside a "
                        "lock — another thread can interleave between "
                        "the test and the write" % (kind, attr)))
        return findings

    def _ctca_pattern(self, if_node, method):
        """(attr, kind) when ``if_node`` is a guarded write race."""
        test = if_node.test
        # if KEY in self.d / if KEY not in self.d  ... self.d[...] = v
        # (the write inside the If, or guarded by an early return)
        if isinstance(test, ast.Compare) and len(test.ops) == 1 \
                and isinstance(test.ops[0], (ast.In, ast.NotIn)):
            attr = _self_attr(test.comparators[0])
            if attr:
                if self._writes_attr_in(if_node, attr):
                    return attr, "membership test"
                if if_node.body and isinstance(
                        if_node.body[0], (ast.Return, ast.Raise)) \
                        and self._writes_attr_after(if_node, method,
                                                    attr):
                    return attr, "membership test"
        # if self.x is None / if self.x is not None / if not self.x /
        # if self.x   ->   self.x = ...
        attr = self._guarded_attr(test)
        if attr is None:
            return None
        if self._writes_attr_in(if_node, attr):
            return attr, "lazy-init"
        # early-return variant: if self.x is not None: return ;
        # ... self.x = ...   later in the same method
        if if_node.body and isinstance(if_node.body[0],
                                       (ast.Return, ast.Raise)) \
                and self._writes_attr_after(if_node, method, attr):
            return attr, "early-return guard"
        return None

    def _writes_attr_after(self, if_node, method, attr):
        end = getattr(if_node, "end_lineno", if_node.lineno)
        for node in ast.walk(method):
            if getattr(node, "lineno", 0) <= end:
                continue
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if _self_attr(t) == attr:
                        return True
                    if isinstance(t, ast.Subscript) \
                            and _self_attr(t.value) == attr:
                        return True
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATORS \
                    and _self_attr(node.func.value) == attr:
                return True
        return False

    @staticmethod
    def _guarded_attr(test):
        if isinstance(test, ast.Compare) and len(test.ops) == 1 \
                and isinstance(test.ops[0], (ast.Is, ast.IsNot)) \
                and isinstance(test.comparators[0], ast.Constant) \
                and test.comparators[0].value is None:
            return _self_attr(test.left)
        if isinstance(test, ast.UnaryOp) \
                and isinstance(test.op, ast.Not):
            return _self_attr(test.operand)
        return _self_attr(test)

    def _writes_attr_in(self, if_node, attr):
        for node in ast.walk(if_node):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if _self_attr(t) == attr:
                        return True
                    if isinstance(t, ast.Subscript) \
                            and _self_attr(t.value) == attr:
                        return True
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATORS \
                    and _self_attr(node.func.value) == attr:
                return True
        return False
