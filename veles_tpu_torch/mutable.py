"""Shared mutable state primitives for graph control flow (the port of
``veles_tpu/mutable.py``):

- :class:`Bool` (ref: veles/mutable.py:44-190) — a *shared, mutable*
  boolean cell with lazy expression algebra.  Units hold references to the
  same Bool, so a Decider flipping ``complete`` instantly changes every
  gate built from it (``~complete``, ``complete & other`` …).  Derived
  Bools re-evaluate their expression on every read.
- :class:`LinkableAttribute` (ref: veles/mutable.py:219-357) — property
  forwarding between objects, the mechanism behind ``Unit.link_attrs``:
  reading ``dst.attr`` transparently reads ``src.attr`` (two-way optional).

Both are plain host-side Python: they drive the workflow's scheduler,
never device code.
"""


class Bool:
    """Shared mutable boolean with lazy expression algebra.

    ``b = Bool(False)``; ``bool(b)`` reads it; ``b << True`` (or
    ``b.set(True)``) writes it.  ``~a``, ``a & b``, ``a | b``, ``a ^ b``
    build *derived* Bools that re-evaluate lazily, so gates stay live as
    their sources flip (ref: veles/mutable.py:77-85).
    """

    __slots__ = ("_value", "_op", "_sources", "name")

    #: closed op set — named (not lambdas) so expression trees pickle with
    #: structure intact; the reference marshaled lambda code objects instead
    #: (veles/mutable.py:163-190), which is fragile across versions.
    _OPS = {
        "not": lambda a: not a,
        "and": lambda a, b: a and b,
        "or": lambda a, b: a or b,
        "xor": lambda a, b: a != b,
    }

    def __init__(self, value=False, name=None):
        self._value = bool(value)
        self._op = None
        self._sources = ()
        self.name = name

    @classmethod
    def _derived(cls, op, sources, name):
        b = cls(False, name)
        b._op = op
        b._sources = tuple(sources)
        return b

    # -- reading ----------------------------------------------------------

    def __bool__(self):
        if self._op is not None:
            return self._OPS[self._op](*[bool(s) for s in self._sources])
        return self._value

    # -- writing ----------------------------------------------------------

    def set(self, value):
        if self._op is not None:
            raise ValueError("cannot assign to a derived Bool (%s)" % self)
        self._value = bool(value)
        return self

    def __ilshift__(self, value):
        """``b <<= True`` — in-place assignment that keeps identity (other
        holders of this Bool see the change)."""
        return self.set(value)

    def __lshift__(self, value):
        return self.set(value)

    def __eq__(self, other):
        """A Bool equals a plain bool of its current value, and another
        Bool only when it is the same cell."""
        if isinstance(other, Bool):
            return self is other
        if isinstance(other, bool):
            return bool(self) == other
        return NotImplemented

    __hash__ = object.__hash__

    # -- algebra (lazy) ----------------------------------------------------

    def __invert__(self):
        return Bool._derived("not", (self,), "~%s" % self.name)

    def __and__(self, other):
        other = other if isinstance(other, Bool) else Bool(other)
        return Bool._derived("and", (self, other), "&")

    def __or__(self, other):
        other = other if isinstance(other, Bool) else Bool(other)
        return Bool._derived("or", (self, other), "|")

    def __xor__(self, other):
        other = other if isinstance(other, Bool) else Bool(other)
        return Bool._derived("xor", (self, other), "^")

    __rand__ = __and__
    __ror__ = __or__
    __rxor__ = __xor__

    # -- pickling ----------------------------------------------------------
    # Expression structure AND shared identity survive pickling: source
    # Bools are pickled by reference, so within one workflow pickle the
    # memo keeps `cnt.complete` and the gates derived from it wired to the
    # same object after load.

    def __getstate__(self):
        return {"value": self._value, "op": self._op,
                "sources": self._sources, "name": self.name}

    def __setstate__(self, state):
        self._value = state["value"]
        self._op = state["op"]
        self._sources = state["sources"]
        self.name = state.get("name")

    def __reduce__(self):
        return (_rebuild_bool, (self.__getstate__(),))

    def __repr__(self):
        kind = "derived" if self._op is not None else "plain"
        return "<Bool %s %s=%s>" % (kind, self.name or id(self), bool(self))


def _rebuild_bool(state):
    b = Bool()
    b.__setstate__(state)
    return b


def unshadow(cls):
    """The original class beneath any LinkableAttribute shadow class —
    pickling must reference this one, since the shadow is synthetic and
    unimportable."""
    while getattr(cls, "_linkable_shadow_", False) \
            and "_linkable_shadow_" in cls.__dict__:
        cls = cls.__mro__[1]
    return cls


class LinkableAttribute:
    """Forward ``obj.name`` to ``src_obj.src_name``.

    ``LinkableAttribute(dst, "minibatch_data", (loader, "minibatch_data"))``
    installs a property on a per-instance shadow class so only *this* dst
    instance forwards (ref: veles/mutable.py:219-357).  With
    ``two_way=True`` writes propagate back to the source.
    """

    def __init__(self, obj, name, source, two_way=False, assign_now=True):
        src_obj, src_name = source
        self.obj, self.name = obj, name
        self.src_obj, self.src_name = src_obj, src_name
        self.two_way = two_way
        cls = type(obj)
        if not getattr(cls, "_linkable_shadow_", False):
            shadow = type(cls.__name__, (cls,), {"_linkable_shadow_": True})
            obj.__class__ = shadow
        # remove any plain instance attribute that would mask the property
        obj.__dict__.pop(name, None)

        def fget(_self, _src=src_obj, _sn=src_name, _name=name):
            # a one-way write detaches the link: the instance dict then
            # shadows the forwarding property (checked here because a data
            # descriptor otherwise wins over __dict__)
            if _name in _self.__dict__:
                return _self.__dict__[_name]
            return getattr(_src, _sn)

        if two_way:
            def fset(_self, value, _src=src_obj, _sn=src_name):
                setattr(_src, _sn, value)
        else:
            def fset(_self, value, _name=name):
                _self.__dict__[_name] = value

        setattr(type(obj), name, property(fget, fset))
        links = obj.__dict__.setdefault("_linked_attrs_", {})
        links[name] = (src_obj, src_name, two_way)

    @staticmethod
    def unlink(obj, name):
        """Detach a linked attribute, freezing its current value."""
        links = obj.__dict__.get("_linked_attrs_", {})
        if name in links:
            value = getattr(obj, name)
            try:
                delattr(type(obj), name)
            except AttributeError:
                pass
            obj.__dict__[name] = value
            del links[name]
