"""Unit class catalog (the port of ``veles_tpu/unit_registry.py``).

Rebuild of veles/unit_registry.py:51-176: a metaclass records every Unit
subclass with a stable UUID (``__id__``) so workflows can be exported and
re-instantiated by id (the C++ runner's unit factory keys on these UUIDs —
ref: libVeles/src/unit_factory.cc:1-65), and so tooling can enumerate the
full unit catalog.  :class:`MappedUnitRegistry` adds named factories
(normalizers, loaders, publishing backends…).
"""

import uuid

from veles_tpu_torch.distributable import Distributable

#: deterministic namespace so a class's UUID is stable across processes —
#: required for package_export archives to be loadable anywhere.
_NAMESPACE = uuid.UUID("6ba7b812-9dad-11d1-80b4-00c04fd430c8")


class UnitRegistry(type):
    """Metaclass cataloguing all Unit subclasses
    (ref: veles/unit_registry.py:51-176)."""

    #: name -> class for every registered (non-hidden) unit class
    units = {}
    #: str(uuid) -> class
    by_id = {}

    def __init__(cls, name, bases, namespace):
        super(UnitRegistry, cls).__init__(name, bases, namespace)
        # every class gets a stable id (tooling reads .id on any unit);
        # hidden classes just stay out of the catalog
        cls.__id__ = namespace.get(
            "__id__", str(uuid.uuid5(_NAMESPACE, cls.__module__ + "." + name)))
        if namespace.get("hide_from_registry", False):
            return
        UnitRegistry.units[name] = cls
        UnitRegistry.by_id[cls.__id__] = cls


class MappedUnitRegistry(UnitRegistry):
    """Metaclass for families addressed by a ``MAPPING`` name, e.g.
    normalizers (ref: veles/normalization.py:110) and loaders.

    Subclass hierarchies set ``mapping_root`` truthy on the base class;
    concrete classes declare ``MAPPING = "name"``.
    """

    registries = {}

    def __init__(cls, name, bases, namespace):
        super(MappedUnitRegistry, cls).__init__(name, bases, namespace)
        mapping = namespace.get("MAPPING")
        if mapping is None:
            return
        # find the hierarchy root: nearest base that *declares*
        # mapping_root in its own body (inherited copies don't count, or
        # intermediate bases would capture the family)
        for base in cls.__mro__[1:]:
            if vars(base).get("mapping_root", False):
                MappedUnitRegistry.registries.setdefault(
                    base.__name__, {})[mapping] = cls
                break

    @staticmethod
    def get_factory(root_name, mapping):
        fam = MappedUnitRegistry.registries.get(root_name, {})
        try:
            return fam[mapping]
        except KeyError:
            raise KeyError("no %r registered under %s (have: %s)" % (
                mapping, root_name, sorted(fam)))


class RegisteredDistributable(Distributable, metaclass=UnitRegistry):
    """Distributable whose subclasses are auto-catalogued."""
    hide_from_registry = True
