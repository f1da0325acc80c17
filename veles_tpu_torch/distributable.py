"""Pickling base + the distributable contract (the port of
``veles_tpu/distributable.py``):

- :class:`Pickleable` (ref: veles/distributable.py:48-134) — snapshotting
  works by pickling live object graphs.  Convention: attributes whose name
  ends with ``_`` are *volatile* (locks, compiled functions, device
  handles, loggers) — they are skipped by ``__getstate__`` and rebuilt by
  ``init_unpickled()`` after load.
- :class:`IDistributable` (ref: veles/distributable.py:222-281) — the
  5-method contract units implement to take part in master–slave style
  data exchange; the workflow aggregates it over its units, and the
  elastic coordinator (:mod:`veles_tpu_torch.parallel.coordinator`)
  drives it in the launcher's master and worker modes.
- :class:`TriviallyDistributable` — no-op defaults.

Tensors in a pickled state are host copies (:func:`host_state`): a
snapshot written on the card loads on the CPU, and ``initialize(device=)``
puts it back on a device.
"""

import threading

import torch

from veles_tpu_torch.logger import Logger


def host_state(value):
    """``value`` with every tensor in it (through dicts, lists and
    tuples) replaced by a detached CPU copy; a container holding no
    tensor is returned as it is, so shared containers stay shared."""
    if torch.is_tensor(value):
        return value.detach().cpu().clone()
    if isinstance(value, dict) and type(value) is dict:
        items = [(k, v, host_state(v)) for k, v in value.items()]
        if all(h is v for _, v, h in items):
            return value
        return {k: h for k, _, h in items}
    if type(value) in (list, tuple):
        items = [(v, host_state(v)) for v in value]
        if all(h is v for v, h in items):
            return value
        return type(value)(h for _, h in items)
    return value


def _reconstruct(cls):
    """Unpickling helper: bare instance of the real (unshadowed) class."""
    return cls.__new__(cls)


class Pickleable(Logger):
    """Base for everything snapshot-able.

    Subclasses put volatile state in attributes ending with ``_`` and
    (re)create them inside :meth:`init_unpickled`, which runs both at
    construction and after unpickling (ref: veles/distributable.py:75-119).
    """

    def __init__(self, **kwargs):
        super(Pickleable, self).__init__(**kwargs)
        self.init_unpickled()

    def init_unpickled(self):
        """(Re)build volatile state.  Subclasses must call super()."""
        self._pickle_lock_ = threading.Lock()

    def __getstate__(self):
        state = {}
        for k, v in self.__dict__.items():
            if k.endswith("_"):
                continue
            state[k] = host_state(v)
        return state

    def __setstate__(self, state):
        links = state.pop("__links__", None)
        self.__dict__.update(state)
        self.init_unpickled()
        if links:
            from veles_tpu_torch.mutable import LinkableAttribute
            for name, src_obj, src_name, two_way in links:
                LinkableAttribute(self, name, (src_obj, src_name),
                                  two_way=two_way)

    def __reduce_ex__(self, protocol):
        # Instances whose class was shadowed by LinkableAttribute pickle
        # through the original class; the link *records* ride along in
        # state (source objects pickle by reference, so identity within a
        # workflow snapshot is preserved by the pickle memo) and the
        # forwarding properties are re-installed in __setstate__.
        from veles_tpu_torch.mutable import unshadow
        cls = unshadow(type(self))
        state = self.__getstate__()
        links = self.__dict__.get("_linked_attrs_")
        if links:
            state["__links__"] = [
                (name, src, sn, tw)
                for name, (src, sn, tw) in links.items()
                # a detached (written-through) one-way link is a plain
                # attribute now; don't resurrect the forwarding
                if name not in self.__dict__]
        return (_reconstruct, (cls,), state)


class IDistributable:
    """The master–slave data-exchange contract
    (ref: veles/distributable.py:222-281).

    ``generate_data_for_slave(slave)`` → picklable job payload;
    ``apply_data_from_master(data)`` consumes it on the worker;
    ``generate_data_for_master()`` → picklable update payload;
    ``apply_data_from_slave(data, slave)`` merges it on the master;
    ``drop_slave(slave)`` undoes in-flight work for a dead worker.
    """

    def generate_data_for_slave(self, slave):
        raise NotImplementedError()

    def generate_data_for_master(self):
        raise NotImplementedError()

    def apply_data_from_master(self, data):
        raise NotImplementedError()

    def apply_data_from_slave(self, data, slave):
        raise NotImplementedError()

    def drop_slave(self, slave):
        raise NotImplementedError()


class Distributable(Pickleable, IDistributable):
    """Pickleable + trivial distributable defaults
    (ref: veles/distributable.py:136-220, 285-302)."""

    #: units that genuinely exchange data override this to True so the
    #: coordinator knows to call the contract methods.
    negotiates_on_connect = False

    def generate_data_for_slave(self, slave):
        return None

    def generate_data_for_master(self):
        return None

    def apply_data_from_master(self, data):
        pass

    def apply_data_from_slave(self, data, slave):
        pass

    def drop_slave(self, slave):
        pass


#: the reference's name for the no-op defaults
TriviallyDistributable = Distributable
