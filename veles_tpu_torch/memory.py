"""Array — the host/device data pair (the port of ``veles_tpu/memory.py``).

The reference's ``Array`` keeps a numpy host mirror beside a device
buffer with an explicit ``map_read / map_write / map_invalidate /
unmap`` coherence protocol (ref: veles/memory.py:110-511).  Here the
device buffer is a torch tensor on the Array's device: loaders fill the
host mirror, ``unmap()`` (or the first :attr:`Array.devmem` read) puts it
on the device, units write device results with ``devmem = tensor``, and
``map_read()`` brings them home for metrics and snapshots.  The two views
never share memory: an upload and a fetch each copy, so a host write can
never reach a tensor a launched kernel still reads.

Coherence is the reference's 3-state machine:

- ``HOST_DIRTY``  — host mirror newer (after map_write/map_invalidate);
- ``DEV_DIRTY``   — device tensor newer (after a unit adopted a result);
- ``COHERENT``    — both views agree.

A pickled Array holds its host mirror only (a DEV_DIRTY tensor is pulled
home first), so a snapshot written on the card loads on the CPU.
``Watcher`` keeps the process-wide device byte accounting.
"""

import threading

import numpy
import torch

from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.distributable import Pickleable

COHERENT = 0
HOST_DIRTY = 1
DEV_DIRTY = 2


class Watcher:
    """Global device-memory byte accounting
    (ref: veles/memory.py:56-107)."""

    _lock = threading.Lock()
    #: device name -> bytes currently resident
    used = {}
    peak = 0

    @classmethod
    def alloc(cls, device, nbytes):
        with cls._lock:
            key = str(device)
            cls.used[key] = cls.used.get(key, 0) + nbytes
            cls.peak = max(cls.peak, sum(cls.used.values()))

    @classmethod
    def free(cls, device, nbytes):
        with cls._lock:
            key = str(device)
            cls.used[key] = max(0, cls.used.get(key, 0) - nbytes)

    @classmethod
    def total(cls):
        with cls._lock:
            return sum(cls.used.values())

    @classmethod
    def report(cls):
        with cls._lock:
            return dict(cls.used), cls.peak

    @classmethod
    def reset(cls):
        with cls._lock:
            cls.used.clear()
            cls.peak = 0


def _nbytes(t):
    return t.numel() * t.element_size()


class Array(Pickleable):
    """Host numpy mirror + device tensor (ref: veles/memory.py:110).

    Usage::

        a = Array(numpy.zeros((128, 784), numpy.float32))
        a.initialize("cuda")                            # bind a device
        a.map_write(); a.mem[...] = batch; a.unmap()    # host -> device
        a.devmem = unit_result                          # adopt a result
        a.map_read(); print(a.mem.mean())               # device -> host

    A tensor type numpy lacks (bfloat16) is mirrored as float32 on the
    host and uploaded back in its own type.
    """

    def __init__(self, data=None, shape=None, dtype=numpy.float32):
        super(Array, self).__init__()
        if data is not None:
            self._mem = numpy.ascontiguousarray(data)
        elif shape is not None:
            self._mem = numpy.zeros(shape, dtype=dtype)
        else:
            self._mem = None
        self._state = HOST_DIRTY if self._mem is not None else COHERENT
        #: the device tensor's type where numpy has no counterpart
        self._dev_dtype = None

    def init_unpickled(self):
        super(Array, self).init_unpickled()
        self._devmem_ = None
        self._device_ = None
        # snapshots store only the host mirror; the device side is
        # re-created by the next devmem read (ref: veles/memory.py:284-292)
        if getattr(self, "_mem", None) is not None:
            self._state = HOST_DIRTY

    # -- host side -----------------------------------------------------------

    @property
    def mem(self):
        """The host numpy mirror.  Call :meth:`map_read`/:meth:`map_write`
        first when a device tensor exists."""
        return self._mem

    @mem.setter
    def mem(self, value):
        self._mem = numpy.ascontiguousarray(value) \
            if value is not None else None
        self._state = HOST_DIRTY

    def reset(self, data=None):
        """Drop both views and optionally adopt new host data
        (ref: veles/memory.py:330)."""
        self._release_devmem()
        self._mem = None if data is None else numpy.ascontiguousarray(data)
        self._dev_dtype = None
        self._state = HOST_DIRTY if data is not None else COHERENT

    # -- device side ---------------------------------------------------------

    @property
    def device(self):
        """The bound device (None until :meth:`initialize`)."""
        return self._device_

    @property
    def devmem(self):
        """The device tensor (uploaded first if the host is newer)."""
        if self._state == HOST_DIRTY or self._devmem_ is None:
            self._upload()
        return self._devmem_

    @devmem.setter
    def devmem(self, value):
        """Adopt a unit's result as the new device tensor."""
        self._release_devmem()
        self._devmem_ = value
        if value is not None:
            self._note_dtype(value)
            Watcher.alloc(value.device, _nbytes(value))
            self._state = DEV_DIRTY

    def adopt(self, mem, devmem=None, dev_dirty=False):
        """Install a prepared (host mirror, device tensor) pair as they
        are: both views are taken as in agreement (or, with
        ``dev_dirty``, the device one as newer), so no copy is made."""
        self._release_devmem()
        self._mem = mem
        self._devmem_ = devmem
        if devmem is not None:
            self._note_dtype(devmem)
            Watcher.alloc(devmem.device, _nbytes(devmem))
            self._state = DEV_DIRTY if dev_dirty else COHERENT
        else:
            self._state = HOST_DIRTY

    def _note_dtype(self, t):
        self._dev_dtype = str(t.dtype).rsplit(".", 1)[-1] \
            if t.dtype == torch.bfloat16 else None

    def _release_devmem(self):
        if self._devmem_ is not None:
            Watcher.free(self._devmem_.device, _nbytes(self._devmem_))
            self._devmem_ = None

    def _upload(self):
        if self._mem is None:
            return
        self._release_devmem()
        dev = self._device_ if self._device_ is not None \
            else resolve_device()
        t = torch.from_numpy(numpy.array(self._mem)).to(dev)
        if self._dev_dtype is not None:
            t = t.to(getattr(torch, self._dev_dtype))
        self._devmem_ = t
        Watcher.alloc(t.device, _nbytes(t))
        self._state = COHERENT

    def initialize(self, device=None):
        """Bind to ``device`` (ref: veles/memory.py:347).  The tensor is
        created lazily, on the first :attr:`devmem` read; a live tensor on
        another device is brought home first and re-uploaded there."""
        if device is not None:
            device = resolve_device(device)
            if self._devmem_ is not None and self._devmem_.device != device:
                self.map_read()
                self._release_devmem()
                self._state = HOST_DIRTY
            self._device_ = device
        return self

    # -- coherence protocol (ref: veles/memory.py:371-384) -------------------

    def map_read(self):
        """Make the host mirror current."""
        if self._state == DEV_DIRTY and self._devmem_ is not None:
            t = self._devmem_.detach()
            if t.dtype == torch.bfloat16:
                t = t.to(torch.float32)
            self._mem = t.cpu().numpy().copy()
            self._state = COHERENT
        return self

    def map_write(self):
        """Host mirror current *and* about to be written."""
        self.map_read()
        self._state = HOST_DIRTY
        return self

    def map_invalidate(self):
        """Host will be fully overwritten — skip the device→host copy."""
        if self._mem is None and self._devmem_ is not None:
            t = self._devmem_
            dt = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
            self._mem = torch.zeros(t.shape, dtype=dt).numpy()
        self._state = HOST_DIRTY
        return self

    def unmap(self):
        """Flush host writes to the device tensor."""
        if self._state == HOST_DIRTY:
            self._upload()
        return self

    def __getstate__(self):
        # a snapshot captures the freshest view: a DEV_DIRTY tensor is
        # pulled back to the host first (ref: veles/memory.py:284-292)
        self.map_read()
        return super(Array, self).__getstate__()

    # -- conveniences --------------------------------------------------------

    @property
    def shape(self):
        if self._mem is not None:
            return self._mem.shape
        if self._devmem_ is not None:
            return tuple(self._devmem_.shape)
        return None

    @property
    def dtype(self):
        if self._mem is not None:
            return self._mem.dtype
        if self._devmem_ is not None:
            t = self._devmem_
            return numpy.dtype("float32") if t.dtype == torch.bfloat16 \
                else torch.zeros((), dtype=t.dtype).numpy().dtype
        return None

    @property
    def size(self):
        s = self.shape
        return int(numpy.prod(s)) if s is not None else 0

    @property
    def nbytes(self):
        return self.size * (self.dtype.itemsize if self.dtype else 0)

    def __bool__(self):
        return self._mem is not None or self._devmem_ is not None

    def __len__(self):
        s = self.shape
        return s[0] if s else 0

    def __getitem__(self, idx):
        self.map_read()
        return self._mem[idx]

    def __setitem__(self, idx, value):
        self.map_write()
        self._mem[idx] = value

    def __array__(self, dtype=None, copy=None):
        self.map_read()
        return self._mem if dtype is None else self._mem.astype(dtype)

    def __repr__(self):
        return "<Array shape=%s dtype=%s state=%s>" % (
            self.shape, self.dtype,
            {COHERENT: "coherent", HOST_DIRTY: "host-dirty",
             DEV_DIRTY: "dev-dirty"}[self._state])


def roundup(num, align):
    """Round ``num`` up to a multiple of ``align`` (ref: veles/numpy_ext.py
    roundup)."""
    rem = num % align
    return num if rem == 0 else num + (align - rem)
