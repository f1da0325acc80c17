"""Meshes of positions and the axis conventions — the port of
``veles_tpu/parallel/mesh.py``.

The canonical axes, outer to inner, are the reference's
(:data:`AXIS_ORDER`): ``pp`` (pipeline stages), ``dp`` (data parallel),
``fsdp`` (data parallel with sharded parameters), ``ep`` (experts),
``sp`` (the ring-attention sequence axis) and ``tp`` (tensor parallel).

A :class:`Mesh` is a grid of positions, each bound to a ``torch.device``.
Several positions may share one device: how many each device offers is
one process-wide setting (:func:`set_positions_per_device`, default 1),
the port's counterpart of the JAX tests'
``--xla_force_host_platform_device_count=8``.  The default positions of
a device type are its devices (every visible card for ``cuda``, the one
``cpu``), each repeated that many times, device-major.
"""

import math
from dataclasses import dataclass, field

import numpy
import torch

#: canonical axis order — outer (slowest) to inner (chattiest)
AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")

_PER_DEVICE = [1]


def set_positions_per_device(n):
    """Let each device offer ``n`` mesh positions (process-wide); returns
    the previous setting."""
    n = int(n)
    if n < 1:
        raise ValueError("positions per device must be >= 1")
    old = _PER_DEVICE[0]
    _PER_DEVICE[0] = n
    return old


def positions_per_device():
    """How many mesh positions each device offers."""
    return _PER_DEVICE[0]


def default_positions(device=None):
    """The positions a mesh takes by default: the devices of
    ``device``'s type (``cuda`` when None), each repeated
    :func:`positions_per_device` times."""
    from veles_tpu_torch.backends import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device("cpu")]
    return [d for d in devs for _ in range(positions_per_device())]


@dataclass
class MeshConfig:
    """Declarative mesh spec: axis name -> size; -1 absorbs the
    remaining positions."""

    axes: dict = field(default_factory=lambda: {"dp": -1})

    def resolve(self, n_devices):
        sizes = dict(self.axes)
        fixed = math.prod(s for s in sizes.values() if s > 0)
        wild = [a for a, s in sizes.items() if s <= 0]
        if len(wild) > 1:
            raise ValueError("at most one -1 axis: %s" % wild)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    "%d devices not divisible by fixed axes %s"
                    % (n_devices, sizes))
            sizes[wild[0]] = n_devices // fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError("mesh %s != %d devices" % (sizes, n_devices))
        return {a: sizes[a] for a in AXIS_ORDER if a in sizes} | {
            a: s for a, s in sizes.items() if a not in AXIS_ORDER}


class Mesh:
    """A grid of positions over named axes; position ``p`` (row-major in
    :attr:`axis_names` order) runs on ``devices[p]`` of process
    ``processes[p]`` (a gang's global mesh,
    :func:`~veles_tpu_torch.parallel.multihost.global_mesh`); by default
    every position is this process's.  This process runs the positions
    that are its own (:meth:`is_local`); ``across`` names the axis a
    gang's global mesh laid across the processes (None: process-major).
    """

    def __init__(self, sizes, devices, processes=None, process_index=0,
                 across=None):
        self.shape = dict(sizes)
        self.axis_names = tuple(self.shape)
        self._devices = [torch.device(d) for d in devices]
        if math.prod(self.shape.values()) != len(self._devices):
            raise ValueError("mesh %s != %d positions"
                             % (self.shape, len(self._devices)))
        self.ids = numpy.arange(len(self._devices)).reshape(
            tuple(self.shape.values()))
        #: the process of every position, in position order
        self.processes = [int(process_index)] * len(self._devices) \
            if processes is None else [int(q) for q in processes]
        #: this process's index in the gang
        self.process_index = int(process_index)
        #: the axis laid across the processes (None: process-major)
        self.across = across

    @property
    def spans_processes(self):
        """Whether the positions belong to more than one process."""
        return len(set(self.processes)) > 1

    def is_local(self, p):
        """Whether position ``p`` is this process's."""
        return self.processes[int(p)] == self.process_index

    def process(self, p):
        """The process position ``p`` belongs to."""
        return self.processes[int(p)]

    @property
    def size(self):
        return len(self._devices)

    @property
    def devices(self):
        """The device of every position, in position order."""
        return list(self._devices)

    def device(self, p):
        return self._devices[int(p)]

    def coords(self, p):
        """``{axis: index}`` of position ``p``."""
        idx = numpy.unravel_index(int(p), self.ids.shape)
        return dict(zip(self.axis_names, (int(i) for i in idx)))

    def position(self, **coords):
        """The position at ``coords`` (axes left out are at 0)."""
        idx = tuple(int(coords.get(a, 0)) for a in self.axis_names)
        return int(self.ids[idx])

    def along(self, p, axis):
        """The positions that differ from ``p`` only on ``axis``, in
        axis order (``[p]`` when the mesh has no such axis)."""
        if axis not in self.shape:
            return [int(p)]
        c = self.coords(p)
        return [self.position(**dict(c, **{axis: i}))
                for i in range(self.shape[axis])]

    def __repr__(self):
        if self.spans_processes:
            return "Mesh(%s over %d processes, this one %d)" % (
                self.shape, len(set(self.processes)), self.process_index)
        return "Mesh(%s over %s)" % (self.shape, sorted(
            set(map(str, self._devices))))


def build_mesh(axes, devices=None, device=None):
    """A :class:`Mesh` of ``{axis: size}`` over ``devices`` (a list of
    positions' devices; default :func:`default_positions` of
    ``device``), axes laid out in :data:`AXIS_ORDER`; -1 absorbs the
    remaining positions.  Raises when the positions do not match."""
    devices = list(devices) if devices is not None \
        else default_positions(device)
    sizes = MeshConfig(dict(axes)).resolve(len(devices))
    return Mesh(sizes, devices)


def single_device_mesh(axis="dp", device=None):
    """A one-position mesh, so the mesh code path runs on one device."""
    dev = device if device is not None else default_positions(None)[0]
    return Mesh({axis: 1}, [dev])
