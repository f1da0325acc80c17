"""Process gangs — the port of ``veles_tpu/parallel/multihost.py``.

In JAX every process of a gang joins one ``jax.distributed`` service and
a mesh spans every process's devices.  Here the processes join one
``torch.distributed`` group (:func:`initialize`), a global mesh's
positions are every process's local positions, process-major
(:func:`global_mesh`), and the mesh collectives
(:mod:`~veles_tpu_torch.parallel.collectives`) take the local
positions' tensors and receive the others' through :func:`exchange`, an
all-gather over the group.  Each process runs its own positions; every
process calls the same exchanges in the same order.

Configuration comes, in order, from the explicit arguments, then the
``VELES_TPU_COORDINATOR`` (``host:port`` of the rendezvous) /
``VELES_TPU_NUM_PROCESSES`` / ``VELES_TPU_PROCESS_ID`` environment.
With nothing configured :func:`initialize` is the single-process no-op
``(0, 1)``; it is idempotent.

The transport is chosen once, at :func:`initialize`, from the
processes' device map, logged and returned: ``gloo`` for CPU
positions; for CUDA positions ``nccl`` when every process's cards are
its own, and ``gloo`` with the tensors staged through the host when two
processes share a card (NCCL refuses two ranks on one device).  The
group itself always starts on gloo, which carries the device map and
the small host values (:func:`process_allgather`).
"""

import collections
import datetime
import logging
import os
import socket
import time

import torch

log = logging.getLogger("veles_tpu_torch.multihost")

#: what :func:`initialize` returns: this process's index, the process
#: count and the transport of the tensors (None alone)
Gang = collections.namedtuple(
    "Gang", ("process_id", "num_processes", "transport"))

_SINGLE = Gang(0, 1, None)

_STATE = {"gang": None, "group": None, "positions": None}

#: this process's exchanges so far: how many, their wall seconds (the
#: host's clock, staging included) and the bytes it sent
STATS = {"exchanges": 0, "seconds": 0.0, "bytes": 0}


def _dist():
    import torch.distributed as dist
    return dist


def _local_positions(device):
    """This process's mesh positions on ``device``'s type: a card given
    with its index alone (a worker pinned by ``-d``), else every visible
    card (or the CPU), each offering ``positions_per_device()``."""
    from veles_tpu_torch.parallel.mesh import (
        default_positions, positions_per_device)
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda" and dev.index is not None:
        return [dev] * positions_per_device()
    return default_positions(device)


def _card_id(dev):
    """A card's identity across the processes of a host: its UUID where
    torch reports one, else the host name and the physical index."""
    props = torch.cuda.get_device_properties(dev)
    uuid = getattr(props, "uuid", None)
    if uuid is not None:
        return str(uuid)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    index = dev.index or 0
    if visible:
        index = visible.split(",")[index]
    return "%s/%s" % (socket.gethostname(), index)


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, device=None, timeout=600.0):
    """Join the gang; returns :data:`Gang` ``(process_id, num_processes,
    transport)``.  ``device`` names the type of this process's positions
    (default: the CPU when there is no card, else ``cuda``)."""
    if _STATE["gang"] is not None:
        return _STATE["gang"]
    coordinator_address = coordinator_address or os.environ.get(
        "VELES_TPU_COORDINATOR")
    if num_processes is None and "VELES_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["VELES_TPU_NUM_PROCESSES"])
    if process_id is None and "VELES_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["VELES_TPU_PROCESS_ID"])
    if num_processes in (None, 1) and coordinator_address is None:
        return _SINGLE
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a gang needs the coordinator address, the process count and "
            "this process's id (got %r, %r, %r)"
            % (coordinator_address, num_processes, process_id))
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dist = _dist()
    dist.init_process_group(
        "gloo", init_method="tcp://%s" % coordinator_address,
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout))
    local = _local_positions(device)
    cards = sorted({_card_id(d) for d in local if d.type == "cuda"})
    maps = [None] * int(num_processes)
    dist.all_gather_object(maps, ([str(d) for d in local], cards))
    transport = "gloo"
    if local[0].type == "cuda":
        seen = [c for _, cs in maps for c in cs]
        if len(seen) == len(set(seen)):
            transport = "nccl"
            _STATE["group"] = dist.new_group(backend="nccl")
    _STATE["positions"] = [[torch.device(d) for d in ds] for ds, _ in maps]
    gang = Gang(dist.get_rank(), dist.get_world_size(), transport)
    _STATE["gang"] = gang
    log.info("gang: process %d/%d, %d local positions, transport %s%s",
             gang.process_id, gang.num_processes, len(local), transport,
             " (cards shared: staged through the host)"
             if transport == "gloo" and local[0].type == "cuda" else "")
    return gang


def gang():
    """The gang this process joined, else the single process."""
    return _STATE["gang"] or _SINGLE


def is_gang():
    """Whether this process is one of a gang of more than one."""
    return gang().num_processes > 1


def shutdown():
    """Leave the gang (``destroy_process_group``); the process is a
    single process again."""
    if _STATE["gang"] is not None:
        _dist().destroy_process_group()
    _STATE.update(gang=None, group=None, positions=None)


def global_mesh(axes, device=None):
    """A mesh of ``{axis: size}`` over every process's positions,
    process-major (outside a gang, the mesh over ``device``'s default
    positions)."""
    from veles_tpu_torch.parallel.mesh import MeshConfig, Mesh, build_mesh
    if not is_gang():
        return build_mesh(axes, device=device)
    devices, procs = [], []
    for q, ds in enumerate(_STATE["positions"]):
        devices += ds
        procs += [q] * len(ds)
    sizes = MeshConfig(dict(axes)).resolve(len(devices))
    return Mesh(sizes, devices, processes=procs,
                process_index=gang().process_id)


def global_put(host_array, mesh, spec):
    """Place a host array on a (global) mesh by ``spec``: every process
    passes the SAME whole array and keeps its own positions' slices
    (the replicated-input convention)."""
    from veles_tpu_torch.parallel.sharding import put
    return put(torch.as_tensor(host_array), mesh, spec)


def process_allgather(value):
    """Every process's ``value`` (any picklable), in process order."""
    if not is_gang():
        return [value]
    out = [None] * gang().num_processes
    _dist().all_gather_object(out, value)
    return out


def sync_global_devices(tag):
    """A barrier across the gang's processes (``tag`` names it in the
    log)."""
    if is_gang():
        log.debug("barrier %s", tag)
        _dist().barrier()


def exchange(xs):
    """The gang's all-gather of tensors: ``xs`` holds one entry per
    slot, a tensor where this process holds it and None where another
    does (each slot held by exactly one process).  Returns every slot:
    this process's own tensors as they are, the others' on the CPU
    (gloo) or on this process's card (nccl).  Every process of the gang
    must call it, in the same order."""
    t0 = time.perf_counter()
    dist = _dist()
    n = gang().num_processes
    mine = [(i, tuple(x.shape), x.dtype) for i, x in enumerate(xs)
            if x is not None]
    metas = [None] * n
    dist.all_gather_object(metas, mine)
    nccl = _STATE["group"] is not None
    local = [x for x in xs if x is not None]
    stage = _STATE["positions"][gang().process_id][0] if nccl \
        else torch.device("cpu")
    flat = [x.detach().contiguous().reshape(-1).view(torch.uint8).to(stage)
            for x in local]
    sizes = [sum(_nbytes(shape, dt) for _, shape, dt in m) for m in metas]
    width = max(max(sizes), 1)
    buf = torch.zeros(width, dtype=torch.uint8, device=stage)
    if flat:
        packed = torch.cat(flat)
        buf[:packed.numel()] = packed
    bufs = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(bufs, buf, group=_STATE["group"])
    out = list(xs)
    for q, meta in enumerate(metas):
        at = 0
        for i, shape, dt in meta:
            size = _nbytes(shape, dt)
            if out[i] is None:
                # a copy: the slice may sit off the dtype's alignment
                out[i] = bufs[q][at:at + size].clone().view(dt).reshape(
                    shape)
            at += size
    if any(x is None for x in out):
        raise RuntimeError("exchange: slots held by no process: %s"
                           % [i for i, x in enumerate(out) if x is None])
    STATS["exchanges"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    STATS["bytes"] += width
    return out


def _nbytes(shape, dtype):
    count = 1
    for s in shape:
        count *= int(s)
    return count * torch.empty((), dtype=dtype).element_size()
