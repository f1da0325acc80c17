"""Process gangs — the port of ``veles_tpu/parallel/multihost.py``.

In JAX every process of a gang joins one ``jax.distributed`` service and
a mesh spans every process's devices.  Here the processes join one
``torch.distributed`` group (:func:`initialize`), a global mesh's
positions are every process's local positions, process-major
(:func:`global_mesh`), and the mesh collectives
(:mod:`~veles_tpu_torch.parallel.collectives`) take the local
positions' tensors and receive the others' through :func:`exchange`, an
all-gather over the group, or, between two processes, through
:func:`send` / :func:`recv` (a point-to-point transfer; the
differentiable hop between positions of two processes,
:mod:`~veles_tpu_torch.parallel.p2p`, is built on them).  Each process
runs its own positions; every process calls the same exchanges in the
same order, and the two ends of each transfer call it at the same point
of the same schedule.

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

Point-to-point transfers follow a fixed schedule.  A process sends
(:func:`send`, which returns at once: the transfer completes in the
background, and :func:`wait_sends` waits for every send posted so far)
and the other end receives (:func:`recv`, which blocks) with the same
``tag``, a number both ends derive from their own count of the
transfers between the two processes, so every pair of processes
matches its messages by tag and no order of the posting can pair the
wrong ones.  A transfer is a header (dtype, shape, whether the receiver
records it for autograd) and the payload; a gradient sent back along a
transfer carries no header (its shape is the transfer's).  Under gloo
the tensors are staged through the host; under nccl they stay on the
card (nccl ignores the tag and matches a pair's messages in order, so
both ends must post them in the same order).  The differentiable hops
of :mod:`~veles_tpu_torch.parallel.p2p` are refused there, and where a
process holds several cards (:func:`hop_refusal`): neither has run.
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
#: host's clock, staging included) and the bytes it sent; and its
#: point-to-point transfers: how many it sent and received, the bytes it
#: sent and the wall seconds of its sends and receives (a receive's
#: includes its wait for the peer)
STATS = {"exchanges": 0, "seconds": 0.0, "bytes": 0, "sends": 0,
         "receives": 0, "p2p_bytes": 0, "p2p_seconds": 0.0}

#: the sends not yet known complete: (work, staged buffer) — the buffer
#: must live until its transfer is done
_PENDING = []

#: the dtypes a transfer's header can name, by index
_DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.float64,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool)
#: a header's length: nbytes, dtype, grad flag, ndim and up to 12 dims
_HEADER = 16
#: tags wrap below 2**30 (gloo takes a 32-bit tag)
_TAG_SPAN = 1 << 28


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
    (default ``cuda``; without a card that raises ``RuntimeError``
    before the process joins the group — pass ``"cpu"`` to run there)."""
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
    # no fallback: without a card a process raises here, before it joins
    # the group, unless it asked for the CPU (a process that joined and
    # then failed would leave its peers waiting)
    from veles_tpu_torch.backends import resolve_device
    device = resolve_device(device)
    dist = _dist()
    dist.init_process_group(
        "gloo", init_method="tcp://%s" % coordinator_address,
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout))
    local = _local_positions(device)
    cards = sorted({_card_id(d) for d in local if d.type == "cuda"})
    maps = [None] * int(num_processes)
    dist.all_gather_object(maps, (list(dict.fromkeys(map(str, local))),
                                  cards))
    transport = "gloo"
    if local[0].type == "cuda":
        seen = [c for _, cs in maps for c in cs]
        if len(seen) == len(set(seen)):
            transport = "nccl"
            _STATE["group"] = dist.new_group(backend="nccl")
    #: every process's devices (each offers positions_per_device()
    #: positions when a mesh is built)
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


def hop_refusal():
    """Why this gang may not run differentiable hops between processes
    (the pp, sp and ep axes across them), None where it may.  They have
    run only under gloo with one card or the CPU per process: under nccl
    (processes on cards of their own) they have never run, and where a
    process holds several cards autograd runs a thread per card, so the
    order the backward posts its hops in is not fixed."""
    if not is_gang():
        return None
    if gang().transport == "nccl":
        return ("the processes hold cards of their own (nccl), where hops "
                "between processes have never run")
    for q, ds in enumerate(_STATE["positions"]):
        cards = {d for d in ds if d.type == "cuda"}
        if len(cards) > 1:
            return ("process %d holds %d cards, and autograd's thread per "
                    "card leaves the order of the backward's hops open"
                    % (q, len(cards)))
    return None


def shutdown():
    """Leave the gang (``destroy_process_group``); the process is a
    single process again."""
    if _STATE["gang"] is not None:
        wait_sends()
        _dist().destroy_process_group()
    _STATE.update(gang=None, group=None, positions=None)
    from veles_tpu_torch.parallel import p2p
    p2p.reset()


def global_mesh(axes, device=None, across=None):
    """A mesh of ``{axis: size}`` over every process's positions (each of
    its devices offering :func:`~veles_tpu_torch.parallel.mesh.
    positions_per_device` positions, read now: every process must hold
    the same setting), process-major (outside a gang, the mesh over
    ``device``'s default positions): the outermost axes split over the
    processes, as the
    reference's global mesh over ``jax.devices()`` does.  ``across``
    names the axis to split over the processes instead: the positions
    are laid out as if it were outermost, so its coordinates change
    process first (``{"sp": 2, "dp": 2}`` over two processes of two
    positions with ``across="sp"`` puts the ring's halves in different
    processes and every group's home in the first; a trainer's mesh
    setting names it as ``"__mesh_across__"``)."""
    import numpy
    from veles_tpu_torch.parallel.mesh import MeshConfig, Mesh, build_mesh
    if not is_gang():
        return build_mesh(axes, device=device)
    from veles_tpu_torch.parallel.mesh import positions_per_device
    devices, procs = [], []
    for q, ds in enumerate(_STATE["positions"]):
        ds = [d for d in ds for _ in range(positions_per_device())]
        devices += ds
        procs += [q] * len(ds)
    sizes = MeshConfig(dict(axes)).resolve(len(devices))
    if across is not None:
        names = list(sizes)
        if across not in names:
            raise ValueError("no axis %r in %s" % (across, sizes))
        ids = numpy.arange(len(devices)).reshape(
            [sizes[across]] + [sizes[a] for a in names if a != across])
        order = numpy.moveaxis(ids, 0, names.index(across)).reshape(-1)
        devices = [devices[i] for i in order]
        procs = [procs[i] for i in order]
    return Mesh(sizes, devices, processes=procs,
                process_index=gang().process_id, across=across)


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


def _stage():
    """Where a transfer's tensors are staged: this process's card under
    nccl, the host under gloo."""
    if _STATE["group"] is not None:
        return _STATE["positions"][gang().process_id][0]
    return torch.device("cpu")


def _post(buf, dst, tag):
    work = _dist().isend(buf, dst, group=_STATE["group"], tag=tag)
    _PENDING.append((work, buf))
    while _PENDING and _PENDING[0][0].is_completed():
        _PENDING.pop(0)


def send(x, dst, tag, grad=False, header=True):
    """Send tensor ``x`` to process ``dst`` under ``tag``; returns at
    once (the transfer completes in the background).  The header tells
    the receiver the dtype and shape and whether it records the tensor
    for autograd (``grad``); ``header=False`` sends the payload alone (a
    gradient back along a transfer, whose shape both ends know)."""
    t0 = time.perf_counter()
    stage = _stage()
    x = x.detach()
    payload = x.contiguous().reshape(-1).view(torch.uint8).to(stage)
    if payload.data_ptr() == x.data_ptr():
        # the caller may reuse its tensor before the send completes
        payload = payload.clone()
    if header:
        if x.dim() > _HEADER - 4:
            raise ValueError("a transfer takes at most %d dims, not %d"
                             % (_HEADER - 4, x.dim()))
        head = torch.zeros(_HEADER, dtype=torch.int64)
        head[:4] = torch.tensor([payload.numel(), _DTYPES.index(x.dtype),
                                 int(grad), x.dim()])
        head[4:4 + x.dim()] = torch.tensor(list(x.shape), dtype=torch.int64)
        _post(head.to(stage), dst, 2 * tag)
    _post(payload, dst, 2 * tag + 1)
    STATS["sends"] += 1
    STATS["p2p_bytes"] += payload.numel()
    STATS["p2p_seconds"] += time.perf_counter() - t0


def recv(src, tag, device, like=None):
    """Receive the tensor process ``src`` sends under ``tag`` onto
    ``device``; blocks until it is here.  Returns ``(tensor, grad)``
    (whether the sender asked for the autograd record).  ``like`` (a
    shape and dtype) receives a payload sent without a header."""
    t0 = time.perf_counter()
    dist, stage, group = _dist(), _stage(), _STATE["group"]
    if like is None:
        head = torch.empty(_HEADER, dtype=torch.int64, device=stage)
        dist.recv(head, src, group=group, tag=2 * tag)
        head = head.tolist()
        nbytes, dtype, grad, ndim = head[:4]
        shape, dtype = tuple(head[4:4 + ndim]), _DTYPES[dtype]
    else:
        shape, dtype = like
        grad = False
        nbytes = _nbytes(shape, dtype)
    buf = torch.empty(nbytes, dtype=torch.uint8, device=stage)
    dist.recv(buf, src, group=group, tag=2 * tag + 1)
    out = buf.view(dtype).reshape(shape).to(device)
    STATS["receives"] += 1
    STATS["p2p_seconds"] += time.perf_counter() - t0
    return out, bool(grad)


def wait_sends():
    """Wait until every send posted so far has completed."""
    while _PENDING:
        work, _ = _PENDING.pop(0)
        work.wait()
