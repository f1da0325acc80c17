"""Sharding specs — how training state maps onto a mesh — the port of
``veles_tpu/parallel/sharding.py``, with the placement JAX's
``device_put`` does written out: :func:`put` cuts a tensor into the
per-position slices a spec names, :func:`gather` puts them back
together.

A spec (:class:`PartitionSpec`, ``P``) holds one entry per dimension:
None (whole on every position), an axis name, or a tuple of axis names
(the dimension split over their product, the first outermost).  Axes
a spec does not name replicate.  The default policy is the reference's:

- minibatch tensors: batch axis over ``dp`` (and ``fsdp`` if present),
  dim 1 over ``sp`` when the caller marks it a sequence
  (:func:`batch_spec`);
- parameters (:func:`param_spec`): ``tp`` on the last axis, ``fsdp`` on
  the largest remaining axis that divides, ``ep`` on the expert axis of
  the expert-major ``expert_*`` tensors;
- solver state: the layout of its parameter (scalars replicated).

On a gang's global mesh a process places and holds only its own
positions' slices (the others' entries are None), and :func:`gather`
reads each slice from a position of its own where one holds it, else
all-gathers it across the gang.
"""

import torch

from veles_tpu_torch.parallel import collectives


class PartitionSpec(tuple):
    """Per-dimension axis names (``P(None, "tp")``); equal to the JAX
    ``PartitionSpec`` of the same entries as tuples."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P%s" % (tuple.__repr__(self),)


P = PartitionSpec


def _axis_size(mesh, name):
    return mesh.shape.get(name, 1)


def batch_spec(mesh, ndim, dim0=None, seq_dim1=None):
    """Batch-axis spec; raises a clear error when ``dim0`` (the batch
    size) does not divide over the data axes, or ``seq_dim1`` (dim 1's
    length, given only when dim 1 is a sequence) over ``sp``."""
    axes = [a for a in ("dp", "fsdp") if _axis_size(mesh, a) > 1]
    sp = _axis_size(mesh, "sp")
    shard_seq = sp > 1 and ndim >= 2 and seq_dim1 is not None
    if shard_seq and seq_dim1 % sp:
        raise ValueError(
            "sequence length %d is not divisible by the sp extent %d — "
            "pick a sequence length that is a multiple of it"
            % (seq_dim1, sp))
    if not axes and not shard_seq:
        return P(*([None] * ndim))
    total = 1
    for a in axes:
        total *= mesh.shape[a]
    if dim0 is not None and dim0 % total:
        raise ValueError(
            "minibatch size %d is not divisible by the data-parallel "
            "extent %d (mesh axes %s) — pick a minibatch_size that is a "
            "multiple of it" % (dim0, total, axes))
    spec = [tuple(axes) if axes else None] + [None] * (ndim - 1)
    if shard_seq:
        spec[1] = "sp"
    return P(*spec)


def param_spec(mesh, name, shape):
    """Sharding spec for one parameter tensor by convention."""
    tp = _axis_size(mesh, "tp")
    fsdp = _axis_size(mesh, "fsdp")
    ep = _axis_size(mesh, "ep")
    ndim = len(shape)
    spec = [None] * ndim
    if name.startswith("expert_") and ep > 1 and ndim >= 2 \
            and shape[0] % ep == 0:
        spec[0] = "ep"
    if ndim >= 1 and tp > 1 and shape[-1] % tp == 0:
        spec[-1] = "tp"
    if fsdp > 1:
        for ax in range(ndim - 1, -1, -1):
            if spec[ax] is None and shape[ax] % fsdp == 0 \
                    and shape[ax] >= fsdp:
                spec[ax] = "fsdp"
                break
    if all(s is None for s in spec):
        return P()
    return P(*spec)


def replicated(mesh):
    return P()


def _axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_slices(mesh, spec, shape, p):
    """The slices of a ``shape`` tensor position ``p`` holds under
    ``spec``."""
    coords = mesh.coords(p)
    out = []
    for dim, n in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        idx, count = 0, 1
        for a in _axes(entry):
            idx = idx * _axis_size(mesh, a) + coords.get(a, 0)
            count *= _axis_size(mesh, a)
        if n % count:
            raise ValueError("dimension %d of %s does not divide over %s"
                             % (dim, tuple(shape), entry))
        step = n // count
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def put(value, mesh, spec):
    """``value`` placed on ``mesh`` by ``spec``: a list holding each
    position's slice, a copy on the position's device (None for the
    positions of another process)."""
    value = torch.as_tensor(value)
    return [value[shard_slices(mesh, spec, value.shape, p)]
            .to(mesh.device(p), copy=True).contiguous()
            if mesh.is_local(p) else None
            for p in range(mesh.size)]


def owners(mesh, spec):
    """The positions whose slices tile the whole tensor once: those at
    index 0 on every axis ``spec`` does not name."""
    named = {a for e in spec for a in _axes(e)}
    return [p for p in range(mesh.size)
            if all(c == 0 for a, c in mesh.coords(p).items()
                   if a not in named)]


def _holder(mesh, spec, p, process):
    """A position of ``process`` holding the slice position ``p`` holds
    under ``spec`` (equal coordinates on the axes ``spec`` names), or
    None."""
    named = {a for e in spec for a in _axes(e)}
    want = {a: c for a, c in mesh.coords(p).items() if a in named}
    for q in range(mesh.size):
        if mesh.process(q) == process and all(
                mesh.coords(q)[a] == c for a, c in want.items()):
            return q
    return None


def local_owners(mesh, spec):
    """The owners' slices as positions of this process can read them:
    each owner replaced by a local position holding its slice; None
    when some process lacks one for some slice (then reading the whole
    tensor takes an all-gather across the gang, the same decision in
    every process)."""
    own = owners(mesh, spec)
    if not mesh.spans_processes:
        return own
    for q in sorted(set(mesh.processes)):
        if any(_holder(mesh, spec, p, q) is None for p in own):
            return None
    return [_holder(mesh, spec, p, mesh.process_index) for p in own]


def gather(mesh, shards, spec, shape, device):
    """The whole tensor of ``shape`` from per-position ``shards``
    (placed by :func:`put` with ``spec``), on ``device``: the owners'
    slices all-gathered (across the gang only when this process, or
    another, holds no copy of some slice)."""
    own = owners(mesh, spec)
    index = [shard_slices(mesh, spec, shape, p) for p in own]
    readable = local_owners(mesh, spec)
    if readable is not None:
        return collectives.all_gather(
            [shards[p] for p in readable], index=index, shape=shape,
            to=[device])[0]
    # every process reads the whole: each is a receiver
    gang = sorted(set(mesh.processes))
    return collectives.all_gather(
        [shards[p] for p in own], index=index, shape=shape,
        to=[device] * len(gang), procs=[mesh.process(p) for p in own],
        to_procs=gang)[gang.index(mesh.process_index)]
