"""Explicit, deterministic collectives over per-position tensors.

The reference's package names such a module; in JAX, XLA inserts these
collectives.  Here the controller runs them: each takes a list holding
one tensor per position of a group (in position order, each on its
position's device) and returns one per receiver, on the receiver's
device — by default the same positions; the gather and the scatter
also take explicit slices and receivers, which is how the trainer
moves a parameter's shards (``parallel.sharding``,
``models.gd_mesh``).  Sums and maxes fold in FIXED position order, so
every position gets the identical result and a run repeats bit for
bit.  Positions sharing a device may receive the same tensor object:
treat results as read-only.

Across a gang's processes (a global mesh,
:mod:`~veles_tpu_torch.parallel.multihost`) the psum, the gather and the
scatter take ``procs``, the process of each entry (and ``to_procs``,
each receiver's; default ``procs``): an entry of another process is
None, and when the entries span processes every process calls the
collective in the same order, the others' tensors arrive through
:func:`~veles_tpu_torch.parallel.multihost.exchange`, and the fold runs
in the same global position order in every process, so every process
holds the identical value.  A receiver of another process gets None.

All of them are plain PyTorch ops, so gradients flow through them
(in one process: an exchanged tensor is a copy).
"""

import torch


def _local_process():
    from veles_tpu_torch.parallel import multihost
    return multihost.gang().process_id


def _fill(xs, procs):
    """``xs`` with every process's entries: as they are when ``procs``
    is None or names one process, else exchanged across the gang."""
    if procs is None or len(set(procs)) < 2:
        return xs
    from veles_tpu_torch.parallel import multihost
    return multihost.exchange(list(xs))


def _mine(to_procs, n):
    """Which of ``n`` receivers are this process's."""
    if to_procs is None:
        return [True] * n
    me = _local_process()
    return [q == me for q in to_procs]


def _fold(xs, op, device=None):
    """``xs`` folded by ``op`` in list order, on ``device`` (default
    the first tensor's)."""
    total = xs[0] if device is None else xs[0].to(device)
    for x in xs[1:]:
        total = op(total, x.to(total.device))
    return total


def _spread(value, xs):
    return [value.to(x.device) if x is not None else None for x in xs]


def psum(xs, procs=None):
    """All-reduce by sum: every position gets ``xs[0] + xs[1] + ...``
    (that order)."""
    full = _fill(xs, procs)
    local = next(x for x in xs if x is not None)
    return _spread(_fold(full, torch.add, local.device), xs)


def pmax(xs):
    """All-reduce by elementwise max."""
    return _spread(_fold(xs, torch.maximum), xs)


def _even(xs, dim):
    """The ``len(xs)`` equal slices of ``xs[0]``'s ``dim``."""
    n, k = xs[0].shape[dim], len(xs)
    if n % k:
        raise ValueError("dimension %d of %s does not divide over %d "
                         "positions" % (dim, tuple(xs[0].shape), k))
    step = n // k
    return [(slice(None),) * dim + (slice(i * step, (i + 1) * step),)
            for i in range(k)]


def all_gather(xs, dim=0, index=None, shape=None, to=None, procs=None,
               to_procs=None):
    """Every receiver gets the whole tensor the positions' pieces make.

    By default piece ``i`` is the ``i``-th along ``dim`` (the pieces
    concatenated in position order).  Given ``index`` (each piece's
    slice of the whole) and ``shape``, piece ``i`` lands at
    ``index[i]`` of a ``shape`` tensor.  ``to`` lists the receiving
    devices (default: each piece's own)."""
    to = [x.device if x is not None else None for x in xs] if to is None \
        else list(to)
    to_procs = procs if to_procs is None else to_procs
    mine = _mine(to_procs, len(to))
    if not any(mine):
        _fill(xs, procs)
        return [None] * len(to)
    xs = _fill(xs, procs)
    first = to[mine.index(True)]
    if index is None:
        whole = torch.cat([x.to(first) for x in xs], dim=dim)
    else:
        whole = torch.empty(tuple(shape), dtype=xs[0].dtype, device=first)
        for x, idx in zip(xs, index):
            whole[idx] = x.to(first)
    return [whole.to(d) if m else None for d, m in zip(to, mine)]


def reduce_scatter(xs, dim=0, index=None, to=None, procs=None,
                   to_procs=None):
    """Sum over positions, each receiver keeping only its slice of the
    sum: receiver ``r`` gets ``xs[0][index[r]] + xs[1][index[r]] + ...``
    (that order), summed on its device ``to[r]``, so no position builds
    the whole sum.  By default receiver ``i`` is position ``i`` on its
    own device and ``index[i]`` the ``i``-th of ``len(xs)`` equal slices
    along ``dim``.  Receivers of one slice on one device share one
    result."""
    xs = _fill(xs, procs)
    if index is None:
        index = _even(xs, dim)
    to = [x.device for x in xs] if to is None else list(to)
    mine = _mine(procs if to_procs is None else to_procs, len(to))
    out, done = [], {}
    for idx, dev, m in zip(index, to, mine):
        if not m:
            out.append(None)
            continue
        key = (repr(idx), str(dev))
        if key not in done:
            done[key] = _fold([x[idx] for x in xs], torch.add, dev)
        out.append(done[key])
    return out


def ppermute(xs, perm):
    """Point-to-point: ``perm`` is a list of ``(src, dst)`` pairs;
    position ``dst`` receives ``xs[src]`` (zeros where nothing is
    sent)."""
    out = [None] * len(xs)
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device)
    return [o if o is not None else torch.zeros_like(x)
            for o, x in zip(out, xs)]


def ring_shift(xs):
    """:func:`ppermute` by ``i → i + 1`` around the ring."""
    n = len(xs)
    return ppermute(xs, [(i, (i + 1) % n) for i in range(n)])
