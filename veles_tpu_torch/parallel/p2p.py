"""Hops between mesh positions of different processes — the transfers
XLA's ``ppermute`` and resharding make when a ``shard_map`` axis spans
the processes of a gang.

:func:`hop` moves one tensor from one process to another, and
:func:`move` from one mesh position to another: within a process it is
a copy onto the receiving position's device (``x.to(device)``, as the
in-process mesh moves tensors), between processes a transfer
(:func:`~veles_tpu_torch.parallel.multihost.send` /
:func:`~veles_tpu_torch.parallel.multihost.recv`).  A process that holds
neither end does nothing and gets None, as does the sending process.

**The schedule.**  Every process walks the same program (the trainer
walks every data-parallel group's chain, each process running only its
own positions' parts), so the two ends of each hop call it at the same
point, and a hop's tag is the two processes' count of the hops between
them so far: both ends derive the same tag without a message.

**Autograd.**  Under grad mode a hop of a tensor that requires grad is
differentiable.  The sender records a :class:`_Send` node whose output,
a zero-size marker, is a root of the process's backward
(:func:`take_markers`); the receiver records a :class:`_Recv` node whose
backward sends the gradient back under the hop's tag plus
:data:`~veles_tpu_torch.parallel.multihost._TAG_SPAN`, and the marker's
backward receives it into the sender's graph.  So one backward per
process, from its loss (if it holds rows of it) and its markers, walks
the whole step across the processes.

Autograd runs a process's backward nodes in the reverse order of their
creation (its ready queue pops the most recent node first, and a node's
consumers are all more recent than the node; a step's nodes all sit on
one device's queue, the card's or the CPU's), and the hops of every
process were created in the schedule's order: so the gradient of the
last hop is sent before it is needed, every receive waits only for
hops that come later in the schedule, and the backward never deadlocks.
The tags keep a gradient with its hop whatever order the sends take.
A hop's received tensor must reach the receiver's backward (a tensor
received and never used would leave its sender waiting), so the
schedules never hop a tensor they do not use.  The receiving node's
input is :func:`anchor`, a zero-size leaf: a backward that asks for
gradients of given inputs must list it, or autograd prunes the receive
nodes (and their sends) from the walk.
"""

import torch

#: this step's send markers (roots of the backward), in creation order
_MARKERS = []
#: (sender, receiver) process pair → the hops between them so far
_COUNTS = {}
_ANCHOR = []


def reset():
    """Forget the markers and the hop counts (a new gang)."""
    del _MARKERS[:]
    _COUNTS.clear()


def begin_step():
    """Drop the markers of a forward that had no backward."""
    del _MARKERS[:]


def take_markers():
    """This step's send markers, handed over once."""
    out = list(_MARKERS)
    del _MARKERS[:]
    return out


def backward(loss=None):
    """This process's backward of a step whose tensors hopped between
    processes: from ``loss`` (None where this process holds no part of
    it) and the step's send markers, accumulating into the leaves'
    ``.grad`` (``torch.autograd.backward``).  Every process of the step
    calls it; the markers are handed over once."""
    from veles_tpu_torch.parallel import multihost
    roots = [loss] if loss is not None else []
    markers = take_markers()
    if roots or markers:
        torch.autograd.backward(
            roots + markers,
            [None] * len(roots) + [torch.zeros_like(m) for m in markers])
    if multihost.is_gang():
        multihost.wait_sends()


def anchor():
    """The zero-size leaf every received tensor's autograd node hangs
    from."""
    if not _ANCHOR:
        _ANCHOR.append(torch.zeros(0, requires_grad=True))
    return _ANCHOR[0]


def refuse(procs):
    """Raise where positions of processes ``procs`` would hop between
    processes that may not (:func:`~veles_tpu_torch.parallel.multihost.
    hop_refusal`); every process reaches the same answer without a
    message, so all of them raise at the same point."""
    from veles_tpu_torch.parallel import multihost
    if len(set(procs)) > 1:
        why = multihost.hop_refusal()
        if why is not None:
            raise RuntimeError("pp, sp and ep across processes: %s" % why)


def _tag(src, dst):
    from veles_tpu_torch.parallel.multihost import _TAG_SPAN
    n = _COUNTS.get((src, dst), 0)
    _COUNTS[(src, dst)] = n + 1
    return n % _TAG_SPAN


class _Send(torch.autograd.Function):
    """The sender's end of a hop: forward sends, backward receives the
    gradient from the receiver."""

    @staticmethod
    def forward(ctx, x, dst, tag):
        from veles_tpu_torch.parallel import multihost
        ctx.dst, ctx.tag = dst, tag
        ctx.like = (tuple(x.shape), x.dtype)
        ctx.device = x.device
        multihost.send(x, dst, tag, grad=True)
        return x.new_empty(0)

    @staticmethod
    def backward(ctx, _):
        from veles_tpu_torch.parallel import multihost
        g, _ = multihost.recv(ctx.dst, ctx.tag + multihost._TAG_SPAN,
                              ctx.device, like=ctx.like)
        return g, None, None


class _Recv(torch.autograd.Function):
    """The receiver's end: forward is the received tensor, backward sends
    its gradient to the sender."""

    @staticmethod
    def forward(ctx, _anchor, got, src, tag):
        ctx.src, ctx.tag = src, tag
        return got

    @staticmethod
    def backward(ctx, grad):
        from veles_tpu_torch.parallel import multihost
        multihost.send(grad, ctx.src, ctx.tag + multihost._TAG_SPAN,
                       header=False)
        return None, None, None, None


def hop(x, src, dst, device, me=None):
    """Tensor ``x`` of process ``src`` onto ``device`` of process
    ``dst``.  Returns the tensor in process ``dst``, None elsewhere
    (when ``src`` is ``dst``: ``x.to(device)`` there, None where ``x``
    is None).  Both ends must call it at the same point of their
    schedules.  ``me`` is this process's index (default: its index in
    the gang)."""
    from veles_tpu_torch.parallel import multihost
    if src == dst:
        return None if x is None else x.to(device)
    if me is None:
        me = multihost.gang().process_id
    if me not in (src, dst):
        return None
    tag = _tag(src, dst)
    if me == src:
        grad = torch.is_grad_enabled() and x.requires_grad
        if grad:
            _MARKERS.append(_Send.apply(x, dst, tag))
        else:
            multihost.send(x, dst, tag)
        return None
    got, grad = multihost.recv(src, tag, device)
    if grad and torch.is_grad_enabled():
        return _Recv.apply(anchor(), got, src, tag)
    return got


def move(x, mesh, src, dst):
    """Position ``src``'s tensor ``x`` onto position ``dst`` of
    ``mesh`` (:func:`hop` between their processes)."""
    return hop(x, mesh.process(src), mesh.process(dst), mesh.device(dst),
               mesh.process_index)


class Route:
    """Where one data-parallel group runs a unit's sharded part: the
    ``ring`` of positions (a pipeline's stages, an ``sp`` ring, an
    ``ep`` slice's positions) around the group's ``home`` position of
    ``mesh``.  Index None names the home."""

    def __init__(self, mesh, home, ring):
        self.mesh = mesh
        self.home = int(home)
        self.ring = [int(p) for p in ring]
        refuse([mesh.process(p) for p in [self.home] + self.ring])

    def position(self, i):
        return self.home if i is None else self.ring[i]

    def here(self, i=None):
        """Whether this process runs ring position ``i`` (the home)."""
        return self.mesh.is_local(self.position(i))

    def device(self, i=None):
        return self.mesh.device(self.position(i))

    @property
    def procs(self):
        """The process of every ring position."""
        return [self.mesh.process(p) for p in self.ring]

    def move(self, x, i, j):
        """``x`` from ring position ``i`` to ``j`` (None: the home)."""
        return move(x, self.mesh, self.position(i), self.position(j))
