"""The trainer's mesh path — the port of the mesh half of
``veles_tpu/models/gd.py`` (``_ensure_shardings``, ``_make_pp_plan``,
``_pp_trunk_apply``, the sharded step, ``_gather_state``).

Under a :class:`~veles_tpu_torch.parallel.mesh.Mesh` the trainer's state
is really sharded: every parameter and each of its solver slots lives
as per-position slices by ``parallel.sharding.param_spec`` (``tp`` on
the last axis, ``fsdp`` on the largest remaining one, ``ep`` on the
expert axis; the rest replicated, each position holding a copy).  One
step:

1. the minibatch splits over the data-parallel **groups** — the
   positions at every ``dp × fsdp`` coordinate with the other axes at
   0, in position order (``batch_spec``'s layout);
2. each group gathers every parameter whole onto its home position
   (``tp``/``fsdp`` all-gather; a replicated one is its own copy; per
   unit under ``tp``/``fsdp``, below) as a fresh leaf of its own — expert slices stay one leaf per ``ep``
   position and run there (``models/moe``), a ``pp`` trunk's layers
   gather onto their stage's position and run the GPipe schedule
   (``parallel/pipeline``), and an ``sp`` axis hands attention the
   group's ring (``models/attention``);
3. the groups' outputs come together on position 0, where the
   evaluator takes the loss of the whole minibatch, exactly as on one
   device, and one backward reaches every group's leaves;
4. the port reduces the leaves' gradients itself: a reduce-scatter
   (``parallel.collectives``) hands each position its slice of the
   groups' sum, added in group order on the position's device (never
   autograd's accumulation across devices), and every position applies
   the solver to its own slices of parameter, gradient and slots.

Under ``tp`` or ``fsdp`` (with no ``pp``, ``ep`` or ``sp`` axis, in one
process) the gathers are per unit (``unit_gather``): step 2 gives a
group only its owners' slices as leaves, and each unit gathers its
sharded parameters whole just before it runs (``_Gather``) and drops
them when it returns; a tensor autograd saves from such a parameter is
kept as a handle (``saved_tensors_hooks``) and gathered again where the
backward reads it.  The groups run last to first, so the backward walks
them first to last and each slice's gradient parts arrive in group
order: a hook on each slice's leaf adds the part to the slice's sum as
it comes and releases it.  A group thus holds one unit's parameters
whole at a time, and no whole gradient per group; the result is bit for
bit the whole-step gather's.  Elsewhere (dp alone, pp, ep, sp, and a
mesh across processes) each group gathers every parameter for the step
as in step 2.

Across a gang's processes (a global mesh of
:mod:`~veles_tpu_torch.parallel.multihost`, axes ``dp``, ``fsdp`` and
``tp``) each process holds its own positions' slices and runs the groups
whose home positions it owns: every process has the whole minibatch,
takes its groups' rows, and computes its part of the loss with the
global masks and divisor (the evaluator's ``offset``), so one backward
per process reaches its groups' leaves.  The gradients reduce-scatter
across the gang in group order (the others' arrive by
``multihost.exchange``), and the loss, the error count and the health
norms are summed in process (or position) order in every process: every
process reports the same values bit for bit.  ``pp``, ``sp`` and ``ep``
run inside one process only.

Dropout masks are drawn once, at the whole minibatch's shape, with the
key the unsharded step uses (kernel 5 on the card), and each group
takes its rows; the augment runs on the whole minibatch before the
split.  So masks and draws equal the unsharded step's.  ``tp`` shards
the trainer's storage and its update; the forward's matmuls run on the
gathered weight (Megatron's split compute is the serving path's,
``serving/tp.py``).
"""

import contextlib
import weakref

import torch

from veles_tpu_torch.models.all2all import All2AllSoftmax
from veles_tpu_torch.models.dropout import DropoutForward
from veles_tpu_torch.parallel import collectives
from veles_tpu_torch.parallel.pipeline import gpipe_apply
from veles_tpu_torch.parallel.sharding import (
    P, batch_spec, gather, local_owners, owners, param_spec, put,
    shard_slices)
from veles_tpu_torch.prng import threefry


def resolve_mesh(mesh, device):
    """A trainer's ``mesh`` made concrete: a Mesh as it is; an axis
    dict (or a snapshot's ``{"__mesh_axes__": ...}``) built over the
    default positions of ``device``'s type."""
    from veles_tpu_torch.parallel import multihost
    from veles_tpu_torch.parallel.mesh import Mesh, build_mesh
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    axes = mesh.get("__mesh_axes__", mesh)
    if multihost.is_gang():
        # a gang's mesh (and a snapshot's, at resume) spans every
        # process's positions
        return multihost.global_mesh(dict(axes))
    return build_mesh(dict(axes), device=device)


class _Gather(torch.autograd.Function):
    """A parameter whole, assembled from its owners' slices (the
    pieces, each a leaf of its own); the backward hands each piece its
    part of the whole's gradient, on the piece's device."""

    @staticmethod
    def forward(ctx, assemble, index, *pieces):
        ctx.index = index
        ctx.devices = [p.device for p in pieces]
        return assemble(pieces)

    @staticmethod
    def backward(ctx, grad):
        return (None, None) + tuple(
            grad[idx].to(d, copy=True)
            for idx, d in zip(ctx.index, ctx.devices))


def _held(shards):
    """A tensor of ``shards`` this process holds (the first)."""
    return next(t for t in shards if t is not None)


class MeshParams(dict):
    """A unit's parameters under a mesh trainer: reading them gathers
    each whole onto the trainer's device (the reference's
    ``map_read``), cached until the next step writes the shards."""

    def __init__(self, plan, index):
        super().__init__()
        self.plan = plan
        self.index = index
        self._version = -1

    def _fresh(self):
        if self._version != self.plan.version:
            dict.clear(self)
            dict.update(self, self.plan.gathered(self.index))
            self._version = self.plan.version
            # fresh tensors restart their version counters: drop the
            # unit's derived copies of the old ones
            self.plan.trainer.forwards[self.index]._derived = {}

    def __getitem__(self, name):
        self._fresh()
        return dict.__getitem__(self, name)

    def __iter__(self):
        self._fresh()
        return dict.__iter__(self)

    def __len__(self):
        self._fresh()
        return dict.__len__(self)

    def __contains__(self, name):
        self._fresh()
        return dict.__contains__(self, name)

    def get(self, name, default=None):
        self._fresh()
        return dict.get(self, name, default)

    def keys(self):
        self._fresh()
        return dict.keys(self)

    def values(self):
        self._fresh()
        return dict.values(self)

    def items(self):
        self._fresh()
        return dict.items(self)

    def __reduce__(self):
        self._fresh()
        return (dict, (dict(dict.items(self)),))


class MeshPlan:
    """The sharded state and step layout of one trainer on one mesh."""

    def __init__(self, trainer, mesh):
        self.trainer = trainer
        self.mesh = mesh
        self.version = 0
        #: whether the positions span a gang's processes
        self.gang = mesh.spans_processes
        if self.gang:
            across = [a for a in ("pp", "sp", "ep")
                      if mesh.shape.get(a, 1) > 1]
            if across:
                raise ValueError(
                    "a mesh across processes shards over dp, fsdp and tp; "
                    "%s run inside one process" % "/".join(across))
        fw = trainer.forwards
        self.pp = self._make_pp_plan() if mesh.shape.get("pp", 1) > 1 \
            else None
        if mesh.shape.get("sp", 1) > 1:
            for u in fw:
                u.sp_mesh_ = mesh
        self.names = list(trainer._names)
        self.shapes = {k: tuple(fw[k[0]].params[k[1]].shape)
                       for k in self.names}
        self.specs = {k: param_spec(mesh, k[1], self.shapes[k])
                      for k in self.names}
        with torch.no_grad():
            self.shards = {k: put(fw[k[0]].params[k[1]].detach(), mesh,
                                  self.specs[k]) for k in self.names}
            self.slots = {k: {s: put(v, mesh, self.specs[k] if v.dim()
                                     else P())
                              for s, v in trainer.opt_state[k].items()}
                          for k in self.names}
        #: the data-parallel groups' home positions, in batch order
        self.groups = [p for p in range(mesh.size)
                       if all(c == 0 for a, c in mesh.coords(p).items()
                              if a not in ("dp", "fsdp"))]
        #: the groups this process runs (all of them in one process)
        self.local_groups = [g for g in self.groups if mesh.is_local(g)]
        if not self.local_groups:
            raise ValueError("this process runs no data-parallel group "
                             "of %r" % (mesh,))
        #: (first, end) of this process's rows of a minibatch, in groups
        self.group_span = (self.groups.index(self.local_groups[0]),
                           self.groups.index(self.local_groups[-1]) + 1)
        if self.group_span[1] - self.group_span[0] \
                != len(self.local_groups):
            raise ValueError("this process's groups are not contiguous "
                             "in %r" % (mesh,))
        self._checked = set()
        #: the per-unit gather: under tp or fsdp (in one process, with
        #: no pp, ep or sp axis) a group gathers a unit's sharded
        #: parameters just before the unit runs and drops them after
        #: it; the backward gathers them again where autograd reads
        #: them, and each slice's gradient is reduced as soon as every
        #: group's part of it is in
        self.unit_gather = not self.gang and all(
            mesh.shape.get(a, 1) == 1 for a in ("pp", "ep", "sp")) \
            and any(mesh.shape.get(a, 1) > 1 for a in ("tp", "fsdp"))
        #: the parameters that are gathered (sharded, not replicated)
        self.sharded = {k for k in self.names
                        if any(e is not None for e in self.specs[k])}
        #: the most bytes of gathered parameters alive at once in this
        #: plan's steps, counted at each gather
        self.gather_peak_bytes = 0
        #: the most bytes of groups' gradient parts held waiting for an
        #: earlier group's part of the same slice (0 when they arrive in
        #: group order)
        self.grad_wait_peak_bytes = 0
        self._live = weakref.WeakSet()
        self._wholes = {}
        for i, u in enumerate(fw):
            u.params = MeshParams(self, i)

    # -- layout ----------------------------------------------------------------

    def _make_pp_plan(self):
        """The longest run of shape-preserving units of one signature
        (the transformer trunk), split into ``pp`` stages; pp composes
        with dp only (ref: ``gd._make_pp_plan``)."""
        mesh, t = self.mesh, self.trainer
        S = mesh.shape["pp"]
        for ax in ("tp", "fsdp", "sp", "ep"):
            if mesh.shape.get(ax, 1) > 1:
                raise ValueError(
                    "pp composes with dp only (got %s>1): shard the "
                    "trunk over pp×dp, or drop the pp axis" % ax)

        def keeps_shape(u):
            shape = getattr(u, "in_shape", None)
            return shape is not None and not isinstance(u, DropoutForward) \
                and tuple(u.out_shape(shape)) == tuple(shape)

        def signature(u):
            cfg = {k: v for k, v in vars(u).items()
                   if isinstance(v, (int, float, str, bool, type(None)))
                   and not k.startswith("_")
                   and k not in ("training", "name")}
            return (type(u).__name__, repr(sorted(cfg.items())),
                    tuple(sorted((n, tuple(a.shape))
                                 for n, a in u.params.items())))

        units, best, i = t.forwards, (0, 0), 0
        while i < len(units):
            if not keeps_shape(units[i]):
                i += 1
                continue
            j, sig = i, signature(units[i])
            while j < len(units) and keeps_shape(units[j]) \
                    and signature(units[j]) == sig:
                j += 1
            if j - i > best[1] - best[0]:
                best = (i, j)
            i = j
        start, end = best
        n = end - start
        if n < S or n % S:
            raise ValueError(
                "pp=%d needs a homogeneous shape-preserving trunk with "
                "a stage-divisible length; found %d matching units "
                "(forwards[%d:%d]) — use a layer count divisible by pp"
                % (S, n, start, end))
        n_micro = int(t.pp_microbatches or S)
        loader = t.loader
        mb = getattr(loader, "max_minibatch_size", None) \
            or getattr(loader, "minibatch_size", None)
        dp = mesh.shape.get("dp", 1)
        if mb is not None and (mb % dp or (mb // dp) % n_micro):
            raise ValueError(
                "minibatch %d must divide into dp extent %d and then "
                "into %d pp microbatches per dp slice" % (mb, dp, n_micro))
        return {"start": start, "end": end, "stages": S, "k": n // S,
                "n_micro": n_micro}

    def home(self, g, i):
        """The position unit ``i`` of group ``g`` runs on."""
        pp = self.pp
        if pp is not None and pp["start"] <= i < pp["end"]:
            stage = (i - pp["start"]) // pp["k"]
            return self.mesh.along(g, "pp")[stage]
        return g

    def check_batch(self, x, target):
        """The reference's refusals: the batch over dp × fsdp, a
        sequence input's dim 1 over sp (``batch_spec``)."""
        key = (tuple(x.shape), tuple(target.shape))
        if key in self._checked:
            return
        fw0 = self.trainer.forwards[0]
        seq = x.shape[1] if getattr(fw0, "SEQ_DIM1_INPUT", False) \
            and x.dim() >= 2 else None
        batch_spec(self.mesh, x.dim(), dim0=x.shape[0], seq_dim1=seq)
        batch_spec(self.mesh, target.dim(), dim0=x.shape[0])
        if self.pp is not None:
            per = x.shape[0] // len(self.groups)
            if per % self.pp["n_micro"]:
                raise ValueError(
                    "minibatch %d must divide into dp extent %d and then "
                    "into %d pp microbatches per dp slice"
                    % (x.shape[0], len(self.groups), self.pp["n_micro"]))
        self._checked.add(key)

    # -- state ---------------------------------------------------------------

    def gathered(self, i):
        """Unit ``i``'s parameters whole, on the trainer's device."""
        dev = self.trainer.device
        return {n: gather(self.mesh, self.shards[(i, n)],
                          self.specs[(i, n)], self.shapes[(i, n)], dev)
                for (j, n) in self.names if j == i}

    def gathered_slots(self):
        dev = self.trainer.device
        out = {}
        for k in self.names:
            out[k] = {}
            for s, shards in self.slots[k].items():
                spec = self.specs[k] if _held(shards).dim() else P()
                shape = self.shapes[k] if _held(shards).dim() else ()
                out[k][s] = gather(self.mesh, shards, spec, shape, dev)
        return out

    def write(self, params=None, slots=None):
        """Re-place whole parameters ``{i: {name: tensor}}`` and/or slots
        ``{(i, name): {slot: tensor}}`` onto the positions (a rollback,
        a carried state)."""
        with torch.no_grad():
            for k in self.names:
                if params is not None:
                    new = put(torch.as_tensor(params[k[0]][k[1]]),
                              self.mesh, self.specs[k])
                    for dst, src in zip(self.shards[k], new):
                        if dst is not None:
                            dst.copy_(src)
                if slots is not None:
                    for s, shards in self.slots[k].items():
                        spec = self.specs[k] if _held(shards).dim() else P()
                        new = put(torch.as_tensor(slots[k][s]), self.mesh,
                                  spec)
                        for dst, src in zip(shards, new):
                            if dst is not None:
                                dst.copy_(src)
        self.version += 1

    def position_bytes(self):
        """Per position: bytes of its parameter and solver-slot
        shards (0 for another process's positions)."""
        out = [0] * self.mesh.size
        for k in self.names:
            trees = [self.shards[k]] + list(self.slots[k].values())
            for shards in trees:
                for p, t in enumerate(shards):
                    if t is not None:
                        out[p] += t.numel() * t.element_size()
        return out

    # -- one step --------------------------------------------------------------

    def _leaves(self, g, grad):
        """Group ``g``'s fresh leaves (requiring grad when ``grad``):
        ``{(i, n): leaf}`` for the non-expert parameters (under the
        per-unit gather a sharded one's is ``[(owner, slice leaf)]``)
        and ``{i: [(device, {n: leaf})]}`` of expert slices per ``ep``
        position."""
        mesh = self.mesh
        leaves, ep = {}, {}
        for k in self.names:
            i, n = k
            p = self.home(g, i)
            dev = mesh.device(p)
            spec = self.specs[k]
            if "ep" in spec:
                whole = gather(mesh, self.shards[k], spec, self.shapes[k],
                               dev)
                ring = mesh.along(p, "ep")
                parts = torch.chunk(whole, len(ring), dim=0)
                ep.setdefault(i, [(mesh.device(q), {}) for q in ring])
                for (d, got), part in zip(ep[i], parts):
                    got[n] = part.to(d, copy=True).requires_grad_(grad)
                continue
            if all(e is None for e in spec):
                leaf = self.shards[k][p].detach()
            elif self.unit_gather:
                # the owners' slices, each a leaf of this group's: the
                # unit gathers them whole when it runs
                leaves[k] = [(o, self.shards[k][o].detach()
                              .requires_grad_(grad))
                             for o in owners(mesh, spec)]
                continue
            else:
                leaf = gather(mesh, self.shards[k], spec, self.shapes[k],
                              dev)
            leaves[k] = leaf.requires_grad_(grad)
        return leaves, ep

    def _install(self, g, leaves, ep):
        mesh = self.mesh
        for i, u in enumerate(self.trainer.forwards):
            u.params = {n: leaves[(j, n)] for (j, n) in self.names
                        if j == i and (j, n) in leaves
                        and torch.is_tensor(leaves[(j, n)])}
            # a unit's derived copies (casts) are keyed by its
            # parameters' versions, which fresh leaves restart: never
            # let one group's, or an earlier step's, copies through
            u._derived = {}
            u.ep_shards_ = ep.get(i)
            if mesh.shape.get("sp", 1) > 1:
                home = self.home(g, i)
                u.sp_ring_ = [mesh.device(q) for q in mesh.along(home, "sp")]

    def _uninstall(self):
        for i, u in enumerate(self.trainer.forwards):
            u.params = MeshParams(self, i)
            u._derived = {}
            u.ep_shards_ = None
            u.sp_ring_ = None

    # -- the per-unit gather ---------------------------------------------------

    def _count_gathered(self, whole):
        self._live.add(whole)
        self.gather_peak_bytes = max(self.gather_peak_bytes, sum(
            t.numel() * t.element_size() for t in self._live))

    def _gather_whole(self, g, k, pieces):
        """Parameter ``k`` whole on group ``g``'s position for its unit,
        from the pieces (leaves of the owners' slices)."""
        mesh, spec, shape = self.mesh, self.specs[k], self.shapes[k]
        dev = mesh.device(self.home(g, k[0]))
        index = [shard_slices(mesh, spec, shape, o) for o, _ in pieces]

        def assemble(parts):
            return collectives.all_gather(list(parts), index=index,
                                          shape=shape, to=[dev])[0]

        whole = _Gather.apply(assemble, index, *[t for _, t in pieces])
        self._count_gathered(whole)
        return whole

    def _regather(self, g, k):
        """Parameter ``k`` gathered again for the backward (the shards
        are not updated until after it: an exact copy)."""
        whole = gather(self.mesh, self.shards[k], self.specs[k],
                       self.shapes[k], self.mesh.device(self.home(g, k[0])))
        self._count_gathered(whole)
        return whole

    def _pack(self, t):
        """A saved tensor that shares a gathered parameter's storage is
        kept as a handle (the parameter and the view), not as memory."""
        got = self._wholes.get(t.untyped_storage().data_ptr())
        if got is None or got[2]() is None:
            return t
        return ("gathered", got[0], got[1], t.size(), t.stride(),
                t.storage_offset())

    def _unpack(self, saved):
        if not isinstance(saved, tuple):
            return saved
        _, g, k, size, stride, offset = saved
        return torch.as_strided(self._regather(g, k), size, stride, offset)

    @contextlib.contextmanager
    def _unit_scope(self, g, i, leaves):
        """Unit ``i`` of group ``g`` runs with its sharded parameters
        gathered whole (the per-unit gather), dropped when it returns."""
        u = self.trainer.forwards[i]
        mine = [k for k in self.names if k[0] == i and k in self.sharded]
        if not self.unit_gather or not mine:
            yield
            return
        kept = dict(u.params)
        for k in mine:
            whole = self._gather_whole(g, k, leaves[k])
            u.params[k[1]] = whole
            self._wholes[whole.untyped_storage().data_ptr()] = (
                g, k, weakref.ref(whole))
        del whole
        u._derived = {}
        try:
            if torch.is_grad_enabled():
                with torch.autograd.graph.saved_tensors_hooks(
                        self._pack, self._unpack):
                    yield
            else:
                yield
        finally:
            u.params = kept
            u._derived = {}
            self._wholes.clear()

    def _group_forward(self, g, x, key, train, masks, rows, leaves):
        t = self.trainer
        mesh = self.mesh
        fw = t.forwards
        last = len(fw) - 1
        h = x
        i = 0
        while i < len(fw):
            pp = self.pp
            if pp is not None and i == pp["start"]:
                h = self._pp_trunk(g, h)
                i = pp["end"]
                continue
            u = fw[i]
            h = h.to(mesh.device(self.home(g, i)))
            if isinstance(u, DropoutForward) and train:
                key, sub = threefry.split(key)
                if i not in masks:
                    shape = (rows[-1][1],) + tuple(h.shape[1:])
                    masks[i] = u.mask_of(shape, sub, t.device)
                lo, hi = rows[self.groups.index(g)]
                h = u.apply_train(h, sub, mask=masks[i][lo:hi].to(h.device))
            else:
                with self._unit_scope(g, i, leaves):
                    h = u.logits(h) if isinstance(u, All2AllSoftmax) \
                        and i == last else u.apply(h)
            i += 1
        return h

    def _pp_trunk(self, g, h):
        pp, fw = self.pp, self.trainer.forwards
        k, S = pp["k"], pp["stages"]
        trunk = fw[pp["start"]:pp["end"]]
        devices = [self.mesh.device(q) for q in self.mesh.along(g, "pp")]

        def stage_fn(s, x):
            for u in trunk[s * k:(s + 1) * k]:
                x = u.apply(x)
            return x

        micro = torch.chunk(h, pp["n_micro"], dim=0)
        out = gpipe_apply(stage_fn, list(range(S)), micro, devices,
                          out_device=h.device)
        return out.reshape(h.shape[:1] + out.shape[2:])

    def rows(self, batch):
        """(first, end) of this process's rows of a ``batch``-row
        minibatch (all of them in one process)."""
        b = batch // len(self.groups)
        return self.group_span[0] * b, self.group_span[1] * b

    def forward(self, x, key, train):
        """The chain over the minibatch ``x`` split across the groups:
        returns (this process's groups' outputs together on the
        trainer's device — :meth:`rows` of the minibatch, all of it in
        one process —, their leaves)."""
        mesh, dev = self.mesh, self.trainer.device
        n = len(self.groups)
        b = x.shape[0] // n
        rows = [(j * b, (j + 1) * b) for j in range(n)]
        outs, all_leaves, masks = {}, {}, {}
        order = list(enumerate(self.groups))
        if self.unit_gather:
            # the last group to run is the first the backward walks:
            # run them last to first, so each slice's gradients arrive
            # in group order and fold as they come
            order.reverse()
        try:
            for j, g in order:
                if not mesh.is_local(g):
                    continue
                leaves, ep = self._leaves(g, train)
                all_leaves[j] = (leaves, ep)
                self._install(g, leaves, ep)
                xg = x[rows[j][0]:rows[j][1]].to(mesh.device(g))
                outs[j] = self._group_forward(g, xg, key, train, masks,
                                              rows, leaves).to(dev)
        finally:
            self._uninstall()
        return (torch.cat([outs[j] for j in sorted(outs)], dim=0),
                [all_leaves[j] for j in sorted(all_leaves)])

    def whole(self, y):
        """Every process's rows of an output (:meth:`forward`) together,
        in row order, on the trainer's device (``y`` itself in one
        process)."""
        if not self.gang:
            return y
        from veles_tpu_torch.parallel import multihost
        parts = [None] * multihost.gang().num_processes
        parts[self.mesh.process_index] = y.detach()
        dev = self.trainer.device
        return torch.cat([t.to(dev) for t in multihost.exchange(parts)])

    def total(self, values):
        """A step's per-process partial sums (a 1-D f32 tensor) summed
        over the gang in process order — the same bits in every process
        (``values`` itself in one process)."""
        if not self.gang:
            return values
        from veles_tpu_torch.parallel import multihost
        parts = [None] * multihost.gang().num_processes
        parts[self.mesh.process_index] = values
        dev = values.device
        got = [t.to(dev) for t in multihost.exchange(parts)]
        total = got[0]
        for t in got[1:]:
            total = total + t
        return total

    def backward(self, loss, all_leaves):
        """The step's backward from ``loss`` to the groups' leaves
        (:meth:`forward`), and the gradients reduce-scattered over the
        groups: ``{key: [per position]}`` (:meth:`reduce_grads`).  Under
        the per-unit gather each sharded slice's groups' gradients are
        summed in group order as soon as the last of them is in, and
        released."""
        inputs, pieces = [], []
        for leaves, ep in all_leaves:
            for k, v in leaves.items():
                if torch.is_tensor(v):
                    inputs.append(v)
                else:
                    pieces += [(k, o, t) for o, t in v]
            for shards in ep.values():
                for _, d in shards:
                    inputs += list(d.values())
        if not pieces:
            grads = torch.autograd.grad(loss, inputs)
            return self.reduce_grads(all_leaves, {
                id(leaf): g for leaf, g in zip(inputs, grads)})
        n = len(all_leaves)
        folding, reduced = {}, {}

        def reduce(k, o, j):
            def hook(t):
                # add the groups' parts in group order, each as soon as
                # its turn comes, and release it
                st = folding.setdefault((k, o), {"next": 0, "total": None,
                                                 "wait": {}})
                st["wait"][j], t.grad = t.grad, None
                dev = self.mesh.device(o)
                while st["next"] in st["wait"]:
                    x = st["wait"].pop(st["next"]).to(dev)
                    st["total"] = x if st["total"] is None \
                        else st["total"] + x
                    st["next"] += 1
                self.grad_wait_peak_bytes = max(
                    self.grad_wait_peak_bytes,
                    sum(w.numel() * w.element_size() for f in folding.values()
                        for w in f["wait"].values()))
                if st["next"] == n:
                    reduced[(k, o)] = folding.pop((k, o))["total"]
            return hook

        handles = []
        per_group = len(pieces) // n
        for m, (k, o, t) in enumerate(pieces):
            handles.append(t.register_post_accumulate_grad_hook(
                reduce(k, o, m // per_group)))
        try:
            torch.autograd.backward(loss, inputs=inputs
                                    + [t for _, _, t in pieces])
        finally:
            for h in handles:
                h.remove()
        grads = {id(leaf): leaf.grad for leaf in inputs}
        out = self.reduce_grads(all_leaves, grads)
        mesh = self.mesh
        for k in self.sharded:
            spec, shape = self.specs[k], self.shapes[k]
            own = owners(mesh, spec)
            index = {repr(shard_slices(mesh, spec, shape, o)): o
                     for o in own}
            done, out[k] = {}, []
            for p in range(mesh.size):
                o = index[repr(shard_slices(mesh, spec, shape, p))]
                dev = mesh.device(p)
                key = (o, str(dev))
                if key not in done:
                    done[key] = reduced[(k, o)].to(dev)
                out[k].append(done[key])
        return out

    def reduce_grads(self, all_leaves, grads):
        """Reduce-scatter each parameter's gradient over the groups (the
        leaves' grads in ``grads``, keyed like the leaves): ``{key: [per
        position]}``, position ``p`` holding its slice (by the
        parameter's spec) of the groups' sum, added on its own device in
        group order (None for another process's positions)."""
        mesh = self.mesh
        to = [mesh.device(p) for p in range(mesh.size)]
        procs = [mesh.process(g) for g in self.groups] if self.gang \
            else None
        to_procs = mesh.processes if self.gang else None
        out = {}
        for k in self.names:
            if self.unit_gather and k in self.sharded:
                continue            # reduced as its pieces' grads came in
            spec, shape = self.specs[k], self.shapes[k]
            per_group = []
            ran = iter(all_leaves)
            for g in self.groups:
                if not mesh.is_local(g):
                    per_group.append(None)
                    continue
                leaves, ep = next(ran)
                if k in leaves:
                    per_group.append(grads[id(leaves[k])])
                else:
                    home = mesh.device(self.home(g, k[0]))
                    per_group.append(torch.cat(
                        [grads[id(got[k[1]])].to(home)
                         for _, got in ep[k[0]]], dim=0))
            out[k] = collectives.reduce_scatter(
                per_group, to=to, index=[shard_slices(mesh, spec, shape, p)
                                         for p in range(mesh.size)],
                procs=procs, to_procs=to_procs)
        return out

    def _owner_sum(self, term):
        """``term(k, p)`` summed over each parameter's owning positions
        in (parameter, owner) order on the trainer's device.  In a gang
        each owner's term is read from a position of this process
        holding its slice, or crosses the gang from the owner's
        process."""
        dev = self.trainer.device
        vals, cross = [], []
        for k in self.names:
            own = owners(self.mesh, self.specs[k])
            readable = local_owners(self.mesh, self.specs[k])
            for j, o in enumerate(own):
                if readable is not None:
                    vals.append(term(k, readable[j]))
                else:
                    cross.append(len(vals))
                    vals.append(term(k, o) if self.mesh.is_local(o)
                                else None)
        if cross:
            from veles_tpu_torch.parallel import multihost
            got = multihost.exchange([vals[i] for i in cross])
            for i, v in zip(cross, got):
                vals[i] = v
        total = None
        for v in vals:
            v = v.to(dev)
            total = v if total is None else total + v
        return total

    def grad_sq(self, grads):
        """The reduced gradient's squared norm, summed over each
        parameter's owning positions."""
        return self._owner_sum(
            lambda k, p: torch.sum(torch.square(grads[k][p].float())))

    def apply_update(self, grads, hps, solver, keep_old=None):
        """Every position updates its slices of parameter and slots from
        its slice of the reduced gradient (:meth:`reduce_grads`);
        returns (weight_sq, update_sq) over each parameter's owning
        positions."""
        mesh = self.mesh
        terms = {}
        with torch.no_grad():
            for k in self.names:
                read = local_owners(mesh, self.specs[k]) \
                    or owners(mesh, self.specs[k])
                for p in range(mesh.size):
                    shard = self.shards[k][p]
                    if shard is None:       # another process's position
                        continue
                    g = grads[k][p]
                    state = {s: v[p] for s, v in self.slots[k].items()}
                    new_p, new_s = solver.update(shard, g, state, hps[k])
                    if keep_old is not None:
                        ko = keep_old.to(shard.device)
                        new_p = torch.where(ko, shard, new_p)
                        new_s = {s: torch.where(ko, state[s], v)
                                 for s, v in new_s.items()}
                    if p in read:       # a term of the health norms
                        terms[(k, p)] = torch.stack([
                            torch.sum(torch.square(new_p.float())),
                            torch.sum(torch.square(
                                (new_p - shard).float()))])
                    shard.copy_(new_p)
                    for s, v in new_s.items():
                        state[s].copy_(v)
            both = self._owner_sum(lambda k, p: terms[(k, p)])
        self.version += 1
        return both[0], both[1]
