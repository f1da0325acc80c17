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
   (``tp``/``fsdp`` all-gather; a replicated one is its own copy) as a
   fresh leaf of its own — expert slices stay one leaf per ``ep``
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

The sharding is of the state at rest (``position_bytes``): within a step
each group's home position holds every parameter whole and, after the
backward, its whole gradient, as the unsharded step does (a gather per
unit released after its forward would need the backward to gather
again; not done).

Dropout masks are drawn once, at the whole minibatch's shape, with the
key the unsharded step uses (kernel 5 on the card), and each group
takes its rows; the augment runs on the whole minibatch before the
split.  So masks and draws equal the unsharded step's.  ``tp`` shards
the trainer's storage and its update; the forward's matmuls run on the
gathered weight (Megatron's split compute is the serving path's,
``serving/tp.py``).
"""

import torch

from veles_tpu_torch.models.all2all import All2AllSoftmax
from veles_tpu_torch.models.dropout import DropoutForward
from veles_tpu_torch.parallel import collectives
from veles_tpu_torch.parallel.pipeline import gpipe_apply
from veles_tpu_torch.parallel.sharding import (
    P, batch_spec, gather, owners, param_spec, put, shard_slices)
from veles_tpu_torch.prng import threefry


def resolve_mesh(mesh, device):
    """A trainer's ``mesh`` made concrete: a Mesh as it is; an axis
    dict (or a snapshot's ``{"__mesh_axes__": ...}``) built over the
    default positions of ``device``'s type."""
    from veles_tpu_torch.parallel.mesh import Mesh, build_mesh
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    axes = mesh.get("__mesh_axes__", mesh)
    return build_mesh(dict(axes), device=device)


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
        self._checked = set()
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
                   and not k.startswith("_") and k != "training"}
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
                spec = self.specs[k] if shards[0].dim() else P()
                shape = self.shapes[k] if shards[0].dim() else ()
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
                        dst.copy_(src)
                if slots is not None:
                    for s, shards in self.slots[k].items():
                        spec = self.specs[k] if shards[0].dim() else P()
                        new = put(torch.as_tensor(slots[k][s]), self.mesh,
                                  spec)
                        for dst, src in zip(shards, new):
                            dst.copy_(src)
        self.version += 1

    def position_bytes(self):
        """Per position: bytes of its parameter and solver-slot
        shards."""
        out = [0] * self.mesh.size
        for k in self.names:
            trees = [self.shards[k]] + list(self.slots[k].values())
            for shards in trees:
                for p, t in enumerate(shards):
                    out[p] += t.numel() * t.element_size()
        return out

    # -- one step --------------------------------------------------------------

    def _leaves(self, g, grad):
        """Group ``g``'s fresh leaves (requiring grad when ``grad``):
        ``{(i, n): leaf}`` for the non-expert parameters and ``{i:
        [(device, {n: leaf})]}`` of expert slices per ``ep``
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
            else:
                leaf = gather(mesh, self.shards[k], spec, self.shapes[k],
                              dev)
            leaves[k] = leaf.requires_grad_(grad)
        return leaves, ep

    def _install(self, g, leaves, ep):
        mesh = self.mesh
        for i, u in enumerate(self.trainer.forwards):
            u.params = {n: leaves[(j, n)] for (j, n) in self.names
                        if j == i and (j, n) in leaves}
            u.ep_shards_ = ep.get(i)
            if mesh.shape.get("sp", 1) > 1:
                home = self.home(g, i)
                u.sp_ring_ = [mesh.device(q) for q in mesh.along(home, "sp")]

    def _uninstall(self):
        for i, u in enumerate(self.trainer.forwards):
            u.params = MeshParams(self, i)
            u.ep_shards_ = None
            u.sp_ring_ = None

    def _group_forward(self, g, x, key, train, masks, rows):
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
            elif isinstance(u, All2AllSoftmax) and i == last:
                h = u.logits(h)
            else:
                h = u.apply(h)
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

    def forward(self, x, key, train):
        """The chain over the whole minibatch ``x`` split across the
        groups: returns (the groups' outputs together on the trainer's
        device, every group's leaves)."""
        mesh, dev = self.mesh, self.trainer.device
        n = len(self.groups)
        b = x.shape[0] // n
        rows = [(j * b, (j + 1) * b) for j in range(n)]
        outs, all_leaves, masks = [], [], {}
        try:
            for j, g in enumerate(self.groups):
                leaves, ep = self._leaves(g, train)
                all_leaves.append((leaves, ep))
                self._install(g, leaves, ep)
                xg = x[rows[j][0]:rows[j][1]].to(mesh.device(g))
                outs.append(self._group_forward(g, xg, key, train, masks,
                                                rows).to(dev))
        finally:
            self._uninstall()
        return torch.cat(outs, dim=0), all_leaves

    def reduce_grads(self, all_leaves, grads):
        """Reduce-scatter each parameter's gradient over the groups (the
        leaves' grads in ``grads``, keyed like the leaves): ``{key: [per
        position]}``, position ``p`` holding its slice (by the
        parameter's spec) of the groups' sum, added on its own device in
        group order."""
        mesh = self.mesh
        to = [mesh.device(p) for p in range(mesh.size)]
        out = {}
        for k in self.names:
            spec, shape = self.specs[k], self.shapes[k]
            per_group = []
            for g, (leaves, ep) in zip(self.groups, all_leaves):
                if k in leaves:
                    per_group.append(grads[id(leaves[k])])
                else:
                    home = mesh.device(self.home(g, k[0]))
                    per_group.append(torch.cat(
                        [grads[id(got[k[1]])].to(home)
                         for _, got in ep[k[0]]], dim=0))
            out[k] = collectives.reduce_scatter(
                per_group, to=to, index=[shard_slices(mesh, spec, shape, p)
                                         for p in range(mesh.size)])
        return out

    def grad_sq(self, grads):
        """The reduced gradient's squared norm, summed over each
        parameter's owning positions."""
        total = None
        for k in self.names:
            for p in owners(self.mesh, self.specs[k]):
                s = torch.sum(torch.square(grads[k][p].float())).to(
                    self.trainer.device)
                total = s if total is None else total + s
        return total

    def apply_update(self, grads, hps, solver, keep_old=None):
        """Every position updates its slices of parameter and slots from
        its slice of the reduced gradient (:meth:`reduce_grads`);
        returns (weight_sq, update_sq) over each parameter's owning
        positions."""
        mesh = self.mesh
        weight_sq = update_sq = None
        with torch.no_grad():
            for k in self.names:
                own = set(owners(mesh, self.specs[k]))
                for p in range(mesh.size):
                    shard = self.shards[k][p]
                    g = grads[k][p]
                    state = {s: v[p] for s, v in self.slots[k].items()}
                    new_p, new_s = solver.update(shard, g, state, hps[k])
                    if keep_old is not None:
                        ko = keep_old.to(shard.device)
                        new_p = torch.where(ko, shard, new_p)
                        new_s = {s: torch.where(ko, state[s], v)
                                 for s, v in new_s.items()}
                    if p in own:
                        w = torch.sum(torch.square(new_p.float())).to(
                            self.trainer.device)
                        u = torch.sum(torch.square(
                            (new_p - shard).float())).to(
                            self.trainer.device)
                        weight_sq = w if weight_sq is None else weight_sq + w
                        update_sq = u if update_sq is None else update_sq + u
                    shard.copy_(new_p)
                    for s, v in new_s.items():
                        state[s].copy_(v)
        self.version += 1
        return weight_sq, update_sq
