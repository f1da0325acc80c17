"""GradientDescent — the trainer (the port of ``veles_tpu/models/gd.py``,
on one device or over a mesh).

One minibatch step (:meth:`GradientDescent.run_minibatch`) is the JAX
package's fused step written eagerly:

    loss = evaluator.loss(chain(x), target)     # autograd records
    grads = d loss / d params                   # the chain's backward
    params, slots = solver.update(...)          # written in place

with the learning rate ``lr × schedule(step)`` per
parameter (per-layer overrides from ``unit.hyperparams()``), the
5-entry health vector ``[grad_norm, weight_norm, update_ratio,
nonfinite, loss]``, the ``skip_step`` policy (a non-finite step keeps
the parameters and slots it had) and the per-class ``[3, 3]`` epoch
accumulator ``[n_err / units, loss · size, size]``, all on the device.
Validation and test minibatches compute the loss and metrics without
the update.  An evaluator's ``train_metrics`` gives ``n_err`` (the
argmax error count otherwise); ``EvaluatorMSE`` reports 0 there and its
mse as the loss, and reads the loader's ``targets_dev`` as its target,
as the JAX trainer does for it.  :meth:`GradientDescent.run_span`
consumes a loader's class span: a host loop over its index schedule,
gathering each minibatch from the device-resident dataset.

Randomness is the JAX trainer's: a ``"trainer"`` generator (seed 42
unless given) whose ``peek_key(global_step)`` keys a minibatch, folded
with ``k`` for the k-th step of a span, and split before each dropout
layer on train steps (``key, sub = split(key)``; ``sub`` draws the
mask).  Keys stay on the host: the mask kernel takes the key's words as
launch arguments, so no step waits on a device read.  A final
``All2AllSoftmax`` gives the trainer its f32 logits.

Health, as in the JAX package: every train dispatch reports its health
vector to the process-wide monitor (:data:`veles_tpu_torch.telemetry.
health.monitor`, read by ``GET /healthz``), every ``sync_every``-th one
on the per-minibatch path and every span, and acts on its verdict.  The
policy ("warn", "skip_step" or "halt") and ``enabled`` are the knobs of
:mod:`veles_tpu_torch.telemetry.health`, read per step as the JAX
trainer reads ``root.common.health``: the policy the trainer acts on is
the one the monitor reports.  ``health=False`` turns it off for this
trainer; a ``health_policy`` given to the constructor configures the
process-wide policy.  ``augment`` (a callable ``fn(x, key)`` or an
``ops.augment.make_augment`` spec such as ``{"kind": "image", "pad":
4}``) transforms train minibatches on the device inside the step: as
in the JAX trainer, the minibatch key is split first (``key, sub =
split(key)``), ``sub`` keys the augment and ``key`` the dropout masks,
so the masks change when augment is on.

``mesh`` (a :class:`~veles_tpu_torch.parallel.mesh.Mesh`, an axis dict
such as ``{"dp": 2, "tp": 2}``, or a snapshot's ``{"__mesh_axes__":
...}``, made concrete on the trainer's device type) shards the step
over ``dp``, ``fsdp``, ``tp``, ``ep``, ``pp`` and ``sp``
(:mod:`~veles_tpu_torch.models.gd_mesh`); ``pp_microbatches`` (default
the ``pp`` extent) sets the pipeline's microbatches.  A mesh pickles as
its axis spec and is rebuilt at resume.

The master/worker exchange (the reference's parameter-server face,
``IDistributable``): a job carries the master's parameters to a worker
as numpy (one crossing to the host per job on the card); the worker
installs them, runs its minibatch, and returns the delta its step made
against them (computed on the host in f32) with the epoch accumulator
it gathered; the master adds the delta to its parameters on the host
in f32 and folds the accumulator into a float64 host accumulator,
which :meth:`GradientDescent.read_epoch_acc` reads on a master.

The trainer is also a workflow unit (the reference's face):
``GradientDescent(workflow, forwards=..., evaluator=..., loader=...,
**hyper)``.  Its ``initialize(device=)`` fills the chain's parameters
from ``numpy.random.default_rng(weights_seed)`` (``convert.init_params``'s
draw, each unit sized from the loader's sample shape) unless they exist,
else moves them (and the solver slots, after a snapshot's load) to the
device; its ``run()`` takes the loader's fresh span
(:meth:`GradientDescent.run_span`) or one minibatch
(:meth:`GradientDescent.run_minibatch`), the same arithmetic in the same
order as a plain trainer's, and leaves ``loss``, ``n_err``,
``epoch_acc``, ``global_step`` and ``lr_multiplier`` for the decision
to read.  The plain form, ``GradientDescent(forwards, evaluator,
...)``, is ready at once.
"""

import logging

import numpy
import torch

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.loader.base import TRAIN, unit_form
from veles_tpu_torch.models.all2all import All2AllSoftmax
from veles_tpu_torch.models.dropout import DropoutForward
from veles_tpu_torch.models.lr_adjust import get_schedule
from veles_tpu_torch.models.solvers import get_solver
from veles_tpu_torch.prng import RandomGenerator, threefry
from veles_tpu_torch.telemetry import health as health_lib

log = logging.getLogger("veles_tpu_torch.gd")


def _sq_norm(tensors):
    total = None
    for t in tensors:
        s = torch.sum(torch.square(t.to(torch.float32)))
        total = s if total is None else total + s
    return total


class GradientDescent(AcceleratedUnit):
    """The trainer of a forward chain ``forwards`` under ``evaluator``."""

    VIEW_GROUP = "TRAINER"
    FUSABLE = False  # launches its own steps

    def __init__(self, workflow=None, evaluator=None, solver="sgd",
                 learning_rate=0.01, learning_rate_bias=None,
                 weights_decay=0.0, weights_decay_bias=None, l1_vs_l2=0.0,
                 gradient_moment=0.0, gradient_moment_bias=None,
                 lr_schedule="constant", lr_schedule_params=None,
                 health=True, health_policy=None, seed=None, forwards=None,
                 loader=None, weights_seed=0, mesh=None, augment=None,
                 pp_microbatches=None, **kwargs):
        plain = not unit_form(workflow)
        if plain:
            forwards, workflow = workflow, None
        super(GradientDescent, self).__init__(workflow, **kwargs)
        #: the mesh the step shards over (None: one device)
        self.mesh = mesh
        #: microbatches per pipeline step on a ``pp`` mesh (None: pp)
        self.pp_microbatches = pp_microbatches
        if health_policy is not None:
            health_lib.configure(policy=health_policy)
        self.forwards = list(forwards) if forwards else []
        self.evaluator = evaluator
        self.loader = loader
        #: train-time augmentation: a spec dict (survives snapshots)
        #: or a callable
        self.augment = augment
        self.solver_name = solver
        self.solver = get_solver(solver)
        self.learning_rate = learning_rate
        self.learning_rate_bias = learning_rate \
            if learning_rate_bias is None else learning_rate_bias
        self.weights_decay = weights_decay
        self.weights_decay_bias = weights_decay \
            if weights_decay_bias is None else weights_decay_bias
        self.l1_vs_l2 = l1_vs_l2
        self.gradient_moment = gradient_moment
        self.gradient_moment_bias = gradient_moment \
            if gradient_moment_bias is None else gradient_moment_bias
        self.schedule = get_schedule(lr_schedule,
                                     **(lr_schedule_params or {}))
        self.health = bool(health)
        self.global_step = 0
        #: Rollback scales the learning rate through this
        self.lr_multiplier = 1.0
        #: the seed of the chain's first parameters (unit form)
        self.weights_seed = weights_seed
        #: the trainer's key stream (the JAX trainer's prng_key="trainer")
        self.prng = RandomGenerator("trainer", seed)
        self.opt_state = {}
        self.epoch_acc = None
        self.loss = self.n_err = None
        #: non-finite train steps seen, and how many were skipped
        self.nonfinite_steps = 0
        self.skipped_steps = 0
        #: set by the "halt" policy at the first non-finite step
        self.halted = False
        self._health_ticks = 0
        self.demand("forwards", "evaluator", "loader")
        if plain:
            self._setup()

    def init_unpickled(self):
        super(GradientDescent, self).init_unpickled()
        #: a master's epoch accounting, fed by its workers' updates
        self._master_acc_ = numpy.zeros((3, 3), numpy.float64)
        #: a worker's parameters as its current job delivered them
        self._job_params_ = None
        self._augment_fn_ = None
        #: the mesh path's sharded state (models/gd_mesh.MeshPlan)
        self.plan_ = None

    def __getstate__(self):
        from veles_tpu_torch.distributable import host_state
        from veles_tpu_torch.parallel.mesh import Mesh
        state = super(GradientDescent, self).__getstate__()
        if isinstance(self.mesh, Mesh):
            # positions hold devices: persist the axis spec, rebuilt
            # over the resuming process's positions at initialize
            state["mesh"] = {"__mesh_axes__": dict(self.mesh.shape)}
        if self.plan_ is not None:
            state["opt_state"] = host_state(self.plan_.gathered_slots())
        return state

    def state_tensors(self):
        """``(params, opt_state)``: ``{i: {name: tensor}}`` of the
        chain's parameters and ``{(i, name): {slot: tensor}}`` of the
        solver slots, whole (gathered under a mesh)."""
        params = {i: dict(u.params.items())
                  for i, u in enumerate(self.forwards)}
        if self.plan_ is not None:
            return params, self.plan_.gathered_slots()
        return params, self.opt_state

    def write_state(self, params=None, opt_state=None):
        """Write whole parameters and/or slots (the forms
        :meth:`state_tensors` returns) in place, re-placed onto the
        positions under a mesh."""
        if self.plan_ is not None:
            self.plan_.write(params, opt_state)
            return
        with torch.no_grad():
            for i, u in enumerate(self.forwards):
                for n, p in u.params.items():
                    if params is not None:
                        p.copy_(torch.as_tensor(params[i][n]))
            for key, slots in self.opt_state.items():
                for s, v in slots.items():
                    if opt_state is not None:
                        v.copy_(torch.as_tensor(opt_state[key][s]))

    @property
    def augment_fn(self):
        """The augment as ``fn(x, key)`` (None when off)."""
        if self.augment is None:
            return None
        if callable(self.augment):
            return self.augment
        if self._augment_fn_ is None:
            from veles_tpu_torch.ops.augment import make_augment
            self._augment_fn_ = make_augment(**dict(self.augment))
        return self._augment_fn_

    def _setup(self):
        """Bind the trainer to its chain's parameters on their device:
        the parameter order, the per-layer hyper-parameters, fresh solver
        slots (kept, moved to the device, when restored) and the epoch
        accumulator."""
        if self.plan_ is not None:   # set up again: take the shards back
            params, self.opt_state = self.state_tensors()
            for i, u in enumerate(self.forwards):
                u.params = params[i]
            self.plan_ = None
        self.device = self.forwards[0].device
        #: (chain index, name) of every parameter, in the order the JAX
        #: package's pytrees flatten them (sorted keys)
        self._names = [(i, n) for i in range(len(self.forwards))
                       for n in sorted(self.forwards[i].params)]
        self._hps = {(i, n): self._layer_hp(self.forwards[i], n)
                     for i, n in self._names}
        for i, n in self._names:
            self.forwards[i].params[n].requires_grad_(True)
        with torch.no_grad():
            if not self.opt_state:
                self.opt_state = {(i, n): self.solver.init(self._param(i, n))
                                  for i, n in self._names}
            else:
                self.opt_state = {k: {s: t.to(self.device)
                                      for s, t in slots.items()}
                                  for k, slots in self.opt_state.items()}
        self.epoch_acc = torch.zeros((3, 3), dtype=torch.float32,
                                     device=self.device) \
            if self.epoch_acc is None else self.epoch_acc.to(self.device)
        if self.mesh is not None:
            from veles_tpu_torch.models.gd_mesh import MeshPlan, resolve_mesh
            self.mesh = resolve_mesh(self.mesh, self.device)
            self.plan_ = MeshPlan(self, self.mesh)
            # the slots live on the positions now
            self.opt_state = {}

    # -- the unit face --------------------------------------------------------

    def initialize(self, device=None, **kwargs):
        from veles_tpu_torch.units import MissingDemand
        if not self.forwards or self.evaluator is None \
                or self.loader is None:
            raise MissingDemand(self, {"forwards", "evaluator", "loader"})
        if not self.loader.is_initialized:
            raise MissingDemand(self, {"loader (initialized)"})
        super(GradientDescent, self).initialize(device=device, **kwargs)
        if self.device is None:
            from veles_tpu_torch.backends import resolve_device
            self.device = resolve_device()
        if any(set(u.PARAMS) - set(u.params) for u in self.forwards):
            self._fill_forwards()
        else:
            for u in self.forwards:
                u.to_device(self.device)
        self._setup()
        # span serving: auto-enable only (None); a builder's explicit
        # False stands (ref: gd.py initialize)
        if getattr(self.loader, "supports_span", False) \
                and self.loader.span_serving is None:
            self.loader.span_serving = True

    def _fill_forwards(self):
        """The chain's first parameters: ``convert.init_params``'s draw
        from ``default_rng(weights_seed)``, each unit sized from the
        sample shape its input has (a 1-D token sequence's length is the
        positional table's window).  ``weights_seed=None`` draws from
        the process-wide generator ``prng.get()`` in the JAX workflow
        units' order instead (``ForwardBase.fill_reference``), as the
        command line's runs do."""
        from veles_tpu_torch import prng
        gen = prng.get() if self.weights_seed is None else None
        rng = numpy.random.default_rng(self.weights_seed) \
            if gen is None else None
        shape = tuple(self.loader.sample_shape)
        window = shape[0] if len(shape) == 1 else None
        for unit in self.forwards:
            unit.in_shape = shape
            shape = tuple(unit.out_shape(shape))
            unit.to_device(self.device)
            unit.load_params(
                unit.fill_arrays(rng, unit.in_shape, window) if gen is None
                else unit.fill_reference(gen, unit.in_shape, window))

    def run(self):
        """One wave: the loader's fresh span, else its minibatch."""
        l = self.loader
        if l.span_fresh_:
            l.span_fresh_ = False
            self.run_span(l)
        else:
            target = l.minibatch_targets \
                if getattr(self.evaluator, "TARGETS", False) \
                else l.minibatch_labels
            self.run_minibatch(l.minibatch_data.devmem, target.devmem,
                               l.minibatch_size, l.minibatch_class)
        if self.halted and self._workflow is not None:
            self.error("health policy 'halt': non-finite training step - "
                       "stopping the workflow")
            self._workflow.on_workflow_finished()

    def step(self, **tensors):
        raise RuntimeError("GradientDescent launches its own steps")

    @property
    def health_policy(self):
        """The policy the trainer acts on: the one
        :mod:`~veles_tpu_torch.telemetry.health` is configured with."""
        return health_lib.health_config()["policy"]

    @property
    def health_on(self):
        """Whether steps compute and report their health vector: this
        trainer's ``health`` and the configured ``enabled``."""
        return self.health and health_lib.health_config()["enabled"]

    def _param(self, i, name):
        return self.forwards[i].params[name]

    def _layer_hp(self, unit, param_name):
        hp = unit.hyperparams()

        def pick(specific, generic, default):
            v = hp.get(specific)
            if v is None:
                v = hp.get(generic)
            return default if v is None else v

        if param_name == "bias":
            return {
                "lr": pick("learning_rate_bias", "learning_rate",
                           self.learning_rate_bias),
                "decay": pick("weights_decay_bias", "weights_decay",
                              self.weights_decay_bias),
                "moment": pick("gradient_moment_bias", "gradient_moment",
                               self.gradient_moment_bias),
                "l1_vs_l2": self.l1_vs_l2,
            }
        return {
            "lr": pick("learning_rate", None, self.learning_rate),
            "decay": pick("weights_decay", None, self.weights_decay),
            "moment": pick("gradient_moment", None, self.gradient_moment),
            "l1_vs_l2": self.l1_vs_l2,
        }

    # -- one minibatch --------------------------------------------------------

    def forward(self, x, key=None, train=False):
        """The chain's output (logits for a softmax head); on a train
        step each dropout layer draws its mask from a key split off
        ``key``."""
        if self.plan_ is not None:
            return self.plan_.whole(self.plan_.forward(x, key, train)[0])
        h = x
        last = len(self.forwards) - 1
        for i, u in enumerate(self.forwards):
            if isinstance(u, DropoutForward) and train:
                key, sub = threefry.split(key)
                h = u.apply_train(h, sub)
            elif isinstance(u, All2AllSoftmax) and i == last:
                h = u.logits(h)
            else:
                h = u.apply(h)
        return h

    def _loss_and_metrics(self, x, target, size, key, train):
        augment = self.augment_fn
        if train and augment is not None:
            key, sub = threefry.split(key)
            x = augment(x, sub)
        if getattr(self.evaluator, "TARGET_IS_INPUT", False):
            target = x
        lo = 0
        if self.plan_ is not None:
            self.plan_.check_batch(x, target)
            y, leaves = self.plan_.forward(x, key, train)
            self._step_leaves_ = leaves if train else None
            if self.plan_.gang:
                # this process's rows: its part of the loss and count
                lo, hi = self.plan_.rows(x.shape[0])
                target = target[lo:hi]
        else:
            y = self.forward(x, key, train)
        kw = {"offset": lo} if lo else {}
        loss = self.evaluator.loss(y, target, size, **kw)
        if hasattr(self.evaluator, "train_metrics"):
            n_err = self.evaluator.train_metrics(y, target, size, **kw)
        else:
            pred = torch.argmax(y, dim=-1)
            mask = torch.arange(lo, lo + y.shape[0], device=y.device) < size
            n_err = ((pred != target.long()) & mask).sum().to(torch.int32)
        return loss, n_err

    def _gang_total(self, loss, n_err):
        """The step's loss and error count over a gang's processes (each
        computed its rows' part), summed in process order: every process
        gets the same values.  As they are outside a gang."""
        if self.plan_ is None or not self.plan_.gang:
            return loss, n_err
        both = self.plan_.total(torch.stack(
            [loss.detach().to(torch.float32), n_err.to(torch.float32)]))
        return both[0], both[1].to(torch.int32)

    def _scaled_hps(self, step):
        # the float32 multiplier the JAX package traces
        scale = torch.tensor(self.lr_multiplier, dtype=torch.float32) \
            * torch.as_tensor(self.schedule(
                torch.tensor(float(step), dtype=torch.float32)),
                dtype=torch.float32)
        out = {}
        for key in self._names:
            hp = dict(self._hps[key])
            hp["lr"] = float(torch.tensor(hp["lr"], dtype=torch.float32)
                             * scale)
            out[key] = hp
        return out

    def _train_mesh(self, x, target, size, step, key):
        """The mesh step (models/gd_mesh): the groups' leaves' gradients
        reduce-scattered in group order, every position updating its
        slices."""
        plan = self.plan_
        loss, n_err = self._loss_and_metrics(x, target, size, key, True)
        sliced = plan.backward(loss, self._step_leaves_)
        self._step_leaves_ = None
        loss, n_err = self._gang_total(loss.detach(), n_err)
        health_on = self.health_on
        skip = health_on and self.health_policy == "skip_step"
        keep_old = None
        with torch.no_grad():
            if health_on:
                grad_sq = plan.grad_sq(sliced)
                bad = torch.where(
                    torch.isfinite(loss) & torch.isfinite(grad_sq),
                    0.0, 1.0).to(torch.float32)
                if skip:
                    keep_old = bad > 0
            weight_sq, update_sq = plan.apply_update(
                sliced, self._scaled_hps(step), self.solver, keep_old)
            if not health_on:
                return loss, n_err, torch.zeros(5, device=self.device)
            w_norm = torch.sqrt(weight_sq)
            health = torch.stack([
                torch.sqrt(grad_sq), w_norm,
                torch.sqrt(update_sq) / (w_norm + 1e-12), bad,
                loss.to(torch.float32)])
        return loss, n_err, health

    def _train(self, x, target, size, step, key):
        if self.plan_ is not None:
            return self._train_mesh(x, target, size, step, key)
        params = [self._param(i, n) for i, n in self._names]
        loss, n_err = self._loss_and_metrics(x, target, size, key, True)
        grads = torch.autograd.grad(loss, params)
        loss = loss.detach()
        hps = self._scaled_hps(step)
        health_on = self.health_on
        skip = health_on and self.health_policy == "skip_step"
        with torch.no_grad():
            if health_on:
                grad_sq = _sq_norm(grads)
                bad = torch.where(
                    torch.isfinite(loss) & torch.isfinite(grad_sq),
                    0.0, 1.0).to(torch.float32)
                keep_old = bad > 0
                weight_sq = update_sq = None
            for key, p, g in zip(self._names, params, grads):
                state = self.opt_state[key]
                new_p, new_s = self.solver.update(p, g, state, hps[key])
                if skip:
                    new_p = torch.where(keep_old, p, new_p)
                    new_s = {s: torch.where(keep_old, state[s], v)
                             for s, v in new_s.items()}
                if health_on:
                    w = _sq_norm([new_p])
                    u = _sq_norm([new_p - p])
                    weight_sq = w if weight_sq is None else weight_sq + w
                    update_sq = u if update_sq is None else update_sq + u
                p.copy_(new_p)
                for s, v in new_s.items():
                    state[s].copy_(v)
            if not health_on:
                return loss, n_err, torch.zeros(5, device=self.device)
            w_norm = torch.sqrt(weight_sq)
            health = torch.stack([
                torch.sqrt(grad_sq), w_norm,
                torch.sqrt(update_sq) / (w_norm + 1e-12), bad,
                loss.to(torch.float32)])
        return loss, n_err, health

    def _eval(self, x, target, size):
        with torch.no_grad():
            loss, n_err = self._gang_total(*self._loss_and_metrics(
                x, target, size, None, False))
            zero = torch.zeros((), device=self.device)
            bad = (~torch.isfinite(loss)).to(torch.float32) \
                if self.health_on else zero
            health = torch.stack([zero, zero, zero, bad,
                                  loss.to(torch.float32)])
        return loss, n_err, health

    def _step(self, x, target, size, class_id, step, key):
        """One minibatch of class ``class_id`` at schedule step ``step``
        with dropout key ``key``: update (train only) and epoch
        accounting; returns (loss, n_err, health) on the device."""
        if class_id == TRAIN:
            loss, n_err, health = self._train(x, target, size, step, key)
        else:
            loss, n_err, health = self._eval(x, target, size)
        with torch.no_grad():
            per_sample = self.evaluator.metric_units(x) \
                if hasattr(self.evaluator, "metric_units") else 1
            fsize = torch.tensor(float(size), device=self.device)
            row = torch.stack([n_err.to(torch.float32) / per_sample,
                               loss * size, fsize])
            if class_id == TRAIN and self.health_on \
                    and self.health_policy == "skip_step":
                zero = torch.zeros((), device=self.device)
                row = torch.where(health[3] > 0,
                                  torch.stack([zero, zero, fsize]), row)
            onehot = (torch.arange(3, device=self.device)
                      == class_id).to(torch.float32)
            self.epoch_acc = self.epoch_acc + onehot[:, None] * row[None, :]
        return loss, n_err, health

    def run_minibatch(self, x, target, size, class_id):
        """One minibatch ``x`` (targets ``target``, ``size`` valid rows)
        of class ``class_id``; a train step advances ``global_step``."""
        self.loss, self.n_err, health = self._step(
            x, target, int(size), class_id, self.global_step,
            self.prng.peek_key(self.global_step))
        if class_id == TRAIN:
            self.global_step += 1
            self._observe_health(health)
        return self.loss, self.n_err, health

    def run_span(self, loader):
        """Consume the class span ``loader.serve_span()`` published: one
        minibatch per row of its index schedule, each gathered from
        ``loader.dataset_dev`` (indices past the span clamp to row 0,
        as the JAX package's gather clips, and are masked by size); the
        k-th minibatch's key is ``fold_in(peek_key(global_step), k)``."""
        ds = loader.dataset_dev
        labels = loader.targets_dev \
            if getattr(self.evaluator, "TARGETS", False) else loader.labels_dev
        idx = torch.as_tensor(loader.span_indices_, device=ds.device).long()
        idx = idx.clamp(0, ds.shape[0] - 1)
        sizes = [int(n) for n in loader.span_sizes_]
        cls = loader.span_class_
        base_key = self.prng.peek_key(self.global_step)
        healths = []
        for k, size in enumerate(sizes):
            self.loss, self.n_err, health = self._step(
                ds[idx[k]], labels[idx[k]], size, cls, self.global_step + k,
                threefry.fold_in(base_key, k))
            healths.append(health)
        health = torch.cat([healths[-1][:3],
                            torch.stack([h[3] for h in healths]).sum()[None],
                            healths[-1][4:]])
        if cls == TRAIN:
            self.global_step += len(sizes)
            self._observe_health(health, force=True)
        return self.loss, self.n_err, health

    def _observe_health(self, health, force=False):
        """Report the step's health vector to the process-wide monitor —
        one small device→host read per observed dispatch, every
        ``sync_every``-th on the per-minibatch path (``force``: a span,
        always) — and act on its verdict: "halt" sets :attr:`halted`."""
        if not self.health_on:
            return
        self._health_ticks += 1
        every = max(int(health_lib.health_config()["sync_every"]), 1)
        if not force and self._health_ticks % every:
            return
        g, w, u, bad, loss = (float(v) for v in health.tolist())
        action = health_lib.monitor.on_train_step(
            grad_norm=g, weight_norm=w, update_ratio=u, nonfinite=bad,
            loss=loss, unit=type(self).__name__)
        if bad > 0:
            self.nonfinite_steps += int(bad)
            if action == "skip_step":
                self.skipped_steps += int(bad)
        if action == "halt":
            log.error("health policy 'halt': non-finite training step - "
                      "stopping (see GET /healthz)")
            self.halted = True

    # -- the master/worker exchange (ref: gd.py:839-887) ----------------------

    negotiates_on_connect = True

    def _params_numpy(self):
        return {i: {n: t.detach().cpu().numpy().copy()
                    for n, t in u.params.items()}
                for i, u in enumerate(self.forwards)}

    def generate_data_for_slave(self, slave=None):
        """Master → worker: the job carries the current parameters."""
        return {"params": self._params_numpy()}

    def apply_data_from_master(self, data):
        """Worker: install the master's parameters and keep them as this
        job's delta baseline."""
        params = data["params"]
        self.write_state(params=params)
        self._job_params_ = params

    def generate_data_for_master(self):
        """Worker → master: the parameters' delta since the job's
        baseline (host f32) and the epoch accounting gathered since the
        last send."""
        now = self._params_numpy()
        base = self._job_params_ or now
        delta = {i: {n: now[i][n] - base[i][n] for n in now[i]}
                 for i in now}
        acc = self.read_epoch_acc(reset_classes=(0, 1, 2), as_array=True)
        return {"delta": delta, "acc": acc}

    def apply_data_from_slave(self, data, slave=None):
        """Master: add the worker's delta to the parameters on the host
        in f32 and fold its epoch accounting into the float64 master
        accumulator."""
        params = self._params_numpy()
        for i, ps in params.items():
            for n in ps:
                ps[n] += data["delta"][i][n]
        self.write_state(params=params)
        self._master_acc_ += numpy.asarray(data["acc"], numpy.float64)

    def drop_slave(self, slave=None):
        pass  # a dead worker's in-flight delta is lost

    def read_epoch_acc(self, reset_classes=(), as_array=False):
        """{class: (n_err, loss_sum, samples)} (or the [3, 3] array);
        resets the requested class rows.  A master reads the float64
        accumulator its workers' updates fed (its graph never runs)."""
        if self.is_master:
            acc = numpy.array(self._master_acc_)
            for c in reset_classes:
                self._master_acc_[c] = 0
        else:
            acc = self.epoch_acc.cpu().numpy().copy()
            if len(reset_classes):
                self.epoch_acc[list(reset_classes)] = 0
        if as_array:
            return acc
        return {c: tuple(float(x) for x in acc[c]) for c in range(3)}
