"""Kohonen self-organizing maps — the port of
``veles_tpu/models/kohonen.py`` (``KohonenForward``, the best-matching
unit, and ``KohonenTrainer``'s batch update).

The distances are the reference's expanded norm
``‖x‖² − 2x·wᵀ + ‖w‖²`` in f32, not ``torch.cdist``, so near-ties fall
the same way; the winner is the first minimum (``argmin``), in both
packages.

``KohonenForward`` and ``KohonenTrainer`` are also workflow units (the
reference's faces): ``KohonenTrainer(workflow, loader=..., shape=...)``
sizes and fills its map at ``initialize(device=)`` and takes one batch
update per ``run()`` from the loader's minibatch;
``KohonenForward(workflow, shape=...)`` writes the winners of its
``input`` Array into ``output`` against its ``weights`` (link them to a
trainer's with ``link_attrs``).  :class:`KohonenDecision` is the SOM's
epoch gate (``models/kohonen.py:156``).
"""

import numpy
import torch

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.loader.base import unit_form
from veles_tpu_torch.memory import Array
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.prng import RandomGenerator
from veles_tpu_torch.result_provider import IResultProvider
from veles_tpu_torch.units import MissingDemand


def grid(sy, sx):
    """[sy·sx, 2] f32 (row, column) coordinates of the map's neurons."""
    yy, xx = numpy.mgrid[0:sy, 0:sx]
    return numpy.stack([yy.ravel(), xx.ravel()], axis=1).astype(
        numpy.float32)


def bmu(weights, x):
    """(winners [batch] int64, distances [batch, neurons] f32) of samples
    ``x`` [batch, features] against ``weights`` [neurons, features]."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    w2 = torch.sum(weights * weights, dim=1)[None, :]
    d = x2 - 2.0 * (x @ weights.T) + w2
    return torch.argmin(d, dim=1), d


class KohonenForward(AcceleratedUnit):
    """The best-matching unit of each sample on a map of ``weights``
    [neurons, features] (a trainer's, or loaded): ``KohonenForward(
    weights)``, or the unit ``KohonenForward(workflow, weights=None,
    shape=(8, 8))``."""

    FUSABLE = False

    def __init__(self, workflow=None, weights=None, shape=(8, 8), **kwargs):
        if not unit_form(workflow):
            workflow, weights = None, workflow
        super(KohonenForward, self).__init__(workflow, **kwargs)
        self.weights = weights
        self.shape = tuple(shape)
        self.input = None
        self.output = Array()

    def apply(self, x):
        """[batch] winner indices of ``x`` [batch, ...]."""
        return bmu(self.weights, x.reshape(x.shape[0], -1))[0]

    def initialize(self, device=None, **kwargs):
        if not isinstance(self.input, Array) or not bool(self.input):
            raise MissingDemand(self, {"input"})
        self.output.reset(numpy.zeros((self.input.shape[0],), numpy.int32))
        super(KohonenForward, self).initialize(device=device, **kwargs)

    def run(self):
        self.output.devmem = self.apply(
            self.input.devmem.to(torch.float32)).to(torch.int32)


class KohonenTrainer(AcceleratedUnit):
    """Batch SOM update on a (sy, sx) grid: each sample's winner pulls
    its Gaussian neighbourhood, the learning rate and the radius decay
    over :attr:`time` steps.  Weights start uniform in ±0.1 from the
    ``"kohonen"`` generator's host stream (seed 42 unless given), as the
    reference's do.  ``KohonenTrainer(features, ...)`` is ready at once;
    ``KohonenTrainer(workflow, loader=..., ...)`` is the unit, sized
    from the loader's sample shape at ``initialize(device=)``."""

    FUSABLE = False  # launches its own updates

    def __init__(self, workflow=None, shape=(8, 8), sigma0=None,
                 sigma_decay=200.0, learning_rate=0.5, lr_decay=200.0,
                 seed=None, weights=None, device=None, loader=None,
                 **kwargs):
        plain = not unit_form(workflow)
        features = workflow if plain else None
        super(KohonenTrainer, self).__init__(None if plain else workflow,
                                             **kwargs)
        self.loader = loader
        self.shape = tuple(shape)
        self.sigma0 = sigma0 if sigma0 is not None \
            else max(self.shape) / 2.0
        self.sigma_decay = sigma_decay
        self.learning_rate = learning_rate
        self.lr_decay = lr_decay
        self.prng = RandomGenerator("kohonen", seed)
        self.weights = weights
        #: steps taken (the schedules' clock)
        self.time = 0
        #: the last step's mean quantization error (f32 on the device)
        self.qerror = None
        if plain:
            self._place(resolve_device(device), features)
        else:
            self.demand("loader")

    def _place(self, device, features):
        """Bind to ``device``: the map (drawn now if there is none) and
        the grid's coordinates there."""
        self.device = device
        if self.weights is None:
            w = numpy.zeros((self.n_neurons, int(features)), numpy.float32)
            self.prng.fill(w, -0.1, 0.1)
            self.weights = w
        self.weights = torch.as_tensor(
            numpy.asarray(self.weights, numpy.float32)
            if not torch.is_tensor(self.weights) else self.weights,
            dtype=torch.float32).to(device)
        self.coords = torch.as_tensor(grid(*self.shape)).to(device)

    @property
    def n_neurons(self):
        return self.shape[0] * self.shape[1]

    def initialize(self, device=None, **kwargs):
        if self.loader is None or not self.loader.is_initialized:
            raise MissingDemand(self, {"loader"})
        super(KohonenTrainer, self).initialize(device=device, **kwargs)
        self._place(self.device or resolve_device(),
                    int(numpy.prod(self.loader.sample_shape)))
        if self.qerror is not None:
            self.qerror = self.qerror.to(self.device)

    def run(self):
        l = self.loader
        self.step(l.minibatch_data.devmem, l.minibatch_size)

    def step(self, x, size=None):
        """One batch update from ``x`` [batch, ...] (rows >= ``size``
        masked); returns the mean quantization error of the valid rows
        before the update."""
        f32 = torch.float32
        x = x.reshape(x.shape[0], -1).to(f32)
        size = x.shape[0] if size is None else int(size)
        w = self.weights
        winners, d = bmu(w, x)
        mask = (torch.arange(x.shape[0], device=x.device) < size).to(f32)
        best = torch.gather(d, 1, winners[:, None])[:, 0]
        qerr = torch.sum(torch.sqrt(torch.clamp(best, min=0.0)) * mask) \
            / max(size, 1)
        t = torch.tensor(float(self.time), dtype=f32, device=x.device)
        sigma = self.sigma0 * torch.exp(-t / self.sigma_decay)
        lr = self.learning_rate * torch.exp(-t / self.lr_decay)
        wc = self.coords[winners]                              # [b, 2]
        d2 = torch.sum((wc[:, None, :] - self.coords[None, :, :]) ** 2,
                       dim=-1)
        h = torch.exp(-d2 / (2.0 * sigma * sigma)) * mask[:, None]
        num = h.T @ x                                          # [n, f]
        den = torch.sum(h, dim=0)[:, None]
        target = num / torch.clamp(den, min=1e-12)
        gate = (den > 1e-12).to(f32)
        self.weights = w + lr * gate * (target - w)
        self.qerror = qerr
        self.time += 1
        return qerr


class KohonenDecision(AcceleratedUnit, IResultProvider):
    """Epoch loop control for SOM training (ref:
    ``models/kohonen.py:156``): no gradient or error signal — it records
    each epoch's quantization error and completes after
    ``max_epochs``."""

    FUSABLE = False

    def __init__(self, workflow, max_epochs=10, **kwargs):
        super(KohonenDecision, self).__init__(workflow, **kwargs)
        self.max_epochs = max_epochs
        self.loader = None
        self.trainer = None
        self.complete = Bool(False, "complete")
        self.epoch_qerror = []
        self.demand("loader", "trainer")

    def run(self):
        l = self.loader
        if l.train_ended:
            self.epoch_qerror.append(float(self.trainer.qerror))
            self.info("epoch %d: quantization error %.4f",
                      l.epoch_number, self.epoch_qerror[-1])
            if l.epoch_number >= self.max_epochs:
                self.complete.set(True)
                if self._workflow is not None:
                    self._workflow.on_workflow_finished()

    def get_metric_values(self):
        return {"quantization_error":
                self.epoch_qerror[-1] if self.epoch_qerror else None}
