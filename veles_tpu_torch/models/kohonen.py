"""Kohonen self-organizing maps — the port of
``veles_tpu/models/kohonen.py`` (``KohonenForward``, the best-matching
unit, and ``KohonenTrainer``'s batch update).

The distances are the reference's expanded norm
``‖x‖² − 2x·wᵀ + ‖w‖²`` in f32, not ``torch.cdist``, so near-ties fall
the same way; the winner is the first minimum (``argmin``), in both
packages.  The workflow gate
``KohonenDecision`` waits for the workflow runtime (ROADMAP item 9).
"""

import numpy
import torch

from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.prng import RandomGenerator


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


class KohonenForward:
    """The best-matching unit of each sample on a map of ``weights``
    [neurons, features] (a trainer's, or loaded)."""

    def __init__(self, weights):
        self.weights = weights

    def apply(self, x):
        """[batch] winner indices of ``x`` [batch, ...]."""
        return bmu(self.weights, x.reshape(x.shape[0], -1))[0]


class KohonenTrainer:
    """Batch SOM update on a (sy, sx) grid: each sample's winner pulls
    its Gaussian neighbourhood, the learning rate and the radius decay
    over :attr:`time` steps.  Weights start uniform in ±0.1 from the
    ``"kohonen"`` generator's host stream (seed 42 unless given), as the
    reference's do."""

    def __init__(self, features, shape=(8, 8), sigma0=None,
                 sigma_decay=200.0, learning_rate=0.5, lr_decay=200.0,
                 seed=None, weights=None, device=None):
        self.device = resolve_device(device)
        self.shape = tuple(shape)
        self.sigma0 = sigma0 if sigma0 is not None \
            else max(self.shape) / 2.0
        self.sigma_decay = sigma_decay
        self.learning_rate = learning_rate
        self.lr_decay = lr_decay
        if weights is None:
            weights = numpy.zeros((self.n_neurons, int(features)),
                                  numpy.float32)
            RandomGenerator("kohonen", seed).fill(weights, -0.1, 0.1)
        self.weights = torch.as_tensor(
            numpy.asarray(weights, numpy.float32)).to(self.device)
        self.coords = torch.as_tensor(grid(*self.shape)).to(self.device)
        #: steps taken (the schedules' clock)
        self.time = 0
        #: the last step's mean quantization error (f32 on the device)
        self.qerror = None

    @property
    def n_neurons(self):
        return self.shape[0] * self.shape[1]

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
