"""Bernoulli-Bernoulli restricted Boltzmann machine — the port of
``veles_tpu/models/rbm.py`` (``BernoulliRBM``: the CD-k step,
``hidden_probs`` and ``reconstruct``).

Randomness is the reference's: step ``t``'s key is the ``"rbm"``
generator's ``peek_key(t)``, Gibbs step ``kk`` folds ``kk`` into it and
samples ``uniform(key) < p`` (``jax.random.bernoulli``) through
``ops.random.uniform`` — kernel 5 on the card — so the hidden samples
equal the reference's bit for bit.  The products are plain f32, as the
reference's are.
"""

import numpy
import torch

from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.ops import random as ops_random
from veles_tpu_torch.prng import RandomGenerator, threefry


def cd_step(w, vb, hb, v0, size, key, k, lr):
    """One CD-k update of ``w`` [visible, hidden], ``vb``, ``hb`` from
    ``v0`` [batch, ...] (rows >= ``size`` masked) with ``key``: returns
    (w, vb, hb, reconstruction error, the hidden samples of each Gibbs
    step)."""
    mask = (torch.arange(v0.shape[0], device=v0.device) < size).to(
        torch.float32)[:, None]
    v0 = v0.reshape(v0.shape[0], -1).to(torch.float32) * mask
    h0p = torch.sigmoid(v0 @ w + hb)
    hp, vp = h0p, v0
    samples = []
    for kk in range(k):
        u = ops_random.uniform(threefry.fold_in(key, kk), hp.shape,
                               device=hp.device)
        h = (u < hp).to(v0.dtype)
        samples.append(h)
        vp = torch.sigmoid(h @ w.T + vb)
        hp = torch.sigmoid(vp @ w + hb)
    n = torch.clamp(mask.sum(), min=1.0)
    pos = v0.T @ h0p
    neg = (vp * mask).T @ hp
    w = w + lr * (pos - neg) / n
    vb = vb + lr * torch.sum(v0 - vp * mask, dim=0) / n
    hb = hb + lr * torch.sum((h0p - hp) * mask, dim=0) / n
    err = torch.sum(((v0 - vp) * mask) ** 2) / n
    return w, vb, hb, err, samples


class BernoulliRBM:
    """An RBM of ``visible`` × ``hidden`` units: :meth:`step` takes one
    CD-k update; weights start normal(0, 0.01) from the ``"rbm"``
    generator's host stream (seed 42 unless given), biases at zero."""

    def __init__(self, visible, hidden=64, cd_k=1, learning_rate=0.1,
                 seed=None, device=None):
        self.device = resolve_device(device)
        self.hidden = int(hidden)
        self.cd_k = int(cd_k)
        self.learning_rate = float(learning_rate)
        self.prng = RandomGenerator("rbm", seed)
        w = numpy.zeros((int(visible), self.hidden), numpy.float32)
        self.prng.fill_normal(w, 0.0, 0.01)
        self.weights = torch.as_tensor(w).to(self.device)
        self.vbias = torch.zeros(int(visible), device=self.device)
        self.hbias = torch.zeros(self.hidden, device=self.device)
        self.global_step = 0
        #: the last step's reconstruction error and hidden samples
        self.recon_error = None
        self.samples = []

    @classmethod
    def from_jax(cls, rec, device=None):
        """The RBM of a JAX package ``BernoulliRBM`` record
        (:func:`veles_tpu_torch.jax_snapshot.read_records`): its
        parameters, step count, CD-k, learning rate and the ``"rbm"``
        generator's state, so its next step is the one the JAX unit
        would take."""
        from veles_tpu_torch import jax_snapshot
        arrays = {n: jax_snapshot.array_of(rec.get(n))
                  for n in ("weights", "vbias", "hbias")}
        missing = [n for n, a in arrays.items() if a is None]
        if missing:
            raise ValueError("the snapshot's %s holds no %s"
                             % (rec.jax_name, missing))
        rbm = cls(arrays["weights"].shape[0],
                  hidden=arrays["weights"].shape[1],
                  cd_k=int(rec.get("cd_k", 1)),
                  learning_rate=float(rec.get("learning_rate", 0.1)),
                  device=device)
        rbm.load_params(arrays)
        rbm.global_step = int(rec.get("global_step", 0))
        if rec.get("prng") is not None:
            jax_snapshot.take_generator(rbm.prng, rec.get("prng"))
        return rbm

    def load_params(self, arrays):
        """Take ``weights`` [visible, hidden], ``vbias`` and ``hbias``
        (numpy arrays, the reference's names and layouts)."""
        for name in ("weights", "vbias", "hbias"):
            setattr(self, name, torch.as_tensor(numpy.array(
                arrays[name], numpy.float32)).to(self.device))
        self.hidden = int(self.weights.shape[1])

    def hidden_probs(self, v):
        return torch.sigmoid(v @ self.weights + self.hbias)

    def reconstruct(self, v):
        h = self.hidden_probs(v)
        return torch.sigmoid(h @ self.weights.T + self.vbias)

    def step(self, v0, size=None):
        """One CD-k update from ``v0`` [batch, ...]; returns the
        reconstruction error."""
        size = v0.shape[0] if size is None else int(size)
        key = self.prng.peek_key(self.global_step)
        (self.weights, self.vbias, self.hbias, self.recon_error,
         self.samples) = cd_step(self.weights, self.vbias, self.hbias, v0,
                                 size, key, self.cd_k, self.learning_rate)
        self.global_step += 1
        return self.recon_error
