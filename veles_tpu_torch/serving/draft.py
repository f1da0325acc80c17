"""Model-based speculative drafting: Medusa-style multi-token heads over
the target's last hidden state — the port of
``veles_tpu/serving/draft.py``.

``k`` small heads read the [B, d] hidden state the engine's
``want_hidden`` lane returns (the input of the LM head).  The LM head
over ``h_t`` predicts token t+1; draft head ``j`` (1-based) over the same
``h_t`` predicts token ``t+1+j``.  The scheduler keeps the hidden of the
position behind each slot's pending token, so head j drafts the token
``j`` past the pending one.  Each head is one residual SiLU block and
its own un-embedding (the Medusa-1 head)::

    z_j = h + silu(h @ w1_j + b1_j),    logits_j = z_j @ w2_j + b2_j

Heads train against the FROZEN target: a teacher forward through every
unit but the LM head gives the hidden states (under ``torch.no_grad()``:
on the card its attention is the FlashAttention forward kernel), and
cross-entropy to the shifted token stream trains the head parameters
only, by SGD with momentum.  Drafts pass through the unchanged verify
contract, so a head moves throughput only: streams stay the spec-off
streams however good or bad it is.

The state is numpy (``params``: ``w1`` [k, d, d], ``b1`` [k, d], ``w2``
[k, d, vocab], ``b2`` [k, vocab]) and pickles through
``__getstate__``/``__setstate__`` as the reference's does, so a head
pickled by either package loads in the other.  The head's matmuls are
plain PyTorch (XLA dots in the reference, not Pallas kernels).
"""

import numpy
import torch

from veles_tpu_torch.serving.engine import hidden_supported

_NAMES = ("w1", "b1", "w2", "b2")


def draft_supported(forwards):
    """True when the chain can feed a draft head: it ends in a
    position-wise vocab head (``hidden_supported``) whose [d, vocab]
    weights size the head."""
    if not hidden_supported(forwards):
        return False
    w = getattr(forwards[-1], "params", {}).get("weights")
    return w is not None and w.dim() == 2


def _logits(hp, h):
    """Every head's logits over hidden states ``h`` [..., d] f32:
    [..., k, vocab]."""
    pre = torch.einsum("...d,kde->...ke", h, hp["w1"]) + hp["b1"]
    z = h[..., None, :] + torch.nn.functional.silu(pre)
    return torch.einsum("...ke,kev->...kv", z, hp["w2"]) + hp["b2"]


class MedusaDraftHead:
    """``k`` draft heads over a ``d_model`` hidden state, each with a
    ``vocab``-wide un-embedding.  :meth:`propose` drafts greedily from a
    batch of hidden states; :meth:`train` fits the heads against a
    frozen chain."""

    def __init__(self, k, d_model, vocab, seed=0):
        self.k = int(k)
        self.d_model = int(d_model)
        self.vocab = int(vocab)
        if self.k < 1:
            raise ValueError("need k >= 1")
        rng = numpy.random.RandomState(int(seed))
        d, v = self.d_model, self.vocab
        # w2 starts at zero: untrained heads emit flat logits (argmax 0),
        # drafts that simply reject at verify
        self.params = {
            "w1": (rng.randn(self.k, d, d) / numpy.sqrt(d)
                   ).astype(numpy.float32),
            "b1": numpy.zeros((self.k, d), numpy.float32),
            "w2": numpy.zeros((self.k, d, v), numpy.float32),
            "b2": numpy.zeros((self.k, v), numpy.float32),
        }
        self._dev = None

    @classmethod
    def from_chain(cls, forwards, k, seed=0):
        """A head sized for ``forwards``: d_model and vocab from the
        chain's LM-head weights."""
        if not draft_supported(forwards):
            raise ValueError(
                "chain cannot feed a draft head (needs a trailing "
                "position-wise vocab head; see draft_supported)")
        d, v = forwards[-1].params["weights"].shape
        return cls(k, int(d), int(v), seed=seed)

    def _device_params(self, device):
        """The parameters as f32 tensors on ``device``, copied once per
        device and parameter set."""
        if self._dev is None or self._dev[0] != device:
            self._dev = (device, {
                n: torch.tensor(self.params[n], device=device)
                for n in _NAMES})
        return self._dev[1]

    def propose(self, hidden):
        """Greedy drafts for hidden states ``hidden`` [B, d] (a tensor,
        on any device, or an array): [B, k] int32 numpy, row n's entry
        j - 1 drafting the token ``j`` past the one row n's hidden
        predicts.  The batch pads to a power of two, as the reference's
        does."""
        h = torch.as_tensor(hidden).to(torch.float32)
        b = h.shape[0]
        bb = 1
        while bb < b:
            bb <<= 1
        if bb != b:
            h = torch.cat([h, h.new_zeros((bb - b, h.shape[1]))])
        with torch.no_grad():
            out = torch.argmax(_logits(self._device_params(h.device), h),
                               dim=-1)
        return out[:b].to(torch.int32).cpu().numpy()

    def train(self, forwards, corpus, steps=200, batch=8, window=32,
              lr=0.1, momentum=0.9, seed=0):
        """Fit the heads against the frozen ``forwards`` on ``corpus`` (a
        1-D token array): each step samples ``batch`` windows of
        ``window`` tokens (``numpy.random.RandomState(seed)``, as the
        reference draws them), teacher-forwards them through every unit
        but the LM head without gradients, and takes one SGD-momentum
        step on the heads' mean masked cross-entropy.  Returns the loss
        of each step."""
        corpus = numpy.asarray(corpus, numpy.int64).ravel()
        if len(corpus) < window + 1:
            raise ValueError("corpus shorter than one window")
        device = forwards[0].device
        hp = {n: torch.tensor(self.params[n], device=device,
                              requires_grad=True) for n in _NAMES}
        mom = {n: torch.zeros_like(t) for n, t in hp.items()}
        k = self.k
        rng = numpy.random.RandomState(int(seed))
        losses = []
        for _ in range(int(steps)):
            starts = rng.randint(0, len(corpus) - window, size=int(batch))
            toks = torch.as_tensor(
                numpy.stack([corpus[s:s + window] for s in starts]),
                device=device)
            with torch.no_grad():
                h = toks
                for u in forwards[:-1]:
                    h = u.apply(h)
                h = h.to(torch.float32)
            b, t, _ = h.shape
            logits = _logits(hp, h)                     # [B, T, k, V]
            # head j (storage index jj = j - 1) over position t predicts
            # token t+1+j = toks[t + 2 + jj]; positions past the window
            # are masked
            idx = (torch.arange(t, device=device)[:, None] + 2
                   + torch.arange(k, device=device)[None, :])
            mask = (idx < t).to(torch.float32)          # [T, k]
            labels = toks[:, idx.clamp(0, t - 1)]       # [B, T, k]
            logp = torch.log_softmax(logits, dim=-1)
            nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
            loss = (nll * mask[None]).sum() \
                / torch.clamp(mask.sum() * b, min=1.0)
            grads = torch.autograd.grad(loss, [hp[n] for n in _NAMES])
            with torch.no_grad():
                for n, g in zip(_NAMES, grads):
                    mom[n].mul_(momentum).add_(g)
                    hp[n].sub_(lr * mom[n])
            losses.append(float(loss.detach()))
        self.params = {n: hp[n].detach().cpu().numpy().copy()
                       for n in _NAMES}
        self._dev = None
        return losses

    def __getstate__(self):
        return {"k": self.k, "d_model": self.d_model, "vocab": self.vocab,
                "params": self.params}

    def __setstate__(self, state):
        self.k = state["k"]
        self.d_model = state["d_model"]
        self.vocab = state["vocab"]
        self.params = {n: numpy.asarray(a, numpy.float32)
                       for n, a in state["params"].items()}
        self._dev = None
