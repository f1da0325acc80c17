"""Evaluators' losses and metrics — the port of
``veles_tpu/models/evaluator.py`` for the trainer: the masked softmax
cross-entropy, the classifier head's loss, the per-token next-token
objective and the regression's mean squared error.  (The JAX package's
evaluators are also in-graph units that read the loader's minibatch
size each run; the port's trainer passes the size itself, so only the
pure functions are needed.)  ``offset`` is the minibatch row the given
rows start at: a process of a gang scores its own rows under the whole
minibatch's mask and divisor, and the parts sum to the whole's loss."""

import torch


def _valid(rows, size, offset, device):
    """Which of ``rows`` rows starting at minibatch row ``offset`` are
    below ``size``."""
    return torch.arange(offset, offset + rows, device=device) < size


def masked_ce_from_logits(logits, labels, size, per_row_positions=1,
                          offset=0):
    """Masked mean softmax cross-entropy: ``logits`` [rows, ..., V]
    (f32-cast here), ``labels`` [rows, ...] int, rows >= ``size``
    masked away; the mean divides by size · per_row_positions."""
    logits = logits.to(torch.float32)
    z = logits - logits.amax(dim=-1, keepdim=True)
    logp = z - torch.log(torch.exp(z).sum(dim=-1, keepdim=True))
    picked = torch.gather(logp, -1,
                          labels.clamp(min=0).long()[..., None])[..., 0]
    mask = _valid(logits.shape[0], size, offset, logits.device)
    mask = mask.reshape((-1,) + (1,) * (picked.dim() - 1))
    return -torch.where(mask, picked, torch.zeros_like(picked)).sum() \
        / max(int(size), 1) / per_row_positions


class EvaluatorSoftmax:
    """Cross-entropy of a classifier head's logits."""

    @staticmethod
    def loss_from_logits(logits, labels, size, offset=0):
        """Masked mean softmax cross-entropy over valid rows (in f32)."""
        return masked_ce_from_logits(logits, labels, size, offset=offset)

    def loss(self, y, labels, size, offset=0):
        return self.loss_from_logits(y, labels, size, offset)


class EvaluatorMSE:
    """Mean squared error against regression targets (an autoencoder's
    targets are its inputs): the masked sum of squared differences in
    f32 over the ``size`` valid rows, divided by ``size`` and by the
    elements per sample.  The trainer reports no error count for it
    (``n_err`` 0, as the reference's trainer does)."""

    #: the trainer gathers the loader's ``targets_dev`` as the target
    TARGETS = True

    def loss(self, y, target, size, offset=0):
        diff = (y.to(torch.float32)
                - target.to(torch.float32)).reshape(y.shape[0], -1)
        mask = _valid(y.shape[0], size, offset, y.device)[:, None]
        return torch.where(mask, diff * diff, torch.zeros_like(diff)).sum() \
            / max(int(size), 1) / diff.shape[1]

    def train_metrics(self, y, target, size, offset=0):
        return torch.zeros((), dtype=torch.int32, device=y.device)


class EvaluatorNextToken:
    """Per-token next-token cross-entropy (teacher forcing): logits
    [batch, seq, vocab] at position t are scored against token t+1 of
    the model's own input, averaged over the seq-1 positions of the
    ``size`` valid rows."""

    #: the trainer scores against the model INPUT (the token minibatch)
    TARGET_IS_INPUT = True

    @staticmethod
    def _shifted(logits, tokens):
        return logits[:, :-1].to(torch.float32), tokens[:, 1:].long()

    def loss(self, y, tokens, size, offset=0):
        """Mean CE per token over valid positions (rows < size)."""
        z, tgt = self._shifted(y, tokens)
        return masked_ce_from_logits(z, tgt, size,
                                     per_row_positions=tgt.shape[1],
                                     offset=offset)

    def metric_units(self, x):
        """Tokens scored per sample (the epoch accounting divides the
        wrong-token count by it)."""
        return x.shape[1] - 1

    def train_metrics(self, y, tokens, size, offset=0):
        """Wrong next-token count over valid positions."""
        z, tgt = self._shifted(y, tokens)
        pred = torch.argmax(z, dim=-1)
        mask = _valid(y.shape[0], size, offset, y.device)[:, None]
        return ((pred != tgt) & mask).sum().to(torch.int32)
