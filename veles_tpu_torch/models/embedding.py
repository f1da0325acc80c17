"""Token embedding with learned positions — the port of
``veles_tpu/models/embedding.py::Embedding``.  In training, gradients
flow through the gather into ``weights`` and ``positions``."""

import numpy
import torch

from veles_tpu_torch.models.nn_units import ForwardBase


class Embedding(ForwardBase):
    """[batch, seq] int tokens → [batch, seq, dim] in the compute
    dtype, plus a learned positional row per position."""

    #: dim 1 of the input is a sequence (a mesh shards it over ``sp``)
    SEQ_DIM1_INPUT = True

    def __init__(self, vocab=None, dim=None, learned_positions=True,
                 device=None, dtype=None, **hyper):
        super().__init__(device=device, dtype=dtype, **hyper)
        if not vocab or not dim:
            raise ValueError("vocab and dim are required")
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.learned_positions = bool(learned_positions)
        self.PARAMS = ("weights", "positions") if self.learned_positions \
            else ("weights",)

    def param_shapes(self, in_shape, window):
        shapes = {"weights": (self.vocab, self.dim)}
        if self.learned_positions:
            shapes["positions"] = (int(window), self.dim)
        return shapes

    def out_shape(self, in_shape):
        return tuple(in_shape) + (self.dim,)

    def fill_arrays(self, rng, in_shape, window):
        # the JAX unit fills both tables uniform in +-0.02
        return {n: rng.uniform(-0.02, 0.02, s).astype(numpy.float32)
                for n, s in self.param_shapes(in_shape, window).items()}

    @property
    def window(self):
        """Rows of the positional table (the serving length bound)."""
        pos = self.params.get("positions")
        return int(pos.shape[0]) if pos is not None else None

    def _lookup(self, x):
        return self.cast("weights")[x.long()]

    def export_config(self):
        return {"vocab": self.vocab, "dim": self.dim,
                "learned_positions": self.learned_positions}

    def apply(self, x):
        y = self._lookup(x)
        if self.learned_positions:
            y = y + self.cast("positions")[None, :y.shape[1], :]
        return y

    def apply_chunk(self, x, offset):
        """Chunked-prefill lookup: x [batch, C] at positions
        [offset, offset+C); rows past the positional table read the
        (masked-off) last row."""
        y = self._lookup(x)
        if self.learned_positions:
            pos = self.cast("positions")
            idx = torch.clamp(
                torch.arange(x.shape[1], device=x.device) + int(offset),
                max=pos.shape[0] - 1)
            y = y + pos[idx][None]
        return y

    def apply_step(self, x, pos):
        """Single-position decode (``models/generate.py``): x [batch, 1]
        at sequence index ``pos`` (an int)."""
        y = self._lookup(x)
        if self.learned_positions:
            y = y + self.cast("positions")[int(pos)][None, None, :]
        return y

    def apply_step_slots(self, x, pos):
        """Per-slot decode step: x [batch, 1] with row n at sequence
        index ``pos[n]``."""
        y = self._lookup(x)
        if self.learned_positions:
            y = y + self.cast("positions")[pos.long()][:, None, :]
        return y

    def apply_verify_slots(self, x, pos):
        """Speculative-verify lookup: x [batch, K1] with row n's position
        j at sequence index ``pos[n] + j``; positions past the
        positional table read its (masked-off) last row, as
        :meth:`apply_chunk` does."""
        y = self._lookup(x)
        if self.learned_positions:
            table = self.cast("positions")
            idx = torch.clamp(
                pos.long()[:, None]
                + torch.arange(x.shape[1], device=x.device)[None, :],
                0, table.shape[0] - 1)
            y = y + table[idx]
        return y
