"""Loader — the minibatch schedule (the port of
``veles_tpu/loader/base.py``, standalone span serving only).

Samples come in three classes walked in the order ``[test | validation
| train]`` each epoch; the train span of ``shuffled_indices`` is
permuted at start-up and whenever the walk wraps to a new epoch, by the
loader's ``RandomGenerator`` (PCG64 — the JAX package's shuffle order
for the same seed).  :meth:`Loader.serve_span` publishes one whole
class span as an index schedule (``span_indices_`` [K, mb], padded with
-1, and ``span_sizes_`` [K]) for the trainer to consume, and advances
the epoch bookkeeping (``epoch_number``, ``train_ended``).  (No
workflow gates or flags, normalization, prefetch or distributed
serving: the LM path needs none.)
"""

import numpy

from veles_tpu_torch.prng import RandomGenerator

TEST, VALID, TRAIN = 0, 1, 2

INDEX_DTYPE = numpy.int32


class Loader:
    """Span server over ``class_lengths`` samples."""

    def __init__(self, class_lengths, minibatch_size=100, seed=None):
        self.class_lengths = [int(n) for n in class_lengths]
        if len(self.class_lengths) != 3 or sum(self.class_lengths) == 0:
            raise ValueError("class_lengths must be [test, validation, "
                             "train] with some samples")
        self.max_minibatch_size = int(minibatch_size)
        #: the loader's stream ("loader", seed 42 unless given)
        self.prng = RandomGenerator("loader", seed)
        self.class_end_offsets = list(numpy.cumsum(self.class_lengths))
        self.global_offset = 0
        self.epoch_number = 0
        self.samples_served = 0
        self.train_ended = False
        self.span_indices_ = None
        self.span_sizes_ = None
        self.span_class_ = None
        self.shuffled_indices = numpy.arange(self.total_samples,
                                             dtype=INDEX_DTYPE)
        self.shuffle()

    @property
    def total_samples(self):
        return sum(self.class_lengths)

    def shuffle(self):
        """Permute the train span of ``shuffled_indices``."""
        if self.class_lengths[TRAIN] == 0:
            return
        self.prng.shuffle(self.shuffled_indices[self.class_end_offsets[VALID]:])

    def _class_by_offset(self, offset):
        for ci, end in enumerate(self.class_end_offsets):
            if offset < end:
                return ci
        raise AssertionError("offset %d beyond the dataset" % offset)

    def serve_span(self):
        """Serve every remaining minibatch of the current class span:
        publish ``span_indices_`` [K, mb] (-1 past the span's end),
        ``span_sizes_`` [K] and ``span_class_``, and advance to the
        span's end (wrapping and reshuffling at an epoch's end)."""
        if self.global_offset >= self.total_samples:
            self.global_offset = 0
            self.shuffle()
        ci = self._class_by_offset(self.global_offset)
        start, end = self.global_offset, self.class_end_offsets[ci]
        span = end - start
        mb = self.max_minibatch_size
        k = -(-span // mb)
        idx = numpy.full((k * mb,), -1, INDEX_DTYPE)
        idx[:span] = self.shuffled_indices[start:end]
        self.span_indices_ = idx.reshape(k, mb)
        sizes = numpy.full((k,), mb, INDEX_DTYPE)
        sizes[-1] = span - (k - 1) * mb
        self.span_sizes_ = sizes
        self.span_class_ = ci
        self.global_offset = end
        self.train_ended = end >= self.total_samples
        self.samples_served += span
        self.epoch_number = self.samples_served // self.total_samples
        return self.span_indices_, self.span_sizes_, ci
