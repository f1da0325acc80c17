"""Loader — the minibatch-serving unit (the port of
``veles_tpu/loader/base.py``).

Samples come in three classes walked in the order ``[test | validation
| train]`` each epoch; the train span of ``shuffled_indices`` is
permuted at start-up and whenever the walk wraps to a new epoch, by the
loader's ``RandomGenerator`` (PCG64 — the JAX package's shuffle order
for the same seed).  A loader serves in one of two ways per
:meth:`Loader.run`:

- a whole class span (:meth:`Loader.serve_span`, when
  :attr:`Loader.span_capable`): ``span_indices_`` [K, mb] (padded with
  -1) and ``span_sizes_`` [K] for the trainer to consume, the
  bookkeeping advanced to the span's end;
- one minibatch (:meth:`Loader.serve_next_minibatch`): its rows
  gathered into ``minibatch_data``/``minibatch_labels`` (``Array``s),
  the tail minibatch zero-padded to ``max_minibatch_size``.

Either way the gates read the ``last_minibatch``, ``epoch_ended`` and
``train_ended`` Bools, set as the reference sets them (a span's wave
flags what the per-minibatch path's last wave of that span flags).

The per-minibatch path runs through the asynchronous input pipeline
(:mod:`veles_tpu_torch.loader.prefetch`) when the loader's ``prefetch``
depth is above 0: ``prefetch=None`` is ``root.common.loader.prefetch``
(:mod:`veles_tpu_torch.config`; depth :data:`PREFETCH_DEPTH` by default,
as the reference's; the command line's ``--prefetch`` sets it), 0/False
pins the synchronous path, an int is the depth.  The pipeline replays
the synchronous path's values exactly and falls back to it under the
reference's conditions (:meth:`Loader._ensure_prefetch`); span serving
bypasses it.

Two constructors: the unit's, ``Loader(workflow, minibatch_size=...,
...)`` with the data discovered by :meth:`Loader.load_data` at
``initialize()``, and the span server's, ``Loader(class_lengths,
minibatch_size=100, seed=None)``, ready at once and never in a workflow.
The reference's ``root.common.ensemble_train_ratio`` waits for the
ensembles (item 11).
"""

import time

import numpy

from veles_tpu_torch.distributable import IDistributable
from veles_tpu_torch.memory import Array
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.normalization import StatelessNormalizer, get_normalizer
from veles_tpu_torch.prng import RandomGenerator
from veles_tpu_torch.result_provider import IResultProvider
from veles_tpu_torch.units import Unit

TEST, VALID, TRAIN = 0, 1, 2

#: the prefetch depth of a loader given ``prefetch=None`` (the
#: reference's ``root.common.loader.prefetch`` default)
PREFETCH_DEPTH = 2
CLASS_NAME = ("test", "validation", "train")

INDEX_DTYPE = numpy.int32
LABEL_DTYPE = numpy.int32


def unit_form(first):
    """Whether a constructor's first argument makes it the unit form: a
    workflow (any Unit) or None."""
    return first is None or isinstance(first, Unit)


class ILoader:
    """The subclass contract (ref: base.py:100-120)."""

    def load_data(self):
        """Discover the dataset: set ``class_lengths`` and load/locate
        sample storage."""
        raise NotImplementedError()

    def create_minibatch_data(self):
        """Allocate ``minibatch_data`` (shape [max_minibatch_size, ...])."""
        raise NotImplementedError()

    def fill_minibatch(self):
        """Copy rows ``minibatch_indices[:minibatch_size]`` of the dataset
        into minibatch_data/labels."""
        raise NotImplementedError()


class Loader(Unit, ILoader, IDistributable, IResultProvider):
    """Minibatch server (ref: veles/loader/base.py:120)."""

    hide_from_registry = True
    VIEW_GROUP = "LOADER"
    negotiates_on_connect = True

    #: loaders whose serving cannot be produced ahead of the waves
    #: (queue-fed interactive streams) opt out of the asynchronous
    #: input pipeline here
    prefetchable = True

    def __init__(self, workflow=None, minibatch_size=100, shuffle_limit=None,
                 train_ratio=1.0, normalization_type="none",
                 normalization_parameters=None, seed=None, prefetch=None,
                 **kwargs):
        if not unit_form(workflow):
            # the span server: Loader(class_lengths, minibatch_size, seed)
            lengths = [int(n) for n in workflow]
            if len(lengths) != 3 or sum(lengths) == 0:
                raise ValueError("class_lengths must be [test, validation, "
                                 "train] with some samples")
            workflow = None
        else:
            lengths = None
        super(Loader, self).__init__(workflow, **kwargs)
        self.max_minibatch_size = int(minibatch_size)
        #: the prefetch depth: None is ``root.common.loader.prefetch``,
        #: 0/False pins the synchronous path
        self.prefetch = prefetch
        #: how many times shuffle() may still permute the train span
        #: (None = unlimited; 0 = deterministic order, ref base.py)
        self.shuffle_limit = shuffle_limit
        self.train_ratio = train_ratio
        #: the loader's stream ("loader", seed 42 unless given)
        self.prng = RandomGenerator("loader", seed)

        self.class_lengths = [0, 0, 0]
        self.class_end_offsets = [0, 0, 0]

        self.minibatch_class = TRAIN
        self.minibatch_size = 0
        self.minibatch_offset = 0
        self.minibatch_data = Array()
        self.minibatch_labels = Array()
        self.minibatch_indices = Array()
        self.raw_minibatch_labels = []
        self.labels_mapping = {}

        self.shuffled_indices = Array()
        self.global_offset = 0
        self.epoch_number = 0
        self.samples_served = 0
        self.last_minibatch = Bool(False, "last_minibatch")
        self.epoch_ended = Bool(False, "epoch_ended")
        self.train_ended = Bool(False, "train_ended")
        self.failed_minibatches = []

        self.normalization_type = normalization_type
        self.normalization_parameters = normalization_parameters or {}
        self._normalizer = None
        if lengths is not None:
            self.class_lengths = lengths
            self._calc_class_end_offsets()
            self._init_indices()

    def init_unpickled(self):
        super(Loader, self).init_unpickled()
        #: worker-id -> list of in-flight (offset, size) jobs — volatile,
        #: a restart abandons in-flight bookkeeping (ref: base.py:205)
        self.pending_minibatches_ = {}
        #: span-serving handoff (see :meth:`serve_span`)
        self.span_indices_ = None
        self.span_sizes_ = None
        self.span_class_ = None
        self.span_fresh_ = False
        #: the asynchronous input pipeline: None = undecided (created
        #: on the first per-minibatch run()), False = decided off, else
        #: the live PrefetchPipeline
        self.prefetch_ = None
        self._input_wait_ = None

    # -- derived quantities ---------------------------------------------------

    @property
    def total_samples(self):
        return sum(self.class_lengths)

    @property
    def effective_total_samples(self):
        """train_ratio < 1 trims the train span (ref: base.py:391)."""
        return self.total_samples - int(
            (1.0 - self.train_ratio) * self.class_lengths[TRAIN])

    @property
    def has_labels(self):
        return bool(self.labels_mapping) or any(
            l is not None for l in self.raw_minibatch_labels)

    @property
    def normalizer(self):
        if self._normalizer is None:
            self._normalizer = get_normalizer(
                self.normalization_type, **self.normalization_parameters)
        return self._normalizer

    @property
    def class_ended(self):
        return self.global_offset in self.class_end_offsets \
            or self.global_offset == self.effective_total_samples

    @property
    def sample_shape(self):
        """One sample's shape (no batch axis)."""
        return tuple(self.minibatch_data.shape[1:])

    # -- lifecycle ------------------------------------------------------------

    def initialize(self, **kwargs):
        super(Loader, self).initialize(**kwargs)
        self.load_data()
        if self.total_samples == 0:
            raise ValueError("%s: load_data() produced no samples" % self)
        self._calc_class_end_offsets()
        self.info("samples: test %d, validation %d, train %d",
                  *self.class_lengths)
        self.minibatch_indices.reset(
            numpy.zeros(self.max_minibatch_size, INDEX_DTYPE))
        self.minibatch_labels.reset(
            numpy.zeros(self.max_minibatch_size, LABEL_DTYPE))
        self.raw_minibatch_labels = [None] * self.max_minibatch_size
        self.create_minibatch_data()
        if not self.minibatch_data:
            raise ValueError(
                "%s: create_minibatch_data() must allocate minibatch_data"
                % self)
        self._analyze_dataset()
        if not self.shuffled_indices:
            self._init_indices()
        device = kwargs.get("device")
        if device is not None:
            for arr in (self.minibatch_data, self.minibatch_labels,
                        self.minibatch_indices):
                arr.initialize(device)

    def _init_indices(self):
        self.shuffled_indices.mem = numpy.arange(
            self.total_samples, dtype=INDEX_DTYPE)
        self.shuffle()

    def _calc_class_end_offsets(self):
        total = 0
        for i, n in enumerate(self.class_lengths):
            total += int(n)
            self.class_end_offsets[i] = total

    def _analyze_dataset(self):
        """One pass over the train set accumulating normalizer stats and
        the label mapping (ref: base.py analyze_dataset; the subclass
        exposes train data via iterate_train())."""
        need_stats = not isinstance(self.normalizer, StatelessNormalizer) \
            and not self.normalizer.is_initialized
        need_labels = not self.labels_mapping
        if not (need_stats or need_labels):
            return
        labels = set()
        for data, batch_labels in self.iterate_train():
            if need_stats:
                self.normalizer.analyze(data)
            if need_labels and batch_labels is not None:
                labels.update(batch_labels)
        if need_labels and labels:
            self.labels_mapping = {
                l: i for i, l in enumerate(sorted(labels))}

    def iterate_train(self):
        """Yield (data, labels) batches of the train set for analysis."""
        return iter(())

    # -- shuffling ------------------------------------------------------------

    def shuffle(self):
        """Permute the train span of shuffled_indices
        (ref: base.py:711)."""
        if self.class_lengths[TRAIN] == 0:
            return
        if self.shuffle_limit is not None:
            if self.shuffle_limit <= 0:
                return
            self.shuffle_limit -= 1
        self.shuffled_indices.map_write()
        self.prng.shuffle(
            self.shuffled_indices.mem[self.class_end_offsets[VALID]:])

    # -- serving (ref: base.py:726-910) ---------------------------------------

    #: subclasses that can hand a whole class span to the trainer set
    #: this True (see FullBatchLoader)
    supports_span = False
    #: None = auto (the trainer turns it on when it can consume spans);
    #: builders wiring per-minibatch consumers set it to False
    span_serving = None

    @property
    def span_capable(self):
        """Span serving is a standalone-mode fast path: distributed jobs
        and failed-minibatch refiles stay per-minibatch."""
        return (self.supports_span and bool(self.span_serving)
                and not self.is_master and not self.is_slave
                and not self.failed_minibatches)

    def run(self):
        self.pending_minibatches_.pop(None, None)
        if self.span_capable:
            self.serve_span()
            return
        pipeline = self._ensure_prefetch()
        t0 = time.perf_counter()
        if pipeline is not None:
            pipeline.pop_into(self)
            mode = "prefetch"
        else:
            self.serve_next_minibatch(None)
            self._on_successful_serve()
            mode = "sync"
        self._observe_input_wait(time.perf_counter() - t0, mode)

    # -- the asynchronous input pipeline (loader/prefetch.py) ---------------

    def _prefetch_depth(self):
        """This loader's prefetch depth; <= 0 means the synchronous
        path."""
        if self.prefetch is None:
            from veles_tpu_torch.config import root
            cfg = root.common.loader.prefetch
            return int(cfg.get("depth", PREFETCH_DEPTH)) \
                if cfg.get("enabled", True) else 0
        return int(self.prefetch)

    def _ensure_prefetch(self):
        """Decide (once) and create the prefetch pipeline; None means
        the synchronous path.  It falls back under the reference's
        conditions: depth <= 0, a loader that opted out, distributed
        master/worker serving, refiled minibatches, or more than one
        process (``torch.distributed`` initialized with a world size
        above 1)."""
        if self.prefetch_ is False:
            return None
        if self.prefetch_ is not None:
            return self.prefetch_
        depth = self._prefetch_depth()
        enabled = (depth > 0 and self.prefetchable
                   and self.is_standalone
                   and not self.failed_minibatches)
        if enabled:
            import torch.distributed as dist
            enabled = not (dist.is_available() and dist.is_initialized()
                           and dist.get_world_size() > 1)
        if not enabled:
            self.prefetch_ = False
            return None
        from veles_tpu_torch.loader.prefetch import PrefetchPipeline
        self.prefetch_ = PrefetchPipeline(self, depth)
        self.debug("asynchronous input pipeline on (depth %d)", depth)
        return self.prefetch_

    def stop(self):
        pipeline = self.prefetch_
        if pipeline not in (None, False):
            pipeline.close()
            self.prefetch_ = None
        super(Loader, self).stop()

    def _observe_input_wait(self, dt, mode):
        """veles_input_wait_seconds: how long this wave blocked on input
        before the trainer could start — the decode, normalization and
        upload on the synchronous path, the ready-queue wait on the
        prefetch path."""
        import veles_tpu_torch.telemetry as telemetry
        if not telemetry.enabled():
            return
        if self._input_wait_ is None or self._input_wait_[0] != mode:
            hist = telemetry.metrics.histogram(
                "veles_input_wait_seconds",
                "time the trainer actually blocked on input per "
                "minibatch wave (sync: decode+normalize+upload; "
                "prefetch: ready-queue wait)", ("loader", "mode"))
            self._input_wait_ = (mode, hist.labels(self.name, mode))
        self._input_wait_[1].observe(dt)

    def serve_span(self):
        """Serve every remaining minibatch of the current class span:
        publish ``span_indices_`` [K, mb] (-1 past the span's end),
        ``span_sizes_`` [K] and ``span_class_`` for the trainer, advance
        the host bookkeeping to the span's end (wrapping and reshuffling
        at an epoch's end) and set the flags; returns
        ``(span_indices_, span_sizes_, span_class_)``."""
        if self.global_offset >= self.effective_total_samples:
            self.global_offset = 0
            self.shuffle()
        ci, _ = self._class_by_offset(self.global_offset)
        span_end = self._effective_end_offsets()[ci]
        start = self.global_offset
        span = span_end - start
        mb = self.max_minibatch_size
        k = -(-span // mb)
        self.shuffled_indices.map_read()
        idx = numpy.full((k * mb,), -1, INDEX_DTYPE)
        idx[:span] = self.shuffled_indices.mem[start:span_end]
        self.span_indices_ = idx.reshape(k, mb)
        sizes = numpy.full((k,), mb, INDEX_DTYPE)
        sizes[-1] = span - (k - 1) * mb
        self.span_sizes_ = sizes
        self.span_class_ = ci
        self.span_fresh_ = True

        self.minibatch_class = ci
        self.minibatch_offset = span_end
        self.minibatch_size = int(sizes[-1])
        self.global_offset = span_end
        self.train_ended.set(
            self.global_offset >= self.effective_total_samples)
        self.samples_served += span
        if self.effective_total_samples:
            self.epoch_number = \
                self.samples_served // self.effective_total_samples
        self._update_flags()
        return self.span_indices_, self.span_sizes_, self.span_class_

    def serve_next_minibatch(self, slave_id):
        """Serve one minibatch (ref: base.py:369)."""
        try:
            minibatch_def = self.failed_minibatches.pop()
        except IndexError:
            minibatch_def = self._advance_global_offset()
        offset, size = minibatch_def
        self.pending_minibatches_.setdefault(slave_id, []).append(
            minibatch_def)
        self.minibatch_offset, self.minibatch_size = offset, size

        self.minibatch_data.map_invalidate()
        self.minibatch_labels.map_invalidate()
        self.minibatch_indices.map_invalidate()
        self.shuffled_indices.map_read()
        self.minibatch_indices.mem[:size] = \
            self.shuffled_indices.mem[offset - size:offset]

        if self.is_master:
            return
        self.fill_minibatch()
        self._normalize_minibatch()
        self._map_minibatch_labels()
        if size < self.max_minibatch_size:
            self._pad_tail(size)
        self.minibatch_data.unmap()
        self.minibatch_labels.unmap()
        self.minibatch_indices.unmap()

    def _pad_tail(self, size):
        """Zero-pad the tail minibatch to the full minibatch shape
        (ref: base.py:749-753)."""
        self.minibatch_data.mem[size:] = 0
        self.minibatch_labels.mem[size:] = -1
        self.minibatch_indices.mem[size:] = -1

    def _normalize_minibatch(self):
        size = self.minibatch_size
        self.minibatch_data.mem[:size] = self.normalizer.normalize(
            self.minibatch_data.mem[:size])

    def _map_minibatch_labels(self):
        if not self.labels_mapping:
            return
        for i, l in enumerate(
                self.raw_minibatch_labels[:self.minibatch_size]):
            if l is None:
                continue
            self.minibatch_labels.mem[i] = self.labels_mapping[l]

    def _class_by_offset(self, offset):
        for ci, end in enumerate(self._effective_end_offsets()):
            if offset < end:
                return ci, end - offset
        raise AssertionError("offset %d beyond dataset" % offset)

    def _effective_end_offsets(self):
        ends = list(self.class_end_offsets)
        ends[TRAIN] -= int(
            (1.0 - self.train_ratio) * self.class_lengths[TRAIN])
        return ends

    def _advance_global_offset(self):
        """Pick the next (offset, size); wraps + reshuffles at epoch end
        (ref: base.py:880)."""
        if self.is_slave:
            return self.minibatch_offset, self.minibatch_size
        if self.global_offset >= self.effective_total_samples:
            self.global_offset = 0
            self.shuffle()
        self.minibatch_class, remainder = self._class_by_offset(
            self.global_offset)
        size = min(remainder, self.max_minibatch_size)
        self.global_offset += size
        self.train_ended.set(
            self.global_offset >= self.effective_total_samples)
        return self.global_offset, size

    def _epoch_flag_values(self, minibatch_class, global_offset):
        """The (last_minibatch, epoch_ended) values one serve at
        ``global_offset`` in ``minibatch_class`` produces."""
        class_ended = global_offset in self.class_end_offsets \
            or global_offset == self.effective_total_samples
        # in-flight jobs only gate the flags on the coordinator — in
        # standalone mode the just-served minibatch is still "pending"
        # at this point (ref: base.py:862-878)
        last_mb = (class_ended and not self.failed_minibatches
                   and (not self.is_master
                        or not any(self.pending_minibatches_.values())))
        epoch_ended = last_mb and (
            minibatch_class == VALID or
            (minibatch_class == TEST and
             self.class_lengths[TRAIN] == self.class_lengths[VALID] == 0) or
            (minibatch_class == TRAIN and
             self.class_lengths[VALID] == 0))
        return last_mb, epoch_ended

    def _update_flags(self):
        if self.is_slave:
            return
        last_mb, epoch_ended = self._epoch_flag_values(
            self.minibatch_class, self.global_offset)
        self.last_minibatch.set(last_mb)
        self.epoch_ended.set(epoch_ended)

    def _on_successful_serve(self):
        self.samples_served += self.minibatch_size
        if not self.is_slave and self.effective_total_samples:
            self.epoch_number = \
                self.samples_served // self.effective_total_samples
        self._update_flags()
        jobs = self.pending_minibatches_.get(None)
        if jobs and (self.minibatch_offset, self.minibatch_size) in jobs:
            jobs.remove((self.minibatch_offset, self.minibatch_size))

    # -- distributed contract (ref: base.py:628-687), driven by the
    #    coordinator in the master and worker modes ---------------------------

    def generate_data_for_slave(self, slave=None):
        self.serve_next_minibatch(slave)
        return {
            "indices": numpy.array(
                self.minibatch_indices.mem[:self.minibatch_size]),
            "minibatch_class": self.minibatch_class,
            "minibatch_size": self.minibatch_size,
            "minibatch_offset": self.minibatch_offset,
            "epoch_number": self.epoch_number,
        }

    def apply_data_from_master(self, data):
        for attr in ("minibatch_class", "minibatch_size",
                     "minibatch_offset", "epoch_number"):
            setattr(self, attr, data[attr])
        self.last_minibatch.set(False)
        self.epoch_ended.set(False)
        self.train_ended.set(False)
        indices = data["indices"]
        assert len(indices) == self.minibatch_size
        self.shuffled_indices.map_write()
        self.shuffled_indices.mem[
            self.minibatch_offset - self.minibatch_size:
            self.minibatch_offset] = indices

    def generate_data_for_master(self):
        return True

    def apply_data_from_slave(self, data, slave=None):
        jobs = self.pending_minibatches_.get(slave)
        if jobs:
            self.minibatch_offset, self.minibatch_size = jobs.pop()
            self._on_successful_serve()

    def drop_slave(self, slave=None):
        jobs = self.pending_minibatches_.pop(slave, None)
        if jobs:
            self.failed_minibatches.extend(jobs)
            self.info("requeued %d minibatch(es) from dropped worker %s",
                      len(jobs), slave)

    # -- results --------------------------------------------------------------

    def get_metric_values(self):
        return {"Total epochs": self.epoch_number}
