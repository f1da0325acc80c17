"""FullBatchLoader — the whole dataset resident on the device (the port
of ``veles_tpu/loader/fullbatch.py``).

On the span path the trainer gathers each minibatch from
``dataset_dev`` by the span's indices itself
(``GradientDescent.run_span``), so the dataset crosses to the card once —
or never, when it is a tensor that already lies there (a dataset
synthesized on the card).  On the per-minibatch path the loader gathers
the minibatch on the device into ``minibatch_data`` (rows past the
minibatch's size zeroed, as the reference's gather does) and its labels
on the host.

Two constructors, as :class:`~veles_tpu_torch.loader.base.Loader`'s:
the unit's, ``FullBatchLoader(workflow, minibatch_size=..., ...)``,
whose subclass's :meth:`load_data` fills ``original_data`` (numpy
[total, ...] or a tensor), ``original_labels`` (one label per sample, or
None), ``class_lengths`` and, for :class:`FullBatchLoaderMSE`,
``original_targets``; and the span server's, ``FullBatchLoader(data,
labels=None, class_lengths=None, minibatch_size=100, seed=None,
device=None, targets=None, force_numpy=False)``, initialized at once
on ``device``.  A snapshot leaves the dataset out (ref: fullbatch.py):
``initialize()`` loads it again.

With ``force_numpy``, or with a dataset over
:attr:`FullBatchLoader.DEVICE_MEMORY_FRACTION` of the card's memory, the
dataset stays on the host (ref: fullbatch.py:131-140): each minibatch is
gathered there and only the minibatch is uploaded, bit-equal to the
device gather, and the span path is off (the trainer steps per
minibatch).
"""

import numpy
import torch

from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.loader.base import (
    INDEX_DTYPE, LABEL_DTYPE, TRAIN, VALID, Loader, unit_form)
from veles_tpu_torch.memory import Array
from veles_tpu_torch.normalization import NoneNormalizer


class FullBatchLoader(Loader):
    """Device-resident dataset loader (ref: loader/fullbatch.py:79).
    Labels are served as class indices through ``labels_mapping``: the
    train span's distinct labels in sorted order, a label the train span
    lacks mapping to -1.  ``targets`` are regression targets
    (``targets_dev``, read by ``EvaluatorMSE``'s trainer)."""

    hide_from_registry = True
    supports_span = True

    #: the share of the card's memory the dataset may take before it
    #: stays on the host (ref: fullbatch.py:33)
    DEVICE_MEMORY_FRACTION = 0.8

    def __init__(self, workflow=None, labels=None, class_lengths=None,
                 minibatch_size=100, seed=None, device=None, targets=None,
                 force_numpy=False, **kwargs):
        given = None
        if not unit_form(workflow):
            data = workflow
            if not torch.is_tensor(data):
                data = numpy.asarray(data)
            if class_lengths is None:
                class_lengths = [0, 0, len(data)]
            if sum(class_lengths) != len(data):
                raise ValueError(
                    "class_lengths %s do not add up to %d samples"
                    % (list(class_lengths), len(data)))
            given = (data, labels, list(class_lengths), targets)
            workflow = None
        super(FullBatchLoader, self).__init__(
            workflow, minibatch_size=minibatch_size, seed=seed, **kwargs)
        self.original_data = None
        self.original_labels = None
        self.original_targets = None
        #: keep the dataset on the host and gather minibatches there
        self.force_numpy = bool(force_numpy)
        self.device = None
        self.minibatch_targets = Array()
        if given is not None:
            self.given_data_ = given
            self.initialize(device=device)

    def init_unpickled(self):
        super(FullBatchLoader, self).init_unpickled()
        self.given_data_ = None
        self._dataset_dev_ = None
        self._labels_dev_ = None
        self._targets_dev_ = None
        self._numeric_labels_ = None
        #: the host-resident dataset (and targets) the minibatches are
        #: gathered from when the dataset is not on the device
        self._host_data_ = None
        self._host_targets_ = None

    @property
    def span_capable(self):
        # the trainer gathers targets from the device-resident labels (or
        # MSE targets), so one of them is required
        return super(FullBatchLoader, self).span_capable \
            and self._dataset_dev_ is not None \
            and (self._labels_dev_ is not None
                 or self._targets_dev_ is not None)

    @property
    def dataset_dev(self):
        """The device-resident dataset (the trainer gathers from it)."""
        return self._dataset_dev_

    @property
    def labels_dev(self):
        return self._labels_dev_

    @property
    def targets_dev(self):
        return self._targets_dev_

    # -- ILoader --------------------------------------------------------------

    def load_data(self):
        """The span server's data, as given to the constructor; unit-form
        subclasses override this."""
        if self.given_data_ is None:
            raise NotImplementedError(
                "%s must implement load_data()" % type(self).__name__)
        data, labels, lengths, targets = self.given_data_
        self.class_lengths[:] = lengths
        self.original_data = data
        self.original_targets = targets
        if labels is None:
            # the span server serves class 0 for unlabelled samples
            self.original_labels = None
            self._numeric_labels_ = numpy.zeros(len(data), LABEL_DTYPE)
        else:
            self.original_labels = numpy.asarray(labels).tolist()

    def create_minibatch_data(self):
        d = self.original_data
        dt = numpy.float32 if torch.is_tensor(d) \
            and d.dtype == torch.bfloat16 else (
                torch.zeros((), dtype=d.dtype).numpy().dtype
                if torch.is_tensor(d) else d.dtype)
        shape = (self.max_minibatch_size,) + tuple(d.shape[1:])
        self.minibatch_data.reset(numpy.zeros(shape, dt))
        if self.original_targets is not None:
            t = numpy.asarray(self.original_targets) \
                if not torch.is_tensor(self.original_targets) \
                else self.original_targets
            tshape = (self.max_minibatch_size,) + tuple(t.shape[1:])
            self.minibatch_targets.reset(numpy.zeros(tshape, numpy.float32))

    def iterate_train(self):
        lo = self.class_end_offsets[VALID]
        hi = self.class_end_offsets[TRAIN]
        step = max(1, self.max_minibatch_size)
        for start in range(lo, hi, step):
            stop = min(start + step, hi)
            labels = None
            if self.original_labels is not None:
                labels = list(self.original_labels[start:stop])
            yield self.original_data[start:stop], labels

    # -- lifecycle ------------------------------------------------------------

    def initialize(self, device=None, **kwargs):
        self.device = resolve_device(device)
        super(FullBatchLoader, self).initialize(device=self.device,
                                                **kwargs)
        self._post_load()

    def _post_load(self):
        # normalize the whole dataset once, as the reference does; a
        # dataset given as a tensor round-trips through the host unless
        # the normalizer is the identity
        data = self.original_data
        if not isinstance(self.normalizer, NoneNormalizer) \
                and self.normalizer.is_initialized:
            if torch.is_tensor(data):
                data = data.detach().cpu().numpy()
            self.original_data = numpy.ascontiguousarray(
                self.normalizer.normalize(data))
        if self.original_labels is not None:
            if self.labels_mapping:
                self._numeric_labels_ = numpy.array(
                    [self.labels_mapping.get(l, -1)
                     for l in self.original_labels], LABEL_DTYPE)
            else:
                self._numeric_labels_ = numpy.asarray(
                    self.original_labels, LABEL_DTYPE)
        self._maybe_upload()

    def device_budget(self):
        """The card's total memory in bytes (``torch.cuda.mem_get_info``),
        or None on the CPU, which has no budget to keep to."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.mem_get_info(self.device)[1]

    def _maybe_upload(self):
        """Upload the dataset, unless ``force_numpy`` is set or it would
        take more than DEVICE_MEMORY_FRACTION of the card's memory: then
        it stays on the host and :meth:`fill_minibatch` gathers there."""
        self._dataset_dev_ = self._labels_dev_ = self._targets_dev_ = None
        self._host_data_ = self._host_targets_ = None
        data = self.original_data
        host = self.force_numpy
        if not host:
            nbytes = data.numel() * data.element_size() \
                if torch.is_tensor(data) else numpy.asarray(data).nbytes
            budget = self.device_budget()
            if budget and nbytes > self.DEVICE_MEMORY_FRACTION * budget:
                self.warning(
                    "dataset (%.1f MiB) exceeds device budget — host "
                    "gather", nbytes / 2**20)
                host = True
        if host:
            self._host_data_ = torch.as_tensor(data).cpu()
            if self.original_targets is not None:
                self._host_targets_ = torch.as_tensor(
                    self.original_targets).cpu()
            return
        self._dataset_dev_ = torch.as_tensor(self.original_data).to(
            self.device)
        if self._numeric_labels_ is not None:
            self._labels_dev_ = torch.as_tensor(
                self._numeric_labels_).to(self.device)
        if self.original_targets is not None:
            self._targets_dev_ = torch.as_tensor(
                self.original_targets).to(self.device)

    # -- serving --------------------------------------------------------------

    def _gather(self, ds, idx, size):
        """Rows ``idx`` of ``ds`` (indices past the dataset clamp, as the
        reference's gather clips) with the rows from ``size`` on
        zeroed."""
        full = numpy.zeros(self.max_minibatch_size, INDEX_DTYPE)
        full[:size] = idx
        rows = ds[torch.as_tensor(full, device=ds.device).long()]
        mask = torch.arange(rows.shape[0], device=ds.device) < size
        return torch.where(mask.reshape((-1,) + (1,) * (rows.dim() - 1)),
                           rows, torch.zeros((), dtype=rows.dtype,
                                             device=ds.device))

    def fill_minibatch(self):
        size = self.minibatch_size
        idx = self.minibatch_indices.mem[:size]
        if self._dataset_dev_ is not None:
            self.minibatch_data.devmem = self._gather(self._dataset_dev_,
                                                      idx, size)
        else:
            # host gather: only the minibatch crosses to the device
            self.minibatch_data.devmem = self._gather(
                self._host_data_, idx, size).to(self.device)
        if self._numeric_labels_ is not None:
            self.minibatch_labels.mem[:size] = self._numeric_labels_[idx]
        if self._targets_dev_ is not None:
            self.minibatch_targets.devmem = self._gather(
                self._targets_dev_, idx, size)
        elif self._host_targets_ is not None:
            self.minibatch_targets.devmem = self._gather(
                self._host_targets_, idx, size).to(self.device)

    def _normalize_minibatch(self):
        pass  # already normalized at load

    def _map_minibatch_labels(self):
        pass  # numeric labels gathered directly

    def _pad_tail(self, size):
        # data rows already zeroed by the gather
        self.minibatch_labels.mem[size:] = -1
        self.minibatch_indices.mem[size:] = -1

    def __getstate__(self):
        state = super(FullBatchLoader, self).__getstate__()
        # the dataset is reloadable via load_data(); keep snapshots small
        # (ref: fullbatch.py)
        for key in ("original_data", "original_labels", "original_targets"):
            state.pop(key, None)
        return state

    def __setstate__(self, state):
        super(FullBatchLoader, self).__setstate__(state)
        self.original_data = None
        self.original_labels = None
        self.original_targets = None


class FullBatchLoaderMSE(FullBatchLoader):
    """A loader of regression targets (ref: fullbatch.py MSE variants):
    ``load_data`` also fills ``original_targets`` [total, ...], gathered
    into ``minibatch_targets`` (and ``targets_dev`` for spans)."""

    hide_from_registry = True

    def create_minibatch_data(self):
        if self.original_targets is None:
            raise ValueError("%s: load_data() must fill original_targets"
                             % self)
        super(FullBatchLoaderMSE, self).create_minibatch_data()
