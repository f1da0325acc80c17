"""Minibatch stream save and replay (the port of
``veles_tpu/loader/saver.py``).

``MinibatchesSaver`` is a unit placed after a loader that appends every
served minibatch to a gzip pickle stream; ``MinibatchesLoader`` replays
such a file as a Loader (to freeze an augmented or shuffled stream, or
to feed workers without the original dataset).  The stream's format is
the JAX package's, so either package reads the other's files.
"""

import gzip
import pickle

import numpy

from veles_tpu_torch.loader.base import TRAIN, Loader
from veles_tpu_torch.units import Unit


class MinibatchesSaver(Unit):
    """Appends (class, size, data, labels) per run
    (ref: loader/saver.py:69)."""

    VIEW_GROUP = "SERVICE"

    def __init__(self, workflow=None, path="minibatches.pickle.gz",
                 **kwargs):
        super(MinibatchesSaver, self).__init__(workflow, **kwargs)
        self.path = path
        self.loader = None
        self.demand("loader")

    def init_unpickled(self):
        super(MinibatchesSaver, self).init_unpickled()
        self._file_ = None

    def initialize(self, **kwargs):
        super(MinibatchesSaver, self).initialize(**kwargs)
        self._file_ = gzip.open(self.path, "wb")
        pickle.dump(
            {"max_minibatch_size": self.loader.max_minibatch_size,
             "data_shape": tuple(self.loader.minibatch_data.shape[1:]),
             "data_dtype": str(self.loader.minibatch_data.dtype)},
            self._file_)

    def run(self):
        l = self.loader
        l.minibatch_data.map_read()
        l.minibatch_labels.map_read()
        pickle.dump(
            (l.minibatch_class, l.minibatch_size,
             numpy.array(l.minibatch_data.mem[:l.minibatch_size]),
             numpy.array(l.minibatch_labels.mem[:l.minibatch_size])),
            self._file_)

    def stop(self):
        if self._file_ is not None:
            self._file_.close()
            self._file_ = None


class MinibatchesLoader(Loader):
    """Replays a saved minibatch stream (ref: loader/saver.py:182).

    The stream is read fully at initialize (it was minibatch-sized to fit
    memory budgets) and served as a regular class-partitioned dataset.
    """

    def __init__(self, workflow=None, path="minibatches.pickle.gz",
                 **kwargs):
        super(MinibatchesLoader, self).__init__(workflow, **kwargs)
        self.path = path

    def load_data(self):
        chunks = {0: [], 1: [], 2: []}
        labels = {0: [], 1: [], 2: []}
        with gzip.open(self.path, "rb") as f:
            header = pickle.load(f)
            self.max_minibatch_size = header["max_minibatch_size"]
            want_shape = tuple(header["data_shape"])
            want_dtype = header["data_dtype"]
            while True:
                try:
                    ci, size, data, lbls = pickle.load(f)
                except EOFError:
                    break
                if tuple(data.shape[1:]) != want_shape \
                        or str(data.dtype) != want_dtype:
                    raise ValueError(
                        "corrupt minibatch stream %s: chunk %s/%s vs "
                        "header %s/%s" % (self.path, data.shape[1:],
                                          data.dtype, want_shape,
                                          want_dtype))
                chunks[ci].append(data[:size])
                labels[ci].append(lbls[:size])
        datas, lbl_list = [], []
        for ci in (0, 1, 2):
            if chunks[ci]:
                arr = numpy.concatenate(chunks[ci], axis=0)
                self.class_lengths[ci] = len(arr)
                datas.append(arr)
                lbl_list.extend(numpy.concatenate(labels[ci]).tolist())
            else:
                self.class_lengths[ci] = 0
        self._data = numpy.concatenate(datas, axis=0)
        self._labels = numpy.asarray(lbl_list, numpy.int32)

    def create_minibatch_data(self):
        shape = (self.max_minibatch_size,) + self._data.shape[1:]
        self.minibatch_data.reset(numpy.zeros(shape, self._data.dtype))

    def fill_minibatch(self):
        size = self.minibatch_size
        idx = self.minibatch_indices.mem[:size]
        self.minibatch_data.mem[:size] = self._data[idx]
        self.minibatch_labels.mem[:size] = self._labels[idx]

    def iterate_train(self):
        lo = self.class_end_offsets[1]
        hi = self.class_end_offsets[TRAIN]
        yield self._data[lo:hi], None
