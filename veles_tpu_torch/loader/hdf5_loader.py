"""HDF5 loaders (the port of ``veles_tpu/loader/hdf5_loader.py``).

One HDF5 file per class (test/validation/train) with ``data`` [n, ...]
and ``labels`` [n] datasets.  :class:`FullBatchHDF5Loader` reads every
file into the device-resident dataset; :class:`HDF5Loader` streams
minibatches from the files (bigger-than-RAM corpora; the prefetch
pipeline reads ahead of the step).  ``h5py`` is optional: it is
imported when a file is opened.
"""

import numpy

from veles_tpu_torch.loader.base import TRAIN, Loader
from veles_tpu_torch.loader.fullbatch import FullBatchLoader


def _require_h5py():
    """The ``h5py`` module (optional: imported when a file is opened)."""
    try:
        import h5py
    except ImportError:
        raise RuntimeError("h5py is unavailable")
    return h5py


class FullBatchHDF5Loader(FullBatchLoader):
    """All class files into memory, then onto the device
    (ref: loader_hdf5.py:48)."""

    def __init__(self, workflow=None, test_path=None, validation_path=None,
                 train_path=None, data_name="data", labels_name="labels",
                 **kwargs):
        super(FullBatchHDF5Loader, self).__init__(workflow, **kwargs)
        self.class_files = [test_path, validation_path, train_path]
        self.data_name = data_name
        self.labels_name = labels_name

    def load_data(self):
        h5py = _require_h5py()
        datas, labels, labelled = [], [], []
        for ci, path in enumerate(self.class_files):
            if not path:
                self.class_lengths[ci] = 0
                continue
            with h5py.File(path, "r") as f:
                d = numpy.asarray(f[self.data_name])
                datas.append(d)
                self.class_lengths[ci] = len(d)
                has = self.labels_name in f
                labelled.append(has)
                if has:
                    labels.extend(numpy.asarray(f[self.labels_name])
                                  .tolist())
        if not datas:
            raise ValueError("%s: no HDF5 files given" % self)
        if labels and not all(labelled):
            # partial labels would silently shift every row's label
            raise ValueError(
                "%s: %r present in some class files but not all"
                % (self, self.labels_name))
        self.original_data = numpy.concatenate(datas).astype(
            numpy.float32)
        if labels:
            self.original_labels = labels


class HDF5Loader(Loader):
    """Streaming variant: minibatches gathered straight from the h5py
    datasets (lazy chunked reads)."""

    def __init__(self, workflow=None, test_path=None, validation_path=None,
                 train_path=None, data_name="data", labels_name="labels",
                 **kwargs):
        super(HDF5Loader, self).__init__(workflow, **kwargs)
        self.class_files = [test_path, validation_path, train_path]
        self.data_name = data_name
        self.labels_name = labels_name

    def init_unpickled(self):
        super(HDF5Loader, self).init_unpickled()
        self._files_ = None
        self._datasets_ = None
        self._labels_ = None
        self._files_owner_ = None

    def _open(self):
        h5py = _require_h5py()
        if self._files_ is not None:
            return
        self._files_, self._datasets_, self._labels_ = [], [], []
        for path in self.class_files:
            if not path:
                self._files_.append(None)
                self._datasets_.append(None)
                self._labels_.append(None)
                continue
            f = h5py.File(path, "r")
            self._files_.append(f)
            self._datasets_.append(f[self.data_name])
            self._labels_.append(f.get(self.labels_name))
        self._files_owner_ = id(self)

    def load_data(self):
        self._open()
        for ci, ds in enumerate(self._datasets_):
            self.class_lengths[ci] = 0 if ds is None else len(ds)

    def create_minibatch_data(self):
        self._open()
        shape = next(ds.shape[1:] for ds in self._datasets_
                     if ds is not None)
        self.minibatch_data.reset(numpy.zeros(
            (self.max_minibatch_size,) + shape, numpy.float32))

    def iterate_train(self):
        self._open()
        ds = self._datasets_[TRAIN]
        if ds is None:
            return
        lab = self._labels_[TRAIN]
        step = max(1, self.max_minibatch_size)
        for start in range(0, len(ds), step):
            stop = min(start + step, len(ds))
            labels = None if lab is None \
                else numpy.asarray(lab[start:stop]).tolist()
            yield numpy.asarray(ds[start:stop]), labels

    def _locate(self, global_idx):
        """global sample index → (class index, local index)."""
        base = 0
        for ci, n in enumerate(self.class_lengths):
            if global_idx < base + n:
                return ci, global_idx - base
            base += n
        raise IndexError(global_idx)

    def fill_minibatch(self):
        self._open()
        for i, gidx in enumerate(
                self.minibatch_indices.mem[:self.minibatch_size]):
            ci, local = self._locate(int(gidx))
            self.minibatch_data.mem[i] = self._datasets_[ci][local]
            lab = self._labels_[ci]
            self.raw_minibatch_labels[i] = \
                None if lab is None else lab[local].item()

    def close_files(self):
        """Close the class files (reopened on the next read).  Only the
        loader that opened them closes them: a prefetch stage shares
        the open files (``loader/prefetch.py``) and, collected, must
        leave them open."""
        if getattr(self, "_files_owner_", None) != id(self):
            return
        files, self._files_ = self._files_, None
        self._datasets_ = self._labels_ = None
        for f in (files or []):
            if f is not None:
                try:
                    f.close()
                except Exception:
                    pass

    def stop(self):
        super(HDF5Loader, self).stop()
        self.close_files()

    def __del__(self):
        self.close_files()
