"""Datasets from pickle files (the port of
``veles_tpu/loader/pickles.py``).

Each of the three classes (test/validation/train) is an optional pickle
file (gzip-compressed when its name ends in ``.gz``) holding an ndarray
[n, ...], a ``(data, labels)`` pair or a ``{"data", "labels"}`` dict.
"""

import gzip
import pickle

import numpy

from veles_tpu_torch.loader.base import TEST, TRAIN, VALID
from veles_tpu_torch.loader.fullbatch import FullBatchLoader


def _load_pickle(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return pickle.load(f)


def _split(obj):
    if isinstance(obj, dict):
        return numpy.asarray(obj["data"]), obj.get("labels")
    if isinstance(obj, (tuple, list)) and len(obj) == 2:
        return numpy.asarray(obj[0]), obj[1]
    return numpy.asarray(obj), None


class PicklesLoader(FullBatchLoader):
    """test/validation/train pickles → device-resident dataset
    (ref: loader/pickles.py:55)."""

    def __init__(self, workflow=None, test_path=None, validation_path=None,
                 train_path=None, **kwargs):
        super(PicklesLoader, self).__init__(workflow, **kwargs)
        self.paths = {TEST: test_path, VALID: validation_path,
                      TRAIN: train_path}

    def load_data(self):
        datas, labels = [], []
        for ci in (TEST, VALID, TRAIN):
            path = self.paths[ci]
            if not path:
                self.class_lengths[ci] = 0
                continue
            data, lbls = _split(_load_pickle(path))
            self.class_lengths[ci] = len(data)
            datas.append(data)
            labels.append(list(lbls) if lbls is not None
                          else [None] * len(data))
        if not datas:
            raise ValueError("no pickle paths given")
        self.original_data = numpy.concatenate(datas, axis=0)
        flat = [l for ls in labels for l in ls]
        self.original_labels = None \
            if all(l is None for l in flat) else flat
