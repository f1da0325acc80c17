"""FullBatchLoader — the whole dataset resident on the device (the port
of ``veles_tpu/loader/fullbatch.py``).

The trainer gathers each minibatch from ``dataset_dev`` by the span's
indices itself (``GradientDescent.run_span``), so the dataset crosses
to the card once."""

import numpy
import torch

from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.loader.base import Loader


class FullBatchLoader(Loader):
    """``data`` [total, ...] (numpy) with ``labels`` (one int per sample,
    or None) in ``class_lengths`` = [test, validation, train] order."""

    def __init__(self, data, labels=None, class_lengths=None,
                 minibatch_size=100, seed=None, device=None):
        data = numpy.asarray(data)
        if class_lengths is None:
            class_lengths = [0, 0, len(data)]
        if sum(class_lengths) != len(data):
            raise ValueError("class_lengths %s do not add up to %d samples"
                             % (list(class_lengths), len(data)))
        super().__init__(class_lengths, minibatch_size, seed)
        self.device = resolve_device(device)
        self.dataset_dev = torch.as_tensor(data).to(self.device)
        labels = numpy.zeros(len(data), numpy.int32) if labels is None \
            else numpy.asarray(labels, numpy.int32)
        self.labels_dev = torch.as_tensor(labels).to(self.device)
