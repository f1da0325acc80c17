"""FullBatchLoader — the whole dataset resident on the device (the port
of ``veles_tpu/loader/fullbatch.py``).

The trainer gathers each minibatch from ``dataset_dev`` by the span's
indices itself (``GradientDescent.run_span``), so the dataset crosses
to the card once — or never, when it is given as a tensor that already
lies there (a dataset synthesized on the card)."""

import numpy
import torch

from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.loader.base import VALID, Loader


class FullBatchLoader(Loader):
    """``data`` [total, ...] (numpy, or a tensor taken as it lies) with
    ``labels`` (one int per sample, or None) in ``class_lengths`` =
    [test, validation, train] order.  Labels are served as class
    indices through ``labels_mapping``.  ``targets`` [total, ...] are
    regression targets (``targets_dev``, read by ``EvaluatorMSE``'s
    trainer), or None."""

    def __init__(self, data, labels=None, class_lengths=None,
                 minibatch_size=100, seed=None, device=None, targets=None):
        if not torch.is_tensor(data):
            data = numpy.asarray(data)
        if class_lengths is None:
            class_lengths = [0, 0, len(data)]
        if sum(class_lengths) != len(data):
            raise ValueError("class_lengths %s do not add up to %d samples"
                             % (list(class_lengths), len(data)))
        super().__init__(class_lengths, minibatch_size, seed)
        self.device = resolve_device(device)
        self.dataset_dev = torch.as_tensor(data).to(self.device)
        #: original label → class index: the train span's distinct
        #: labels in sorted order (the JAX loader's ``labels_mapping``);
        #: a label the train span lacks maps to -1
        self.labels_mapping = {}
        if labels is None:
            labels = numpy.zeros(len(data), numpy.int32)
        else:
            labels = numpy.asarray(labels).tolist()
            train = set(labels[self.class_end_offsets[VALID]:])
            self.labels_mapping = {l: i for i, l in enumerate(sorted(train))}
            if self.labels_mapping:
                labels = [self.labels_mapping.get(l, -1) for l in labels]
            labels = numpy.asarray(labels, numpy.int32)
        self.labels_dev = torch.as_tensor(labels).to(self.device)
        self.targets_dev = None if targets is None \
            else torch.as_tensor(targets).to(self.device)
