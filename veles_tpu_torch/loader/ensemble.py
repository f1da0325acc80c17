"""Ensemble (stacking) loader — the port of
``veles_tpu/loader/ensemble.py``: the meta-model's dataset is the
concatenated outputs of a trained ensemble's instances over a base
dataset.

Each instance's snapshot (from the ensemble summary JSON; the port's
own, or one the JAX package wrote, read through
:mod:`veles_tpu_torch.jax_snapshot`) is loaded and its forward chain
run over the base loader's samples in chunks of ``batch`` on the
loader's device; the features stay there as the loader's dataset.
"""

import json

import numpy
import torch

from veles_tpu_torch.loader.fullbatch import FullBatchLoader


class EnsembleLoader(FullBatchLoader):
    """``features[i] = concat(model_k.forward(sample_i) for k)`` over
    the ensemble's instances; the labels are the base loader's."""

    def __init__(self, workflow=None, summary_path=None, base_loader=None,
                 batch=256, **kwargs):
        super(EnsembleLoader, self).__init__(workflow, **kwargs)
        if summary_path is None or base_loader is None:
            raise ValueError("summary_path and base_loader are required")
        self.summary_path = summary_path
        #: an (uninitialized) loader supplying the underlying dataset
        self.base_loader = base_loader
        self.batch = batch

    def _forward_outputs(self, workflow, data):
        """A snapshot workflow's forward chain over ``data`` (host
        numpy) in chunks of ``batch``, f32 on the loader's device."""
        chain = workflow.forwards
        for u in chain:
            u.to_device(self.device)
        outs = []
        with torch.no_grad():
            for start in range(0, len(data), self.batch):
                h = torch.as_tensor(data[start:start + self.batch],
                                    device=self.device)
                for u in chain:
                    h = u.apply(h)
                outs.append(h.float())
        return torch.cat(outs)

    def load_data(self):
        from veles_tpu_torch.snapshotter import SnapshotterToFile
        with open(self.summary_path) as f:
            summary = json.load(f)
        base = self.base_loader
        base.load_data()
        data = numpy.asarray(base.original_data, numpy.float32)
        features = []
        for inst in summary["instances"]:
            snap = inst.get("snapshot")
            if not snap:
                continue
            wf = SnapshotterToFile.import_file(snap)
            features.append(self._forward_outputs(wf, data))
        if not features:
            raise ValueError("no usable snapshots in %s"
                             % self.summary_path)
        self.class_lengths[:] = list(base.class_lengths)
        self.original_data = torch.cat(features, dim=1)
        self.original_labels = base.original_labels
