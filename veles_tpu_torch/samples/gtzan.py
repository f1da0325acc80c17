"""GTZAN genre recognition — the port of ``veles_tpu/samples/gtzan.py``
(BASELINE config 5).

Audio tracks under ``dataset_dir`` (``root.gtzan_tpu.dataset_dir``; the
GTZAN layout ``genres/<genre>/<track>.wav``) flow through the XML
feature pipeline (``gtzan_features.xml``, the reference's copy) of
:class:`~veles_tpu_torch.loader.sound.SoundLoader` into an MLP
classifier.  ``datasets/tones.py`` writes a GTZAN-shaped tree of
synthetic tracks.

    python -m veles_tpu_torch veles_tpu_torch/samples/gtzan.py \\
        -c "root.gtzan_tpu.dataset_dir = '/path/to/genres'"
"""

import os

import numpy

from veles_tpu_torch.loader.sound import SoundLoader
from veles_tpu_torch.models.standard import StandardWorkflow

FEATURES_XML = os.path.join(os.path.dirname(__file__),
                            "gtzan_features.xml")


class GtzanLoader(SoundLoader):
    """The tracks of ``dataset_dir``, with a validation span carved off
    a shuffled order (``default_rng(42)``: the scan is genre-sorted)."""

    def __init__(self, workflow, dataset_dir=None, features_xml=None,
                 max_seconds=30.0, train_ratio=1.0, validation_ratio=0.2,
                 **kwargs):
        if not dataset_dir:
            raise ValueError(
                "set root.gtzan_tpu.dataset_dir to the GTZAN genres/ "
                "directory")
        super(GtzanLoader, self).__init__(
            workflow, features_xml=features_xml or FEATURES_XML,
            train_paths=[dataset_dir], max_seconds=max_seconds,
            train_ratio=float(train_ratio), **kwargs)
        self.validation_ratio = float(validation_ratio)

    def load_data(self):
        super(GtzanLoader, self).load_data()
        n = self.class_lengths[2]
        perm = numpy.random.default_rng(42).permutation(n)
        self.original_data = self.original_data[perm]
        self.original_labels = [self.original_labels[i] for i in perm]
        n_valid = int(n * self.validation_ratio)
        self.class_lengths[:] = [0, n_valid, n - n_valid]


class GtzanWorkflow(StandardWorkflow):
    """The features → tanh(hidden) → softmax(classes) classifier; its
    keyword arguments are ``root.gtzan_tpu``'s keys."""

    def __init__(self, workflow=None, dataset_dir=None, features_xml=None,
                 max_seconds=30.0, train_ratio=1.0, validation_ratio=0.2,
                 classes=10, hidden=100, minibatch_size=50, solver="adam",
                 learning_rate=0.001, fail_iterations=50, max_epochs=None,
                 snapshot_prefix="gtzan", decision_config=None,
                 snapshotter_config=None, **kwargs):
        super(GtzanWorkflow, self).__init__(
            workflow, name="GTZAN", loader_factory=GtzanLoader,
            loader_config={
                "dataset_dir": dataset_dir, "features_xml": features_xml,
                "max_seconds": max_seconds, "train_ratio": train_ratio,
                "validation_ratio": validation_ratio,
                "minibatch_size": int(minibatch_size),
                "normalization_type": "mean_disp"},
            layers=[
                {"type": "all2all_tanh",
                 "output_sample_shape": (int(hidden),)},
                {"type": "softmax", "output_sample_shape": (int(classes),)},
            ],
            solver=solver, learning_rate=float(learning_rate),
            decision_config=dict({
                "fail_iterations": int(fail_iterations),
                "max_epochs": max_epochs}, **(decision_config or {})),
            snapshotter_config=dict({"prefix": snapshot_prefix},
                                    **(snapshotter_config or {})),
            **kwargs)

    @classmethod
    def jax_kwargs(cls, rec):
        """The tracks, features and split of a JAX GTZAN record's loader
        (its train paths, feature file and track length; the validation
        share from ``root.gtzan_tpu``, as the JAX loader read it) and
        the chain's widths."""
        from veles_tpu_torch.config import root
        loader, fwd = rec.get("loader"), rec.get("forwards")
        paths = (loader.get("class_paths") or [[], [], []])[2]
        kw = {"dataset_dir": paths[0] if paths else
              root.gtzan_tpu.get("dataset_dir"),
              "max_seconds": loader.get("max_seconds"),
              "validation_ratio": float(root.gtzan_tpu.get(
                  "validation_ratio", 0.2)),
              "hidden": int(numpy.prod(fwd[0].get("output_sample_shape"))),
              "classes": int(numpy.prod(
                  fwd[-1].get("output_sample_shape")))}
        xml = loader.get("features_xml")
        if xml and os.path.basename(xml) != os.path.basename(FEATURES_XML):
            kw["features_xml"] = xml
        return kw


def run(load, main):
    """The command line's entry: the workflow from ``root.gtzan_tpu``."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import config_kwargs
    load(GtzanWorkflow, **config_kwargs(GtzanWorkflow, root.gtzan_tpu))
    main()
