"""CIFAR-10 convolutional workflow — the port of
``veles_tpu/samples/cifar.py`` (BASELINE config 2: caffe's
cifar10_quick shape, conv5x5x32 → maxpool3/2 → conv5x5x32 → avgpool3/2
→ conv5x5x64 → avgpool3/2 → fc64 → softmax10, NHWC).  Its keyword
arguments are the reference's ``root.cifar_tpu`` keys with their
defaults.

    wf = CifarWorkflow(synthetic_train=256, synthetic_valid=64,
                       max_epochs=2, dtype="float32")
    wf.initialize(device="cpu"); wf.run()

The data is one of the reference's deterministic synthetic stand-ins:
``synthetic_kind="blobs"`` (class-dependent colour blobs) or
``"scenes"`` (rendered shape classes, ``datasets/scenes.py``, at
``synthetic_size`` pixels a side).  ``augment`` (e.g. ``{"kind":
"image", "pad": 4}``) goes to the trainer.
"""

import numpy

from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.models.standard import StandardWorkflow


class CifarLoader(FullBatchLoader):
    """The synthetic stand-ins: "blobs", class-dependent colour blobs
    from ``default_rng(1234)``, or "scenes", ``render_scenes(n,
    seed=1234, size=synthetic_size)`` (the reference's quality
    stand-in)."""

    def __init__(self, workflow, synthetic_train=4096, synthetic_valid=512,
                 synthetic_kind="blobs", synthetic_size=32, **kwargs):
        if synthetic_kind not in ("blobs", "scenes"):
            raise ValueError("synthetic_kind must be 'blobs' or 'scenes', "
                             "not %r" % (synthetic_kind,))
        super(CifarLoader, self).__init__(workflow, **kwargs)
        self.synthetic_train = int(synthetic_train)
        self.synthetic_valid = int(synthetic_valid)
        self.synthetic_kind = synthetic_kind
        self.synthetic_size = int(synthetic_size)

    def load_data(self):
        n_train, n_valid = self.synthetic_train, self.synthetic_valid
        tot = n_train + n_valid
        if self.synthetic_kind == "scenes":
            from veles_tpu_torch.datasets import render_scenes
            data, labels = render_scenes(tot, seed=1234,
                                         size=self.synthetic_size)
            data = data * 255.0
        else:
            rng = numpy.random.default_rng(1234)
            labels = rng.integers(0, 10, tot)
            centers = rng.normal(scale=0.6, size=(10, 1, 1, 3))
            data = numpy.clip(
                centers[labels]
                + rng.normal(scale=0.25, size=(tot, 32, 32, 3)) + 0.5,
                0, 1) * 255
        valid, train = data[:n_valid], data[n_valid:]
        valid_l, train_l = (labels[:n_valid].tolist(),
                            labels[n_valid:].tolist())
        self.class_lengths[:] = [0, len(valid), len(train)]
        self.original_data = numpy.concatenate(
            [valid, train]).astype(numpy.float32) / 255.0
        self.original_labels = list(valid_l) + list(train_l)


def cifar_layers(conv_type="conv_str", fc_type="all2all_str"):
    """caffe's cifar10_quick shapes (caffe's ReLU is znicz's STRICT relu:
    ``conv_relu``/``all2all_relu`` are znicz's softplus)."""
    return [
        {"type": conv_type, "n_kernels": 32, "kx": 5, "ky": 5,
         "padding": 2},
        {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
        {"type": conv_type, "n_kernels": 32, "kx": 5, "ky": 5,
         "padding": 2},
        {"type": "avg_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
        {"type": conv_type, "n_kernels": 64, "kx": 5, "ky": 5,
         "padding": 2},
        {"type": "avg_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
        {"type": fc_type, "output_sample_shape": (64,)},
        {"type": "softmax", "output_sample_shape": (10,)},
    ]


class CifarWorkflow(StandardWorkflow):
    """The caffe-style CIFAR conv net as a StandardWorkflow layers spec,
    ``mean_disp``-normalized as the reference's default."""

    def __init__(self, workflow=None, layers=None, conv_type="conv_str",
                 fc_type="all2all_str", minibatch_size=128,
                 normalization="mean_disp", solver="adam",
                 learning_rate=0.002, gradient_moment=0.9,
                 weights_decay=0.0005, lr_schedule="constant",
                 lr_schedule_params=None, fail_iterations=20,
                 max_epochs=None, snapshot_prefix="cifar",
                 snapshot_compression="gz", snapshot_time_interval=10.0,
                 synthetic_train=4096, synthetic_valid=512,
                 synthetic_kind="blobs", synthetic_size=32, augment=None,
                 decision_config=None,
                 snapshotter_config=None, **kwargs):
        super(CifarWorkflow, self).__init__(
            workflow, name="CIFAR-10", loader_factory=CifarLoader,
            loader_config={
                "minibatch_size": int(minibatch_size),
                "normalization_type": normalization,
                "synthetic_train": synthetic_train,
                "synthetic_valid": synthetic_valid,
                "synthetic_kind": synthetic_kind,
                "synthetic_size": synthetic_size},
            layers=layers or cifar_layers(conv_type, fc_type),
            solver=solver, learning_rate=float(learning_rate),
            gradient_moment=float(gradient_moment),
            weights_decay=float(weights_decay), augment=augment,
            lr_schedule=lr_schedule,
            lr_schedule_params=lr_schedule_params or {},
            decision_config=dict({
                "fail_iterations": int(fail_iterations),
                "max_epochs": max_epochs}, **(decision_config or {})),
            snapshotter_config=dict({
                "prefix": snapshot_prefix,
                "compression": snapshot_compression,
                "time_interval": float(snapshot_time_interval)},
                **(snapshotter_config or {})),
            **kwargs)


def run(load, main):
    """The command line's entry: the workflow from ``root.cifar_tpu``."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import config_kwargs
    load(CifarWorkflow, **config_kwargs(CifarWorkflow, root.cifar_tpu))
    main()
