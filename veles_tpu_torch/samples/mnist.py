"""MNIST fully-connected workflow — the port of
``veles_tpu/samples/mnist.py`` (BASELINE config 1: the znicz
MnistWorkflow 784→100→10, SGD).  The command line runs it through
:func:`run` from ``root.mnist_tpu`` (``mnist_config.py`` is the
reference's config file); built directly, its keyword arguments are the
same keys with the reference's defaults.

    python -m veles_tpu_torch veles_tpu_torch/samples/mnist.py \
        veles_tpu_torch/samples/mnist_config.py

    wf = MnistWorkflow(synthetic_train=512, synthetic_valid=128,
                       max_epochs=2, dtype="float32")
    wf.initialize(device="cpu"); wf.run()

The data is one of the reference's deterministic synthetic stand-ins:
``synthetic_kind="blobs"`` (Gaussian class blobs) or ``"glyphs"``
(rendered stroke digits, ``datasets/glyphs.py``).  ``augment`` (e.g.
``{"kind": "image", "pad": 2, "shape": (28, 28, 1)}``: the minibatches
are flat) goes to the trainer.
"""

import numpy

from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.models.standard import StandardWorkflow


class MnistLoader(FullBatchLoader):
    """The synthetic stand-ins: "blobs", Gaussian class blobs from
    ``default_rng(1234)``, or "glyphs", ``render_digits(n, seed=1234)``
    (the reference's quality stand-in)."""

    def __init__(self, workflow, synthetic_train=8192, synthetic_valid=1024,
                 synthetic_kind="blobs", **kwargs):
        if synthetic_kind not in ("blobs", "glyphs"):
            raise ValueError("synthetic_kind must be 'blobs' or 'glyphs', "
                             "not %r" % (synthetic_kind,))
        super(MnistLoader, self).__init__(workflow, **kwargs)
        self.synthetic_train = int(synthetic_train)
        self.synthetic_valid = int(synthetic_valid)
        self.synthetic_kind = synthetic_kind

    def load_data(self):
        n_train, n_valid = self.synthetic_train, self.synthetic_valid
        if self.synthetic_kind == "glyphs":
            from veles_tpu_torch.datasets import render_digits
            imgs, tl_all = render_digits(n_train + n_valid, seed=1234)
            data = imgs.reshape(len(imgs), 784) * 255.0
        else:
            rng = numpy.random.default_rng(1234)
            centers = rng.normal(scale=2.0, size=(10, 784))
            tl_all = rng.integers(0, 10, n_train + n_valid)
            data = centers[tl_all] + rng.normal(
                size=(n_train + n_valid, 784))
            data = numpy.clip((data - data.min()) /
                              (data.max() - data.min()) * 255, 0, 255)
        train, valid = data[:n_train], data[n_train:]
        train_l, valid_l = tl_all[:n_train], tl_all[n_train:]
        self.class_lengths[:] = [0, len(valid), len(train)]
        self.original_data = numpy.concatenate(
            [valid, train]).astype(numpy.float32) / 255.0
        self.original_labels = numpy.concatenate(
            [valid_l, train_l]).tolist()


class MnistWorkflow(StandardWorkflow):
    """An MLP of ``layers`` widths (tanh hidden layers, softmax head) on
    the StandardWorkflow graph."""

    def __init__(self, workflow=None, layers=(100, 10), minibatch_size=128,
                 normalization="none", solver="sgd", learning_rate=0.1,
                 gradient_moment=0.9, weights_decay=0.0,
                 lr_schedule="constant", lr_schedule_params=None,
                 fail_iterations=25, max_epochs=None,
                 snapshot_prefix="mnist", snapshot_compression="gz",
                 snapshot_time_interval=5.0, synthetic_train=8192,
                 synthetic_valid=1024, synthetic_kind="blobs", augment=None,
                 decision_config=None,
                 snapshotter_config=None, **kwargs):
        spec = [{"type": "all2all_tanh", "output_sample_shape": (int(w),)}
                for w in layers[:-1]]
        spec.append({"type": "softmax",
                     "output_sample_shape": (int(layers[-1]),)})
        super(MnistWorkflow, self).__init__(
            workflow, name="MNIST", loader_factory=MnistLoader,
            loader_config={
                "minibatch_size": int(minibatch_size),
                "normalization_type": normalization,
                "synthetic_train": synthetic_train,
                "synthetic_valid": synthetic_valid,
                "synthetic_kind": synthetic_kind},
            layers=spec, solver=solver, learning_rate=float(learning_rate),
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

    @classmethod
    def jax_kwargs(cls, rec):
        """The layer widths of a JAX MNIST record's chain, and the
        stand-in's kind from ``root.mnist_tpu`` (as the JAX loader read
        it)."""
        from veles_tpu_torch.config import root
        return {"layers": [int(numpy.prod(u.get("output_sample_shape")))
                           for u in rec.get("forwards")],
                "synthetic_kind": root.mnist_tpu.get("synthetic_kind",
                                                     "blobs")}


def run(load, main):
    """The command line's entry: the workflow from ``root.mnist_tpu``."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import config_kwargs
    load(MnistWorkflow, **config_kwargs(MnistWorkflow, root.mnist_tpu))
    main()
