"""MNIST autoencoder — the port of ``veles_tpu/samples/mnist_ae.py``
(the reference's MnistAE workflow family).

The default topology is the FC autoencoder (784 → tanh(hidden) → 784,
MSE on the input); ``conv=True`` (``root.mnist_ae_tpu.conv``) switches
to the convolutional one: a conv/pool encoder and a depool/deconv
decoder.  The data is MNIST's stand-in (``samples/mnist.py``), whose
keys — ``synthetic_train``, ``synthetic_valid``, ``synthetic_kind`` —
the command line reads from ``root.mnist_tpu``, as the reference does.

    python -m veles_tpu_torch veles_tpu_torch/samples/mnist_ae.py \\
        -c "root.mnist_ae_tpu.conv = True"
"""

import numpy

from veles_tpu_torch.loader.fullbatch import FullBatchLoader, \
    FullBatchLoaderMSE
from veles_tpu_torch.models.standard import StandardWorkflow
from veles_tpu_torch.samples.mnist import MnistLoader


class MnistAELoader(FullBatchLoaderMSE, MnistLoader):
    """MNIST images as both the input and the regression target."""

    def __init__(self, workflow, conv=False, **kwargs):
        super(MnistAELoader, self).__init__(workflow, **kwargs)
        self.conv = bool(conv)

    def load_data(self):
        MnistLoader.load_data(self)
        if self.conv:
            self.original_data = self.original_data.reshape(-1, 28, 28, 1)
        self.original_targets = self.original_data
        self.original_labels = None  # regression: no classes

    def _maybe_upload(self):
        # the target IS the (normalized) input: one device copy serves
        # both, as the reference shares its dataset buffer
        self.original_targets = self.original_data
        FullBatchLoader._maybe_upload(self)
        if self._dataset_dev_ is not None:
            self._targets_dev_ = self._dataset_dev_


def ae_layers(conv=False, hidden=100, normalization="none"):
    """The autoencoder's layer spec: the conv topology, or the FC one
    whose head is tanh under "linear" normalization (the decoder must
    span negatives) and sigmoid otherwise."""
    if conv:
        return [
            {"type": "conv_relu", "n_kernels": 16, "kx": 3, "ky": 3,
             "padding": "same"},
            {"type": "max_pooling", "kx": 2, "ky": 2},
            {"type": "depooling", "kx": 2, "ky": 2},
            {"type": "deconv", "n_kernels": 1, "kx": 3, "ky": 3,
             "padding": "same", "activation": "sigmoid"},
        ]
    out_type = "all2all_tanh" if normalization == "linear" \
        else "all2all_sigmoid"
    return [
        {"type": "all2all_tanh", "output_sample_shape": (int(hidden),)},
        {"type": out_type, "output_sample_shape": (784,)},
    ]


class MnistAEWorkflow(StandardWorkflow):
    """The autoencoder on the StandardWorkflow graph under the MSE
    evaluator; its keyword arguments are ``root.mnist_ae_tpu``'s keys
    (with MNIST's synthetic ones)."""

    def __init__(self, workflow=None, conv=False, hidden=100,
                 normalization="none", minibatch_size=128, solver="adam",
                 learning_rate=0.001, fail_iterations=20, max_epochs=None,
                 snapshot_prefix="mnist_ae", synthetic_train=8192,
                 synthetic_valid=1024, synthetic_kind="blobs",
                 decision_config=None, snapshotter_config=None, **kwargs):
        super(MnistAEWorkflow, self).__init__(
            workflow, name="MnistAE", loader_factory=MnistAELoader,
            loader_config={
                "minibatch_size": int(minibatch_size),
                "normalization_type": normalization,
                "conv": bool(conv),
                "synthetic_train": synthetic_train,
                "synthetic_valid": synthetic_valid,
                "synthetic_kind": synthetic_kind},
            layers=ae_layers(conv, hidden, normalization), loss="mse",
            solver=solver, learning_rate=float(learning_rate),
            decision_config=dict({
                "fail_iterations": int(fail_iterations),
                "max_epochs": max_epochs}, **(decision_config or {})),
            snapshotter_config=dict({"prefix": snapshot_prefix},
                                    **(snapshotter_config or {})),
            **kwargs)

    @classmethod
    def jax_kwargs(cls, rec):
        """The topology of a JAX autoencoder record's chain (conv, or
        FC with its hidden width)."""
        fwd = rec.get("forwards")
        if any(u.jax_name.endswith((".ConvRELU", ".Deconv")) for u in fwd):
            return {"conv": True}
        return {"conv": False, "hidden": int(numpy.prod(
            fwd[0].get("output_sample_shape")))}

    def rmse(self):
        """Validation RMSE (the reference's published AE metric)."""
        loss = self.decision.epoch_metrics.get("validation_loss")
        return float(numpy.sqrt(loss)) if loss is not None else None


def run(load, main):
    """The command line's entry: the workflow from ``root.mnist_ae_tpu``
    and MNIST's synthetic keys from ``root.mnist_tpu``."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import config_kwargs
    kw = config_kwargs(MnistAEWorkflow, root.mnist_ae_tpu)
    for key in ("synthetic_train", "synthetic_valid", "synthetic_kind"):
        if key in root.mnist_tpu:
            kw[key] = root.mnist_tpu.get(key)
    load(MnistAEWorkflow, **kw)
    main()
