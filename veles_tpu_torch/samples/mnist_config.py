"""Config for the MNIST workflow (per-run config files are executable
Python mutating ``root``)."""

from veles_tpu_torch.config import root

root.mnist_tpu.update({
    "layers": [100, 10],
    "minibatch_size": 128,
    "learning_rate": 0.02,
    "gradient_moment": 0.9,
    "solver": "sgd",
    "weights_decay": 0.0,
    "fail_iterations": 25,
    "max_epochs": 5,
    "snapshot_prefix": "mnist",
    "snapshot_compression": "gz",
    "snapshot_time_interval": 5.0,
})
