"""Config for the CIFAR-10 conv workflow (BASELINE config 2)."""

from veles_tpu_torch.config import root

root.cifar_tpu.update({
    "minibatch_size": 128,
    "solver": "adam",
    "learning_rate": 0.002,
    "gradient_moment": 0.9,
    "weights_decay": 0.0005,
    "fail_iterations": 20,
    "max_epochs": 50,
    "snapshot_prefix": "cifar",
})
