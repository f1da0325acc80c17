"""Config for the AlexNet/ImageNet workflow (BASELINE config 3)."""

from veles_tpu_torch.config import root

root.alexnet_tpu.update({
    "minibatch_size": 256,
    "classes": 1000,
    "side": 227,
    "solver": "sgd",
    "learning_rate": 0.01,
    "gradient_moment": 0.9,
    "weights_decay": 0.0005,
    "fail_iterations": 10,
    "max_epochs": 90,
    "snapshot_prefix": "alexnet",
})
