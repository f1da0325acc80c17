"""AlexNet training — the port of ``veles_tpu/samples/alexnet.py`` and of
the configuration ``bench.py``'s ``bench_alexnet`` trains:

    conv → LRN → max-pool twice, three convs (two grouped), max-pool,
    two FC layers each followed by dropout, a softmax head →
    EvaluatorSoftmax → GradientDescent (SGD with momentum)

over an :class:`ImagenetLoader`: the synthetic ImageNet-shaped dataset
of the JAX sample, drawn on the device (``uniform(key(42), ...)`` plus
``label / classes``, stored bf16), with labels from
``numpy.random.default_rng(42)``.  On the card the draw runs through
kernel 5 and the dataset never crosses from the host.

    from veles_tpu_torch.samples.alexnet import build_alexnet, train_alexnet
    net = build_alexnet(side=67, widths=(8, 16, 24, 24, 16, 32),
                        classes=10, n_train=64, minibatch_size=16,
                        device="cpu", dtype="float32")
    history = train_alexnet(net, epochs=1)
"""

import collections

import numpy
import torch

from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.convert import init_params
from veles_tpu_torch.loader import FullBatchLoader
from veles_tpu_torch.models.evaluator import EvaluatorSoftmax
from veles_tpu_torch.models.gd import GradientDescent
from veles_tpu_torch.ops import random as ops_random
from veles_tpu_torch.prng import threefry
from veles_tpu_torch.samples.lm import train_lm

#: conv widths (five convolutions) and the FC width of AlexNet
ALEXNET_WIDTHS = (96, 256, 384, 384, 256, 4096)


def alexnet_layers(classes=1000, dropout=0.5, widths=ALEXNET_WIDTHS):
    """The AlexNet layer spec (Krizhevsky et al. 2012) of the JAX
    sample with the plain strided stem (``space_to_depth=0``, as
    ``bench_alexnet`` pins it); ``widths`` narrows it for tests."""
    c1, c2, c3, c4, c5, fc = widths
    norm = {"type": "norm", "n": 5, "alpha": 1e-4, "beta": 0.75, "k": 2.0}
    pool = {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)}
    return [
        {"type": "conv_relu", "n_kernels": c1, "kx": 11, "ky": 11,
         "sliding": (4, 4), "padding": "valid"},
        dict(norm), dict(pool),
        {"type": "conv_relu", "n_kernels": c2, "kx": 5, "ky": 5,
         "padding": 2, "n_groups": 2},
        dict(norm), dict(pool),
        {"type": "conv_relu", "n_kernels": c3, "kx": 3, "ky": 3,
         "padding": 1},
        {"type": "conv_relu", "n_kernels": c4, "kx": 3, "ky": 3,
         "padding": 1, "n_groups": 2},
        {"type": "conv_relu", "n_kernels": c5, "kx": 3, "ky": 3,
         "padding": 1, "n_groups": 2},
        dict(pool),
        {"type": "all2all_relu", "output_sample_shape": (fc,)},
        {"type": "dropout", "dropout_ratio": dropout},
        {"type": "all2all_relu", "output_sample_shape": (fc,)},
        {"type": "dropout", "dropout_ratio": dropout},
        {"type": "softmax", "output_sample_shape": (classes,)},
    ]


class ImagenetLoader(FullBatchLoader):
    """The JAX sample's synthetic ImageNet: ``n_valid`` validation then
    ``n_train`` train samples [side, side, 3], labels from
    ``default_rng(42)`` and data ``uniform(key(42)) + label / classes``
    in f32, stored bf16 on ``device``."""

    def __init__(self, side=227, classes=1000, n_train=2048, n_valid=256,
                 minibatch_size=256, seed=None, device=None):
        dev = resolve_device(device)
        tot = n_train + n_valid
        labels = numpy.random.default_rng(42).integers(0, classes, tot)
        data = ops_random.uniform(threefry.key(42), (tot, side, side, 3),
                                  device=dev)
        lab = torch.as_tensor(labels, device=dev).to(torch.float32)
        data.add_((lab / classes)[:, None, None, None])
        super().__init__(data.to(torch.bfloat16), labels,
                         [0, n_valid, n_train],
                         minibatch_size=minibatch_size, seed=seed,
                         device=dev)


AlexNet = collections.namedtuple("AlexNet", "chain evaluator trainer loader")


def build_alexnet(minibatch_size=1024, side=227, classes=1000, n_train=4096,
                  n_valid=0, dropout=0.5, widths=ALEXNET_WIDTHS,
                  learning_rate=0.01, gradient_moment=0.9,
                  weights_decay=0.0005, seed=0, loader=None, device=None,
                  dtype="bfloat16", **trainer_kwargs):
    """AlexNet's pieces with ``bench_alexnet``'s defaults (batch 1024,
    side 227, 1000 classes, 4096 train samples, SGD lr 0.01 momentum
    0.9 weights decay 0.0005, dropout 0.5, bf16 compute): a chain with
    fresh weights from ``seed``, the softmax evaluator, the trainer and
    ``loader`` (default: an :class:`ImagenetLoader`)."""
    if loader is None:
        loader = ImagenetLoader(side, classes, n_train, n_valid,
                                minibatch_size=minibatch_size, device=device)
    chain = init_params(alexnet_layers(classes, dropout, widths), seed,
                        device=device, dtype=dtype, in_shape=(side, side, 3))
    evaluator = EvaluatorSoftmax()
    trainer = GradientDescent(chain, evaluator, solver="sgd",
                              learning_rate=learning_rate,
                              gradient_moment=gradient_moment,
                              weights_decay=weights_decay, **trainer_kwargs)
    return AlexNet(chain, evaluator, trainer, loader)


def train_alexnet(net, epochs):
    """Run ``epochs`` epochs of class spans (``samples.lm.train_lm``'s
    loop); returns one dict per epoch with the validation and train
    losses and error percentages."""
    return train_lm(net, epochs)
