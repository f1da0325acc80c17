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

``space_to_depth=4`` runs AlexNet's 11×11/4 stem in blocked form: the
loader pre-blocks the dataset and stores it flat ``[N, hb·wb·48]``, and
the stem reshapes it (``models/conv.py``).  ``model="vgg_a"`` builds
VGG-A instead (:func:`vgg_a_layers`, the reference's other ImageNet
configuration; its 3×3/1 stem has nothing to block).

    from veles_tpu_torch.samples.alexnet import build_alexnet, train_alexnet
    net = build_alexnet(side=67, widths=(8, 16, 24, 24, 16, 32),
                        classes=10, n_train=64, minibatch_size=16,
                        device="cpu", dtype="float32")
    history = train_alexnet(net, epochs=1)

:class:`AlexNetWorkflow` is the same training as a ``StandardWorkflow``
(the reference sample's face, ``samples/alexnet.py:153``; its
``root.alexnet_tpu`` keys are keyword arguments of the same names and
defaults, ``widths`` a port knob for narrow tests):

    wf = AlexNetWorkflow(side=67, widths=(8, 16, 24, 24, 16, 32),
                         classes=10, synthetic_train=64,
                         synthetic_valid=16, minibatch_size=16,
                         max_epochs=2, dtype="float32")
    wf.initialize(device="cpu"); wf.run()
"""

import collections

import numpy
import torch

from veles_tpu_torch.convert import init_params
from veles_tpu_torch.loader import FullBatchLoader
from veles_tpu_torch.loader.base import unit_form
from veles_tpu_torch.models import conv
from veles_tpu_torch.models.evaluator import EvaluatorSoftmax
from veles_tpu_torch.models.gd import GradientDescent
from veles_tpu_torch.models.standard import StandardWorkflow
from veles_tpu_torch.ops import random as ops_random
from veles_tpu_torch.prng import threefry
from veles_tpu_torch.samples.lm import train_lm

#: conv widths (five convolutions) and the FC width of AlexNet
ALEXNET_WIDTHS = (96, 256, 384, 384, 256, 4096)


def alexnet_layers(classes=1000, dropout=0.5, widths=ALEXNET_WIDTHS,
                   space_to_depth=0, side=227):
    """The AlexNet layer spec (Krizhevsky et al. 2012) of the JAX
    sample; ``widths`` narrows it for tests.  ``space_to_depth=n``
    makes the stem the blocked one over a flat pre-blocked input of
    ``side``-pixel images (``bench_alexnet`` pins 0, the plain strided
    stem)."""
    c1, c2, c3, c4, c5, fc = widths
    norm = {"type": "norm", "n": 5, "alpha": 1e-4, "beta": 0.75, "k": 2.0}
    pool = {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)}
    s2d_hw = (-(-side // space_to_depth),) * 2 if space_to_depth else None
    return [
        {"type": "conv_relu", "n_kernels": c1, "kx": 11, "ky": 11,
         "sliding": (4, 4), "padding": "valid",
         "space_to_depth": space_to_depth, "space_to_depth_hw": s2d_hw},
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


def vgg_a_layers(classes=1000, dropout=0.5):
    """VGG-A (Simonyan and Zisserman 2014, configuration A), the JAX
    sample's ``vgg_a_layers``: eight 3×3 convolutions in five stages,
    2×2 max pools, two 4096-wide FC layers with dropout."""
    def conv3x3(k):
        return {"type": "conv_relu", "n_kernels": k, "kx": 3, "ky": 3,
                "padding": 1}

    pool = {"type": "max_pooling", "kx": 2, "ky": 2}
    return [
        conv3x3(64), dict(pool),
        conv3x3(128), dict(pool),
        conv3x3(256), conv3x3(256), dict(pool),
        conv3x3(512), conv3x3(512), dict(pool),
        conv3x3(512), conv3x3(512), dict(pool),
        {"type": "all2all_relu", "output_sample_shape": (4096,)},
        {"type": "dropout", "dropout_ratio": dropout},
        {"type": "all2all_relu", "output_sample_shape": (4096,)},
        {"type": "dropout", "dropout_ratio": dropout},
        {"type": "softmax", "output_sample_shape": (classes,)},
    ]


class ImagenetLoader(FullBatchLoader):
    """The JAX sample's synthetic ImageNet: ``n_valid`` validation then
    ``n_train`` train samples [side, side, 3], labels from
    ``default_rng(42)`` and data ``uniform(key(42)) + label / classes``
    in f32, stored bf16 on the loader's device; with ``space_to_depth=n``
    pre-blocked (``models.conv.space_to_depth``) and stored flat, for
    AlexNet's blocked stem (whose geometry it validates).

    ``ImagenetLoader(side=227, classes=1000, n_train=2048, n_valid=256,
    minibatch_size=256, seed=None, device=None, space_to_depth=0)`` is
    ready at once; ``ImagenetLoader(workflow, side=..., classes=...,
    synthetic_train=..., synthetic_valid=..., space_to_depth=...,
    **loader_kwargs)`` is the unit, drawing the dataset at
    ``initialize``."""

    def __init__(self, *args, **kwargs):
        if args and unit_form(args[0]):
            self._init_unit(*args, **kwargs)
        else:
            self._init_plain(*args, **kwargs)

    def _init_unit(self, workflow, side=227, classes=1000,
                   synthetic_train=2048, synthetic_valid=256,
                   space_to_depth=0, **kwargs):
        FullBatchLoader.__init__(self, workflow, **kwargs)
        self.side, self.classes = int(side), int(classes)
        self.n_train, self.n_valid = int(synthetic_train), \
            int(synthetic_valid)
        self.space_to_depth = int(space_to_depth)
        if self.space_to_depth:
            conv.validate_space_to_depth(self.side, self.side, 11, 11,
                                         self.space_to_depth)

    def _init_plain(self, side=227, classes=1000, n_train=2048, n_valid=256,
                    minibatch_size=256, seed=None, device=None,
                    space_to_depth=0):
        self._init_unit(None, side, classes, n_train, n_valid,
                        space_to_depth, minibatch_size=minibatch_size,
                        seed=seed)
        self.initialize(device=device)

    def load_data(self):
        dev, side, s2d = self.device, self.side, self.space_to_depth
        tot = self.n_train + self.n_valid
        labels = numpy.random.default_rng(42).integers(0, self.classes, tot)
        data = ops_random.uniform(threefry.key(42), (tot, side, side, 3),
                                  device=dev)
        lab = torch.as_tensor(labels, device=dev).to(torch.float32)
        data.add_((lab / self.classes)[:, None, None, None])
        data = data.to(torch.bfloat16)
        if s2d:
            data = conv.space_to_depth(data, s2d).reshape(tot, -1)
        self.class_lengths[:] = [0, self.n_valid, self.n_train]
        self.original_data = data
        self.original_labels = labels.tolist()


AlexNet = collections.namedtuple("AlexNet", "chain evaluator trainer loader")


def build_alexnet(minibatch_size=1024, side=227, classes=1000, n_train=4096,
                  n_valid=0, dropout=0.5, widths=ALEXNET_WIDTHS,
                  learning_rate=0.01, gradient_moment=0.9,
                  weights_decay=0.0005, seed=0, loader=None, device=None,
                  dtype="bfloat16", model="alexnet", space_to_depth=0,
                  **trainer_kwargs):
    """AlexNet's pieces with ``bench_alexnet``'s defaults (batch 1024,
    side 227, 1000 classes, 4096 train samples, SGD lr 0.01 momentum
    0.9 weights decay 0.0005, dropout 0.5, bf16 compute): a chain with
    fresh weights from ``seed``, the softmax evaluator, the trainer and
    ``loader`` (default: an :class:`ImagenetLoader`).  ``model`` is
    "alexnet" (``widths`` and ``space_to_depth`` apply) or "vgg_a"."""
    if model == "vgg_a":
        space_to_depth = 0
        layers = vgg_a_layers(classes, dropout)
    elif model == "alexnet":
        layers = alexnet_layers(classes, dropout, widths, space_to_depth,
                                side)
    else:
        raise ValueError("model must be 'alexnet' or 'vgg_a', not %r"
                         % (model,))
    if loader is None:
        loader = ImagenetLoader(side, classes, n_train, n_valid,
                                minibatch_size=minibatch_size, device=device,
                                space_to_depth=space_to_depth)
    in_shape = (side, side, 3)
    if space_to_depth:
        hb = -(-side // space_to_depth)
        in_shape = (hb * hb * space_to_depth ** 2 * 3,)
    chain = init_params(layers, seed, device=device, dtype=dtype,
                        in_shape=in_shape)
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


class AlexNetWorkflow(StandardWorkflow):
    """BASELINE config 3 (the reference's ``samples/alexnet.py:153``):
    AlexNet (``model="alexnet"``, either stem) or VGG-A
    (``model="vgg_a"``) over the synthetic ImageNet, its keyword
    arguments the reference's ``root.alexnet_tpu`` keys with their
    defaults; ``decision_config`` and ``snapshotter_config`` entries
    override the sample's, other keyword arguments go to
    ``StandardWorkflow`` and the trainer."""

    def __init__(self, workflow=None, model="alexnet", classes=1000,
                 dropout=0.5, space_to_depth=0, side=227,
                 minibatch_size=256, solver="sgd", learning_rate=0.01,
                 gradient_moment=0.9, weights_decay=0.0005,
                 fail_iterations=10, max_epochs=None,
                 snapshot_prefix="alexnet", snapshot_compression="gz",
                 snapshot_time_interval=60.0, synthetic_train=2048,
                 synthetic_valid=256, widths=ALEXNET_WIDTHS,
                 dtype="bfloat16", decision_config=None,
                 snapshotter_config=None, **kwargs):
        if model == "vgg_a":
            s2d = 0                        # 3×3/1 stem — nothing to block
            layers = vgg_a_layers(int(classes), float(dropout))
        elif model == "alexnet":
            s2d = int(space_to_depth)
            layers = alexnet_layers(int(classes), float(dropout), widths,
                                    s2d, int(side))
        else:
            raise ValueError("model must be 'alexnet' or 'vgg_a', not %r"
                             % (model,))
        super(AlexNetWorkflow, self).__init__(
            workflow, name="AlexNet", loader_factory=ImagenetLoader,
            loader_config={
                "side": side, "classes": classes,
                "synthetic_train": synthetic_train,
                "synthetic_valid": synthetic_valid,
                "space_to_depth": s2d,
                "minibatch_size": int(minibatch_size)},
            layers=layers, dtype=dtype, solver=solver,
            learning_rate=float(learning_rate),
            gradient_moment=float(gradient_moment),
            weights_decay=float(weights_decay),
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
        """The net of a JAX AlexNet record: the model (VGG-A's stem is a
        3×3 convolution), the classes, the dropout ratio, the widths and
        the stem's blocking, and the image side from ``root.alexnet_tpu``
        (as the JAX loader read it)."""
        from veles_tpu_torch.config import root
        fwd = rec.get("forwards")
        convs = [u for u in fwd if u.get("n_kernels") is not None]
        fcs = [u for u in fwd if u.jax_name.endswith(".All2AllRELU")]
        drops = [u for u in fwd if u.get("dropout_ratio") is not None]
        kw = {"classes": int(numpy.prod(fwd[-1].get("output_sample_shape"))),
              "side": int(root.alexnet_tpu.get("side", 227))}
        if drops:
            kw["dropout"] = float(drops[0].get("dropout_ratio"))
        if convs and int(convs[0].get("kx")) == 3:
            kw["model"] = "vgg_a"
        elif len(convs) == 5 and fcs:
            kw["widths"] = tuple(int(u.get("n_kernels")) for u in convs) + (
                int(numpy.prod(fcs[0].get("output_sample_shape"))),)
            kw["space_to_depth"] = int(convs[0].get("space_to_depth") or 0)
        return kw


def run(load, main):
    """The command line's entry: the workflow from ``root.alexnet_tpu``."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import config_kwargs
    load(AlexNetWorkflow, **config_kwargs(AlexNetWorkflow, root.alexnet_tpu))
    main()
