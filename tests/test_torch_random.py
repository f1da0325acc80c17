"""Random draws of the PyTorch port (kernel 5's plain version and the
Threefry helpers around it) held BIT-equal to ``jax.random`` and the
JAX package on the CPU:

- ``threefry.split`` and ``bernoulli`` against ``jax.random.split`` /
  ``bernoulli``;
- ``ops.random.uniform`` (a key or an int seed) against
  ``jax.random.uniform`` and the JAX package's ``uniform(...,
  use_pallas=False)``; ``pallas_uniform(seed)`` against
  ``jax.random.uniform(key(seed & 0x7FFFFFFF))``;
- the index offset that reaches the count's high word, against JAX's
  Threefry primitive on the same counts;
- ``ImagenetLoader``'s synthetic data, its labels and their mapping to
  class indices (the train span's distinct labels in sorted order)
  against the JAX loader's at 6 samples of side 35.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.config import root

pytestmark = pytest.mark.torch_port

SEEDS = [0, 7, 12345, 2 ** 31 + 5, 2 ** 32 - 1]


def _bits(a):
    """A float array's bit pattern (numpy or torch, f32 or bf16)."""
    if torch.is_tensor(a):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().astype(numpy.int64)
        return a.numpy().view(numpy.int32).astype(numpy.int64)
    a = numpy.asarray(a)
    wide = numpy.int16 if a.dtype.itemsize == 2 else numpy.int32
    return a.view(wide).astype(numpy.int64)


def _keys(seed):
    from veles_tpu_torch.prng import threefry
    return jax.random.key(numpy.uint32(seed)), threefry.key(seed)


@pytest.mark.parametrize("num", [2, 3, 5])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_bit_equal(seed, num):
    from veles_tpu_torch.prng import threefry
    jk, pk = _keys(seed)
    for _ in range(2):                     # a key, then a split-off key
        want = numpy.asarray(jax.random.key_data(jax.random.split(jk, num)))
        got = threefry.split(pk, num).numpy()
        assert got.tolist() == want.astype(numpy.int64).tolist()
        jk, pk = jax.random.split(jk)[1], threefry.split(pk)[1]


@pytest.mark.parametrize("p", [0.5, 0.3, 0.9])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bernoulli_bit_equal(seed, p):
    from veles_tpu_torch.prng import threefry
    jk, pk = _keys(seed)
    for shape in ((7,), (16, 33)):
        want = numpy.asarray(jax.random.bernoulli(jk, p, shape))
        assert numpy.array_equal(threefry.bernoulli(pk, p, shape).numpy(),
                                 want)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bit_equal(seed):
    """A key, a folded key and an int seed (``key(seed)``, as the JAX
    package's threefry path takes it)."""
    from veles_tpu.ops import random as jax_random
    from veles_tpu_torch.ops import random as ops_random
    from veles_tpu_torch.prng import threefry
    jk, pk = _keys(seed)
    jk, pk = jax.random.fold_in(jk, 3), threefry.fold_in(pk, 3)
    for shape in ((5,), (4, 9, 9, 3)):
        want = jax.random.uniform(jk, shape)
        got = ops_random.uniform(pk, shape, device="cpu")
        assert got.dtype == torch.float32
        assert numpy.array_equal(_bits(got), _bits(want))
        want = jax_random.uniform(int(seed), shape, use_pallas=False)
        got = ops_random.uniform(int(seed), shape, device="cpu")
        assert numpy.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_pallas_uniform_masks_the_seed(seed):
    from veles_tpu_torch.ops import random as ops_random
    want = jax.random.uniform(jax.random.key(seed & 0x7FFFFFFF), (6, 11))
    got = ops_random.pallas_uniform(seed, (6, 11), device="cpu")
    assert numpy.array_equal(_bits(got), _bits(want))


def test_uniform_without_a_device_needs_the_card():
    from veles_tpu_torch.ops import random as ops_random
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops_random.uniform(3, (4,))


@pytest.mark.parametrize("offset", [0, 5, 2 ** 32 - 3, 3 * 2 ** 32 + 7])
def test_offset_reaches_the_high_count_word(offset):
    """``uniform(k, (n,), offset=o)`` is elements o..o+n of the draw:
    against a longer draw for small o, and against JAX's Threefry
    primitive on the counts (hi, lo) of o..o+n where the high word is
    nonzero."""
    from jax.extend.random import threefry_2x32
    from veles_tpu_torch.prng import threefry
    jk, pk = _keys(99)
    n = 11
    got = threefry.uniform(pk, (n,), offset=offset)
    if offset < 64:
        want = numpy.asarray(jax.random.uniform(jk, (offset + n,)))[offset:]
        assert numpy.array_equal(_bits(got), _bits(want))
    idx = numpy.arange(offset, offset + n, dtype=numpy.uint64)
    counts = numpy.concatenate([idx >> numpy.uint64(32),
                                idx & numpy.uint64(0xFFFFFFFF)]).astype(
                                    numpy.uint32)
    words = numpy.asarray(threefry_2x32(jax.random.key_data(jk),
                                        jnp.asarray(counts)))
    bits = (words[:n] ^ words[n:]) >> numpy.uint32(9) \
        | numpy.uint32(0x3F800000)
    want = bits.view(numpy.float32) - numpy.float32(1.0)
    assert numpy.array_equal(_bits(got), _bits(want))


@pytest.fixture
def alexnet_config():
    """``root.alexnet_tpu`` for the JAX loader, restored afterwards."""
    keys = {"synthetic_train": 2048, "synthetic_valid": 256, "side": 227,
            "classes": 1000, "space_to_depth": 0}
    saved = {k: root.alexnet_tpu.get(k, v) for k, v in keys.items()}
    yield root.alexnet_tpu
    root.alexnet_tpu.update(saved)


def test_imagenet_loader_bit_equal(alexnet_config):
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.backends import Device
    from veles_tpu.samples.alexnet import ImagenetLoader as JaxLoader
    from veles_tpu_torch.samples.alexnet import ImagenetLoader
    alexnet_config.update({"synthetic_train": 4, "synthetic_valid": 2,
                           "side": 35, "classes": 10, "space_to_depth": 0})
    jl = JaxLoader(AcceleratedWorkflow(None, name="t"), minibatch_size=2)
    jl.initialize(device=Device(backend="numpy"))
    pl = ImagenetLoader(side=35, classes=10, n_train=4, n_valid=2,
                        minibatch_size=2, device="cpu")
    assert pl.class_lengths == list(jl.class_lengths) == [0, 2, 4]
    assert pl.labels_mapping == jl.labels_mapping
    assert pl.labels_dev.tolist() == numpy.asarray(jl.labels_dev).tolist()
    assert pl.dataset_dev.dtype == torch.bfloat16
    assert tuple(pl.dataset_dev.shape) == jl.original_data.shape \
        == (6, 35, 35, 3)
    assert numpy.array_equal(_bits(pl.dataset_dev),
                             _bits(jl.original_data))
