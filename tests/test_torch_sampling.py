"""Seeded sampling of the PyTorch port held against ``jax.random`` and
the JAX package's samplers on the CPU.

- Threefry keys, ``fold_in``, random bits and uniforms are integer and
  bit-level operations: they must be BIT-equal.
- Gumbel noise is ``-log(-log(u))`` and the two libraries' ``log``
  may round one ulp apart, so the Gumbel floats are held to 1 ulp
  (relative 2**-23 per log, two logs) and the drawn tokens must be
  equal over 12,288 draws.
- ``sample_first``/``sample_slots`` with temperatures and top-k, and
  one seeded serving stream of the session's trained tiny chain
  (f32), must give the JAX package's tokens.

The Gumbel references are compiled in the test's own process: the JAX
package turns on its on-disk compile cache the first time a unit
initializes in a process (``accelerated_units.
enable_persistent_compile_cache``), and an earlier test in the same
worker can leave the cache's thresholds at 0, so ``jit__gumbel``
executables written by another process would be loaded instead
(:func:`compiled_here`).
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.config import root

from tests.test_torch_serving import WINDOW, BLOCK, _spec
from tests.test_torch_transformer import port_chain

pytestmark = pytest.mark.torch_port

SEEDS = [0, 1, 7, 12345, 2 ** 31 + 5, 2 ** 32 - 1]


@pytest.fixture
def compiled_here():
    """The persistent compile cache off and the in-memory caches empty
    for the test, restored afterwards."""
    from jax.experimental.compilation_cache import compilation_cache
    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    compilation_cache.reset_cache()
    jax.clear_caches()
    try:
        yield
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
        compilation_cache.reset_cache()


def _jax_key(seed, count=None):
    k = jax.random.key(numpy.uint32(seed))
    if count is not None:
        k = jax.random.fold_in(k, numpy.int32(count))
    return k


def _port_key(seed, count=None):
    from veles_tpu_torch.prng import threefry
    k = threefry.key(seed)
    if count is not None:
        k = threefry.fold_in(k, count)
    return k


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_bit_equal(seed):
    for count in (None, 0, 1, 31, 1000):
        want = numpy.asarray(jax.random.key_data(_jax_key(seed, count)))
        got = _port_key(seed, count).numpy()
        assert got.tolist() == want.astype(numpy.int64).tolist()


def test_random_generator_keys_equal():
    """``RandomGenerator.key``/``peek_key`` against the JAX package's
    generator of the same seed, and the host stream's shuffle."""
    from veles_tpu.prng.random_generator import RandomGenerator as JaxGen
    from veles_tpu_torch.prng import RandomGenerator
    jg, pg = JaxGen("t", 1234), RandomGenerator("t", 1234)
    for offset in (0, 3):
        assert pg.peek_key(offset).tolist() == numpy.asarray(
            jax.random.key_data(jg.peek_key(offset))).tolist()
    for _ in range(3):
        assert pg.key().tolist() == numpy.asarray(
            jax.random.key_data(jg.key())).tolist()
    a, b = numpy.arange(50), numpy.arange(50)
    jg.shuffle(a)
    pg.shuffle(b)
    assert numpy.array_equal(a, b)


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 129)])
@pytest.mark.parametrize("seed", [0, 3, 2 ** 32 - 1])
def test_bits_and_uniform_bit_equal(seed, shape):
    from veles_tpu_torch.prng import threefry
    for count in (0, 9):
        jk, pk = _jax_key(seed, count), _port_key(seed, count)
        want = numpy.asarray(jax.random.bits(jk, shape, jnp.uint32))
        got = threefry.random_bits(pk, shape).numpy()
        assert numpy.array_equal(got, want.astype(numpy.int64))
        for lo, hi in ((0.0, 1.0), (-2.5, 3.0)):
            want = numpy.asarray(jax.random.uniform(jk, shape, jnp.float32,
                                                    lo, hi))
            got = threefry.uniform(pk, shape, lo, hi).numpy()
            assert got.dtype == numpy.float32
            assert numpy.array_equal(got.view(numpy.int32),
                                     want.view(numpy.int32))


def test_categorical_tokens_equal(compiled_here):
    """12,288 draws (96 keys × 128 rows of logits) and their Gumbel
    noise against ``jax.random``."""
    from veles_tpu_torch.prng import threefry
    rng = numpy.random.default_rng(0)
    seeds = rng.integers(0, 2 ** 32, 96, dtype=numpy.uint64)
    counts = rng.integers(0, 4096, 96)
    logits = (rng.standard_normal((96, 128, 50)) * 2).astype(numpy.float32)
    jkeys = jax.vmap(lambda s, c: jax.random.fold_in(jax.random.key(s), c))(
        jnp.asarray(seeds, jnp.uint32), jnp.asarray(counts, jnp.int32))
    pkeys = threefry.fold_in(
        threefry.key(torch.as_tensor(seeds.astype(numpy.int64))),
        torch.as_tensor(counts))
    want_g = numpy.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (50,), jnp.float32))(jkeys))
    got_g = threefry.gumbel(pkeys, (50,)).numpy()
    numpy.testing.assert_allclose(got_g, want_g, rtol=2.0 ** -22,
                                  atol=2.0 ** -22)
    want = numpy.asarray(jax.vmap(
        lambda k, z: jax.vmap(lambda r: jax.random.categorical(k, r))(z))(
            jkeys, jnp.asarray(logits)))
    got = threefry.categorical(pkeys[:, None, :],
                               torch.as_tensor(logits)).numpy()
    assert got.shape == want.shape == (96, 128)
    assert numpy.array_equal(got, want)


@pytest.mark.parametrize("first", [True, False], ids=["first", "slots"])
def test_samplers_equal(compiled_here, first):
    from veles_tpu.serving import engine as jeng
    from veles_tpu_torch.serving import engine as peng
    rng = numpy.random.default_rng(5)
    b, v = 64, 97
    logits = (rng.standard_normal((b, v)) * 3).astype(numpy.float32)
    temps = rng.choice([0.0, 0.5, 1.0, 1.7], b).astype(numpy.float32)
    topks = rng.choice([0, 1, 5, 40, 200], b).astype(numpy.int32)
    seeds = rng.integers(0, 2 ** 32, b, dtype=numpy.uint64).astype(
        numpy.uint32)
    counts = rng.integers(0, 300, b).astype(numpy.int32)
    if first:
        want = numpy.asarray(jeng.first_tokens(logits, temps, topks, seeds,
                                               counts))
        got = peng.first_tokens(logits, temps, topks, seeds, counts)
    else:
        keys = jax.vmap(
            lambda s, c: jax.random.fold_in(jax.random.key(s), c))(
                jnp.asarray(seeds), jnp.asarray(counts))
        want = numpy.asarray(jeng.sample_slots(
            jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(topks),
            keys))
        got = peng.sample_slots(torch.as_tensor(logits), temps, topks,
                                seeds, counts).numpy()
    assert numpy.array_equal(got, want)


def test_seeded_serving_stream_equal(spec_trained_chain):
    """Four seeded requests (temperature 1, two with top-k) through
    both schedulers over fp32 pools."""
    from veles_tpu.serving import InferenceScheduler as JaxScheduler
    from veles_tpu_torch.serving import InferenceScheduler
    fw, pattern = spec_trained_chain
    prompts = [(pattern * 2)[o:o + n] for o, n in ((0, 5), (2, 9), (1, 3),
                                                   (4, 6))]
    reqs = [dict(temperature=1.0, top_k=k, seed=s)
            for k, s in ((0, 11), (3, 12), (0, 2 ** 32 - 3), (5, 0))]
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    try:
        sch = JaxScheduler(fw, max_slots=4, window=WINDOW, kv="paged",
                           block_size=BLOCK, spec=False, prefix_cache=False,
                           warm_buckets=False).start()
        try:
            want = [f.result(240) for f in
                    [sch.submit(p, 10, **r) for p, r in zip(prompts, reqs)]]
        finally:
            sch.close()
        sch = InferenceScheduler(port_chain(_spec(fw), fw), max_slots=4,
                                 window=WINDOW, block_size=BLOCK,
                                 prefix_cache=False, device="cpu").start()
        try:
            got = [f.result(240) for f in
                   [sch.submit(p, 10, **r) for p, r in zip(prompts, reqs)]]
        finally:
            sch.close()
    finally:
        root.common.precision.compute_dtype = saved
    assert got == want


def test_positional_submit_matches_reference(spec_trained_chain):
    """``submit(prompt, steps, temperature, top_k, seed)`` positionally:
    the fifth argument is the seed in both packages, so the port's
    stream equals the reference's and repeats from run to run; the
    port's constructor takes nothing positional past ``max_queue``."""
    from veles_tpu.serving import InferenceScheduler as JaxScheduler
    from veles_tpu_torch.serving import InferenceScheduler
    fw, pattern = spec_trained_chain
    prompt = (pattern * 2)[1:7]
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    try:
        sch = JaxScheduler(fw, max_slots=4, window=WINDOW, kv="paged",
                           block_size=BLOCK, spec=False, prefix_cache=False,
                           warm_buckets=False).start()
        try:
            want = [sch.submit(prompt, 8, 1.0, 0, 7).result(240)
                    for _ in range(2)]
        finally:
            sch.close()
        chain = port_chain(_spec(fw), fw)
        sch = InferenceScheduler(chain, 4, WINDOW, 32, block_size=BLOCK,
                                 prefix_cache=False, device="cpu").start()
        try:
            got = [sch.submit(prompt, 8, 1.0, 0, 7).result(240)
                   for _ in range(2)]
        finally:
            sch.close()
    finally:
        root.common.precision.compute_dtype = saved
    assert want[0] == want[1]
    assert got == want
    with pytest.raises(TypeError):
        InferenceScheduler(chain, 4, None, 32, 16)
