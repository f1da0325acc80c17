"""Data normalizers in the PyTorch port held against the JAX package on
the CPU: every normalizer of ``veles_tpu/normalization.py`` (keyed by
its ``MAPPING`` name through ``MappedUnitRegistry``) analyzes the same
batches and must hold the same state and give the same normalized and
denormalized data, within 1e-6; ``ops/normalize.py``'s
``mean_disp_normalize`` and its ``MeanDispNormalizer`` unit against the
JAX ones, within 1e-6."""

import numpy
import pytest
import torch

pytestmark = pytest.mark.torch_port

TOL = 1e-6

KINDS = {
    "none": {},
    "linear": {"interval": (-2.0, 3.0)},
    "range_linear": {"interval": (0.0, 1.0)},
    "mean_disp": {},
    "external_mean": {"mean_source": numpy.linspace(
        -1, 1, 12, dtype=numpy.float32).reshape(3, 4)},
    "internal_mean": {},
    "exp": {},
    "pointwise": {},
}


def _batches(seed=3):
    rng = numpy.random.default_rng(seed)
    data = (rng.standard_normal((3, 5, 3, 4)) * 4 + 1).astype(numpy.float32)
    data[1, :, 0, 0] = 2.5   # a constant feature: zero dispersion
    return data


def _close(got, want):
    numpy.testing.assert_allclose(numpy.asarray(got, numpy.float64),
                                  numpy.asarray(want, numpy.float64),
                                  rtol=TOL, atol=TOL)


def test_registries_hold_the_same_names():
    from veles_tpu.unit_registry import MappedUnitRegistry as J
    import veles_tpu.normalization  # noqa: F401 (registers the family)
    from veles_tpu_torch.unit_registry import MappedUnitRegistry as P
    import veles_tpu_torch.normalization  # noqa: F401
    assert sorted(P.registries["NormalizerBase"]) == \
        sorted(J.registries["NormalizerBase"]) == sorted(KINDS)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_normalizer_matches_reference(kind):
    from veles_tpu.normalization import get_normalizer as jget
    from veles_tpu_torch.normalization import get_normalizer as pget
    batches = _batches()
    jn, pn = jget(kind, **KINDS[kind]), pget(kind, **KINDS[kind])
    assert type(pn).__name__ == type(jn).__name__
    for b in batches:
        jn.analyze(b)
        pn.analyze(b)
    assert pn.is_initialized == jn.is_initialized
    js, ps = jn.state, pn.state
    assert sorted(ps) == sorted(js)
    for k in js:
        if isinstance(js[k], (numpy.ndarray, float, int)) \
                and not isinstance(js[k], bool):
            _close(ps[k], js[k])
        else:
            assert ps[k] == js[k] or (ps[k] is None and js[k] is None)
    x = batches[2]
    want = jn.normalize(x)
    got = pn.normalize(x)
    assert got.dtype == want.dtype and got.shape == want.shape
    _close(got, want)
    try:
        back = jn.denormalize(want)
    except NotImplementedError:
        with pytest.raises(NotImplementedError):
            pn.denormalize(got)
    else:
        _close(pn.denormalize(got), back)
    # the state round-trips through a fresh normalizer of the kind
    fresh = pget(kind, **KINDS[kind])
    fresh.state = pn.state
    _close(fresh.normalize(x), want)
    pn.reset()
    jn.reset()
    assert pn.is_initialized == jn.is_initialized


def test_unknown_kind_raises():
    from veles_tpu_torch.normalization import get_normalizer
    with pytest.raises(KeyError, match="mean_disp"):
        get_normalizer("nope")


def test_mean_disp_op_and_unit_match_reference():
    """``mean_disp_normalize`` and the ``MeanDispNormalizer`` unit run in
    a workflow (f32 output), against the JAX unit run the same way."""
    import jax.numpy as jnp
    from veles_tpu.accelerated_units import AcceleratedWorkflow as JWf
    from veles_tpu.backends import Device
    from veles_tpu.config import root
    from veles_tpu.memory import Array as JArray
    from veles_tpu.ops.normalize import (
        MeanDispNormalizer as JUnit, mean_disp_normalize as jop)
    from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.ops.normalize import (
        MeanDispNormalizer, mean_disp_normalize)
    rng = numpy.random.default_rng(4)
    x = rng.standard_normal((6, 7)).astype(numpy.float32)
    mean = rng.standard_normal(7).astype(numpy.float32)
    rdisp = rng.uniform(0.5, 2, 7).astype(numpy.float32)
    want = numpy.asarray(jop(jnp.asarray(x), jnp.asarray(mean),
                             jnp.asarray(rdisp), jnp.float32))
    got = mean_disp_normalize(torch.as_tensor(x), torch.as_tensor(mean),
                              torch.as_tensor(rdisp), "float32")
    _close(got, want)
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    try:
        jwf = JWf(None, name="md")
        ju = JUnit(jwf)
        ju.input, ju.mean, ju.rdisp = (JArray(a) for a in (x, mean, rdisp))
        ju.link_from(jwf.start_point)
        jwf.end_point.link_from(ju)
        jwf.initialize(device=Device(backend="numpy"))
        jwf.run()
        jout = ju.output.map_read().mem
    finally:
        root.common.precision.compute_dtype = saved
    wf = AcceleratedWorkflow(None, name="md")
    u = MeanDispNormalizer(wf, dtype="float32")
    u.input, u.mean, u.rdisp = (Array(a) for a in (x, mean, rdisp))
    u.link_from(wf.start_point)
    wf.end_point.link_from(u)
    wf.initialize(device="cpu")
    wf.run()
    _close(u.output.map_read().mem, jout)
    _close(jout, want)
