"""The stand-in datasets of the PyTorch port (``veles_tpu_torch/
datasets/{glyphs, scenes, tones}.py``) and the sample loaders that read
them, held against the JAX package on the CPU (oracle
``tests/test_datasets.py``): every render is the JAX package's array
for the same arguments, bit for bit — chunked renders included — and
so are the MNIST ``"glyphs"`` and CIFAR ``"scenes"`` datasets; the
tone tracks and the GTZAN-layout wav tree are the same samples, in a
cache directory of the port's own."""

import os

import numpy
import pytest

from tests.test_torch_workflow import jax_state

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("kw", [
    dict(n=64, seed=0), dict(n=50, seed=3, size=20, noise=0.0),
    dict(n=100, seed=5, _chunk=32)], ids=["default", "options", "chunked"])
def test_render_digits_matches_jax(kw):
    from veles_tpu.datasets import render_digits as J
    from veles_tpu_torch.datasets import render_digits
    (gi, gl), (wi, wl) = render_digits(**kw), J(**kw)
    assert gi.dtype == wi.dtype == numpy.float32
    numpy.testing.assert_array_equal(gi, wi)
    numpy.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("kw", [
    dict(n=64, seed=0), dict(n=40, seed=2, size=24, label_noise=0.0),
    dict(n=90, seed=4, _chunk=32)], ids=["default", "options", "chunked"])
def test_render_scenes_matches_jax(kw):
    from veles_tpu.datasets import render_scenes as J
    from veles_tpu_torch.datasets import render_scenes
    (gi, gl), (wi, wl) = render_scenes(**kw), J(**kw)
    numpy.testing.assert_array_equal(gi, wi)
    numpy.testing.assert_array_equal(gl, wl)


def test_tones_match_jax(tmp_path):
    from veles_tpu.datasets import tones as J
    from veles_tpu_torch.datasets import tones
    assert tones.GENRES == J.GENRES
    for style in ("drone", "metal", "pop"):
        got = tones.synth_track(tones.GENRES[style],
                                numpy.random.default_rng(1), 0.5, 8000)
        want = J.synth_track(J.GENRES[style],
                             numpy.random.default_rng(1), 0.5, 8000)
        numpy.testing.assert_array_equal(got, want)
    kw = dict(tracks_per_genre=1, seconds=0.25, rate=8000, seed=9)
    pdir = tones.generate(str(tmp_path / "p"), **kw)
    jdir = J.generate(str(tmp_path / "j"), **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), pdir)
                   for d, _, fs in os.walk(pdir) for f in fs)
    assert len(files) == len(tones.GENRES)
    for f in files:
        with open(os.path.join(pdir, f), "rb") as a, \
                open(os.path.join(jdir, f), "rb") as b:
            assert a.read() == b.read(), f
    # complete trees are not written again
    stamp = os.path.getmtime(os.path.join(pdir, files[0]))
    tones.generate(pdir, **kw)
    assert os.path.getmtime(os.path.join(pdir, files[0])) == stamp
    # the two packages never share a generated tree
    mine, theirs = tones.default_cache_dir(**kw), J.default_cache_dir(**kw)
    assert mine != theirs
    assert os.path.basename(mine).startswith("veles_tpu_torch_tones_")
    assert os.path.basename(mine)[len("veles_tpu_torch_"):] == \
        os.path.basename(theirs)[len("veles_tpu_"):]


@pytest.mark.parametrize("sample,kind", [("mnist", "glyphs"),
                                         ("cifar", "scenes"),
                                         ("mnist", "blobs")])
def test_sample_stand_ins_match_jax(sample, kind):
    """``synthetic_kind`` switches the port's sample loaders onto the
    same stand-in datasets the JAX loaders read."""
    import importlib
    jmod = importlib.import_module("veles_tpu.samples." + sample)
    pmod = importlib.import_module("veles_tpu_torch.samples." + sample)
    cls = "MnistLoader" if sample == "mnist" else "CifarLoader"
    keys = dict(synthetic_kind=kind, synthetic_train=96,
                synthetic_valid=32)
    with jax_state(sample + "_tpu", **keys):
        jl = getattr(jmod, cls)(None, minibatch_size=32)
        jl.load_data()
    pl = getattr(pmod, cls)(None, minibatch_size=32, **keys)
    pl.load_data()
    assert pl.class_lengths == jl.class_lengths == [0, 32, 96]
    numpy.testing.assert_array_equal(pl.original_data, jl.original_data)
    assert pl.original_labels == list(jl.original_labels)
    if kind == "glyphs":
        assert (pl.original_data < 0.2).mean() > 0.5
    with pytest.raises(ValueError, match="synthetic_kind"):
        getattr(pmod, cls)(None, synthetic_kind="nope")


def test_cifar_scenes_size():
    """``synthetic_size`` renders the STL-shaped variant."""
    from veles_tpu.samples.cifar import CifarLoader as J
    from veles_tpu_torch.samples.cifar import CifarLoader
    keys = dict(synthetic_kind="scenes", synthetic_train=8,
                synthetic_valid=4, synthetic_size=48)
    with jax_state("cifar_tpu", **keys):
        jl = J(None, minibatch_size=4)
        jl.load_data()
    pl = CifarLoader(None, minibatch_size=4, **keys)
    pl.load_data()
    assert pl.original_data.shape == (12, 48, 48, 3)
    numpy.testing.assert_array_equal(pl.original_data, jl.original_data)
