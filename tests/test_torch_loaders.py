"""The file loaders of the PyTorch port (``veles_tpu_torch/loader/{image,
pickles, hdf5_loader, text, sound, interactive, saver}.py``,
``snd_features.py``, ``ops/join.py`` and ``downloader.py``) held
against the JAX package on the CPU, from the same files and seeds
(oracles ``tests/test_image_cifar.py``, ``test_loader.py``,
``test_loader_breadth.py``, ``test_text_loader.py`` and
``test_services_misc.py::test_downloader_*``):

- exact: ``ImagePipeline`` outputs (every option, the random ones from
  equally seeded generators), the streaming image loader's served
  minibatches wave by wave through both prefetch pipelines, the
  full-batch image datasets and label maps, pickles, HDF5 (full and
  streaming), BPE merges, ids and saved JSON read across packages, the
  text windows, the LM trained on text (within 2e-5), saved minibatch
  streams read across packages, the interactive loader's minibatches,
  the ``InputJoiner``'s output;
- within 1e-5: sound features (the GTZAN XML tree and a stereo mix)
  and the ``SoundLoader``'s dataset;
- the downloader unpacks local and ``file://`` archives, keeps them,
  and fails on a missing file.

PIL and h5py cases skip where those packages are missing, as the
oracles do.
"""

import gzip
import os
import pickle
import tarfile
import zipfile

import numpy
import pytest

from tests.test_torch_workflow import jax_state

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GTZAN_XML = os.path.join(ROOT, "veles_tpu", "samples", "gtzan_features.xml")


def _jdev():
    from veles_tpu.backends import Device
    return Device(backend="numpy")


def _served(loader, waves):
    """(class, size, offset, flags, indices, data, labels) per wave."""
    out = []
    for _ in range(waves):
        loader.run()
        n = loader.minibatch_size
        loader.minibatch_data.map_read()
        loader.minibatch_labels.map_read()
        out.append((loader.minibatch_class, n, loader.minibatch_offset,
                    bool(loader.last_minibatch), bool(loader.epoch_ended),
                    bool(loader.train_ended),
                    numpy.array(loader.minibatch_indices.mem[:n]),
                    numpy.array(loader.minibatch_data.mem),
                    numpy.array(loader.minibatch_labels.mem)))
    return out


def _assert_same_waves(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:6] == w[:6]
        for a, b in zip(g[6:], w[6:]):
            numpy.testing.assert_array_equal(a, b)


# -- ImagePipeline ------------------------------------------------------------

PIPELINES = [
    ("scale_crop_mirror", dict(scale=(30, 20), crop=(16, 10), mirror=True),
     False),
    ("ratio", dict(scale=0.5), False),
    ("aspect", dict(scale=(20, 20), scale_maintain_aspect_ratio=True),
     False),
    ("sobel", dict(add_sobel=True), False),
    ("rot90", dict(rotation=90), False),
    ("rot180_float", dict(rotation=180), True),
    ("random_crop_mirror", dict(crop=(24, 16), mirror="random"), False),
    ("random_rotation", dict(rotation=(-30, 30)), False),
    ("float_scale", dict(scale=(25, 15)), True),
]


@pytest.mark.parametrize("name,kw,as_float", PIPELINES,
                         ids=[p[0] for p in PIPELINES])
def test_image_pipeline_matches_jax(name, kw, as_float):
    from veles_tpu.loader.image import ImagePipeline as JPipe
    from veles_tpu.prng.random_generator import RandomGenerator as JGen
    from veles_tpu_torch.loader.image import ImagePipeline
    from veles_tpu_torch.prng import RandomGenerator
    if not as_float and name not in ("sobel", "random_crop_mirror"):
        pytest.importorskip("PIL")
    rng = numpy.random.default_rng(5)
    arr = rng.integers(0, 256, (40, 60, 3)).astype(numpy.uint8)
    if as_float:
        arr = arr.astype(numpy.float32) / 255.0
    jp = JPipe(prng=JGen("t", 3), **kw)
    pp = ImagePipeline(prng=RandomGenerator("t", 3), **kw)
    for augment in (False, True, True, True):
        want = jp(arr, augment=augment)
        got = pp(arr, augment=augment)
        assert got.dtype == numpy.float32
        numpy.testing.assert_array_equal(got, want)


def test_image_pipeline_refuses_unseeded_random():
    from veles_tpu_torch.loader.image import ImagePipeline
    with pytest.raises(ValueError):
        ImagePipeline(mirror="random")
    with pytest.raises(ValueError):
        ImagePipeline(rotation=(-5, 5))
    with pytest.raises(ValueError, match="multiples of 90"):
        ImagePipeline(rotation=45)(numpy.zeros((4, 4, 1), numpy.float32))


# -- file image loaders -------------------------------------------------------

@pytest.fixture(scope="module")
def npy_tree(tmp_path_factory):
    """<root>/{train,valid}/<class>/<n>.npy, uint8 HWC from a seed."""
    base = tmp_path_factory.mktemp("npy")
    rng = numpy.random.default_rng(7)
    for split, n in (("train", 30), ("valid", 9)):
        for i in range(n):
            d = base / split / ("c%d" % (i % 3))
            d.mkdir(parents=True, exist_ok=True)
            numpy.save(d / ("%03d.npy" % i),
                       rng.integers(0, 256, (12, 10, 3)).astype(
                           numpy.uint8))
    return base


@pytest.fixture(scope="module")
def png_tree(tmp_path_factory):
    Image = pytest.importorskip("PIL.Image")
    base = tmp_path_factory.mktemp("png")
    rng = numpy.random.default_rng(8)
    for split, n in (("train", 12), ("valid", 4)):
        for i in range(n):
            d = base / split / ("dark" if i % 2 else "light")
            d.mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (8, 8, 3)).astype(
                numpy.uint8)).save(d / ("%02d.png" % i))
    return base


def _paths(tree):
    return dict(train_paths=[str(tree / "train")],
                validation_paths=[str(tree / "valid")])


@pytest.mark.parametrize("tree", ["npy", "png"])
def test_streaming_image_loader_matches_jax(tree, request):
    """Two epochs of served minibatches, random crop and mirror on the
    train class, both packages prefetching (the default)."""
    from veles_tpu.loader.image import FileImageLoader as J
    from veles_tpu_torch.loader.image import FileImageLoader
    base = request.getfixturevalue(tree + "_tree")
    kw = dict(minibatch_size=8, crop=(6, 6), mirror="random", **_paths(base))
    with jax_state():
        jl = J(None, **kw)
        jl.initialize(device=_jdev())
        want = _served(jl, 12)
        jl.stop()
    pl = FileImageLoader(None, **kw)
    pl.initialize(device="cpu")
    got = _served(pl, 12)
    assert pl.prefetch_ not in (None, False)
    pl.stop()
    assert pl.labels_mapping == jl.labels_mapping
    _assert_same_waves(got, want)


def test_fullbatch_image_loaders_match_jax(npy_tree, tmp_path):
    from veles_tpu.loader.image import FullBatchFileImageLoader as J
    from veles_tpu.loader.image import FullBatchImageLoaderMSE as JMSE
    from veles_tpu_torch.loader.image import (
        FullBatchFileImageLoader, FullBatchImageLoaderMSE)
    kw = dict(minibatch_size=8, scale=(8, 6), **_paths(npy_tree))
    with jax_state():
        jl = J(None, **kw)
        jl.initialize(device=_jdev())
    pl = FullBatchFileImageLoader(None, **kw)
    pl.initialize(device="cpu")
    assert pl.class_lengths == jl.class_lengths == [0, 9, 30]
    assert pl.labels_mapping == jl.labels_mapping
    numpy.testing.assert_array_equal(numpy.asarray(pl.original_data),
                                     numpy.asarray(jl.original_data))
    numpy.testing.assert_array_equal(pl.labels_dev.numpy(),
                                     numpy.asarray(jl.labels_dev))

    def images(self):
        rng = numpy.random.default_rng(2)
        for i in range(10):
            img = rng.integers(0, 256, (6, 6, 1)).astype(numpy.uint8)
            yield (1 if i < 3 else 2), img, 255 - img

    with jax_state():
        jm = type("M", (JMSE,), {"load_images": images})(
            None, minibatch_size=4)
        jm.initialize(device=_jdev())
    pm = type("M", (FullBatchImageLoaderMSE,), {"load_images": images})(
        None, minibatch_size=4)
    pm.initialize(device="cpu")
    numpy.testing.assert_array_equal(pm.targets_dev.numpy(),
                                     numpy.asarray(jm.original_targets))
    numpy.testing.assert_array_equal(numpy.asarray(pm.original_data),
                                     numpy.asarray(jm.original_data))


def test_filename_regex_labels(tmp_path):
    from veles_tpu.loader.image import FullBatchFileImageLoader as J
    from veles_tpu_torch.loader.image import FullBatchFileImageLoader
    d = tmp_path / "t"
    d.mkdir()
    for i, cls in enumerate(["catA", "dogB", "catC", "bird"]):
        numpy.save(d / ("%s_%d.npy" % (cls, i)),
                   numpy.full((4, 4, 3), i, numpy.uint8))
    kw = dict(train_paths=[str(d)], filename_re=r"^(cat|dog)",
              minibatch_size=3)
    with jax_state():
        jl = J(None, **kw)
        jl.initialize(device=_jdev())
    pl = FullBatchFileImageLoader(None, **kw)
    pl.initialize(device="cpu")
    assert pl.labels_mapping == jl.labels_mapping == {"cat": 0, "dog": 1}
    assert pl.class_lengths == jl.class_lengths == [0, 0, 3]


# -- pickles, HDF5 --------------------------------------------------------------

@pytest.mark.parametrize("form", ["tuple", "dict_gz", "bare"])
def test_pickles_loader_matches_jax(form, tmp_path):
    from veles_tpu.loader.pickles import PicklesLoader as J
    from veles_tpu_torch.loader.pickles import PicklesLoader
    rng = numpy.random.default_rng(1)
    paths = {}
    for name, n in (("train", 40), ("valid", 10)):
        data = rng.normal(size=(n, 6)).astype(numpy.float32)
        labels = [i % 3 for i in range(n)]
        obj = {"tuple": (data, labels), "bare": data,
               "dict_gz": {"data": data, "labels": labels}}[form]
        p = str(tmp_path / (name + (".pickle.gz" if form == "dict_gz"
                                    else ".pickle")))
        with (gzip.open if p.endswith(".gz") else open)(p, "wb") as f:
            pickle.dump(obj, f)
        paths[name] = p
    kw = dict(train_path=paths["train"], validation_path=paths["valid"],
              minibatch_size=16)
    with jax_state():
        jl = J(None, **kw)
        jl.initialize(device=_jdev())
        want = _served(jl, 6)
        jl.stop()
    pl = PicklesLoader(None, **kw)
    pl.initialize(device="cpu")
    got = _served(pl, 6)
    assert pl.class_lengths == jl.class_lengths == [0, 10, 40]
    _assert_same_waves(got, want)


@pytest.fixture(scope="module")
def h5_files(tmp_path_factory):
    h5py = pytest.importorskip("h5py")
    base = tmp_path_factory.mktemp("h5")
    rng = numpy.random.default_rng(0)
    paths = {}
    for name, n in (("train", 48), ("validation", 16)):
        p = str(base / (name + ".h5"))
        with h5py.File(p, "w") as f:
            f["data"] = rng.normal(size=(n, 6)).astype(numpy.float32)
            f["labels"] = rng.integers(0, 3, n)
        paths[name] = p
    return paths


@pytest.mark.parametrize("kind", ["full", "streaming"])
def test_hdf5_loaders_match_jax(kind, h5_files):
    """The port's streaming loader prefetching (its default) against
    the reference's synchronous one: under the reference's own prefetch
    a collected stage's ``__del__`` closes the live loader's files (a
    fault of the reference the port repairs)."""
    from veles_tpu.loader import hdf5_loader as jmod
    from veles_tpu_torch.loader import hdf5_loader as pmod
    name = "FullBatchHDF5Loader" if kind == "full" else "HDF5Loader"
    kw = dict(validation_path=h5_files["validation"],
              train_path=h5_files["train"], minibatch_size=16)
    with jax_state():
        jl = getattr(jmod, name)(None, prefetch=0, **kw)
        jl.initialize(device=_jdev())
        want = _served(jl, 10)
        jl.stop()
    pl = getattr(pmod, name)(None, **kw)
    pl.initialize(device="cpu")
    got = _served(pl, 10)
    assert pl.prefetch_ not in (None, False)
    pl.stop()
    assert pl.class_lengths == jl.class_lengths == [0, 16, 48]
    _assert_same_waves(got, want)


# -- text ---------------------------------------------------------------------

CORPUS = (open(os.path.join(ROOT, "README.md"), encoding="utf-8").read()
          [:6000])


@pytest.mark.parametrize("vocab_size", [257, 300, 600])
def test_bpe_matches_jax(vocab_size, tmp_path):
    """Merges, ids, decode and the saved JSON, across packages."""
    from veles_tpu.loader.text import BytePairVocab as J
    from veles_tpu_torch.loader.text import BytePairVocab
    jv = J.train(CORPUS, vocab_size, specials=("<eos>",))
    pv = BytePairVocab.train(CORPUS, vocab_size, specials=("<eos>",))
    assert pv.merges == jv.merges and pv.size == jv.size
    assert pv.special("<eos>") == jv.special("<eos>") == 256
    ids = pv.encode(CORPUS)
    assert ids == jv.encode(CORPUS)
    assert pv.decode(ids) == CORPUS
    pv.save(str(tmp_path / "p.json"))
    jv.save(str(tmp_path / "j.json"))
    assert open(tmp_path / "p.json").read() == open(tmp_path / "j.json").read()
    assert J.load(str(tmp_path / "p.json")).encode("zz top") == \
        BytePairVocab.load(str(tmp_path / "j.json")).encode("zz top")
    with pytest.raises(ValueError, match="vocab_size"):
        BytePairVocab.train(CORPUS, 100)


def test_text_windows_match_jax():
    from veles_tpu.loader.text import FullBatchTextLM as J
    from veles_tpu_torch.loader.text import FullBatchTextLM
    corpus = " ".join("w%03d" % i for i in range(400)) + " "
    kw = dict(text=corpus, vocab_size=300, seq_len=16, stride=8,
              minibatch_size=8, normalization_type="none")
    with jax_state():
        jl = J(None, **kw)
        jl.initialize(device=_jdev())
    pl = FullBatchTextLM(None, **kw)
    pl.initialize(device="cpu")
    assert pl.class_lengths == jl.class_lengths
    numpy.testing.assert_array_equal(pl.dataset_dev.numpy(),
                                     numpy.asarray(jl.original_data))
    assert pl.vocab.merges == jl.vocab.merges


def test_lm_trains_on_text_like_jax(tmp_path):
    """``LMWorkflow(text_path=...)`` for two epochs against the JAX
    sample's ``root.lm_tpu.text_path`` route from the same weights; the
    model's width is the vocabulary's size, and the vocabulary is
    saved to ``vocab_path`` and loaded from it next time."""
    from tests.test_torch_workflow import (
        _compare_runs, _jax_device, _jax_params, _record_epochs)
    from veles_tpu.samples.lm import LMWorkflow as J
    from veles_tpu_torch.convert import load_workflow_params
    from veles_tpu_torch.samples.lm import LMWorkflow
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(CORPUS[:3000])
    keys = dict(text_path=str(corpus), vocab_size=280, seq=16, stride=8,
                dim=32, blocks=1, heads=2, minibatch_size=16)
    with jax_state("lm_tpu", tmp_path / "jax", max_epochs=2,
                   snapshot_time_interval=1e9, **keys):
        jwf = J(None, plotters=False)
        jwf.initialize(device=_jax_device())
        jrows = _record_epochs(jwf.decision)
        params = _jax_params(jwf.forwards)
        jwf.run()
        jwf.stop()
    vocab_path = str(tmp_path / "vocab.json")
    pwf = LMWorkflow(max_epochs=2, dtype="float32", vocab_path=vocab_path,
                     snapshotter_config={"directory": str(tmp_path / "p"),
                                         "time_interval": 1e9}, **keys)
    assert pwf.forwards[0].vocab == jwf.loader.vocab.size
    pwf.initialize(device="cpu")
    load_workflow_params(pwf, params)
    prows = _record_epochs(pwf.decision)
    pwf.run()
    _compare_runs(jwf, pwf, jrows, prows)
    again = LMWorkflow(vocab_path=vocab_path, **dict(keys, vocab_size=999))
    assert again.forwards[0].vocab == jwf.loader.vocab.size


# -- sound --------------------------------------------------------------------

@pytest.fixture(scope="module")
def wav_tree(tmp_path_factory):
    from scipy.io import wavfile
    base = tmp_path_factory.mktemp("genres")
    rng = numpy.random.default_rng(1)
    rate = 8000
    t = numpy.arange(rate * 2) / rate
    for genre, freq in (("lowtone", 220.0), ("hightone", 1760.0)):
        d = base / genre
        d.mkdir()
        for i in range(3):
            sig = 0.5 * numpy.sin(2 * numpy.pi * freq * t) \
                + 0.05 * rng.normal(size=len(t))
            if i == 2:
                sig = numpy.stack([sig, 0.5 * sig], axis=1)
            wavfile.write(str(d / ("%02d.wav" % i)), rate,
                          (sig * 32767).astype(numpy.int16))
    return str(base)


SND_TOL = 1e-5


def _close_features(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        numpy.testing.assert_allclose(got[k], want[k], rtol=SND_TOL,
                                      atol=SND_TOL, err_msg=k)


@pytest.mark.parametrize("channels", [1, 2])
def test_sound_features_match_jax(channels):
    from veles_tpu import snd_features as J
    from veles_tpu_torch import snd_features as P
    rng = numpy.random.default_rng(channels)
    sig = rng.normal(size=(16000, channels) if channels > 1
                     else 16000).astype(numpy.float32)
    jt = J.parse_features_xml(GTZAN_XML)
    pt = P.parse_features_xml(GTZAN_XML)
    _close_features(P.FeatureExtractor(pt, 8000).extract(sig),
                    J.FeatureExtractor(jt, 8000).extract(sig))
    numpy.testing.assert_allclose(
        P.extract_features(pt, sig, 8000),
        J.extract_features(jt, sig, 8000), rtol=SND_TOL, atol=SND_TOL)
    xml = ("<features><transform name='Mix' condition='channels==2'>"
           "<transform name='Energy'><feature name='E'/></transform>"
           "</transform></features>")
    numpy.testing.assert_allclose(P.extract_features(xml, sig),
                                  J.extract_features(xml, sig),
                                  rtol=SND_TOL, atol=SND_TOL)


def test_sound_loader_matches_jax(wav_tree):
    from veles_tpu.loader.sound import SoundLoader as J
    from veles_tpu.loader.sound import decode_sound as jdecode
    from veles_tpu_torch.loader.sound import SoundLoader, decode_sound
    kw = dict(features_xml=GTZAN_XML, train_paths=[wav_tree],
              minibatch_size=4, max_seconds=1.5)
    with jax_state():
        jl = J(None, **kw)
        jl.initialize(device=_jdev())
    pl = SoundLoader(None, **kw)
    pl.initialize(device="cpu")
    assert pl.class_lengths == jl.class_lengths == [0, 0, 6]
    assert pl.labels_mapping == jl.labels_mapping
    numpy.testing.assert_allclose(pl.dataset_dev.numpy(),
                                  numpy.asarray(jl.original_data),
                                  rtol=SND_TOL, atol=SND_TOL)
    numpy.testing.assert_array_equal(pl.labels_dev.numpy(),
                                     numpy.asarray(jl.labels_dev))
    path = os.path.join(wav_tree, "lowtone", "02.wav")
    (gd, gr), (wd, wr) = decode_sound(path), jdecode(path)
    assert gr == wr and gd.shape == wd.shape == (16000, 2)
    numpy.testing.assert_array_equal(gd, wd)


# -- interactive, saver, joiner ------------------------------------------------

def test_interactive_loader_matches_jax():
    from veles_tpu.loader.interactive import InteractiveLoader as J
    from veles_tpu_torch.loader.interactive import InteractiveLoader
    got = []
    for cls, dev in ((J, _jdev()), (InteractiveLoader, "cpu")):
        with jax_state():
            loader = cls(None, sample_shape=(4,), minibatch_size=3,
                         max_wait=5.0)
            loader.initialize(device=dev)
        for v in (1, 2, 3, 4):
            loader.feed(v * numpy.ones(4))
        loader.run()
        first = (loader.minibatch_size, numpy.array(
            loader.minibatch_data.map_read().mem))
        loader.close()
        loader.run()
        got.append((first, loader.minibatch_size,
                    numpy.array(loader.minibatch_data.map_read().mem),
                    bool(loader.epoch_ended), loader.closed,
                    loader.samples_served))
        with pytest.raises(ValueError):
            loader.feed(numpy.ones(3))
    (a, b) = got
    assert a[0][0] == b[0][0] == 3 and a[1:2] == b[1:2] == (1,)
    numpy.testing.assert_array_equal(a[0][1], b[0][1])
    numpy.testing.assert_array_equal(a[2], b[2])
    assert a[3:] == b[3:] == (True, True, 4)


def _stream(cls, wf, seed_kw):
    rng = numpy.random.default_rng(4)
    data = rng.normal(size=(100, 5)).astype(numpy.float32)
    data[:, 0] = numpy.arange(100)

    def load(self):
        self.class_lengths[:] = [0, 20, 80]
        self.original_data = data
        self.original_labels = (numpy.arange(100) % 4).tolist()
    loader = type("Src", (cls,), {"load_data": load})(
        wf, minibatch_size=32, **seed_kw)
    loader.span_serving = False
    return loader


def test_minibatch_streams_cross_read(tmp_path):
    """A stream the port's saver writes replays in the JAX package's
    loader and the other way round, minibatch for minibatch."""
    from veles_tpu.loader.fullbatch import FullBatchLoader as JFB
    from veles_tpu.loader.saver import MinibatchesLoader as JLoad
    from veles_tpu.loader.saver import MinibatchesSaver as JSave
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    from veles_tpu_torch.loader.saver import (
        MinibatchesLoader, MinibatchesSaver)

    def record(src, saver_cls, dev, path):
        src.initialize(device=dev)
        saver = saver_cls(None, path=path)
        saver.loader = src
        saver.initialize()
        for _ in range(12):
            src.run()
            saver.run()
        saver.stop()
        src.stop()

    with jax_state():
        record(_stream(JFB, None, {}), JSave, _jdev(),
               str(tmp_path / "j.gz"))
    record(_stream(FullBatchLoader, None, {}), MinibatchesSaver, "cpu",
           str(tmp_path / "p.gz"))

    def chunks(path):
        with gzip.open(path, "rb") as f:
            out = [pickle.load(f)]
            while True:
                try:
                    ci, n, d, l = pickle.load(f)
                except EOFError:
                    return out
                out.append((ci, n, d.tolist(), l.tolist()))

    assert chunks(str(tmp_path / "p.gz")) == chunks(str(tmp_path / "j.gz"))
    with jax_state():
        jl = JLoad(None, path=str(tmp_path / "p.gz"))
        jl.initialize(device=_jdev())
        want = _served(jl, 8)
        # a running pipeline would draw the next epoch's shuffle from
        # the JAX package's process-wide generator after it is restored
        jl.stop()
    pl = MinibatchesLoader(None, path=str(tmp_path / "j.gz"))
    pl.initialize(device="cpu")
    got = _served(pl, 8)
    pl.stop()
    assert pl.class_lengths == jl.class_lengths
    _assert_same_waves(got, want)


def test_input_joiner_matches_jax():
    from veles_tpu.memory import Array as JArray
    from veles_tpu.ops.join import InputJoiner as J
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.ops.join import InputJoiner
    rng = numpy.random.default_rng(3)
    a = rng.normal(size=(4, 3)).astype(numpy.float32)
    b = rng.normal(size=(4, 2, 5)).astype(numpy.float32)
    c = rng.normal(size=(4, 2, 2, 2)).astype(numpy.float32)

    class Src:
        pass

    jsrc, psrc = Src(), Src()
    jsrc.c, psrc.c = JArray(c), Array(c)
    jj = J(None, inputs=[JArray(a), JArray(b)]).link_inputs(jsrc, "c")
    pj = InputJoiner(None, inputs=[Array(a), Array(b)]).link_inputs(
        psrc, "c")
    jj.initialize(device=_jdev())
    pj.initialize(device="cpu")
    jj.run()
    pj.run()
    assert pj.reads == jj.reads == ("input_0", "input_1", "input_2")
    want = numpy.asarray(jj.output.map_read().mem)
    got = pj.output.map_read().mem
    assert got.shape == want.shape == (4, 3 + 10 + 8)
    numpy.testing.assert_array_equal(got, want)
    from veles_tpu_torch.units import MissingDemand
    with pytest.raises(MissingDemand):
        InputJoiner(None).initialize(device="cpu")


# -- downloader ---------------------------------------------------------------

def _archive(tmp_path, kind):
    src = tmp_path / "payload.txt"
    src.write_text("hello")
    if kind == "zip":
        path = tmp_path / "payload.zip"
        with zipfile.ZipFile(path, "w") as z:
            z.write(src, arcname="data.txt")
    else:
        path = tmp_path / "payload.tar.gz"
        with tarfile.open(path, "w:gz") as t:
            t.add(src, arcname="data.txt")
    return path


@pytest.mark.parametrize("kind,scheme", [("tar", ""), ("zip", "file://")])
def test_downloader_unpacks_local_archive(kind, scheme, tmp_path):
    from veles_tpu_torch.downloader import Downloader
    archive = _archive(tmp_path, kind)
    dest = tmp_path / "dataset"
    d = Downloader(None, url=scheme + str(archive), directory=str(dest),
                   files=["data.txt"])
    d.initialize()
    assert (dest / "data.txt").read_text() == "hello"
    assert archive.exists()   # a local archive is never deleted
    # already complete: nothing is read
    Downloader(None, url="/nonexistent", directory=str(dest),
               files=["data.txt"]).initialize()
    with pytest.raises(RuntimeError, match="expected files"):
        Downloader(None, url=str(archive), directory=str(tmp_path / "o"),
                   files=["other.txt"]).initialize()


def test_downloader_missing_file_fails(tmp_path):
    from veles_tpu_torch.downloader import Downloader
    d = Downloader(None, url=str(tmp_path / "nope.tar"),
                   directory=str(tmp_path / "out"), files=["x"])
    with pytest.raises(FileNotFoundError):
        d.initialize()


def test_loader_exports_match_reference():
    import veles_tpu.loader as jl
    import veles_tpu_torch.loader as pl
    names = ("CLASS_NAME", "TEST", "TRAIN", "VALID", "ILoader", "Loader",
             "FullBatchLoader", "FullBatchLoaderMSE")
    for n in names:
        assert hasattr(pl, n) and hasattr(jl, n), n
    assert pl.CLASS_NAME == jl.CLASS_NAME


# -- FullBatchLoader's host gather ---------------------------------------------

def _synthetic(cls, wf, **kw):
    """The oracle's ``SyntheticLoader`` (``tests/test_loader.py``) over
    either package's ``FullBatchLoader``: 10/20/70 rows of 8 features,
    the first feature the row index, labels ``lbl<i % 3>``."""

    def load(self):
        rng = numpy.random.default_rng(0)
        data = rng.normal(size=(100, 8)).astype(numpy.float32)
        data[:, 0] = numpy.arange(100)
        self.class_lengths[:] = [10, 20, 70]
        self.original_data = data
        self.original_labels = ["lbl%d" % (i % 3) for i in range(100)]

    loader = type("Synthetic", (cls,), {"load_data": load})(
        wf, minibatch_size=16, **kw)
    loader.span_serving = False
    return loader


@pytest.mark.parametrize("mode", ["force_numpy", "over_budget"])
def test_fullbatch_host_gather_matches_device_and_jax(mode, monkeypatch):
    """``force_numpy=True`` (oracle ``tests/test_loader.py::
    TestDeviceGather::test_force_numpy_fallback``), and a dataset over
    0.8 of a budget patched small, keep the dataset on the host: no
    device copy, no span path, and every minibatch bit-equal to the
    device-resident loader's and to the JAX package's under
    ``force_numpy``."""
    from veles_tpu.loader.fullbatch import FullBatchLoader as JFB
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader

    def waves(loader, dev):
        loader.initialize(device=dev)
        out = _served(loader, 9)
        loader.stop()
        return loader, out

    _, resident = waves(_synthetic(FullBatchLoader, None), "cpu")
    if mode == "force_numpy":
        kw = {"force_numpy": True}
    else:
        kw = {}
        # 100 x 8 f32 rows are 3200 bytes: over 0.8 of 3000
        monkeypatch.setattr(FullBatchLoader, "device_budget",
                            lambda self: 3000)
    host, got = waves(_synthetic(FullBatchLoader, None, **kw), "cpu")
    assert host.dataset_dev is None and host.labels_dev is None
    assert not host.span_capable
    assert host.force_numpy == (mode == "force_numpy")
    _assert_same_waves(got, resident)
    with jax_state():
        jl, want = waves(_synthetic(JFB, None, force_numpy=True), _jdev())
        assert jl._dataset_dev_ is None
    _assert_same_waves(got, want)


def test_fullbatch_host_gather_targets(monkeypatch):
    """Regression targets stay on the host with the dataset and are
    gathered per minibatch, equal to the device-resident loader's."""
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    rng = numpy.random.default_rng(3)
    data = rng.normal(size=(40, 6)).astype(numpy.float32)
    targets = rng.normal(size=(40, 2)).astype(numpy.float32)
    out = []
    for force in (False, True):
        ld = FullBatchLoader(data, targets=targets, class_lengths=[0, 8, 32],
                             minibatch_size=12, seed=5, device="cpu",
                             force_numpy=force)
        ld.span_serving = False
        rows = []
        for _ in range(6):
            ld.run()
            rows.append((ld.minibatch_data.mem.copy(),
                         ld.minibatch_targets.mem.copy()))
        ld.stop()
        assert (ld.targets_dev is None) == force
        out.append(rows)
    for (d0, t0), (d1, t1) in zip(*out):
        numpy.testing.assert_array_equal(d0, d1)
        numpy.testing.assert_array_equal(t0, t1)
