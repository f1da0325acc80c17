"""The samples this slice adds — ``mnist_ae`` (FC and conv),
``mnist_forward`` and ``gtzan`` — held against the JAX package's on the
CPU, each through both command lines on the same argv (float32).
Oracles: ``tests/test_model_families.py::test_mnist_ae_trains`` and
``test_conv_ae_mechanics`` (the autoencoders), ``tests/
test_loader_breadth.py::test_mnist_forward_example`` (the inference
example, on snapshots and on exported packages) and ``test_sound_loader_separates_genres`` (the GTZAN loader
through ``gtzan_features.xml``, on a tree ``datasets.tones`` writes)."""

import json
import os

import numpy
import pytest

from tests.test_torch_cli import (  # noqa: F401 (fixture)
    F32, assert_results_close, assert_weights_close, cli_env, jax_sample,
    port_sample, run_jax, run_port)

pytestmark = pytest.mark.torch_port

AE = {
    "fc": ["-c", "root.mnist_tpu.update({'synthetic_train': 512, "
           "'synthetic_valid': 128})",
           "-c", "root.mnist_ae_tpu.update({'max_epochs': 3, "
           "'conv': False, 'minibatch_size': 128, 'hidden': 32})"],
    "conv": ["-c", "root.mnist_tpu.update({'synthetic_train': 128, "
             "'synthetic_valid': 64})",
             "-c", "root.mnist_ae_tpu.update({'max_epochs': 1, "
             "'conv': True, 'minibatch_size': 64})"],
}


@pytest.mark.parametrize("kind", sorted(AE))
def test_mnist_ae_against_reference(kind, cli_env):
    """Both autoencoders trained by both command lines from the same
    first weights (``--seed``'s generator): results and weights agree;
    the FC one learns (RMSE < 0.3, as the oracle's), the conv one is
    finite."""
    argv = AE[kind] + ["-c", F32, "-a", "numpy"]
    jm = run_jax([jax_sample("mnist_ae.py")] + argv + [
        "--result-file", str(cli_env / "j.json")])
    pm = run_port([port_sample("mnist_ae.py")] + argv + [
        "--result-file", str(cli_env / "p.json")])
    got = json.loads((cli_env / "p.json").read_text())
    assert_results_close(got, json.loads((cli_env / "j.json").read_text()))
    assert_weights_close(jm.workflow, pm.workflow)
    rmse = pm.workflow.rmse()
    assert abs(rmse - jm.workflow.rmse()) < 1e-5
    if kind == "fc":
        assert rmse < 0.3, rmse
    else:
        assert numpy.isfinite(rmse)
        from veles_tpu_torch.models.conv import Deconv
        from veles_tpu_torch.models.pooling import Depooling
        types = [type(u) for u in pm.workflow.forwards]
        assert Deconv in types and Depooling in types


def _digits(out):
    return [line for line in out.splitlines() if line.startswith("sample")]


def test_mnist_forward_example(cli_env, capsys):
    """The inference example on a JAX snapshot prints the JAX example's
    digits and confidences; on the port's own snapshot, its chain's; on
    an exported package — the JAX run's and the port's — the JAX
    example's lines for the same archive."""
    keys = ["-c", "root.mnist_tpu.update({'synthetic_train': 256, "
            "'synthetic_valid': 128, 'max_epochs': 2, "
            "'minibatch_size': 64, 'layers': [16, 10], "
            "'snapshot_time_interval': 0.0})", "-c", F32, "-a", "numpy"]
    jm = run_jax([jax_sample("mnist.py")] + keys)
    from veles_tpu.config import root as jroot
    from veles_tpu.samples.mnist_forward import main as jax_fwd
    from veles_tpu_torch.samples import mnist_forward
    snap = os.path.join(jroot.common.dirs.get("snapshots"),
                        "mnist_current.pickle.gz")
    from veles_tpu_torch.config import root
    # the port reads the JAX snapshot at its own compute dtype: float32,
    # as the JAX run's
    root.common.precision.compute_dtype = "float32"
    capsys.readouterr()
    assert jax_fwd([snap, "6"]) == 0
    want = _digits(capsys.readouterr().out)
    assert mnist_forward.main([snap, "6", "--device", "cpu"]) == 0
    got = _digits(capsys.readouterr().out)
    assert len(got) == 6 and got == want
    probs = mnist_forward.forward_from_snapshot(snap, 6, "cpu")
    numpy.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)
    pm = run_port([port_sample("mnist.py")] + keys)
    psnap = os.path.join(root.common.dirs.get("snapshots"),
                         "mnist_current.pickle.gz")
    # the snapshot names the workflow file's module ("mnist"); without
    # it loaded, the port's sample of that name is read
    import sys
    sys.modules.pop("mnist", None)
    assert mnist_forward.main([psnap, "4", "--device", "cpu"]) == 0
    assert len(_digits(capsys.readouterr().out)) == 4
    for m, name in ((jm, "jax.tar.gz"), (pm, "port.tar.gz")):
        pkg = str(cli_env / name)
        m.workflow.package_export(pkg, batch=8)
        assert jax_fwd([pkg, "5"]) == 0
        want = _digits(capsys.readouterr().out)
        assert mnist_forward.main([pkg, "5", "--device", "cpu"]) == 0
        got = _digits(capsys.readouterr().out)
        assert len(got) == 5 and got == want
    assert mnist_forward.main([]) == 2


@pytest.fixture(scope="module")
def tones_tree(tmp_path_factory):
    from veles_tpu_torch.datasets import tones
    return tones.generate(str(tmp_path_factory.mktemp("genres")),
                          tracks_per_genre=4, seconds=1.0, rate=8000)


def test_gtzan_loader_against_reference(tones_tree, cli_env):
    """The GTZAN loader reads the port's copy of gtzan_features.xml into
    the same features, labels and split as the JAX package's; the two
    command lines then train to the same results."""
    from veles_tpu.backends import Device
    from veles_tpu.config import root as jroot
    from veles_tpu.samples.gtzan import GtzanLoader as JaxLoader
    from veles_tpu_torch.samples.gtzan import FEATURES_XML, GtzanLoader
    with open(FEATURES_XML) as f, open(jax_sample(
            "gtzan_features.xml")) as g:
        assert f.read().split("-->", 1)[1] == g.read().split("-->", 1)[1]
    jroot.gtzan_tpu.update({"dataset_dir": tones_tree, "max_seconds": 1.0})
    want = JaxLoader(None, minibatch_size=4)
    want.initialize(device=Device(backend="numpy"))
    got = GtzanLoader(None, dataset_dir=tones_tree, max_seconds=1.0,
                      minibatch_size=4)
    got.initialize(device="cpu")
    assert got.class_lengths == want.class_lengths
    assert got.labels_mapping == want.labels_mapping
    assert len(got.labels_mapping) == 10
    numpy.testing.assert_allclose(got.original_data, want.original_data,
                                  rtol=1e-5, atol=1e-5)
    assert list(got._numeric_labels_) == list(want._numeric_labels)
    # separable genres: class means apart
    d, l = numpy.asarray(got.original_data), got._numeric_labels_
    assert numpy.linalg.norm(d[l == 0].mean(0) - d[l == 1].mean(0)) > 0.1
    argv = ["-c", "root.gtzan_tpu.update({'dataset_dir': %r, "
            "'max_seconds': 1.0, 'max_epochs': 3, 'minibatch_size': 8, "
            "'hidden': 16})" % tones_tree, "-c", F32, "-a", "numpy"]
    jm = run_jax([jax_sample("gtzan.py")] + argv + [
        "--result-file", str(cli_env / "j.json")])
    pm = run_port([port_sample("gtzan.py")] + argv + [
        "--result-file", str(cli_env / "p.json")])
    assert_results_close(json.loads((cli_env / "p.json").read_text()),
                         json.loads((cli_env / "j.json").read_text()))
    assert_weights_close(jm.workflow, pm.workflow)
