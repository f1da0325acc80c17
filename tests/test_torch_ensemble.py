"""Ensembles in the PyTorch port (``veles_tpu_torch/ensemble``,
``loader/ensemble.py`` and the loader's train ratio) held against the
JAX package's on the CPU (the oracle is ``tests/test_genetics_ensemble.
py``):

- ``root.common.ensemble_train_ratio`` sub-samples the train span: the
  per-minibatch and the span path serve the JAX loader's indices for
  the same seed;
- ``EnsembleTrainer``'s command lines and summary keys and
  ``EnsembleTester``'s output are the JAX package's, under the same
  injected runs;
- ``EnsembleLoader``'s features are the JAX loader's from the same
  snapshots (the JAX package's, read through ``jax_snapshot``), and the
  port's own snapshots' chains;
- ``--ensemble-train 2`` then ``--ensemble-test`` through
  ``python -m veles_tpu_torch``.

Every subprocess has its own timeout."""

import json
import os
import subprocess
import sys

import numpy
import pytest
import torch

from tests.test_torch_workflow import jax_state

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_loaders(n_valid=16, n_train=40, features=6):
    """The same dataset as a JAX and as a port FullBatchLoader class."""
    from veles_tpu.loader.fullbatch import FullBatchLoader as J
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader as P

    def load(self):
        rng = numpy.random.default_rng(3)
        self.class_lengths[:] = [0, n_valid, n_train]
        self.original_data = rng.normal(
            size=(n_valid + n_train, features)).astype(numpy.float32)
        self.original_labels = rng.integers(
            0, 3, n_valid + n_train).tolist()
    return (type("Tiny", (J,), {"load_data": load}),
            type("Tiny", (P,), {"load_data": load}))


def _waves(loader, waves, spans):
    out = []
    for _ in range(waves):
        if spans:
            loader.serve_span() if hasattr(loader, "serve_span") \
                else loader._serve_span()
            idx = numpy.array(loader.span_indices_).ravel().tolist()
        else:
            loader.run()
            idx = [int(i) for i in
                   loader.minibatch_indices.mem[:loader.minibatch_size]]
        out.append((loader.minibatch_class, loader.minibatch_size,
                    loader.epoch_number, bool(loader.epoch_ended),
                    bool(loader.train_ended), idx))
    return out


@pytest.mark.parametrize("spans", [False, True], ids=["minibatch", "span"])
def test_train_ratio_split_matches_reference(spans):
    """``root.common.ensemble_train_ratio = 0.75``: three epochs of
    waves — classes, sizes, flags and indices — equal the JAX
    loader's, and each epoch's train span holds 30 of the 40 train
    samples."""
    from veles_tpu.backends import Device
    from veles_tpu.config import root as jroot
    from veles_tpu_torch.config import root
    J, P = _tiny_loaders()
    waves = 9 if spans else 3 * (2 + 4)
    with jax_state():
        jroot.common.ensemble_train_ratio = 0.75
        try:
            jl = J(None, minibatch_size=8, prefetch=0)
            jl.initialize(device=Device(backend="numpy"))
            want = _waves(jl, waves, spans)
        finally:
            jl.stop()
            jroot.common.ensemble_train_ratio = None
    root.common.ensemble_train_ratio = 0.75
    try:
        pl = P(None, minibatch_size=8, prefetch=0)
        pl.initialize(device="cpu")
        got = _waves(pl, waves, spans)
    finally:
        pl.stop()
        root.common.ensemble_train_ratio = None
    assert pl.train_ratio == jl.train_ratio == 0.75
    assert pl.effective_total_samples == 16 + 30
    assert got == want
    served = []
    for c, _, _, _, train_ended, idx in got:
        if c == 2:
            served += [i for i in idx if i >= 0]
            if train_ended:
                break
    assert len(served) == 30 and len(set(served)) == 30


def _fake_results(i):
    return {"validation_error_pct": 10.0 + i, "Snapshot": "s%d.pickle" % i,
            "Total epochs": 2}


def test_ensemble_trainer_argv_and_summary(tmp_path, monkeypatch):
    """Both trainers call the command line with the same arguments (the
    JAX one after its interpreter and module) and write summaries of
    the same keys and values, one failed instance included."""
    import veles_tpu.ensemble as jens
    import veles_tpu_torch.ensemble as pens
    calls = {"jax": [], "port": []}

    def fake(tag):
        def run(argv, timeout=None):
            calls[tag].append((list(argv), timeout))
            i = len(calls[tag]) - 1
            return None if i == 2 else _fake_results(i)
        return run

    monkeypatch.setattr(jens, "_run_cli", fake("jax"))
    monkeypatch.setattr(pens, "_run_cli", fake("port"))
    kw = dict(size=3, train_ratio=0.75, base_overrides=["root.a = 1"],
              extra_argv=["-a", "cpu"], timeout=90)
    js = jens.EnsembleTrainer("wf.py", "cfg.py", **kw).run(
        output_path=str(tmp_path / "j.json"))
    ps = pens.EnsembleTrainer("wf.py", "cfg.py", **kw).run(
        output_path=str(tmp_path / "p.json"))
    assert [(a[3:], t) for a, t in calls["jax"]] == calls["port"]
    assert calls["port"][1][0] == [
        "wf.py", "cfg.py", "-c", "root.a = 1", "-c",
        "root.common.snapshot_suffix = 'ens1'", "-c",
        "root.common.ensemble_train_ratio = 0.75", "--seed", "4243",
        "-a", "cpu"]
    assert ps == js
    assert json.loads((tmp_path / "p.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())
    assert ps["succeeded"] == 2 and [i["seed"] for i in ps["instances"]] \
        == [4242, 4243, 4244]


def test_ensemble_tester_matches_reference(tmp_path, monkeypatch):
    """Both testers run the summary's snapshots (a missing one reported
    as such) with the same arguments and write the same output."""
    import veles_tpu.ensemble as jens
    import veles_tpu_torch.ensemble as pens
    snap = tmp_path / "s0.pickle"
    snap.write_bytes(b"x")
    summary = {"size": 2, "workflow_file": "wf.py", "config_file": "cfg.py",
               "base_overrides": ["root.a = 1"],
               "instances": [{"index": 0, "snapshot": str(snap)},
                             {"index": 1, "snapshot": str(tmp_path / "no")}]}
    path = tmp_path / "ens.json"
    path.write_text(json.dumps(summary))
    calls = {"jax": [], "port": []}
    for tag, mod in (("jax", jens), ("port", pens)):
        monkeypatch.setattr(mod, "_run_cli", lambda argv, timeout=None,
                            tag=tag: calls[tag].append(list(argv))
                            or {"validation_error_pct": 1.5})
    jo = jens.EnsembleTester(str(path), extra_argv=["-v"]).run(
        output_path=str(tmp_path / "jt.json"))
    po = pens.EnsembleTester(str(path), extra_argv=["-v"]).run(
        output_path=str(tmp_path / "pt.json"))
    assert [a[3:] for a in calls["jax"]] == calls["port"] == [
        ["wf.py", "cfg.py", "-c", "root.a = 1", "--snapshot", str(snap),
         "-v"]]
    assert po == jo and po["tests"][1] == {"index": 1,
                                           "error": "snapshot missing"}


def _base_pair():
    """A 784-feature base dataset as a JAX and a port loader."""
    from veles_tpu.loader.fullbatch import FullBatchLoader as J
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader as P

    def load(self):
        rng = numpy.random.default_rng(9)
        self.class_lengths[:] = [0, 24, 40]
        self.original_data = rng.normal(size=(64, 784)).astype(
            numpy.float32)
        self.original_labels = rng.integers(0, 10, 64).tolist()
    return (type("Base", (J,), {"load_data": load}),
            type("Base", (P,), {"load_data": load}))


def test_ensemble_loader_matches_reference(tmp_path):
    """Two JAX MNIST snapshots (different weights) as an ensemble: the
    port's ``EnsembleLoader`` reads them through ``jax_snapshot`` and
    its features — both chains' outputs side by side, computed in
    chunks — equal the JAX loader's; the labels are the base's."""
    from veles_tpu import prng
    from veles_tpu.backends import Device
    from veles_tpu.loader.ensemble import EnsembleLoader as JEnsemble
    from veles_tpu.samples.mnist import MnistWorkflow
    from veles_tpu_torch.config import root
    from veles_tpu_torch.loader.ensemble import EnsembleLoader
    keys = dict(synthetic_train=64, synthetic_valid=32, minibatch_size=32,
                snapshot_time_interval=1e9)
    snaps = []
    JBase, PBase = _base_pair()
    with jax_state("mnist_tpu", tmp_path, **keys):
        for i in range(2):
            prng.get().seed(100 + i)
            wf = MnistWorkflow(None, layers=[24, 10])
            wf.initialize(device=Device(backend="numpy"))
            wf.snapshotter.suffix = "ens%d" % i
            wf.snapshotter.export()
            snaps.append(wf.snapshotter.destination)
        summary = tmp_path / "ens.json"
        summary.write_text(json.dumps({"instances": [
            {"snapshot": s} for s in snaps]}))
        jl = JEnsemble(None, summary_path=str(summary),
                       base_loader=JBase(None), batch=24)
        jl.initialize(device=Device(backend="numpy"))
        want = numpy.array(jl.original_data)
        jl.stop()
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    try:
        pl = EnsembleLoader(None, summary_path=str(summary),
                            base_loader=PBase(None), batch=24)
        pl.initialize(device="cpu")
    finally:
        root.common.precision.compute_dtype = saved
    got = pl.original_data
    assert torch.is_tensor(got) and got.shape == (64, 20) == want.shape
    numpy.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert list(pl.class_lengths) == [0, 24, 40]
    assert pl.original_labels == jl.original_labels
    pl.stop()


def test_ensemble_loader_reads_port_snapshots(tmp_path):
    """The port's own snapshots: each instance's block of features is
    its chain's forward over the base data."""
    from veles_tpu_torch.loader.ensemble import EnsembleLoader
    from veles_tpu_torch.samples.mnist import MnistWorkflow
    _, PBase = _base_pair()
    snaps, chains = [], []
    for i in range(2):
        wf = MnistWorkflow(layers=[16, 10], synthetic_train=64,
                           synthetic_valid=32, minibatch_size=32,
                           dtype="float32", weights_seed=i,
                           snapshotter_config={"directory": str(tmp_path),
                                               "suffix": "ens%d" % i})
        wf.initialize(device="cpu")
        wf.snapshotter.export()
        snaps.append(wf.snapshotter.destination)
        chains.append(wf.forwards)
    summary = tmp_path / "ens.json"
    summary.write_text(json.dumps({"instances": [{"snapshot": s}
                                                 for s in snaps]}))
    pl = EnsembleLoader(None, summary_path=str(summary),
                        base_loader=PBase(None), batch=16)
    pl.initialize(device="cpu")
    base = PBase(None)
    base.load_data()
    x = torch.as_tensor(base.original_data)
    with torch.no_grad():
        for k, chain in enumerate(chains):
            h = x
            for u in chain:
                h = u.apply(h)
            numpy.testing.assert_allclose(
                pl.original_data[:, 10 * k:10 * k + 10].numpy(),
                h.numpy(), rtol=1e-6, atol=1e-7)
    pl.stop()


def test_ensemble_loader_needs_a_summary():
    from veles_tpu_torch.loader.ensemble import EnsembleLoader
    with pytest.raises(ValueError, match="summary_path"):
        EnsembleLoader(None, base_loader=object())


TINY = ("root.mnist_tpu.update({'max_epochs':1,'synthetic_train':512,"
        "'synthetic_valid':128,'snapshot_time_interval':0.0,"
        "'minibatch_size':128})")


def test_cli_ensemble_train_and_test(tmp_path):
    """``--ensemble-train 2 --train-ratio 0.75`` then ``--ensemble-test``
    through ``python -m veles_tpu_torch`` on the CPU."""
    sample = os.path.join(REPO, "veles_tpu_torch", "samples")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = tmp_path / "ens.json"
    r = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch",
         os.path.join(sample, "mnist.py"),
         os.path.join(sample, "mnist_config.py"), "-a", "cpu",
         "--ensemble-train", "2", "--train-ratio", "0.75", "-c", TINY,
         "--result-file", str(out)],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=120)
    assert r.returncode == 0, r.stderr[-800:]
    summary = json.loads(out.read_text())
    assert summary["succeeded"] == 2
    snaps = [i["snapshot"] for i in summary["instances"]]
    assert all(s and os.path.isfile(s) for s in snaps)
    assert len(set(snaps)) == 2
    errs = [i["results"]["validation_error_pct"]
            for i in summary["instances"]]
    assert errs[0] != errs[1]
    test_out = tmp_path / "test.json"
    r = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "--ensemble-test",
         str(out), "-a", "cpu", "--result-file", str(test_out)],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=120)
    assert r.returncode == 0, r.stderr[-800:]
    tested = json.loads(test_out.read_text())
    assert len(tested["tests"]) == 2
    assert all(t.get("results") for t in tested["tests"])
