"""JAX package snapshots the port resumes that no other test covered
(item 9's leftovers): GTZAN's, VGG-A's, the space-to-depth AlexNet's,
the Kohonen workflow's and the RBM's trainer state.

- GTZAN (on SGD: see ``tests/test_torch_snapshot_jax.py`` on Adam's
  first steps), VGG-A and the space-to-depth AlexNet: the JAX ``Main``
  trains two epochs and writes its snapshot; both packages resume it for one
  more epoch (``-s``, ``--decision max_epochs=3``) and agree within 2e-5
  — results, steps, epochs and weights (``tests/test_torch_snapshot_jax.py``'s
  rule);
- Kohonen: the JAX package cannot resume its own Kohonen pickle (its
  ``ClustersLoader`` keeps no ``original_labels``), so the JAX snapshot
  resumed by the port is held to the port's own snapshot of the same
  epoch resumed the same way: the same map, clock, history and next
  epoch, bit for bit;
- the RBM: a JAX ``BernoulliRBM`` unit after two CD-1 steps, pickled,
  becomes the port's RBM (``BernoulliRBM.from_jax``) whose next step
  equals the JAX unit's next step — hidden samples bit-equal, the
  parameters within 1e-5."""

import gzip
import json
import os
import pickle

import numpy
import pytest

from tests.test_torch_cli import (  # noqa: F401 (fixture)
    F32, assert_results_close, assert_weights_close, cli_env, jax_sample,
    port_sample, run_jax, run_port)
from tests.test_torch_samples import tones_tree  # noqa: F401 (fixture)

pytestmark = pytest.mark.torch_port

ALEXNET = ("root.alexnet_tpu.update({'synthetic_train': 32, "
           "'synthetic_valid': 16, 'max_epochs': 2, 'minibatch_size': 16, "
           "'side': %d, 'classes': 10, 'snapshot_time_interval': 0.0%s})")

CASES = {
    "vgg_a": ("alexnet.py", "alexnet_current.pickle.gz",
              ["-c", ALEXNET % (32, ", 'model': 'vgg_a'")]),
    "alexnet_s2d": ("alexnet.py", "alexnet_current.pickle.gz",
                    ["-c", ALEXNET % (67, ", 'space_to_depth': 4")]),
    "gtzan": ("gtzan.py", "gtzan_current.pickle.gz",
              ["-c", "root.gtzan_tpu.update({'dataset_dir': %r, "
               "'max_seconds': 1.0, 'max_epochs': 2, 'minibatch_size': 8, "
               "'hidden': 16, 'solver': 'sgd', 'learning_rate': 0.01})"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_resumes_jax_snapshot(case, cli_env, tones_tree,
                                   monkeypatch):
    sample, snap_name, keys = CASES[case]
    # the JAX GTZAN sample sets no snapshot interval, and its
    # snapshotter's default is a 1 s wall-clock gate: without one, every
    # improved epoch snapshots, as the other samples' do
    from veles_tpu.snapshotter import SnapshotterBase
    defaults = list(SnapshotterBase.__init__.__defaults__)
    defaults[2] = 0.0     # time_interval
    monkeypatch.setattr(SnapshotterBase.__init__, "__defaults__",
                        tuple(defaults))
    if case == "gtzan":
        keys = [keys[0], keys[1] % tones_tree]
    argv = keys + ["-c", F32, "-a", "numpy"]
    run_jax([jax_sample(sample)] + argv)
    from veles_tpu.config import root as jroot
    snap = os.path.join(jroot.common.dirs.get("snapshots"), snap_name)
    more = ["-s", snap, "--decision", "max_epochs=3"]
    jm = run_jax([jax_sample(sample)] + more + argv + [
        "--result-file", str(cli_env / "j.json")])
    pm = run_port([port_sample(sample)] + more + argv + [
        "--result-file", str(cli_env / "p.json")])
    assert pm.restored
    assert pm.workflow.gd.global_step == jm.workflow.gd.global_step > 0
    assert pm.workflow.loader.epoch_number == \
        jm.workflow.loader.epoch_number == 3
    assert_results_close(json.loads((cli_env / "p.json").read_text()),
                         json.loads((cli_env / "j.json").read_text()))
    assert_weights_close(jm.workflow, pm.workflow)
    types = [type(u).__name__ for u in pm.workflow.forwards]
    if case == "vgg_a":
        assert types.count("ConvRELU") == 8
    if case == "alexnet_s2d":
        assert pm.workflow.forwards[0].space_to_depth == 4


KOHONEN = {"samples": 512, "minibatch_size": 128, "shape": (4, 4)}


def test_kohonen_jax_snapshot_resumes_like_the_ports(cli_env):
    from veles_tpu import prng
    from veles_tpu.backends import Device
    from veles_tpu.config import root as jroot
    from veles_tpu.samples.kohonen import KohonenWorkflow as JaxKohonen
    from veles_tpu_torch import jax_snapshot
    from veles_tpu_torch.samples.kohonen import KohonenWorkflow
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    jroot.kohonen_tpu.update(dict(KOHONEN, max_epochs=1))
    for g in ("kohonen", "loader", "trainer"):
        prng.get(g).seed(42)
    jwf = JaxKohonen(None)
    jwf.initialize(device=Device(backend="numpy"))
    jwf.run()
    jpath = cli_env / "kohonen_jax.pickle.gz"
    with gzip.open(jpath, "wb") as f:
        pickle.dump(jwf, f)
    pwf = KohonenWorkflow(max_epochs=1, seed=42, **KOHONEN)
    pwf.initialize(device="cpu")
    pwf.run()
    numpy.testing.assert_allclose(
        pwf.trainer.weights.numpy(),
        numpy.array(jwf.trainer.weights.map_read().mem), atol=2e-5)
    ppath = cli_env / "kohonen_port.pickle.gz"
    with gzip.open(ppath, "wb") as f:
        pickle.dump(pwf, f)
    resumed = []
    for path in (jpath, ppath):
        wf = SnapshotterToFile.import_file(str(path))
        assert type(wf) is KohonenWorkflow
        assert wf.trainer.time == 4 and wf.loader.epoch_number == 1
        wf.decision.max_epochs = 2
        wf.decision.complete.set(False)
        wf.initialize(device="cpu")
        wf.run()
        assert wf.loader.epoch_number == 2 and wf.trainer.time == 8
        resumed.append(wf)
    jres, pres = resumed
    numpy.testing.assert_allclose(jres.trainer.weights.numpy(),
                                  pres.trainer.weights.numpy(), atol=2e-5)
    numpy.testing.assert_allclose(jres.decision.epoch_qerror,
                                  pres.decision.epoch_qerror, atol=2e-5)
    rec = jax_snapshot.read_records(gzip.open(jpath).read())
    assert rec.jax_name == "veles_tpu.samples.kohonen.KohonenWorkflow"


def test_rbm_trainer_state_takes_the_next_step(cli_env):
    import jax
    import jax.numpy as jnp
    import torch
    from veles_tpu import prng
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.models.rbm import BernoulliRBM as JaxRBM
    from veles_tpu_torch import jax_snapshot
    from veles_tpu_torch.models.rbm import BernoulliRBM
    rng = numpy.random.default_rng(21)
    batches = [(rng.random((8, 10)) < 0.4).astype(numpy.float32)
               for _ in range(3)]
    gen = prng.get("rbm")
    with gen.preserve_state():
        gen.seed(31)
        jr = JaxRBM(AcceleratedWorkflow(None, name="t"), hidden=6,
                    learning_rate=0.5)
        w = numpy.zeros((10, 6), numpy.float32)
        jr.prng.fill_normal(w, 0.0, 0.01)
        jr.weights.reset(w)
        jr.vbias.reset(numpy.zeros(10, numpy.float32))
        jr.hbias.reset(numpy.zeros(6, numpy.float32))
        step = jr._build_step()

        def jax_step(v):
            key = jr.prng.peek_key(jr.global_step)
            out = step(jnp.asarray(jr.weights.mem), jnp.asarray(
                jr.vbias.mem), jnp.asarray(jr.hbias.mem), jnp.asarray(v),
                jnp.int32(len(v)), key)
            for arr, new in zip((jr.weights, jr.vbias, jr.hbias), out):
                arr.reset(numpy.array(new))
            jr.global_step += 1
            return key

        for v in batches[:2]:
            jax_step(v)
        blob = pickle.dumps(jr)
        rec = jax_snapshot.read_records(blob)
        rbm = BernoulliRBM.from_jax(rec, device="cpu")
        assert rbm.global_step == 2 and rbm.cd_k == 1
        assert rbm.learning_rate == 0.5 and rbm.hidden == 6
        for name in ("weights", "vbias", "hbias"):
            numpy.testing.assert_array_equal(
                getattr(rbm, name).numpy(), getattr(jr, name).mem)
        key = jax_step(batches[2])
        w_before = jnp.asarray(rec.get("weights").get("_mem"))
        hb = jnp.asarray(rec.get("hbias").get("_mem"))
        h0p = jax.nn.sigmoid(jnp.asarray(batches[2]) @ w_before + hb)
        want_h = numpy.asarray(jax.random.bernoulli(
            jax.random.fold_in(key, 0), h0p)).astype(numpy.float32)
    rbm.step(torch.as_tensor(batches[2]))
    numpy.testing.assert_array_equal(rbm.samples[0].numpy(), want_h)
    for name in ("weights", "vbias", "hbias"):
        numpy.testing.assert_allclose(getattr(rbm, name).numpy(),
                                      getattr(jr, name).mem, atol=1e-5)
