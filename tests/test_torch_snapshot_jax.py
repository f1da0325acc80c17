"""Snapshots of the JAX package resumed by the port, on the CPU.

The JAX ``Main`` trains MNIST, the conv MNIST autoencoder and the LM —
and CIFAR, the transformer and AlexNet (full widths at side 67) — at
small sizes in float32 and writes its snapshot; both packages resume it
for one more epoch (``-s`` with ``--decision max_epochs=3``), and the
two resumed runs agree within 2e-5: results files, closed-epoch
metrics, steps and weights.  The LM trains on SGD here: in its first
warm-up steps Adam turns rounding-level differences of near-zero
gradients into whole steps of either sign (the two packages' LM weights
then part by up to 6e-5), while the translated state itself is checked
exactly (``test_import_file_reads_jax_snapshot_without_cli``).

The port reads the file through ``veles_tpu_torch.jax_snapshot``
without importing ``jax``: each JAX class maps to the port's class of
the same name — the workflows ``MnistWorkflow``, ``MnistAEWorkflow``,
``LMWorkflow``, ``CifarWorkflow``, ``TransformerWorkflow`` and
``AlexNetWorkflow`` with their loaders (``MeanDispNormalizer``
included); the units ``All2AllTanh``, ``All2AllSoftmax``,
``All2AllRELU``, ``All2AllStrictRELU``, ``ConvRELU``,
``ConvStrictRELU``, ``MaxPooling``, ``AvgPooling``, ``Depooling``,
``Deconv``, ``LRNormalizerForward``, ``DropoutForward``, ``Embedding``,
``TransformerBlock``, ``MeanPoolSeq`` and ``TokenProjection``;
``GradientDescent``, ``DecisionGD``, ``SnapshotterToFile``,
``RandomGenerator``, ``Bool`` and ``memory.Array`` — and a pickle
naming anything else (``os.system``, a class the port lacks) raises
``UnpicklingError`` and runs nothing.  The ``safe_pickle`` cases are the
oracle's (``tests/test_services_misc.py``)."""

import gzip
import io
import json
import os
import pickle
import subprocess

import numpy
import pytest

from tests.test_torch_cli import (  # noqa: F401 (fixture)
    F32, assert_results_close, assert_weights_close, cli_env, jax_sample,
    port_sample, run_jax, run_port)

pytestmark = pytest.mark.torch_port

CASES = {
    "mnist": (
        "mnist.py", "mnist_current.pickle.gz",
        ["-c", "root.mnist_tpu.update({'synthetic_train': 256, "
         "'synthetic_valid': 128, 'max_epochs': 2, 'minibatch_size': 64, "
         "'layers': [16, 10], 'snapshot_time_interval': 0.0})"]),
    "mnist_ae_conv": (
        "mnist_ae.py", "mnist_ae_current.pickle.gz",
        ["-c", "root.mnist_tpu.update({'synthetic_train': 128, "
         "'synthetic_valid': 64})",
         "-c", "root.mnist_ae_tpu.update({'max_epochs': 2, 'conv': True, "
         "'minibatch_size': 32})"]),
    "lm": (
        "lm.py", "lm_current.pickle.gz",
        ["-c", "root.lm_tpu.update({'max_epochs': 2, 'dim': 32, "
         "'blocks': 1, 'heads': 2, 'seq': 16, 'vocab': 16, "
         "'synthetic_train': 128, 'synthetic_valid': 32, "
         "'minibatch_size': 32, 'snapshot_time_interval': 0.0, "
         "'solver': 'sgd', 'learning_rate': 0.05})"]),
    "cifar": (
        "cifar.py", "cifar_current.pickle.gz",
        ["-c", "root.cifar_tpu.update({'synthetic_train': 128, "
         "'synthetic_valid': 64, 'max_epochs': 2, 'minibatch_size': 32, "
         "'solver': 'sgd', 'learning_rate': 0.01, "
         "'snapshot_time_interval': 0.0})"]),
    "transformer": (
        "transformer.py", "transformer_current.pickle.gz",
        ["-c", "root.transformer_tpu.update({'synthetic_train': 128, "
         "'synthetic_valid': 64, 'max_epochs': 2, 'minibatch_size': 32, "
         "'dim': 32, 'heads': 2, 'blocks': 1, 'seq': 16, 'solver': 'sgd', "
         "'learning_rate': 0.01, 'snapshot_time_interval': 0.0})"]),
    "alexnet": (
        "alexnet.py", "alexnet_current.pickle.gz",
        ["-c", "root.alexnet_tpu.update({'synthetic_train': 32, "
         "'synthetic_valid': 16, 'max_epochs': 2, 'minibatch_size': 16, "
         "'side': 67, 'classes': 10, 'snapshot_time_interval': 0.0})"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_resumes_jax_snapshot(case, cli_env, monkeypatch):
    sample, snap_name, keys = CASES[case]
    argv = keys + ["-c", F32, "-a", "numpy"]
    # the JAX autoencoder sample sets no snapshot interval, and its
    # snapshotter's default is a 1 s wall-clock gate: without one, the
    # improved epochs snapshot as MNIST's and the LM's do
    from veles_tpu.snapshotter import SnapshotterBase
    defaults = list(SnapshotterBase.__init__.__defaults__)
    defaults[2] = 0.0     # time_interval
    monkeypatch.setattr(SnapshotterBase.__init__, "__defaults__",
                        tuple(defaults))
    run_jax([jax_sample(sample)] + argv)
    from veles_tpu.config import root as jroot
    snap = os.path.join(jroot.common.dirs.get("snapshots"), snap_name)
    more = ["-s", snap, "--decision", "max_epochs=3"]
    jm = run_jax([jax_sample(sample)] + more + argv + [
        "--result-file", str(cli_env / "j.json")])
    pm = run_port([port_sample(sample)] + more + argv + [
        "--result-file", str(cli_env / "p.json")])
    assert pm.restored
    assert type(pm.workflow).__module__ == os.path.splitext(sample)[0]
    assert pm.workflow.gd.global_step == jm.workflow.gd.global_step > 0
    assert pm.workflow.loader.epoch_number == \
        jm.workflow.loader.epoch_number
    assert_results_close(json.loads((cli_env / "p.json").read_text()),
                         json.loads((cli_env / "j.json").read_text()))
    assert_weights_close(jm.workflow, pm.workflow)


def test_import_file_reads_jax_snapshot_without_cli(cli_env):
    """``SnapshotterToFile.import_file`` alone: the workflow of a JAX
    MNIST snapshot, its parameters and trainer state the file's."""
    sample, snap_name, keys = CASES["mnist"]
    run_jax([jax_sample(sample)] + keys + ["-c", F32, "-a", "numpy"])
    from veles_tpu.config import root as jroot
    from veles_tpu.snapshotter import SnapshotterToFile as JaxSnap
    from veles_tpu_torch.samples.mnist import MnistWorkflow
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    path = os.path.join(jroot.common.dirs.get("snapshots"), snap_name)
    wf = SnapshotterToFile.import_file(path)
    want = JaxSnap.import_file(path)
    assert isinstance(wf, MnistWorkflow) and wf._restored_from_snapshot_
    assert wf.gd.global_step == want.gd.global_step
    assert wf.loader.epoch_number == want.loader.epoch_number
    assert bool(wf.decision.complete) == bool(want.decision.complete)
    assert wf.decision.min_validation_n_err == \
        want.decision.min_validation_n_err
    numpy.testing.assert_array_equal(
        wf.loader.shuffled_indices.mem, want.loader.shuffled_indices.mem)
    assert_weights_close(want, wf, tol=0)
    for (i, name), slots in wf.gd.opt_state.items():
        for slot, t in slots.items():
            numpy.testing.assert_array_equal(
                t.numpy(), want.gd.opt_state[i][name][slot].map_read().mem)


def test_import_db_reads_jax_snapshot(cli_env):
    """A JAX ``SnapshotterToDB`` store on sqlite: the port's
    ``import_db`` (and ``-s sqlite:``) reads the JAX workflow from it."""
    sample, _, keys = CASES["mnist"]
    jm = run_jax([jax_sample(sample)] + keys + ["-c", F32, "-a", "numpy"])
    from veles_tpu.snapshotter import SnapshotterToDB as JaxDB
    from veles_tpu_torch.snapshotter import SnapshotterToDB
    db = str(cli_env / "jax.db")
    unit = JaxDB(jm.workflow, odbc="sqlite:" + db, prefix="mnist")
    unit.initialize()
    unit.export()
    wf = SnapshotterToDB.import_db("sqlite:" + db, prefix="mnist")
    assert type(wf).__name__ == "MnistWorkflow"
    assert wf.gd.global_step == jm.workflow.gd.global_step
    assert_weights_close(jm.workflow, wf, tol=0)
    pm = run_port([port_sample(sample), "-s", "sqlite:%s#veles/mnist" % db,
                   "--decision", "max_epochs=3", "--decision",
                   "complete=False"] + keys + ["-c", F32, "-a", "numpy"])
    assert pm.restored and pm.workflow.decision.max_epochs == 3
    assert pm.workflow.gd.global_step > jm.workflow.gd.global_step


def _jax_blob(*objs):
    """A pickle stream that names ``veles_tpu`` (so it is read as a JAX
    snapshot) and then holds ``objs``."""
    buf = io.BytesIO()
    pickle.dump(("veles_tpu.models.gd",) + objs, buf)
    return buf.getvalue()


class _Evil:
    def __reduce__(self):
        return (os.system, ("echo pwned",))


def test_jax_snapshot_refuses_other_classes(tmp_path):
    from veles_tpu_torch import jax_snapshot
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    with pytest.raises(pickle.UnpicklingError, match="system"):
        jax_snapshot.read_records(_jax_blob(_Evil()))
    with pytest.raises(pickle.UnpicklingError, match="getoutput"):
        jax_snapshot.read_records(_jax_blob(subprocess.getoutput))
    # a class the port lacks (a GLOBAL opcode naming it)
    with pytest.raises(pickle.UnpicklingError,
                       match="veles_tpu.models.nowhere.Unknown"):
        jax_snapshot.read_records(
            b"cveles_tpu.models.nowhere\nUnknown\n.")
    with pytest.raises(pickle.UnpicklingError, match="veles_tpu.nn.X"):
        jax_snapshot.read_records(b"cveles_tpu.nn\nX\n.")
    # through import_file too: a file naming os.system is refused
    path = str(tmp_path / "evil.pickle.gz")
    with gzip.open(path, "wb") as f:
        f.write(_jax_blob(_Evil()))
    with pytest.raises(pickle.UnpicklingError):
        SnapshotterToFile.import_file(path)
    # a record of a known class that is not a workflow cannot resume
    from veles_tpu.mutable import Bool
    with pytest.raises(pickle.UnpicklingError, match="cannot resume"):
        jax_snapshot.load(pickle.dumps(Bool(True)))


def test_safe_pickle_blocks_code_execution():
    """``tests/test_services_misc.py::test_safe_pickle_blocks_code_
    execution`` against the port's copy."""
    from veles_tpu_torch.safe_pickle import safe_loads
    data = {"x": numpy.arange(6, dtype=numpy.float32).reshape(2, 3),
            "label": 3, "name": "batch", "nested": [(1, 2.5), b"raw"]}
    out = safe_loads(pickle.dumps(data, protocol=pickle.HIGHEST_PROTOCOL))
    assert numpy.array_equal(out["x"], data["x"])
    assert out["nested"] == data["nested"]
    with pytest.raises(pickle.UnpicklingError):
        safe_loads(pickle.dumps(_Evil()))
    with pytest.raises(pickle.UnpicklingError):
        safe_loads(pickle.dumps(subprocess.getoutput))


def test_safe_pickle_bf16_roundtrip():
    """``tests/test_services_misc.py::test_safe_pickle_bf16_roundtrip``
    against the port's copy."""
    import ml_dtypes
    from veles_tpu_torch.safe_pickle import safe_loads
    a = numpy.arange(6, dtype=ml_dtypes.bfloat16).reshape(2, 3)
    out = safe_loads(pickle.dumps(a, protocol=pickle.HIGHEST_PROTOCOL))
    assert out.dtype == ml_dtypes.bfloat16
    assert numpy.array_equal(out.astype(numpy.float32),
                             a.astype(numpy.float32))


def test_warn_if_public():
    from veles_tpu_torch.safe_pickle import warn_if_public
    seen = []

    class Log:
        def warning(self, msg, *args):
            seen.append(msg % args)
    for ep in ("tcp://127.0.0.1:5555", "ipc:///tmp/x", "inproc://a"):
        warn_if_public(ep, Log())
    assert seen == []
    warn_if_public("tcp://0.0.0.0:5555", Log())
    assert len(seen) == 1 and "0.0.0.0" in seen[0]
