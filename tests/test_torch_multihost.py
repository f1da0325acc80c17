"""A gang of processes over ``torch.distributed`` (the port's
``parallel/multihost.py``) on the CPU, held against the JAX package's
in-process mesh — the port of ``tests/test_multihost.py``.

Two worker processes (this file run as a script) join one gloo gang
with 2 positions each (``set_positions_per_device(2)``), so the global
mesh has 4 positions, 2 of them local.  Each worker:

1. sums a ``{"dp": 4}``-sharded ``arange(16)`` with the gang's psum
   (120.0 in both);
2. trains ``build_mlp_classifier`` over ``{"dp": 4}`` for 5 minibatches
   from the JAX package's loader, from the JAX trainer's first weights:
   its losses must be bit-equal across the two processes, and losses
   and final parameters within 1e-5 of the JAX package's in-process
   ``{"dp": 4}`` run on the same weights and minibatches;
3. pickles its workflow (the mesh persists as its axis spec), resumes
   it over the gang's positions, finds the state it pickled, and
   trains 2 more minibatches, bit-equal across the processes;
4. trains the same 5 minibatches over ``{"fsdp": 4}``, whose
   parameter gathers cross the gang: bit-equal across the processes and
   within 1e-5 of the JAX run.

Every worker has its own timeout of 120 s, so a hang fails the test
instead of stalling the suite; each leaves the gang
(``destroy_process_group``) before it exits."""

import os
import pickle
import socket
import subprocess
import sys

import numpy
import pytest
import torch

from veles_tpu_torch.loader import FullBatchLoader

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, RESUMED = 5, 2
TOL = 1e-5


# -- the worker (this file as a script) ---------------------------------------

class GangLoader(FullBatchLoader):
    """The minibatches' rows as one train span, read from the data file
    (module level, so a pickled workflow's loader resumes)."""

    def __init__(self, workflow=None, path=None, **kwargs):
        super(GangLoader, self).__init__(workflow, **kwargs)
        self.path = path

    def load_data(self):
        data = numpy.load(self.path)
        n = int(data["n"])
        self.original_data = numpy.concatenate(
            [data["x%d" % i] for i in range(n)])
        self.original_labels = (numpy.concatenate(
            [data["y%d" % i] for i in range(n)]).astype(int) % 4).tolist()
        self.class_lengths[:] = [0, 0, len(self.original_data)]


def _proof(key, value):
    print("PROOF %s=%s" % (key, value), flush=True)


def worker(address, nproc, rank, data_path, out_path):
    torch.set_num_threads(1)
    from veles_tpu_torch.convert import params_to_numpy
    from veles_tpu_torch.models.gd import GradientDescent
    from veles_tpu_torch.models.standard import build_mlp_classifier
    from veles_tpu_torch.parallel import collectives, multihost
    from veles_tpu_torch.parallel.mesh import set_positions_per_device
    from veles_tpu_torch.parallel.sharding import P
    set_positions_per_device(2)
    gang = multihost.initialize(address, nproc, rank, device="cpu")
    try:
        mesh = multihost.global_mesh({"dp": 4})
        _proof("process", "%d/%d positions=%d local=%d transport=%s" % (
            gang.process_id, gang.num_processes, mesh.size,
            sum(map(mesh.is_local, range(mesh.size))), gang.transport))
        # 1. a sharded sum across the gang
        x = numpy.arange(16, dtype=numpy.float32).reshape(4, 4)
        shards = multihost.global_put(x, mesh, P("dp", None))
        parts = [s.sum() if s is not None else None for s in shards]
        sums = collectives.psum(parts, procs=mesh.processes)
        _proof("sum", float(next(s for s in sums if s is not None)))
        # 2. the classifier over the gang's {"dp": 4}
        data = numpy.load(data_path)
        n = int(data["n"])
        batches = [(data["x%d" % i], data["y%d" % i], int(data["size"][i]),
                    int(data["cls"][i])) for i in range(n)]
        init = {i: {k.split("/")[1]: data[k] for k in data.files
                    if k.startswith("p%d/" % i)} for i in range(2)}
        loader = GangLoader(None, path=data_path, minibatch_size=64)
        wf, layers, _, gd = build_mlp_classifier(
            "cpu", loader, hidden=(16,), classes=4, mesh={"dp": 4},
            dtype="float32", learning_rate=0.1, gradient_moment=0.9)
        assert gd.mesh.spans_processes and gd.plan_.gang
        gd.write_state(params=init)

        def steps(trainer, chunk):
            out = []
            for xb, yb, size, cls in chunk:
                loss, _, _ = trainer.run_minibatch(
                    torch.as_tensor(xb), torch.as_tensor(yb), size, cls)
                out.append(float(loss).hex())
            return out

        _proof("losses", ",".join(steps(gd, batches[:STEPS])))
        final = params_to_numpy(layers)
        numpy.savez(out_path, **{"%d/%s" % (i, k): v
                                 for i, ps in final.items()
                                 for k, v in ps.items()})
        # 3. the mesh snapshot resumes over the gang
        slots = gd.state_tensors()[1]
        wf2 = pickle.loads(pickle.dumps(wf))
        gd2 = next(u for u in wf2.units if isinstance(u, GradientDescent))
        assert gd2.mesh == {"__mesh_axes__": {"dp": 4}}, gd2.mesh
        gd2.loader.initialize(device="cpu")
        gd2.initialize(device="cpu")
        assert gd2.mesh.shape == {"dp": 4} and gd2.mesh.spans_processes
        assert {gd2.mesh.process(p) for p in range(4)} == {0, 1}
        back = params_to_numpy(gd2.forwards)
        for i in final:
            for k in final[i]:
                assert numpy.array_equal(back[i][k], final[i][k])
        for key, s in gd2.state_tensors()[1].items():
            for name, t in s.items():
                assert torch.equal(t, slots[key][name])
        _proof("resumed", ",".join(steps(gd2, batches[STEPS:])))
        # 4. fsdp across the processes: every gather crosses the gang
        loader3 = GangLoader(None, path=data_path, minibatch_size=64)
        _, _, _, gd3 = build_mlp_classifier(
            "cpu", loader3, hidden=(16,), classes=4, mesh={"fsdp": 4},
            dtype="float32", learning_rate=0.1, gradient_moment=0.9)
        gd3.write_state(params=init)
        _proof("fsdp", ",".join(steps(gd3, batches[:STEPS])))
        multihost.sync_global_devices("done")
    finally:
        multihost.shutdown()
    return 0


# -- the test -----------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _jax_dp4():
    """The JAX trainer over an in-process ``{"dp": 4}`` on the suite's
    virtual devices: its minibatches, first weights, losses and final
    weights."""
    from veles_tpu import prng
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.backends import Device
    from tests.test_models import BlobsLoader
    from tests.test_torch_parallel import (
        _build_jax_mlp, _jax_mesh, jax_streams)
    with jax_streams():
        prng.get("dist").seed(99)
        prng.get("default").seed(7)
        wf = AcceleratedWorkflow(None, name="torch-gang")
        loader = BlobsLoader(wf, minibatch_size=64, prng_key="dist")
        loader.span_serving = False
        try:
            layers, gd = _build_jax_mlp(Device(backend="numpy"), wf, loader,
                                        _jax_mesh({"dp": 4}))
            init = [{n: numpy.array(a.map_read().mem)
                     for n, a in u.param_arrays().items()} for u in layers]
            batches, losses = [], []
            for _ in range(STEPS + RESUMED):
                loader.run()
                batches.append((
                    numpy.array(loader.minibatch_data.map_read().mem),
                    numpy.array(loader.minibatch_labels.map_read().mem),
                    int(loader.minibatch_size),
                    int(loader.minibatch_class)))
                gd.run()
                gd.loss.map_read()
                losses.append(float(gd.loss.mem))
                if len(batches) == STEPS:
                    final = [{n: numpy.array(a.map_read().mem)
                              for n, a in u.param_arrays().items()}
                             for u in layers]
        finally:
            loader.stop()
    return batches, init, losses, final


def test_initialize_without_a_gang_is_single(monkeypatch):
    from veles_tpu_torch.parallel import multihost
    for name in ("VELES_TPU_COORDINATOR", "VELES_TPU_NUM_PROCESSES",
                 "VELES_TPU_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize() == (0, 1, None)
    assert multihost.initialize(num_processes=1) == (0, 1, None)
    assert not multihost.is_gang()
    assert multihost.process_allgather({"a": 1}) == [{"a": 1}]
    mesh = multihost.global_mesh({"dp": 1}, device="cpu")
    assert not mesh.spans_processes and mesh.is_local(0)
    with pytest.raises(ValueError, match="process count"):
        multihost.initialize(coordinator_address="127.0.0.1:1")


def test_two_process_gang_trains(tmp_path):
    root_cfg = __import__("veles_tpu.config", fromlist=["root"]).root
    saved = root_cfg.common.precision.get("compute_dtype", "bfloat16")
    root_cfg.common.precision.compute_dtype = "float32"
    try:
        batches, init, want_losses, want_final = _jax_dp4()
    finally:
        root_cfg.common.precision.compute_dtype = saved
    assert sum(b[3] == 2 for b in batches[:STEPS]) > 2   # train steps
    arrays = {"n": numpy.array(len(batches)),
              "size": numpy.array([b[2] for b in batches]),
              "cls": numpy.array([b[3] for b in batches])}
    for i, (xb, yb, _, _) in enumerate(batches):
        arrays["x%d" % i], arrays["y%d" % i] = xb, yb
    for i, layer in enumerate(init):
        for k, v in layer.items():
            arrays["p%d/%s" % (i, k)] = v
    data = tmp_path / "gang.npz"
    numpy.savez(data, **arrays)
    address = "127.0.0.1:%d" % _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(__file__), address, "2",
         str(r), str(data), str(tmp_path / ("final%d.npz" % r))],
        env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(p.communicate()[0])
    proofs = []
    report = "\n".join("worker %d rc=%s:\n%s" % (r, p.returncode, out[-1500:])
                       for r, (p, out) in enumerate(zip(procs, outs)))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, report
        proofs.append(dict(l[len("PROOF "):].split("=", 1)
                           for l in out.splitlines()
                           if l.startswith("PROOF ")))
    for r, proof in enumerate(proofs):
        assert proof["process"] == \
            "%d/2 positions=4 local=2 transport=gloo" % r
    assert proofs[0]["sum"] == proofs[1]["sum"] == "120.0"
    # bit-equal across the processes
    assert proofs[0]["losses"] == proofs[1]["losses"]
    assert proofs[0]["resumed"] == proofs[1]["resumed"]
    assert proofs[0]["fsdp"] == proofs[1]["fsdp"]
    got = [float.fromhex(h) for h in proofs[0]["losses"].split(",")
           + proofs[0]["resumed"].split(",")]
    numpy.testing.assert_allclose(got, want_losses, rtol=TOL, atol=TOL)
    fsdp = [float.fromhex(h) for h in proofs[0]["fsdp"].split(",")]
    numpy.testing.assert_allclose(fsdp, want_losses[:STEPS], rtol=TOL,
                                  atol=TOL)
    for r in range(2):
        final = numpy.load(tmp_path / ("final%d.npz" % r))
        for i, layer in enumerate(want_final):
            for k, v in layer.items():
                numpy.testing.assert_allclose(final["%d/%s" % (i, k)], v,
                                              rtol=TOL, atol=TOL)


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                    sys.argv[4], sys.argv[5]))
