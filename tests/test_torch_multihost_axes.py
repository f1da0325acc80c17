"""The mesh trainer's ``pp``, ``sp`` and ``ep`` axes across a gang's
processes (``parallel/p2p.py``, the hops of ``parallel/pipeline.py``,
``ops/attention.py``, ``models/moe.py`` and ``models/gd_mesh.py``) on the
CPU, held against the JAX package's in-process mesh trainer and the
port's own in-process run — the port of what ``tests/test_pp_trainer.py``,
``tests/test_parallel.py`` and ``tests/test_multihost.py`` check there.

One spawn of two worker processes (this file run as a script, with the
gang's ``VELES_TPU_COORDINATOR`` / ``VELES_TPU_NUM_PROCESSES`` /
``VELES_TPU_PROCESS_ID`` in their environment) joins one gloo gang with 2
CPU positions each and runs the cases one after another:

- ``{"pp": 2, "dp": 2}``: the LM trunk of
  ``test_torch_pp_sp.py::test_pp_trainer_matches_reference`` (its two
  stages in different processes, both groups' homes in process 0), 3
  minibatches, then the trainer pickled and resumed over the gang for a
  4th;
- ``{"sp": 2, "dp": 2}`` laid out with the ring across the processes
  (``global_mesh(across="sp")``): the transformer sample of
  ``::test_transformer_sample_sp_matches_reference``, 3 minibatches;
- ``{"ep": 2, "dp": 2}`` with the expert axis across the processes: the
  MoE of ``test_torch_parallel.py::test_mesh_trainer_matches_reference``,
  3 minibatches;
- the command line (``python -m veles_tpu_torch``'s ``Main`` in the
  worker) on the transformer sample with ``root.common.mesh = {'pp': 2,
  'dp': 2}``, reaching the gang through its environment.

Before them the workers run ``pipeline_forward`` and
``ring_attention_sharded`` over gang meshes, forward and gradients
(``p2p.backward``), against the same functions in one process.

Each case checks that its axis crosses the processes (the positions
``along`` it belong to both), that the two processes' losses are bit-
equal, that losses and final parameters are within 2e-5 of the JAX
package's in-process mesh of the same axes (f32 compute, the tolerance
of ``test_torch_pp_sp.py``), and that they equal the port's in-process
run of the same axes bit for bit: the gang sums every gradient in the
order one process does (a hop's gradient arrives in autograd's walk
where the in-process copy's would).  The spawn has its own deadline
(``DEADLINE``); both processes are killed when it runs out.  Each worker
leaves the gang before it exits.
"""

import contextlib
import json
import os
import pickle
import socket
import subprocess
import sys
from unittest import mock

import numpy
import pytest
import torch

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5
DEADLINE = 240
#: each case: its mesh, the axis laid across the processes (None: the
#: reference's process-major layout, which puts the outermost axis —
#: pp, else dp — across) and the case whose model and minibatches it
#: trains
CASES = {"pp": ({"pp": 2, "dp": 2}, None, "pp"),
         "sp": ({"sp": 2, "dp": 2}, "sp", "sp"),
         "ep": ({"ep": 2, "dp": 2}, "ep", "ep"),
         "sp_dp": ({"sp": 2, "dp": 2}, None, "sp"),
         "ep_dp": ({"ep": 2, "dp": 2}, None, "ep")}
#: the cases with their own data, JAX oracle and in-process run
DATA = ("pp", "sp", "ep")
STEPS, RESUMED = 3, 1


def _proof(key, value):
    print("PROOF %s=%s" % (key, value), flush=True)


# -- the worker (this file as a script) ---------------------------------------

def _case_data(d, name):
    data = numpy.load(os.path.join(d, name + ".npz"))
    with open(os.path.join(d, name + ".json")) as f:
        meta = json.load(f)
    n = int(data["n"])
    batches = [(data["x%d" % i], data["y%d" % i], int(data["size"][i]),
                int(data["cls"][i])) for i in range(n)]
    init = {i: {} for i in range(len(meta["spec"]))}
    for k in data.files:
        if k.startswith("p/"):
            _, i, name_ = k.split("/")
            init.setdefault(int(i), {})[name_] = data[k]
    return meta, batches, init


def _chain(meta, init):
    from veles_tpu_torch.convert import params_from_numpy
    spec = [dict(s, **({"output_sample_shape": tuple(
        s["output_sample_shape"])} if "output_sample_shape" in s else {}))
        for s in meta["spec"]]
    chain = params_from_numpy(spec, init, device="cpu", dtype="float32")
    if meta["seq"]:
        shape = (meta["seq"],)
        for u in chain:
            u.in_shape = shape
            shape = tuple(u.out_shape(shape))
    return chain


def _steps(gd, batches):
    return [float(gd.run_minibatch(torch.as_tensor(x), torch.as_tensor(y),
                                   size, cls)[0]).hex()
            for x, y, size, cls in batches]


def _save(path, chain):
    from veles_tpu_torch.convert import params_to_numpy
    numpy.savez(path, **{"%d/%s" % (i, k): v
                         for i, ps in params_to_numpy(chain).items()
                         for k, v in ps.items()})


def worker_case(d, rank, name):
    from veles_tpu_torch.models.evaluator import EvaluatorSoftmax
    from veles_tpu_torch.models.gd import GradientDescent
    from veles_tpu_torch.parallel import multihost
    axes, across, data = CASES[name]
    meta, batches, init = _case_data(d, data)
    chain = _chain(meta, init)
    # the trainer's own mesh setting (root.common.mesh reaches it in
    # this form)
    spec = {"__mesh_axes__": axes, "__mesh_across__": across} if across \
        else axes
    gd = GradientDescent(chain, EvaluatorSoftmax(), mesh=spec,
                         **meta["kw"])
    mesh = gd.mesh
    axis = data
    crossing = sorted({mesh.process(p) for p in mesh.along(0, axis)})
    homes = sorted({mesh.process(p) for p in range(mesh.size)
                    if all(c == 0 for a, c in mesh.coords(p).items()
                           if a != "dp")})
    _proof(name + "_crossing", crossing)
    _proof(name + "_homes", homes)
    assert gd.plan_.gang
    _proof(name + "_losses", ",".join(_steps(gd, batches[:STEPS])))
    final = os.path.join(d, "%s_final%d.npz" % (name, rank))
    if name != "pp":
        _save(final, chain)
        # the pickled mesh keeps the axis laid across the processes
        _proof(name + "_pickled", json.dumps(
            pickle.loads(pickle.dumps(gd)).mesh, sort_keys=True))
        return
    # the trainer pickles (its mesh as the axis spec) and resumes over
    # the gang's positions with the state it pickled
    slots = gd.state_tensors()[1]
    params = [{n: t.detach().clone() for n, t in u.params.items()}
              for u in chain]
    gd2 = pickle.loads(pickle.dumps(gd))
    assert gd2.mesh == {"__mesh_axes__": axes}, gd2.mesh
    for u in gd2.forwards:
        u.to_device("cpu")
    gd2._setup()
    assert gd2.mesh.spans_processes and gd2.plan_.gang
    assert sorted({gd2.mesh.process(p)
                   for p in gd2.mesh.along(0, "pp")}) == [0, 1]
    for u, want in zip(gd2.forwards, params):
        for n, t in want.items():
            assert torch.equal(u.params[n], t), n
    for key, s in gd2.state_tensors()[1].items():
        for n, t in s.items():
            assert torch.equal(t, slots[key][n]), (key, n)
    _proof("pp_resumed", ",".join(_steps(gd2, batches[STEPS:])))
    _save(final, gd2.forwards)


def _stage_mlp(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _function_inputs():
    """The pipeline's and the ring's inputs, the same in every process."""
    rng = numpy.random.default_rng(0)
    params = [{"w": torch.as_tensor(rng.normal(size=(6, 6)).astype(
        numpy.float32) * 0.5).requires_grad_(True),
        "b": torch.as_tensor(rng.normal(size=(6,)).astype(
            numpy.float32) * 0.1).requires_grad_(True)} for _ in range(2)]
    x = torch.as_tensor(rng.normal(size=(8, 6)).astype(numpy.float32))
    qkv = [torch.as_tensor(rng.normal(size=(16, 2, 8)).astype(
        numpy.float32)).requires_grad_(True) for _ in range(3)]
    return params, x, qkv


def run_functions(pp_mesh, sp_mesh, home):
    """``pipeline_forward`` over ``pp_mesh`` (pp x dp) and
    ``ring_attention_sharded`` over ``sp_mesh``: their outputs (None in a
    process without the result) and the gradients this process holds,
    from ``p2p.backward``.  ``home``: whether this process passes the
    ring's inputs."""
    from veles_tpu_torch.ops.attention import ring_attention_sharded
    from veles_tpu_torch.parallel import p2p
    from veles_tpu_torch.parallel.pipeline import pipeline_forward
    params, x, qkv = _function_inputs()
    out = pipeline_forward(pp_mesh, _stage_mlp, params, x, n_micro=2,
                           batch_axes=("dp",))
    p2p.backward((out ** 2).sum() if out is not None else None)
    ring = ring_attention_sharded(sp_mesh, *(qkv if home else [None] * 3),
                                  causal=True)
    p2p.backward(torch.sin(ring).sum() if ring is not None else None)
    got = {"pipe": out, "ring": ring}
    for s, p in enumerate(params):
        for n, t in p.items():
            got["g%d%s" % (s, n)] = t.grad
    for n, t in zip("qkv", qkv):
        got["g" + n] = t.grad
    return {k: v.detach().numpy() for k, v in got.items() if v is not None}


def worker(d, rank):
    torch.set_num_threads(1)
    from veles_tpu_torch.parallel import multihost
    from veles_tpu_torch.parallel.mesh import set_positions_per_device
    set_positions_per_device(2)
    # the gang from the environment (VELES_TPU_COORDINATOR & co.)
    gang = multihost.initialize(device="cpu")
    try:
        _proof("process", "%d/%d %s" % (gang.process_id,
                                        gang.num_processes, gang.transport))
        got = run_functions(multihost.global_mesh({"pp": 2, "dp": 2}),
                            multihost.global_mesh({"sp": 2, "dp": 2},
                                                  across="sp"), rank == 0)
        numpy.savez(os.path.join(d, "functions%d.npz" % rank), **got)
        for name in CASES:
            worker_case(d, rank, name)
            _proof(name + "_stats", json.dumps(multihost.STATS))
        for cli in CLI:
            gd = run_cli(d, cli, "%s%d" % (cli, rank))
            _proof(cli + "_cli_plan", json.dumps([
                gd.plan_.pp and gd.plan_.pp["stages"], dict(gd.mesh.shape),
                sorted({gd.mesh.process(p)
                        for p in gd.mesh.along(0, cli)})]))
        multihost.sync_global_devices("done")
    finally:
        multihost.shutdown()
    return 0


# -- the parent ----------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@contextlib.contextmanager
def _seeded():
    """The JAX package's generators seeded, then restored: its weights
    and minibatches the same whatever ran before on this worker."""
    from veles_tpu import prng
    from tests.test_torch_parallel import jax_streams
    with jax_streams():
        for name, seed in (("default", 7), ("dist", 99), ("loader", 42),
                           ("trainer", 42)):
            prng.get(name).seed(seed)
        yield


def _jax_moe(steps):
    """The JAX MoE trainer over an in-process ``{"ep": 2, "dp": 2}``:
    its minibatches, first and final weights and losses."""
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.backends import Device
    from tests.test_models import BlobsLoader
    from tests.test_torch_parallel import _build_jax_moe, _jax_mesh
    wf = AcceleratedWorkflow(None, name="torch-gang-ep")
    loader = BlobsLoader(wf, minibatch_size=64, prng_key="dist")
    loader.span_serving = False
    batches, losses = [], []
    try:
        layers, gd = _build_jax_moe(Device(backend="numpy"), wf, loader,
                                    _jax_mesh(CASES["ep"][0]))
        init = {i: {n: numpy.array(a.map_read().mem)
                    for n, a in u.param_arrays().items()}
                for i, u in enumerate(layers)}
        for _ in range(steps):
            loader.run()
            batches.append((numpy.array(loader.minibatch_data.map_read().mem),
                            numpy.array(loader.minibatch_labels.map_read().mem),
                            int(loader.minibatch_size),
                            int(loader.minibatch_class)))
            gd.run()
            losses.append(float(gd.loss.map_read().mem))
        final = {i: {n: numpy.array(a.map_read().mem)
                     for n, a in u.param_arrays().items()}
                 for i, u in enumerate(layers)}
    finally:
        loader.stop()
    return batches, init, final, losses


def _write_case(d, name, spec, seq, kw, batches, init):
    assert sum(b[3] == 2 for b in batches[:STEPS]) >= 2, name  # train
    arrays = {"n": numpy.array(len(batches)),
              "size": numpy.array([b[2] for b in batches]),
              "cls": numpy.array([b[3] for b in batches])}
    for i, (xb, yb, _, _) in enumerate(batches):
        arrays["x%d" % i], arrays["y%d" % i] = xb, yb
    for i, layer in init.items():
        for k, v in layer.items():
            arrays["p/%d/%s" % (i, k)] = v
    numpy.savez(os.path.join(d, name + ".npz"), **arrays)
    with open(os.path.join(d, name + ".json"), "w") as f:
        json.dump({"spec": spec, "seq": seq, "kw": kw}, f)


def _port_in_process(name, d):
    """The port's in-process run of the case's mesh (4 positions on the
    CPU) over every minibatch: its losses (hex, as the workers print
    them) and final parameters."""
    from veles_tpu_torch.convert import params_to_numpy
    from veles_tpu_torch.models.evaluator import EvaluatorSoftmax
    from veles_tpu_torch.models.gd import GradientDescent
    from tests.test_torch_parallel import _port_mesh
    meta, batches, init = _case_data(d, name)
    chain = _chain(meta, init)
    gd = GradientDescent(chain, EvaluatorSoftmax(),
                         mesh=_port_mesh(CASES[name][0]), **meta["kw"])
    return _steps(gd, batches), params_to_numpy(chain)


CLI_KEYS = ("root.transformer_tpu.update({'seq': 8, 'dim': 16, 'heads': 2, "
            "'blocks': 2, 'causal': True, 'minibatch_size': 8, "
            "'synthetic_train': 32, 'synthetic_valid': 8, 'max_epochs': 2, "
            "'solver': 'sgd', 'learning_rate': 0.05})")


#: the command lines' mesh settings: pp by the process-major layout,
#: sp laid across the processes by the setting's "__mesh_across__"
CLI = {"pp": ["-c", "root.common.mesh = {'pp': 2, 'dp': 2}"],
       "sp": ["-c", "root.common.mesh = {'__mesh_axes__': {'sp': 2, "
              "'dp': 2}, '__mesh_across__': 'sp'}"]}


def _cli_argv(cli):
    from tests.test_torch_cli import port_sample
    return [port_sample("transformer.py"), "-a", "cpu",
            "-c", "root.common.precision.compute_dtype = 'float32'"] \
        + CLI[cli] + ["-c", CLI_KEYS]


def run_cli(d, cli, tag):
    """The command line of ``CLI[cli]`` (``python -m veles_tpu_torch``'s
    ``Main``), its results written to ``cli_<tag>.json``; returns its
    trainer."""
    from veles_tpu_torch.__main__ import Main
    m = Main(_cli_argv(cli) + [
        "--result-file", os.path.join(d, "cli_%s.json" % tag), "-c",
        "root.common.dirs.snapshots = %r" % os.path.join(d, "snaps_" + tag)])
    assert m.run() == 0
    return m.workflow.gd


def _cli_in_process(d, cli):
    """The same command line in one process over 4 CPU positions."""
    from veles_tpu_torch.parallel.mesh import set_positions_per_device
    from tests.test_torch_cli import restored_process_state
    old = set_positions_per_device(4)
    try:
        with restored_process_state():
            gd = run_cli(d, cli, cli + "_alone")
            plan = (gd.plan_.pp and gd.plan_.pp["stages"],
                    dict(gd.mesh.shape))
    finally:
        set_positions_per_device(old)
    with open(os.path.join(d, "cli_%s_alone.json" % cli)) as f:
        return json.load(f), plan


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The JAX oracles, the port's in-process runs and the gang's
    proofs of every case."""
    from veles_tpu.config import root
    from tests.test_torch_pp_sp import _jax_lm_run, _jax_sample_run, _lm_spec
    from tests.test_torch_parallel import MOE, _jax_mesh
    d = str(tmp_path_factory.mktemp("gang_axes"))
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    sgd = dict(solver="sgd", learning_rate=0.05, gradient_moment=0.9)
    want = {}
    try:
        with _seeded():
            batches, init, final, losses = _jax_lm_run(
                CASES["pp"][0], steps=STEPS + RESUMED)
        want["pp"] = (losses, final)
        _write_case(d, "pp", _lm_spec(), batches[0][0].shape[1], sgd,
                    batches, init)
        # the sample builds its mesh over every device; this one takes
        # the first 4 of the suite's 8
        mesh = _jax_mesh({"dp": 2, "sp": 2})
        with mock.patch("veles_tpu.parallel.build_mesh",
                        lambda axes, devices=None: mesh), _seeded():
            batches, init, final, losses = _jax_sample_run(
                {"dp": 2, "sp": 2}, steps=STEPS)
        want["sp"] = (losses, final)
        spec = _lm_spec(blocks=1)
        spec[-1]["output_sample_shape"] = (16,)
        spec[0]["vocab"] = 16
        _write_case(d, "sp", spec, batches[0][0].shape[1], sgd, batches,
                    init)
        with _seeded():
            batches, init, final, losses = _jax_moe(STEPS)
        want["ep"] = (losses, final)
        _write_case(d, "ep", MOE, None, dict(learning_rate=0.1), batches,
                    init)
    finally:
        root.common.precision.compute_dtype = saved
    alone = {name: _port_in_process(name, d) for name in DATA}
    from tests.test_torch_parallel import _port_mesh
    functions = run_functions(_port_mesh({"pp": 2, "dp": 2}),
                              _port_mesh({"sp": 2, "dp": 2}), True)
    cli_alone = {cli: _cli_in_process(d, cli) for cli in CLI}
    address = "127.0.0.1:%d" % _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   VELES_TPU_COORDINATOR=address,
                   VELES_TPU_NUM_PROCESSES="2", VELES_TPU_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), d, str(r)],
            env=env, cwd=d, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DEADLINE)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate()[0] for p in procs]
    report = "\n".join("worker %d rc=%s:\n%s" % (r, p.returncode,
                                                  out[-3000:])
                       for r, (p, out) in enumerate(zip(procs, outs)))
    proofs = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, report
        proofs.append(dict(l[len("PROOF "):].split("=", 1)
                           for l in out.splitlines()
                           if l.startswith("PROOF ")))
    return dict(d=d, want=want, alone=alone, proofs=proofs,
                cli_alone=cli_alone, functions=functions)


def _close(got, want, tol=TOL):
    numpy.testing.assert_allclose(numpy.asarray(got, numpy.float64),
                                  numpy.asarray(want, numpy.float64),
                                  rtol=tol, atol=tol)


def _check_case(gang, name, crossing="[0, 1]", homes="[0]", split=False):
    """By default the case's axis crosses the processes and every
    group's home is in process 0, so process 1 runs only stages, ring
    halves or expert slices.  ``split``: the groups' homes lie in both
    processes, so each process scores its own rows and the gang sums the
    two parts — a different order from one process's one sum over every
    row, so the losses hold to 1e-6 of the in-process run, not to the
    bit (the parameters, whose gradients do not read the loss's sum,
    still equal it bit for bit)."""
    proofs = gang["proofs"]
    data = CASES[name][2]
    axes, across = CASES[name][:2]
    pickled = {"__mesh_axes__": axes}
    if across:
        pickled["__mesh_across__"] = across
    for r, proof in enumerate(proofs):
        assert proof["process"] == "%d/2 gloo" % r
        assert proof[name + "_crossing"] == crossing
        assert proof[name + "_homes"] == homes
        if name != "pp":
            assert json.loads(proof[name + "_pickled"]) == pickled
    assert proofs[0][name + "_losses"] == proofs[1][name + "_losses"]
    got = proofs[0][name + "_losses"].split(",")
    jlosses, jfinal = gang["want"][data]
    alone, plain = gang["alone"][data]
    if split:
        _close([float.fromhex(h) for h in got],
               [float.fromhex(h) for h in alone[:STEPS]], 1e-6)
    else:
        assert got == alone[:STEPS]
    _close([float.fromhex(h) for h in got], jlosses[:STEPS])
    for r in range(2):
        final = numpy.load(os.path.join(gang["d"], "%s_final%d.npz"
                                        % (name, r)))
        for i, layer in jfinal.items():
            for n, w in layer.items():
                have = final["%d/%s" % (i, n)]
                _close(have, w)
                assert numpy.array_equal(have, plain[i][n]), (i, n)


def test_gang_pp_matches_reference(gang):
    _check_case(gang, "pp")


def test_gang_sp_matches_reference(gang):
    _check_case(gang, "sp")


def test_gang_ep_matches_reference(gang):
    _check_case(gang, "ep")


@pytest.mark.parametrize("name", ["sp_dp", "ep_dp"])
def test_gang_default_layout_matches_reference(gang, name):
    """The reference's process-major layout of the same meshes puts dp
    across the processes: each process holds one group's home and runs
    its ring or expert slices inside itself."""
    _check_case(gang, name, crossing="[0]", homes="[0, 1]", split=True)


def test_gang_pp_snapshot_resumes(gang):
    """The pp trainer pickled over the gang resumes on it: its 4th step
    is bit-equal across the processes and to the in-process run's, and
    within 2e-5 of the JAX trainer's."""
    proofs = gang["proofs"]
    assert proofs[0]["pp_resumed"] == proofs[1]["pp_resumed"]
    got = proofs[0]["pp_resumed"].split(",")
    assert got == gang["alone"]["pp"][0][STEPS:]
    _close([float.fromhex(h) for h in got], gang["want"]["pp"][0][STEPS:])


def test_gang_pipeline_and_ring_functions(gang):
    """``pipeline_forward`` over a gang's pp x dp (the stages in different
    processes) and ``ring_attention_sharded`` over its sp (the ring's
    halves in different processes), forward and gradients through
    ``p2p.backward``, equal the in-process functions bit for bit: the
    outputs come back to process 0, each process holds the gradients of
    its own stage's parameters, and process 0, which passed q/k/v, holds
    theirs."""
    want = gang["functions"]
    got = [dict(numpy.load(os.path.join(gang["d"], "functions%d.npz" % r)))
           for r in range(2)]
    assert sorted(got[0]) == ["g0b", "g0w", "gk", "gq", "gv", "pipe",
                              "ring"]
    assert sorted(got[1]) == ["g1b", "g1w"]
    for r in range(2):
        for k, v in got[r].items():
            assert numpy.array_equal(v, want[k]), (r, k)


def test_gang_moves_through_hops(gang):
    """Every case moved its tensors between the processes by hops, both
    ways, and the processes sent what the other received."""
    stats = [json.loads(p["ep_stats"]) for p in gang["proofs"]]
    assert all(s["sends"] > 0 and s["receives"] > 0 for s in stats)
    assert stats[0]["sends"] == stats[1]["receives"]
    assert stats[1]["sends"] == stats[0]["receives"]


def _check_cli(gang, cli, stages, crossing):
    alone, plan = gang["cli_alone"][cli]
    axes = {cli: 2, "dp": 2}
    assert plan == (stages, axes)
    want = dict(alone)
    del want["elapsed_sec"]                 # the run's wall clock
    for r, proof in enumerate(gang["proofs"]):
        assert json.loads(proof[cli + "_cli_plan"]) == [stages, axes,
                                                        crossing]
        with open(os.path.join(gang["d"], "cli_%s%d.json" % (cli, r))) as f:
            got = json.load(f)
        del got["elapsed_sec"]
        assert got == want


def test_gang_cli_pp_matches_in_process(gang):
    """``python -m veles_tpu_torch`` over a 2-process gang from the
    environment with ``root.common.mesh = {'pp': 2, 'dp': 2}`` (the tree's
    mesh, C11) builds the 2-stage plan and writes the results of the same
    command line in one process."""
    _check_cli(gang, "pp", 2, [0, 1])


def test_gang_cli_sp_across_matches_in_process(gang):
    """The same over ``root.common.mesh = {'__mesh_axes__': {'sp': 2,
    'dp': 2}, '__mesh_across__': 'sp'}``: the setting lays the ring
    across the processes (the process-major layout would put dp there),
    and the results equal the command line's in one process."""
    _check_cli(gang, "sp", None, [0, 1])


@pytest.mark.parametrize("transport,cards", [
    ("nccl", [["cuda:0"], ["cuda:1"]]),
    ("gloo", [["cuda:0", "cuda:1"], ["cuda:0", "cuda:1"]])])
def test_hops_refused_where_they_never_ran(monkeypatch, transport, cards):
    """pp, sp and ep across processes raise, by name and before any
    transfer, under nccl (processes on cards of their own) and where a
    process holds several cards; dp, fsdp and tp across processes do
    not hop and are not refused."""
    from veles_tpu_torch.models.gd_mesh import MeshPlan
    from veles_tpu_torch.parallel import collectives, multihost, p2p
    from veles_tpu_torch.parallel.mesh import Mesh
    monkeypatch.setitem(multihost._STATE, "gang",
                        multihost.Gang(0, 2, transport))
    monkeypatch.setitem(multihost._STATE, "positions",
                        [[torch.device(c) for c in cs] for cs in cards])
    assert multihost.hop_refusal() is not None
    x = torch.ones(2)
    for axes in ({"pp": 2, "dp": 2}, {"sp": 2, "dp": 2}, {"ep": 2, "dp": 2}):
        mesh = Mesh(axes, ["cpu"] * 4, processes=[0, 0, 1, 1])
        with pytest.raises(RuntimeError, match="pp, sp and ep across"):
            MeshPlan(None, mesh)
        with pytest.raises(RuntimeError, match="pp, sp and ep across"):
            p2p.Route(mesh, 0, [0, 2])
    with pytest.raises(RuntimeError, match="pp, sp and ep across"):
        collectives.ppermute([x, None], [(0, 1)], procs=[0, 1])
    # within one process nothing hops: the same calls run
    mesh = Mesh({"pp": 2, "dp": 2}, ["cpu"] * 4)
    p2p.Route(mesh, 0, [0, 2])
    assert torch.equal(collectives.ppermute([x, x * 2], [(0, 1)])[1], x)
    # a reduce-scatter summed in one process exchanges instead of hopping
    seen = []
    monkeypatch.setattr(multihost, "exchange",
                        lambda xs: seen.append(len(xs)) or xs)
    got = collectives.reduce_scatter([x, x * 3], to=["cpu", "cpu"],
                                     procs=[0, 0], to_procs=[0, 1])
    assert seen == [2] and torch.equal(got[0], x[:1] * 4) and got[1] is None
    monkeypatch.setitem(multihost._STATE, "positions",
                        [[torch.device("cuda:0")], [torch.device("cuda:0")]])
    assert (multihost.hop_refusal() is None) == (transport == "gloo")


def test_initialize_without_a_card_raises(monkeypatch):
    """A gang configured with no device and no card raises before the
    process joins the group (no silent CPU gang)."""
    import torch.distributed as dist
    from veles_tpu_torch.parallel import multihost
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("VELES_TPU_COORDINATOR", "127.0.0.1:%d"
                       % _free_port())
    monkeypatch.setenv("VELES_TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("VELES_TPU_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize()
    assert not dist.is_initialized()
    assert not multihost.is_gang()


def test_smoke_gang_worker_asks_for_the_card():
    """``chip_smoke.py``'s gang processes ask for the card and nothing
    else: no fallback to the CPU."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        text = f.read()
    start = text.index("def gang_worker(")
    body = text[start:text.index("\ndef ", start + 1)]
    assert "torch.cuda.is_available()" not in body
    assert 'torch.device("cuda")' in body


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1], int(sys.argv[2])))
