"""The config keys the reference reads and the port used to drop (faults
C11–C16 in ``ROADMAP.md`` §C), each held to the JAX package on the same
setting:

- ``root.common.mesh``: a standard workflow built without ``mesh=``
  shards over the tree's axes — through the command line, as the JAX
  package's does, and exactly as with ``mesh=`` given;
- ``root.common.faults.spec``: arms the registry when ``VELES_FAULTS``
  is empty, the same points the variable arms;
- ``root.common.dirs.cache``: where the downloader fetches;
- ``root.common.flightrec.dump_on_exit``: the recorder dumps at exit;
- ``root.common.engine.backend``: the device of a run without ``-a``;
- ``root.common.precision.{accum_dtype, param_dtype, level}``: what the
  port does not compute is refused by name.

The real corpora (``root.common.dirs.datasets``) are in
``tests/test_torch_loader_breadth.py``."""

import http.server
import json
import os
import subprocess
import sys
import tarfile
import threading

import numpy
import pytest

from tests.test_torch_cli import (  # noqa: F401 (fixture)
    F32, REPO, assert_results_close, assert_weights_close, cli_env,
    mnist_argv, port_weights, run_jax, run_port)

pytestmark = pytest.mark.torch_port

MESH_RUN = ("root.mnist_tpu.update({'synthetic_train': 256, "
            "'synthetic_valid': 128, 'max_epochs': 2, "
            "'minibatch_size': 64, 'layers': [16, 10], "
            "'snapshot_time_interval': 0.0})")


@pytest.fixture
def eight_positions():
    """Eight CPU positions, as the JAX package's eight host devices."""
    from veles_tpu_torch.parallel.mesh import set_positions_per_device
    old = set_positions_per_device(8)
    yield
    set_positions_per_device(old)


def test_tree_mesh_shards_standard_workflows(cli_env, eight_positions):
    """``-c "root.common.mesh = {'dp': -1}"`` on the eight CPU
    positions: the port's MNIST run shards its trainer over the tree's
    axes and lands where the JAX package's run with the same setting
    lands; a workflow built under that tree equals one given
    ``mesh={'dp': -1}``, bit for bit."""
    argv = [
        "-c", MESH_RUN, "-c", F32, "-c", "root.common.mesh = {'dp': -1}",
        "-a", "numpy"]
    # the JAX workflow draws its first weights from the default
    # generator: from its fresh state, as the port's draw
    from veles_tpu import prng as jprng
    jprng.get().seed(42)
    jm = run_jax(mnist_argv("jax") + argv + [
        "--result-file", str(cli_env / "j.json")])
    pm = run_port(mnist_argv("port") + argv + [
        "--result-file", str(cli_env / "p.json")])
    from veles_tpu_torch.parallel.mesh import Mesh
    assert isinstance(pm.workflow.gd.mesh, Mesh)
    assert pm.workflow.gd.mesh.shape == {"dp": 8}
    assert_results_close(json.loads((cli_env / "p.json").read_text()),
                         json.loads((cli_env / "j.json").read_text()))
    assert_weights_close(jm.workflow, pm.workflow)

    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples.mnist import MnistWorkflow
    kw = dict(synthetic_train=256, synthetic_valid=128, max_epochs=1,
              minibatch_size=64, layers=(16, 10), dtype="float32",
              snapshotter_config={"enabled": False})
    runs = []
    for mesh in (None, {"dp": -1}):
        root.common.mesh = {"dp": -1}
        wf = MnistWorkflow(mesh=mesh, **kw)
        assert wf.gd.mesh == {"dp": -1}
        wf.initialize(device="cpu")
        wf.run()
        runs.append(port_weights(wf))
        root.common.mesh = None
    for a, b in zip(*runs):
        for n in a:
            numpy.testing.assert_array_equal(a[n], b[n])
    assert MnistWorkflow(**kw).gd.mesh is None


@pytest.fixture
def fresh_faults(monkeypatch):
    """Both registries disarmed and their environment latch reset."""
    from veles_tpu import faults as jfaults
    from veles_tpu_torch import faults
    monkeypatch.delenv("VELES_FAULTS", raising=False)
    for reg in (faults, jfaults):
        reg.clear()
        monkeypatch.setattr(reg, "_env_loaded", False)
    yield faults, jfaults
    for reg in (faults, jfaults):
        reg.clear()


SPEC = "loader.fill=exception@1x2;router.forward=http_error:503~r1"


def _armed(reg):
    return [(s.point, s.action, s.arg, s.after, s.times, s.key)
            for s in reg.active()]


@pytest.mark.parametrize("source", ["tree", "env"])
def test_faults_spec_from_the_tree_arms_like_the_environment(
        source, fresh_faults, cli_env, monkeypatch):
    """``root.common.faults.spec`` arms both registries when
    ``VELES_FAULTS`` is empty, and the variable arms the same specs;
    the armed point fires after its ``@1`` skip."""
    from veles_tpu.config import root as jroot
    from veles_tpu_torch.config import root
    faults, jfaults = fresh_faults
    if source == "tree":
        root.common.faults.spec = SPEC
        jroot.common.faults.spec = SPEC
    else:
        monkeypatch.setenv("VELES_FAULTS", SPEC)
    assert _armed(faults) == _armed(jfaults) != []
    for reg in (faults, jfaults):
        assert not reg.fire("loader.fill")
        with pytest.raises(reg.InjectedFault):
            reg.fire("loader.fill")


def test_tree_fault_spec_yields_to_the_environment(fresh_faults, cli_env,
                                                   monkeypatch):
    from veles_tpu_torch.config import root
    faults, _ = fresh_faults
    root.common.faults.spec = "loader.fill=drop"
    monkeypatch.setenv("VELES_FAULTS", "router.forward=drop")
    assert [s.point for s in faults.active()] == ["router.forward"]


def test_downloader_fetches_into_dirs_cache(cli_env):
    """An http(s) archive lands in ``root.common.dirs.cache`` before it
    is unpacked, in both packages; the fetched copy is deleted after."""
    from veles_tpu.config import root as jroot
    from veles_tpu.downloader import Downloader as JaxDownloader
    from veles_tpu_torch.config import root
    from veles_tpu_torch.downloader import Downloader
    payload = cli_env / "payload.txt"
    payload.write_text("corpus")
    archive = cli_env / "corpus.tar.gz"
    with tarfile.open(archive, "w:gz") as t:
        t.add(payload, arcname="payload.txt")
    blob = archive.read_bytes()
    fetched = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            fetched.append(self.path)
            self.send_response(200)
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

    srv = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = "http://127.0.0.1:%d/corpus.tar.gz" % srv.server_address[1]
    seen = {}
    try:
        for name, cls, tree in (("port", Downloader, root),
                                ("jax", JaxDownloader, jroot)):
            cache = cli_env / ("cache_" + name)
            vars(tree.common.dirs)["cache"] = str(cache)
            d = cls(None, url=url, directory=str(cli_env / name),
                    files=["payload.txt"])
            d.initialize()
            assert (cli_env / name / "payload.txt").read_text() == "corpus"
            seen[name] = sorted(os.listdir(cache))
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(10)
    assert fetched == ["/corpus.tar.gz"] * 2
    assert seen["port"] == seen["jax"] == []
    # an explicit cache_dir still wins over the tree
    assert Downloader(None, url=url, directory="x",
                      cache_dir="here").cache_dir == "here"


_DUMP = """
import sys
from {pkg}.config import root
root.common.flightrec.dump_on_exit = {flag}
from {pkg}.telemetry.flight_recorder import recorder
recorder.install(directory=sys.argv[1], signals=(), excepthook=False,
                 enable_faulthandler=False)
"""


@pytest.mark.parametrize("flag", [True, False])
def test_flight_recorder_dumps_at_exit_when_the_tree_says(flag, tmp_path):
    """``root.common.flightrec.dump_on_exit``: a process that installed
    the recorder writes ``flightrec-<pid>.json`` (reason ``atexit``) as
    it exits, as the reference's does; without the key, nothing."""
    out = {}
    for pkg in ("veles_tpu_torch", "veles_tpu"):
        d = tmp_path / pkg
        d.mkdir()
        r = subprocess.run(
            [sys.executable, "-c", _DUMP.format(pkg=pkg, flag=flag),
             str(d)], cwd=REPO, capture_output=True, text=True,
            timeout=120, env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert r.returncode == 0, r.stderr[-1500:]
        dumps = sorted(os.listdir(d))
        out[pkg] = [json.loads((d / f).read_text())["reason"]
                    for f in dumps]
    assert out["veles_tpu_torch"] == out["veles_tpu"] == (
        ["atexit"] if flag else [])


def test_engine_backend_picks_the_device_without_a(cli_env):
    """No ``-a``: ``root.common.engine.backend`` names the device (the
    reference's ``Device`` reads it); ``-a`` still wins; a backend the
    port lacks raises."""
    from veles_tpu_torch.cmdline import backend_device
    from veles_tpu_torch.config import root
    root.common.engine.backend = "numpy"
    assert backend_device(None) == "cpu"
    assert backend_device("cuda") == "cuda"
    root.common.engine.backend = "tpu"
    with pytest.raises(ValueError, match="tpu"):
        backend_device(None)
    root.common.engine.backend = "numpy"
    m = run_port(mnist_argv("port") + [
        "-c", MESH_RUN, "-c", F32, "-c",
        "root.common.engine.backend = 'cpu'"])
    assert str(m.launcher.device) == "cpu"
    assert m.workflow.gd.global_step > 0


@pytest.mark.parametrize("key,value,ok", [
    ("accum_dtype", "float32", True), ("accum_dtype", "bfloat16", False),
    ("param_dtype", "float32", True), ("param_dtype", "float16", False),
    ("level", 0, True), ("level", 2, True), ("level", 1, False)])
def test_precision_keys_honoured_or_refused_by_name(key, value, ok,
                                                    cli_env):
    """The port sums in float32, keeps float32 master parameters and
    takes exact float32 products (level 0 on its devices, or 2): any
    other ``root.common.precision`` value raises, naming the key, when a
    standard workflow is built."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples.mnist import MnistWorkflow
    setattr(root.common.precision, key, value)
    kw = dict(synthetic_train=64, synthetic_valid=64, max_epochs=1,
              layers=(8, 10), snapshotter_config={"enabled": False})
    if ok:
        MnistWorkflow(**kw)
    else:
        with pytest.raises(ValueError,
                           match="root.common.precision.%s" % key):
            MnistWorkflow(**kw)
