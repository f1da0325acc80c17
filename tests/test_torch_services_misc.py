"""The port's remaining services — the avatar, publishing, the forge, the
scripts — held against the JAX package's on the CPU.  The oracle is
``tests/test_services_misc.py``; its cases are ported here, and where a
wire is involved each runs in both directions:

- an :class:`Avatar` pulls bit-equal copies from an
  :class:`AvatarServer` of either package (port↔port, port from JAX,
  JAX from port), and a second pull sees the source's change;
- the :class:`Publisher` renders a trained port MNIST run in all five
  backends (Confluence to a loopback fake; LaTeX to a PDF only where a
  TeX engine is installed) with the port's metrics, checksum and graph,
  and the HTML backend says why it wrote no images when it wrote none;
- the forge: upload, list, latest and by-version fetch, immutable
  history (409), checksum-verified fetches and bad names refused — each
  client against each server;
- ``compare_snapshots`` on the port's snapshots and on a JAX package
  snapshot; ``bboxer``; ``update_forge`` into either package's server.

Every server binds port 0, and every test stops the servers, sockets
and threads it starts."""

import gzip
import json
import os
import pickle
import tarfile
import threading

import numpy
import pytest
import torch

pytestmark = pytest.mark.torch_port


# -- avatar -------------------------------------------------------------------

def _serve_once(server):
    t = threading.Thread(target=server.serve_once, daemon=True)
    t.start()
    return t


@pytest.mark.parametrize("pair", ["port-port", "port-from-jax",
                                  "jax-from-port"])
def test_avatar_bridges_arrays(pair):
    """The source's Arrays reach the avatar's mirrors bit for bit; the
    source changes and the next pull sees it."""
    pytest.importorskip("zmq")
    from veles_tpu import avatar as javatar
    from veles_tpu.memory import Array as JaxArray
    from veles_tpu_torch import avatar
    from veles_tpu_torch.memory import Array
    src_pkg, dst_pkg = {"port-port": (avatar, avatar),
                        "port-from-jax": (javatar, avatar),
                        "jax-from-port": (avatar, javatar)}[pair]
    arr_cls = Array if src_pkg is avatar else JaxArray
    start = numpy.random.default_rng(3).normal(
        size=(4, 6)).astype(numpy.float32)
    weights = arr_cls(start.copy())
    bias = arr_cls(numpy.arange(6, dtype=numpy.float32))
    if src_pkg is avatar:
        # a device-resident source: the server reads it home per request
        weights.initialize("cpu")
        weights.devmem = torch.as_tensor(start) * 2
        start = start * 2
    server = src_pkg.AvatarServer({"weights": weights, "bias": bias})
    av = dst_pkg.Avatar(None, endpoint=server.endpoint,
                        names=["weights"])
    if dst_pkg is avatar:
        av.initialize(device="cpu")
    try:
        t = _serve_once(server)
        av.run()
        t.join(10)
        mirror = av.mirrors["weights"]
        numpy.testing.assert_array_equal(mirror.mem, start)
        assert list(av.mirrors) == ["weights"]   # only what was asked
        if dst_pkg is avatar:
            assert torch.equal(mirror.devmem, torch.as_tensor(start))
        weights.map_write()
        weights.mem[0, 0] = 99.0
        t = _serve_once(server)
        av.run()
        t.join(10)
        assert av.mirrors["weights"].mem[0, 0] == 99.0
    finally:
        if dst_pkg is avatar:
            av.close()
        elif av._sock_ is not None:
            av._sock_.close(0)
        server.close()


def test_avatar_times_out_on_a_silent_source():
    zmq = pytest.importorskip("zmq")
    from veles_tpu_torch.avatar import Avatar
    rep = zmq.Context.instance().socket(zmq.REP)
    port = rep.bind_to_random_port("tcp://127.0.0.1")
    av = Avatar(None, endpoint="tcp://127.0.0.1:%d" % port, timeout=0.2)
    try:
        with pytest.raises(TimeoutError):
            av.run()
    finally:
        av.close()
        rep.close(0)


# -- publishing ---------------------------------------------------------------

@pytest.fixture(scope="module")
def trained_wf():
    from veles_tpu_torch.samples.mnist import MnistWorkflow
    wf = MnistWorkflow(synthetic_train=256, synthetic_valid=64,
                       max_epochs=1, minibatch_size=64, layers=(16, 10),
                       dtype="float32",
                       snapshotter_config={"enabled": False})
    for p in wf.plotters:
        p.collect = True
    wf.initialize(device="cpu")
    wf.run()
    return wf


@pytest.mark.parametrize("backend,ext", [
    ("markdown", ".md"), ("html", ".html"), ("notebook", ".ipynb"),
    ("latex", (".tex", ".pdf")), ("confluence", ".xhtml")])
def test_publisher_backends(trained_wf, tmp_path, backend, ext):
    from veles_tpu_torch.publishing import Publisher
    pub = Publisher(trained_wf, backend=backend,
                    output_dir=str(tmp_path))
    pub.run()
    assert pub.destination.endswith(ext)
    if pub.destination.endswith(".pdf"):
        return  # a TeX engine compiled it; content is binary
    content = open(pub.destination).read()
    assert "MNIST" in content
    if backend == "markdown":
        assert "validation_error_pct" in content
        assert trained_wf.checksum()[:16] in content
        assert "digraph" in content
    if backend == "notebook":
        json.loads(content)  # valid ipynb JSON
    if backend == "latex":
        assert content.startswith("\\documentclass")
        assert "\\end{document}" in content
    if backend == "confluence":
        assert "<h2>Metrics</h2>" in content
    if backend == "html":
        html = pub.backend
        plots = sorted(trained_wf.plotters, key=lambda p: p.name)
        assert all(p.last_payload for p in plots)
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            assert html.images == [] and html.images_skipped
        else:
            assert html.images_skipped is None
            assert len(html.images) == len(plots)
            assert all(os.path.getsize(p) > 0 for p in html.images)


def test_confluence_backend_posts_page(trained_wf, tmp_path, cli_env):
    """Storage-format XHTML to the REST content endpoint of a loopback
    fake, with the settings from the backend's arguments and, for what
    they leave out, from ``root.common.publishing.confluence``."""
    import http.server
    from veles_tpu_torch.config import root
    from veles_tpu_torch.publishing import Publisher

    captured = {}

    class FakeConfluence(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            captured["path"] = self.path
            captured["auth"] = self.headers.get("Authorization")
            length = int(self.headers.get("Content-Length", 0))
            captured["doc"] = json.loads(self.rfile.read(length))
            blob = json.dumps({"id": "123", "_links": {
                "base": "http://wiki.local",
                "webui": "/display/ML/report"}}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

    httpd = http.server.HTTPServer(("127.0.0.1", 0), FakeConfluence)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    root.common.publishing.confluence.update({
        "server": "http://127.0.0.1:%d" % httpd.server_address[1],
        "space": "ML", "parent": "42"})
    try:
        pub = Publisher(trained_wf, backend="confluence",
                        output_dir=str(tmp_path), backend_config={
                            "token": "s3cret", "page": "MNIST run"})
        pub.run()
        assert captured["path"] == "/rest/api/content"
        assert captured["auth"] == "Bearer s3cret"
        doc = captured["doc"]
        assert doc["space"] == {"key": "ML"}
        assert doc["title"] == "MNIST run"
        assert doc["ancestors"] == [{"id": "42"}]
        assert doc["body"]["storage"]["representation"] == "storage"
        assert "<h2>Metrics</h2>" in doc["body"]["storage"]["value"]
        assert pub.backend.url == "http://wiki.local/display/ML/report"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(10)


def test_confluence_storage_body_matches_reference(trained_wf):
    """The storage body of one payload is the JAX backend's, byte for
    byte."""
    from veles_tpu.publishing.backends import ConfluenceBackend as Jax
    from veles_tpu_torch.publishing import Publisher
    from veles_tpu_torch.publishing.backends import ConfluenceBackend
    payload = Publisher(trained_wf).gather()
    assert ConfluenceBackend().storage_xhtml(payload) == \
        Jax().storage_xhtml(payload)


# -- forge --------------------------------------------------------------------

def _forge(pkg):
    if pkg == "port":
        from veles_tpu_torch import forge
    else:
        from veles_tpu import forge
    return forge


PAIRS = ["port-port", "port-client-jax-server", "jax-client-port-server"]


def _pair(pair):
    return {"port-port": ("port", "port"),
            "port-client-jax-server": ("port", "jax"),
            "jax-client-port-server": ("jax", "port")}[pair]


@pytest.mark.parametrize("pair", PAIRS)
def test_forge_roundtrip(tmp_path, pair):
    client_pkg, server_pkg = _pair(pair)
    client = _forge(client_pkg)
    server = _forge(server_pkg).ForgeServer(str(tmp_path / "store")).start()
    try:
        pkg = tmp_path / "model.tar.gz"
        with tarfile.open(pkg, "w:gz") as t:
            manifest = tmp_path / "contents.json"
            manifest.write_text('{"workflow": "m"}')
            t.add(manifest, arcname="contents.json")
        meta = client.upload(server.url, "mnist-mlp", "1.0", str(pkg),
                             "test model")
        assert meta["name"] == "mnist-mlp" and meta["size"] > 0
        client.upload(server.url, "mnist-mlp", "1.1", str(pkg), "newer")
        listing = client.list_packages(server.url)
        assert [m["version"] for m in listing
                if m["name"] == "mnist-mlp"] == ["1.0", "1.1"]
        path, version = client.fetch(server.url, "mnist-mlp",
                                     str(tmp_path))
        assert version == "1.1" and os.path.getsize(path) > 0
        with tarfile.open(path) as t:
            assert "contents.json" in t.getnames()
    finally:
        server.stop()


def test_forge_rejects_bad_names(tmp_path):
    from veles_tpu_torch.forge.server import ForgeStore
    store = ForgeStore(str(tmp_path))
    with pytest.raises(ValueError):
        store.save("../evil", "1.0", b"x", {})


@pytest.mark.parametrize("pair", PAIRS)
def test_forge_version_history(tmp_path, pair):
    """Two uploads of one name, ordered ``/versions`` with uploader and
    checksum, fetch by version, immutability (409) and the stored bytes
    untouched after the refused upload."""
    import urllib.error
    client_pkg, server_pkg = _pair(pair)
    client = _forge(client_pkg)
    server = _forge(server_pkg).ForgeServer(str(tmp_path / "store")).start()
    try:
        pkgs = {}
        for ver, payload in (("1.0", b"first"), ("2.0", b"second")):
            pkg = tmp_path / ("model-%s.tar.gz" % ver)
            pkg.write_bytes(payload)
            pkgs[ver] = payload
            meta = client.upload(server.url, "histnet", ver, str(pkg),
                                 "rev " + ver, uploader="ops")
            assert meta["uploader"] == "ops"
            assert len(meta["sha256"]) == 64
        history = client.versions(server.url, "histnet")
        assert [m["version"] for m in history] == ["1.0", "2.0"]
        assert history[0]["uploaded"] <= history[1]["uploaded"]
        path, got = client.fetch(server.url, "histnet", str(tmp_path),
                                 version="1.0")
        assert got == "1.0"
        with open(path, "rb") as f:
            assert f.read() == pkgs["1.0"]
        _, got = client.fetch(server.url, "histnet", str(tmp_path))
        assert got == "2.0"
        clash = tmp_path / "clash.tar.gz"
        clash.write_bytes(b"overwrite attempt")
        with pytest.raises(urllib.error.HTTPError) as ei:
            client.upload(server.url, "histnet", "1.0", str(clash))
        assert ei.value.code == 409
        path, _ = client.fetch(server.url, "histnet", str(tmp_path),
                               version="1.0")
        with open(path, "rb") as f:
            assert f.read() == pkgs["1.0"]
    finally:
        server.stop()


def test_forge_fetch_detects_corruption(tmp_path):
    from veles_tpu_torch.forge import ForgeServer, fetch, upload
    server = ForgeServer(str(tmp_path / "store")).start()
    try:
        pkg = tmp_path / "m.tar.gz"
        pkg.write_bytes(b"payload")
        upload(server.url, "cnet", "1.0", str(pkg))
        stored = tmp_path / "store" / "cnet" / "1.0" / "package.tar.gz"
        stored.write_bytes(b"tampered")
        with pytest.raises(Exception):
            fetch(server.url, "cnet", str(tmp_path), version="1.0")
    finally:
        server.stop()


def test_forge_command_line(tmp_path, capsys):
    """``python -m veles_tpu_torch.forge`` verbs: upload, list (and its
    version history), fetch."""
    from veles_tpu_torch.forge import ForgeServer
    from veles_tpu_torch.forge.client import main
    server = ForgeServer(str(tmp_path / "store")).start()
    try:
        pkg = tmp_path / "p.tar.gz"
        pkg.write_bytes(b"bytes")
        assert main(["upload", "--server", server.url, "--name", "cli",
                     "--version", "3.1", "--package", str(pkg)]) == 0
        assert main(["list", "--server", server.url]) == 0
        assert main(["list", "--server", server.url, "--name", "cli",
                     "--versions"]) == 0
        assert main(["fetch", "--server", server.url, "--name", "cli",
                     "--dest", str(tmp_path)]) == 0
        out = capsys.readouterr().out
        assert "uploaded cli==3.1 (5 bytes)" in out
        assert "cli 3.1  5 bytes" in out
        assert (tmp_path / "cli-3.1.tar.gz").read_bytes() == b"bytes"
    finally:
        server.stop()


# -- compare_snapshots --------------------------------------------------------

def _dump(obj, path):
    with gzip.open(path, "wb") as f:
        pickle.dump(obj, f)
    return str(path)


def test_compare_snapshots(trained_wf, tmp_path, capsys):
    from veles_tpu_torch.scripts.compare_snapshots import main
    a = _dump(trained_wf, tmp_path / "a.pickle.gz")
    assert main([a, a]) == 0
    assert "identical" in capsys.readouterr().out
    w = trained_wf.forwards[0].params["weights"]
    saved = w.detach().clone()
    with torch.no_grad():
        w[0, 0] += 1.0
    try:
        b = _dump(trained_wf, tmp_path / "b.pickle.gz")
    finally:
        with torch.no_grad():
            w.copy_(saved)
    assert main([a, b]) == 1
    out = capsys.readouterr().out
    assert "diverged (max delta 1.000e+00)" in out


def test_compare_snapshots_reads_a_jax_snapshot(tmp_path, capsys,
                                                cli_env):
    """A JAX package snapshot against the port's resume of it: the same
    parameters (identical); against that resume with one weight moved:
    diverged — the JAX file read through ``jax_snapshot``, without
    jax."""
    from tests.test_torch_cli import jax_sample, run_jax
    from veles_tpu.config import root as jroot
    from veles_tpu_torch.scripts.compare_snapshots import (
        main, snapshot_params)
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    run_jax([jax_sample("mnist.py"), "-c",
             "root.mnist_tpu.update({'synthetic_train': 128, "
             "'synthetic_valid': 64, 'max_epochs': 2, "
             "'minibatch_size': 64, 'layers': [8, 10], "
             "'snapshot_time_interval': 0.0})", "-c",
             "root.common.precision.compute_dtype = 'float32'",
             "-a", "numpy"])
    jax_snap = os.path.join(jroot.common.dirs.get("snapshots"),
                            "mnist_current.pickle.gz")
    resumed = SnapshotterToFile.import_file(jax_snap)
    port_copy = _dump(resumed, tmp_path / "port.pickle.gz")
    assert sorted(snapshot_params(jax_snap)) == \
        sorted(snapshot_params(port_copy))
    assert main([jax_snap, port_copy]) == 0
    assert "identical" in capsys.readouterr().out
    with torch.no_grad():
        resumed.forwards[-1].params["bias"][0] += 0.5
    moved = _dump(resumed, tmp_path / "moved.pickle.gz")
    assert main([jax_snap, moved]) == 1
    assert "diverged (max delta 5.000e-01)" in capsys.readouterr().out


# -- scripts: bboxer + update_forge -------------------------------------------

def test_bboxer_label_roundtrip(tmp_path):
    """The labeling tool serves the image tree and persists box
    selections; path escapes are refused."""
    import urllib.request as rq
    from PIL import Image
    from veles_tpu_torch.scripts.bboxer import BBoxStore, make_server

    d = tmp_path / "imgs" / "sub"
    d.mkdir(parents=True)
    for name in ("a.png", "b.png"):
        Image.fromarray(numpy.zeros((8, 8, 3), numpy.uint8)).save(d / name)
    store = BBoxStore(str(tmp_path / "boxes.json"))
    server = make_server(str(tmp_path / "imgs"), store, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    url = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        page = rq.urlopen(url + "/", timeout=5).read().decode()
        assert "canvas" in page
        imgs = json.load(rq.urlopen(url + "/api/images", timeout=5))
        assert imgs == ["sub/a.png", "sub/b.png"]
        blob = rq.urlopen(url + "/image/sub/a.png", timeout=5).read()
        assert blob[:4] == b"\x89PNG"
        boxes = [{"x": 0.1, "y": 0.2, "w": 0.3, "h": 0.4,
                  "label": "cat"}]
        req = rq.Request(url + "/api/boxes?path=sub/a.png",
                         data=json.dumps(boxes).encode())
        assert json.load(rq.urlopen(req, timeout=5))["ok"]
        got = json.load(rq.urlopen(url + "/api/boxes?path=sub/a.png",
                                   timeout=5))
        assert got == boxes
        saved = json.load(open(tmp_path / "boxes.json"))
        assert saved["sub/a.png"][0]["label"] == "cat"
        bad = rq.urlopen(url + "/api/boxes?path=../../etc/passwd",
                         timeout=5)
        assert json.load(bad) == []
    finally:
        server.shutdown()
        server.server_close()
        t.join(10)


@pytest.mark.parametrize("pair", ["port-port", "port-script-jax-server",
                                  "jax-script-port-server"])
def test_update_forge_uploads_manifests(tmp_path, pair):
    """The tree's ``forge.json`` packages land on the server; a second
    sweep skips the versions the immutable store already has."""
    from veles_tpu.scripts.update_forge import main as jax_update
    from veles_tpu_torch.scripts.update_forge import main as port_update
    script_pkg, server_pkg = {
        "port-port": ("port", "port"),
        "port-script-jax-server": ("port", "jax"),
        "jax-script-port-server": ("jax", "port")}[pair]
    update = port_update if script_pkg == "port" else jax_update
    wf_dir = tmp_path / "samples" / "mnist"
    wf_dir.mkdir(parents=True)
    (wf_dir / "model.tar.gz").write_bytes(b"package-bytes")
    (wf_dir / "forge.json").write_text(json.dumps({
        "name": "mnist-mlp", "version": "2.0",
        "description": "digit mlp", "package": "model.tar.gz"}))
    forge = _forge(server_pkg)
    server = forge.ForgeServer(str(tmp_path / "store")).start()
    try:
        assert update(["--server", server.url,
                       "--root", str(tmp_path)]) == 0
        listing = forge.list_packages(server.url)
        assert [(m["name"], m["version"]) for m in listing] == \
            [("mnist-mlp", "2.0")]
        assert update(["--server", server.url,
                       "--root", str(tmp_path)]) == 0
        assert len(forge.list_packages(server.url)) == 1
    finally:
        server.stop()


from tests.test_torch_cli import cli_env  # noqa: E402,F401 (fixture)
