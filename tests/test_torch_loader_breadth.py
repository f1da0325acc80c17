"""The port's ZeroMQ and WebHDFS loaders and the samples' real corpora,
held against the JAX package's on the CPU (the oracle is
``tests/test_loader_breadth.py``'s ZeroMQ and WebHDFS cases):

- ``ZeroMQLoader``: the same PUSH frames give both packages' loaders the
  same minibatch; a frame the restricted unpickler refuses and a sample
  of the wrong shape are dropped with a warning; ``None`` closes the
  stream; ``stop()`` ends the thread and the socket;
- ``HDFSTextLoader`` over a loopback WebHDFS gateway (LISTSTATUS, OPEN,
  nested directories): the same rows, class lengths and raw labels as
  the JAX loader, the mapping applied once;
- the MNIST IDX files (plain and gzipped) and CIFAR-10's pickle batches
  under ``root.common.dirs.datasets``, written in ``tmp_path``: both
  packages' loaders read the same data and labels; CIFAR's batches go
  through the restricted unpickler, so a batch naming a callable is
  refused; without the files both fall back to their stand-ins.

Every server and socket is stopped by the test that starts it."""

import gzip
import http.server
import json
import os
import pickle
import socketserver
import struct
import threading
import time
import urllib.parse

import numpy
import pytest

pytestmark = pytest.mark.torch_port


# -- ZeroMQ ------------------------------------------------------------------

def _push_all(endpoint, frames):
    zmq = pytest.importorskip("zmq")
    push = zmq.Context.instance().socket(zmq.PUSH)
    push.connect(endpoint)
    for f in frames:
        push.send(f)
    return push


def _frames(rng):
    good = [rng.normal(size=3).astype(numpy.float32) for _ in range(3)]
    frames = [pickle.dumps(good[0]), b"\x80\x04not a pickle",
              pickle.dumps(numpy.zeros(5, numpy.float32)),
              pickle.dumps(good[1]),
              pickle.dumps(__import__("os").getcwd),
              pickle.dumps(good[2])]
    return good, frames


def test_zmq_loader_ingests_like_the_reference(caplog):
    pytest.importorskip("zmq")
    from veles_tpu.backends import Device
    from veles_tpu.zmq_loader import ZeroMQLoader as JaxLoader
    from veles_tpu_torch.zmq_loader import ZeroMQLoader
    good, frames = _frames(numpy.random.default_rng(5))
    out = {}
    for name, cls, dev in (("port", ZeroMQLoader, "cpu"),
                           ("jax", JaxLoader, Device(backend="numpy"))):
        loader = cls(None, sample_shape=(3,), minibatch_size=4,
                     max_wait=10.0)
        loader.initialize(device=dev)
        push = _push_all(loader.endpoint, frames)
        try:
            deadline = time.time() + 10
            while loader._queue_.qsize() < 3 and time.time() < deadline:
                time.sleep(0.01)
            loader.run()
            out[name] = (loader.minibatch_size,
                         numpy.array(loader.minibatch_data.map_read().mem))
            push.send_pyobj(None)
            deadline = time.time() + 10
            while not loader.closed and time.time() < deadline:
                time.sleep(0.01)
            assert loader.closed
        finally:
            push.close(0)
            if name == "port":
                loader.stop()
                assert loader._recv_thread_ is None
                assert loader._sock_ is None
            else:
                loader._sock_.close(0)
    assert out["port"][0] == out["jax"][0] == 3
    numpy.testing.assert_array_equal(out["port"][1], out["jax"][1])
    numpy.testing.assert_array_equal(out["port"][1][:3], numpy.stack(good))
    dropped = [r for r in caplog.records
               if "dropped bad ingest frame" in r.getMessage()]
    assert len(dropped) == 6    # three bad frames, in each package


def test_zmq_loader_feeds_a_forward_chain():
    """The minibatch the loader serves goes through a small chain: the
    outputs equal the same chain's forward on the stacked samples."""
    pytest.importorskip("zmq")
    import torch
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.zmq_loader import ZeroMQLoader
    rng = numpy.random.default_rng(9)
    samples = [rng.normal(size=(4, 4, 3)).astype(numpy.float32)
               for _ in range(5)]
    loader = ZeroMQLoader(None, sample_shape=(4, 4, 3), minibatch_size=8,
                          max_wait=10.0)
    loader.initialize(device="cpu")
    chain = init_params([{"type": "conv_str", "n_kernels": 4, "kx": 3,
                          "ky": 3, "padding": 1},
                         {"type": "softmax", "output_sample_shape": (3,)}],
                        0, device="cpu", dtype="float32",
                        in_shape=(4, 4, 3))
    push = _push_all(loader.endpoint,
                     [pickle.dumps(s) for s in samples])
    try:
        deadline = time.time() + 10
        while loader._queue_.qsize() < 5 and time.time() < deadline:
            time.sleep(0.01)
        loader.run()
        assert loader.minibatch_size == 5
        x = loader.minibatch_data.devmem[:5]
        want = torch.as_tensor(numpy.stack(samples))
        for u in chain:
            x, want = u(x), u(want)
        assert torch.equal(x, want)
    finally:
        push.close(0)
        loader.stop()


# -- WebHDFS -------------------------------------------------------------------

FILES = {
    "/data/train/part-0": "1.0 2.0 cat\n3.0 4.0 dog\n",
    "/data/train/sub/part-1": "5.0 6.0 cat\n\n",
    "/data/valid/part-0": "7.0 8.0 dog\n",
}


class _WebHDFS(http.server.BaseHTTPRequestHandler):
    files = FILES

    def log_message(self, *a):
        pass

    def do_GET(self):
        url = urllib.parse.urlparse(self.path)
        q = dict(urllib.parse.parse_qsl(url.query))
        path = url.path[len("/webhdfs/v1"):]
        if q["op"] == "LISTSTATUS":
            names = sorted({f[len(path):].lstrip("/").split("/")[0]
                            for f in self.files if f.startswith(path)})
            body = json.dumps({"FileStatuses": {"FileStatus": [
                {"pathSuffix": n,
                 "type": "FILE" if path.rstrip("/") + "/" + n
                 in self.files else "DIRECTORY"} for n in names]}})
        else:  # OPEN
            body = self.files[path]
        blob = body.encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)


@pytest.fixture
def webhdfs():
    srv = socketserver.TCPServer(("127.0.0.1", 0), _WebHDFS)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield "127.0.0.1:%d" % srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    t.join(10)


def test_hdfs_text_loader_matches_reference(webhdfs):
    from veles_tpu.backends import Device
    from veles_tpu.loader.hdfs_loader import HDFSTextLoader as JaxLoader
    from veles_tpu_torch.loader.hdfs_loader import HDFSTextLoader
    got = HDFSTextLoader(None, namenode=webhdfs, train_path="/data/train",
                         validation_path="/data/valid", minibatch_size=2)
    got.initialize(device="cpu")
    want = JaxLoader(None, namenode=webhdfs, train_path="/data/train",
                     validation_path="/data/valid", minibatch_size=2)
    want.initialize(device=Device(backend="numpy"))
    assert got.class_lengths == want.class_lengths == [0, 1, 3]
    assert got.labels_mapping == want.labels_mapping == {"cat": 0,
                                                         "dog": 1}
    numpy.testing.assert_array_equal(got.original_data,
                                     want.original_data)
    numpy.testing.assert_array_equal(got.original_data,
                                     [[7, 8], [1, 2], [3, 4], [5, 6]])
    assert list(got.original_labels) == list(want.original_labels)


def test_hdfs_loader_needs_a_namenode_and_records(webhdfs):
    from veles_tpu_torch.loader.hdfs_loader import HDFSTextLoader
    with pytest.raises(ValueError, match="namenode"):
        HDFSTextLoader(None, train_path="/data/train")
    empty = HDFSTextLoader(None, namenode=webhdfs, train_path="/nothing")
    with pytest.raises(ValueError, match="no records"):
        empty.initialize(device="cpu")


# -- the real corpora ------------------------------------------------------------

def _write_idx(path, arr):
    arr = numpy.ascontiguousarray(arr, numpy.uint8)
    head = struct.pack(">HBB", 0, 0x08, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(head + arr.tobytes())


@pytest.fixture
def datasets(tmp_path, cli_env):
    """``root.common.dirs.datasets`` of both packages pointed at
    ``tmp_path``."""
    from veles_tpu.config import root as jroot
    from veles_tpu_torch.config import root
    for tree in (root, jroot):
        vars(tree.common.dirs)["datasets"] = str(tmp_path)
    return tmp_path


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_reads_the_idx_files(datasets, gz):
    from veles_tpu.backends import Device
    from veles_tpu.config import root as jroot
    from veles_tpu.samples.mnist import MnistLoader as JaxLoader
    from veles_tpu_torch.samples.mnist import MnistLoader
    rng = numpy.random.default_rng(11)
    d = datasets / "mnist"
    d.mkdir()
    sfx = ".gz" if gz else ""
    parts = {"train": 40, "t10k": 24}
    for part, n in parts.items():
        _write_idx(str(d / ("%s-images-idx3-ubyte%s" % (part, sfx))),
                   rng.integers(0, 256, (n, 28, 28)))
        _write_idx(str(d / ("%s-labels-idx1-ubyte%s" % (part, sfx))),
                   rng.integers(0, 10, n))
    got = MnistLoader(None, minibatch_size=8)
    got.initialize(device="cpu")
    jroot.mnist_tpu.update({"synthetic_train": 7, "synthetic_valid": 5})
    want = JaxLoader(None, minibatch_size=8)
    want.initialize(device=Device(backend="numpy"))
    assert got.class_lengths == want.class_lengths == [0, 24, 40]
    numpy.testing.assert_array_equal(got.original_data, want.original_data)
    assert list(got.original_labels) == list(want.original_labels)


def test_mnist_falls_back_without_every_file(datasets):
    from veles_tpu_torch.samples.mnist import MnistLoader
    d = datasets / "mnist"
    d.mkdir()
    _write_idx(str(d / "train-images-idx3-ubyte"), numpy.zeros((4, 28, 28)))
    got = MnistLoader(None, synthetic_train=32, synthetic_valid=16,
                      minibatch_size=8)
    got.initialize(device="cpu")
    assert got.class_lengths == [0, 16, 32]


def _cifar_batch(rng, n):
    return {b"data": rng.integers(0, 256, (n, 3072)).astype(numpy.uint8),
            b"labels": rng.integers(0, 10, n).tolist()}


def test_cifar_reads_the_pickle_batches(datasets):
    from veles_tpu.backends import Device
    from veles_tpu.samples.cifar import CifarLoader as JaxLoader
    from veles_tpu_torch.samples.cifar import CifarLoader
    rng = numpy.random.default_rng(13)
    d = datasets / "cifar10"
    d.mkdir()
    names = ["data_batch_%d" % i for i in range(1, 6)] + ["test_batch"]
    for name in names:
        with open(d / name, "wb") as f:
            pickle.dump(_cifar_batch(rng, 6), f, protocol=2)
    got = CifarLoader(None, minibatch_size=6)
    got.initialize(device="cpu")
    want = JaxLoader(None, minibatch_size=6)
    want.initialize(device=Device(backend="numpy"))
    assert got.class_lengths == want.class_lengths == [0, 6, 30]
    assert got.original_data.shape == (36, 32, 32, 3)
    numpy.testing.assert_array_equal(got.original_data, want.original_data)
    assert list(got.original_labels) == list(want.original_labels)


def test_cifar_batches_go_through_the_restricted_unpickler(datasets):
    from veles_tpu_torch.samples.cifar import CifarLoader
    rng = numpy.random.default_rng(13)
    d = datasets / "cifar10"
    d.mkdir()
    for i in range(1, 6):
        with open(d / ("data_batch_%d" % i), "wb") as f:
            pickle.dump(_cifar_batch(rng, 2), f, protocol=2)
    with open(d / "test_batch", "wb") as f:
        pickle.dump({b"data": os.getcwd, b"labels": []}, f, protocol=2)
    loader = CifarLoader(None, minibatch_size=2)
    with pytest.raises(pickle.UnpicklingError):
        loader.initialize(device="cpu")
    os.remove(d / "test_batch")
    fallback = CifarLoader(None, synthetic_train=16, synthetic_valid=8,
                           minibatch_size=8)
    fallback.initialize(device="cpu")
    assert fallback.class_lengths == [0, 8, 16]


from tests.test_torch_cli import cli_env  # noqa: E402,F401 (fixture)
