"""The serving workflow (``samples/serve.py``: ``RESTfulAPI`` as a unit
behind a ``RestfulLoader``) held against the JAX package's on the CPU.

The JAX ``Main`` trains MNIST and the LM small (float32) and writes
their snapshots; each package's command line serves the same snapshot
(``samples/serve.py`` with ``root.serve.snapshot``) on a loopback port,
each run on its own thread.  ``POST /api`` replies agree within 1e-5
and its errors (a sample of the wrong shape, a malformed body) are the
same status codes; the LM snapshot's ``POST /generate`` gives the same
greedy tokens; ``POST /shutdown`` ends both runs through their gates
and both return 0.  The port's idle waves skip the chain."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy
import pytest

from tests.test_torch_cli import (  # noqa: F401 (fixture)
    F32, cli_env, jax_sample, port_sample, run_jax)

pytestmark = pytest.mark.torch_port

MNIST_KEYS = ("root.mnist_tpu.update({'synthetic_train': 256, "
              "'synthetic_valid': 128, 'max_epochs': 2, "
              "'minibatch_size': 64, 'layers': [16, 10], "
              "'snapshot_time_interval': 0.0})")
LM_KEYS = ("root.lm_tpu.update({'max_epochs': 2, 'dim': 32, 'blocks': 1, "
           "'heads': 2, 'seq': 16, 'vocab': 16, 'synthetic_train': 128, "
           "'synthetic_valid': 32, 'minibatch_size': 32, "
           "'snapshot_time_interval': 0.0})")


def post(port, path, body=None, timeout=60):
    data = json.dumps(body if body is not None else {}).encode()
    req = urllib.request.Request("http://127.0.0.1:%d%s" % (port, path),
                                 data=data)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, None


class Served:
    """One package's ``Main`` serving a snapshot on its own thread."""

    def __init__(self, main_cls, argv):
        self.main = main_cls(argv)
        self.rc = None
        self.error = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        deadline = time.time() + 120
        while time.time() < deadline:
            wf = self.main.workflow
            api = getattr(wf, "api", None) if wf is not None else None
            if api is not None and getattr(api, "_server_", None) \
                    is not None:
                self.port = api.port
                return
            if self.error is not None:
                raise self.error
            time.sleep(0.05)
        raise TimeoutError("the server did not come up")

    def _run(self):
        try:
            self.rc = self.main.run()
        except BaseException as e:  # surfaced by the test
            self.error = e

    def shutdown(self):
        assert post(self.port, "/shutdown")[0] == 200
        self.thread.join(60)
        assert not self.thread.is_alive()
        if self.error is not None:
            raise self.error
        return self.rc


def serve_both(sample, snap, extra=()):
    from veles_tpu import prng
    from veles_tpu.__main__ import Main as JaxMain
    from veles_tpu_torch.__main__ import Main
    keys = ["-c", "root.serve.update({'snapshot': %r, 'workflow': %r, "
            "'max_wait': 0.05})" % (snap, jax_sample(sample)),
            "-c", F32, "-a", "numpy"] + list(extra)
    with prng.get().preserve_state():
        ref = Served(JaxMain, [jax_sample("serve.py")] + keys)
    mine = Served(Main, [port_sample("serve.py")] + keys)
    return mine, ref


def test_serve_api_equals_reference(cli_env):
    run_jax([jax_sample("mnist.py"), "-c", MNIST_KEYS, "-c", F32,
             "-a", "numpy"])
    from veles_tpu.config import root as jroot
    snap = os.path.join(jroot.common.dirs.get("snapshots"),
                        "mnist_current.pickle.gz")
    mine, ref = serve_both("mnist.py", snap)
    try:
        rng = numpy.random.default_rng(0)
        for _ in range(3):
            x = rng.random(784).astype(numpy.float32).tolist()
            (c1, got), (c2, want) = post(mine.port, "/api", {"input": x}), \
                post(ref.port, "/api", {"input": x})
            assert c1 == c2 == 200
            numpy.testing.assert_allclose(got["result"], want["result"],
                                          rtol=1e-5, atol=1e-5)
            assert abs(sum(got["result"]) - 1.0) < 1e-5
        # concurrent requests each get their own row
        xs = [rng.random(784).astype(numpy.float32).tolist()
              for _ in range(6)]
        out = [None] * len(xs)

        def one(i):
            out[i] = post(mine.port, "/api", {"input": xs[i]})
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        for i, x in enumerate(xs):
            code, want = post(ref.port, "/api", {"input": x})
            assert out[i][0] == code == 200
            numpy.testing.assert_allclose(out[i][1]["result"],
                                          want["result"], rtol=1e-5,
                                          atol=1e-5)
        # the errors: a wrong-shaped sample and a body without "input"
        for body in ({"input": [0.0, 1.0]}, {"prompt": [1]}):
            assert post(mine.port, "/api", body)[0] == \
                post(ref.port, "/api", body)[0] == 500
        # idle waves skipped the chain: it ran once per served batch
        wf = mine.main.workflow
        assert wf.chain.timers["runs"] <= wf.loader.timers["runs"]
        assert wf.chain.timers["runs"] < wf.repeater.timers["runs"]
    finally:
        assert mine.shutdown() == 0
        assert ref.shutdown() == 0
    assert bool(mine.main.workflow.loader.stop_requested)


def test_serve_generate_on_lm_snapshot(cli_env):
    run_jax([jax_sample("lm.py"), "-c", LM_KEYS, "-c", F32, "-a", "numpy"])
    from veles_tpu.config import root as jroot
    snap = os.path.join(jroot.common.dirs.get("snapshots"),
                        "lm_current.pickle.gz")
    spec_off = ["-c", "root.common.serving.update({'spec': False, "
                "'warm_buckets': False})"]
    mine, ref = serve_both("lm.py", snap, spec_off)
    try:
        from veles_tpu_torch.models.generate import generate
        import torch
        for body in ({"prompt": [3, 1, 4], "steps": 8},
                     {"prompt": [[5, 2], [7, 7, 1]], "steps": 5}):
            (c1, got), (c2, want) = post(mine.port, "/generate", body), \
                post(ref.port, "/generate", body)
            assert c1 == c2 == 200
            assert got["tokens"] == want["tokens"]
        # the scheduler's greedy tokens are the chain's own generate's
        chain = mine.main.workflow.forwards
        direct = generate(chain, torch.tensor([[3, 1, 4]]), 8)
        assert post(mine.port, "/generate",
                    {"prompt": [3, 1, 4], "steps": 8})[1]["tokens"] == \
            direct[0].tolist()
        assert mine.main.workflow.api.scheduler_ is not None
    finally:
        assert mine.shutdown() == 0
        assert ref.shutdown() == 0
