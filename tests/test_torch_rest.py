"""The REST and OpenAI server of the PyTorch port
(``veles_tpu_torch/restful_api.py``) held against the JAX package's
``RESTfulAPI`` on the CPU: both serve the reference's REST fixture (an
embedding of vocab 11 and dim 8, a 2-head causal block and token
logits, window 24, 2 slots) on the same weights over loopback, the
same requests go to both, and the decoded replies are compared.

Oracles: ``tests/test_serving.py::test_rest_*`` and
``tests/test_streaming.py::test_rest_sse_*`` /
``::test_openai_facade_roundtrip``.

Tolerances: tokens are exact (greedy, seeded sampled, ragged, stop,
beam, the serialized decode, SSE frames, ``/v1/completions``); beam
scores, embeddings and class log-probabilities agree within 1e-5 in
f32; error replies carry the same status, headers and body, less the
trace id.  ``id``, ``created`` and ``trace_id`` are left out of every
comparison (random or clock)."""

import concurrent.futures
import json
import socket
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy
import pytest

from veles_tpu import faults as jax_faults
from veles_tpu import prng as jax_prng
from veles_tpu.config import root
from veles_tpu_torch import faults

from tests.test_torch_metrics import _compare_metrics
from tests.test_torch_serving import _spec
from tests.test_torch_transformer import port_chain

pytestmark = pytest.mark.torch_port

WINDOW = 24
#: the /generate caps both servers run with
MAX_STEPS, MAX_BATCH = 20, 4


def _jax_chain():
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.backends import Device
    from veles_tpu.memory import Array
    from veles_tpu.models.standard import make_forwards
    dev = Device(backend="numpy")
    wf = AcceleratedWorkflow(None, name="torch-rest")
    fw = make_forwards(
        wf, Array(numpy.zeros((1, WINDOW), numpy.int32)), [
            {"type": "embedding", "vocab": 11, "dim": 8},
            {"type": "transformer_block", "heads": 2, "causal": True},
            {"type": "token_logits", "vocab": 11}])
    for u in fw:
        u.initialize(device=dev)
    return wf, dev, fw


class Pair:
    """The reference's server and the port's on the same weights."""

    def __init__(self, **kwargs):
        from veles_tpu.restful_api import RESTfulAPI as JAPI, RestfulLoader
        from veles_tpu_torch.restful_api import RESTfulAPI
        wf, dev, fw = _jax_chain()
        self.loader = RestfulLoader(wf, sample_shape=(WINDOW,),
                                    minibatch_size=1, max_wait=10.0)
        self.loader.initialize(device=dev)
        kwargs = dict(dict(max_slots=2, serving_warm_buckets=False,
                           max_steps=MAX_STEPS, max_batch=MAX_BATCH),
                      **kwargs)
        self.ref = JAPI(wf, loader=self.loader, forwards=fw,
                        name="torch-rest-api", **kwargs)
        self.ref.output = fw[-1].output
        self.port = RESTfulAPI(forwards=port_chain(_spec(fw), fw),
                               device="cpu", **kwargs)
        self.ref.initialize()
        self.port.initialize()

    @property
    def apis(self):
        return self.port, self.ref

    def both(self, path, body=None, headers=None):
        """The same request to both servers: (port reply, reference
        reply), each (status, headers, decoded body)."""
        return tuple(call(api, path, body, headers) for api in self.apis)

    def stop(self):
        for api in self.apis:
            api.stop()
        self.loader.close()


def call(api, path, body=None, headers=None, timeout=120):
    """One request; (status, headers, body: JSON decoded, else bytes)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (api.port, path), data=data,
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        resp = e
    raw = resp.read()
    try:
        out = json.loads(raw)
    except ValueError:
        out = raw
    return resp.status if hasattr(resp, "status") else resp.code, \
        resp.headers, out


def strip(obj):
    """``obj`` without its random and clock fields."""
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items()
                if k not in ("id", "created", "trace_id")}
    if isinstance(obj, list):
        return [strip(v) for v in obj]
    return obj


def sse_events(raw):
    """An SSE body → its JSON payloads and whether ``data: [DONE]``
    ended it."""
    events, done = [], False
    for line in raw.split(b"\n"):
        if line == b"data: [DONE]":
            done = True
            break
        if line.startswith(b"data: "):
            events.append(json.loads(line[6:]))
    return events, done


@pytest.fixture(scope="module")
def pair():
    from veles_tpu_torch.config import root as port_root
    saved = {"compute_dtype": root.common.precision.get(
        "compute_dtype", "bfloat16")}
    for tree in (root, port_root):
        saved[tree] = (tree.common.alerts.get("enabled", True),
                       tree.common.tsdb.get("enabled", True))
        # both servers with their alert and history engines off: a
        # live engine's replies carry clocks (test_torch_alerts and
        # test_torch_tsdb compare the live engines)
        tree.common.alerts.enabled = False
        tree.common.tsdb.enabled = False
    root.common.precision.compute_dtype = "float32"
    p = Pair()
    try:
        yield p
    finally:
        p.stop()
        root.common.precision.compute_dtype = saved["compute_dtype"]
        for tree in (root, port_root):
            (tree.common.alerts.enabled,
             tree.common.tsdb.enabled) = saved[tree]


@pytest.fixture(autouse=True)
def disarm():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


def _same(got, want):
    assert got[0] == want[0], (got, want)
    assert strip(got[2]) == strip(want[2])


# -- /generate ----------------------------------------------------------------

GENERATE = {
    "greedy": {"prompt": [3, 1, 4], "steps": 6},
    "sampled": {"prompt": [3, 1, 4], "steps": 6, "seed": 5,
                "temperature": 0.8, "top_k": 4},
    "sampled_batch": {"prompt": [[3, 1, 4], [5, 2]], "steps": 7, "seed": 11,
                      "temperature": 0.9},
    "ragged": {"prompt": [[3, 1, 4], [5], [7, 2, 9, 1]], "steps": 5},
    "high": {"prompt": [2, 7], "steps": 9, "priority": "high"},
    "low_int": {"prompt": [[2, 7], [8]], "steps": 4, "priority": 0},
    "zero_steps": {"prompt": [3, 1], "steps": 0},
    "long": {"prompt": [1, 2, 3, 4, 5, 6, 7, 8, 9, 10], "steps": 14},
}


@pytest.mark.parametrize("name", sorted(GENERATE))
def test_generate_matches_reference(pair, name):
    got, want = pair.both("/generate", GENERATE[name])
    _same(got, want)
    assert got[0] == 200 and got[2]["tokens"]


def test_stop_token_matches_reference(pair):
    _, _, full = call(pair.ref, "/generate", {"prompt": [5, 2], "steps": 14})
    gen = full["tokens"][2:]
    for stop in (gen[0], gen[5], (max(gen) + 1) % 11):
        body = {"prompt": [[5, 2], [3, 1, 4]], "steps": 14, "stop": stop}
        got, want = pair.both("/generate", body)
        _same(got, want)
        row = got[2]["tokens"][0]
        if stop in gen:
            assert row[-1] == stop and row[2:].index(stop) == len(row) - 3


@pytest.mark.parametrize("beam,prompt", [(2, [3, 1, 4]), (3, [3, 1, 4]),
                                         (2, [[3, 1, 4], [5, 2, 6]])])
def test_beam_matches_reference(pair, beam, prompt):
    body = {"prompt": prompt, "steps": 5, "beam": beam}
    got, want = pair.both("/generate", body)
    assert got[0] == want[0] == 200
    assert got[2]["tokens"] == want[2]["tokens"]
    assert got[2]["beams"] == want[2]["beams"]
    numpy.testing.assert_allclose(got[2]["scores"], want[2]["scores"],
                                  rtol=0, atol=1e-5)
    assert all(isinstance(s, float)
               for s in numpy.ravel(got[2]["scores"]).tolist())


def test_serialized_decode_matches_reference(pair):
    """``serving=False``: the legacy decode (``generate`` under the
    lock, kv form) gives the reference's tokens, greedy and seeded."""
    legacy = Pair(serving=False)
    try:
        assert legacy.port.scheduler_ is None and legacy.ref.scheduler_ is None
        for body in (GENERATE["greedy"], GENERATE["sampled"],
                     GENERATE["sampled_batch"], GENERATE["ragged"],
                     {"prompt": [5, 2], "steps": 12, "stop": 6},
                     {"prompt": [[5, 2, 1], [3]], "steps": 8, "stop": 6,
                      "temperature": 0.7, "seed": 3}):
            got, want = legacy.both("/generate", body)
            _same(got, want)
        # an unpinned seed draws a fresh stream per call
        body = {"prompt": [3, 1, 4], "steps": 12, "temperature": 1.0}
        draws = {tuple(call(legacy.port, "/generate", body)[2]["tokens"])
                 for _ in range(4)}
        assert len(draws) > 1
        # the OpenAI facade needs the scheduler
        got, want = legacy.both("/v1/completions", {"prompt": [3, 1]})
        _same(got, want)
        assert got[0] == 501
    finally:
        legacy.stop()


def test_concurrent_clients_get_their_solo_replies(pair):
    """Eight concurrent clients each get the reference's solo reply."""
    prompts = [[3, 1, 4], [5], [7, 2], [1, 9, 2, 4], [6, 6], [0, 10, 3],
               [8, 1], [2]]
    solo = [call(pair.ref, "/generate", {"prompt": p, "steps": 10})[2]
            ["tokens"] for p in prompts]
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as ex:
        replies = list(ex.map(lambda p: call(pair.port, "/generate",
                                             {"prompt": p, "steps": 10}),
                              prompts))
    assert [r[0] for r in replies] == [200] * len(prompts)
    assert [r[2]["tokens"] for r in replies] == solo
    pair.port.scheduler_.check_kv()


def test_handler_threads_beside_the_loop(pair):
    """Beam search and embeddings on handler threads while scheduled
    requests decode on the loop, the interpreter switching threads every
    10 µs: every reply equals its solo reply (the paths share the chain
    and its cached weight casts, and write nothing the other reads)."""
    import sys
    jobs = [("/generate", {"prompt": [3, 1, 4], "steps": 12}),
            ("/generate", {"prompt": [5, 2], "steps": 9, "seed": 3,
                           "temperature": 0.9}),
            ("/generate", {"prompt": [3, 1, 4], "steps": 6, "beam": 3}),
            ("/v1/embeddings", {"input": [[3, 1, 4], [7, 7]]}),
            ("/v1/classify", {"input": [[2, 9, 4]]})] * 4
    solo = {i: call(pair.port, path, body)[2] for i, (path, body)
            in enumerate(jobs[:5])}
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
            replies = list(ex.map(
                lambda job: call(pair.port, *job, timeout=60), jobs))
    finally:
        sys.setswitchinterval(saved)
    for i, (code, _, body) in enumerate(replies):
        assert code == 200
        assert strip(body) == strip(solo[i % 5]), jobs[i]
    pair.port.scheduler_.check_kv()


# -- SSE ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["greedy", "sampled", "long"])
def test_sse_generate_matches_batch_and_reference(pair, name):
    body = GENERATE[name]
    batch = call(pair.port, "/generate", body)[2]["tokens"]
    replies = pair.both("/generate", dict(body, stream=True))
    frames = []
    for code, headers, raw in replies:
        assert code == 200
        assert headers["Content-Type"] == "text/event-stream"
        assert headers["X-Veles-Replica"]
        events, done = sse_events(raw)
        assert done, "no [DONE] frame"
        toks = [e["token"] for e in events if "token" in e]
        final = events[-1]
        assert final["done"] is True and final["trace_id"]
        assert body["prompt"] + toks == final["tokens"] == batch
        assert final["usage"] == {
            "prompt_tokens": len(body["prompt"]),
            "completion_tokens": len(toks),
            "total_tokens": len(body["prompt"]) + len(toks)}
        frames.append(strip(events))
    assert frames[0] == frames[1]


def test_sse_disconnect_frees_slot_and_blocks(pair):
    """A client that resets its socket mid-stream cancels its request:
    the slot and blocks return, ``check_kv()`` is clean and
    ``requests_cancelled`` counts it — in both packages."""
    for api in pair.apis:
        sch = api.scheduler_
        faults.inject("serving.scheduler.step", "delay", 0.02)
        jax_faults.inject("serving.scheduler.step", "delay", 0.02)
        cancelled = sch.metrics()["requests_cancelled"]
        s = socket.create_connection(("127.0.0.1", api.port), timeout=30)
        body = json.dumps({"prompt": [3, 1, 4], "steps": 18,
                           "stream": True}).encode()
        s.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\n"
                  b"Content-Length: %d\r\n\r\n" % len(body) + body)
        assert s.recv(64), "no SSE bytes arrived"
        # RST, not FIN: the server's next write fails at once
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack("ii", 1, 0))
        s.close()
        deadline = time.monotonic() + 30
        while sch.in_flight:
            assert time.monotonic() < deadline, "stream not reaped"
            time.sleep(0.02)
        faults.clear()
        jax_faults.clear()
        sch.check_kv()
        assert sch.metrics()["requests_cancelled"] == cancelled + 1
    cache = pair.port.scheduler_.cache_
    assert cache.free_slots == cache.max_slots


# -- the OpenAI facade --------------------------------------------------------

@pytest.mark.parametrize("body", [
    {"prompt": [3, 1, 4], "max_tokens": 6},
    {"prompt": [[3, 1, 4], [5, 2]], "max_tokens": 4, "echo": True},
    {"prompt": [3, 1], "max_tokens": 5, "top_p": 1, "n": 1,
     "frequency_penalty": 0, "model": "other"},
    {"prompt": [5, 2], "max_tokens": 9, "temperature": 0.8, "top_k": 3,
     "seed": 9, "priority": "low"},
    {"prompt": [5, 2], "max_tokens": 12, "stop": 6},
], ids=["plain", "echo_batch", "neutral", "sampled", "stop"])
def test_completions_match_reference(pair, body):
    got, want = pair.both("/v1/completions", body)
    _same(got, want)
    assert got[0] == 200 and got[2]["object"] == "text_completion"
    assert got[2]["id"].startswith("cmpl-")
    batch = [c["tokens"] for c in got[2]["choices"]]
    if not body.get("echo") and not isinstance(body["prompt"][0], list):
        replies = pair.both("/v1/completions", dict(body, stream=True))
        chunks = []
        for code, _, raw in replies:
            events, done = sse_events(raw)
            assert code == 200 and done
            toks = [t for e in events for t in e["choices"][0]["tokens"]]
            assert toks == batch[0]
            assert events[-1]["choices"][0]["finish_reason"] \
                == got[2]["choices"][0]["finish_reason"]
            assert events[-1]["usage"] == got[2]["usage"]
            chunks.append(strip(events))
        assert chunks[0] == chunks[1]


def test_models_embeddings_classify_match_reference(pair):
    got, want = pair.both("/v1/models")
    _same(got, want)
    assert got[2]["data"][0]["id"] == "veles-lm"
    for body in ({"input": [[3, 1, 4], [5, 2]]}, {"input": [3, 1, 4]},
                 {"input": [[7] * 20, [1]], "model": "emb"}):
        got, want = pair.both("/v1/embeddings", body)
        assert got[0] == want[0] == 200
        g = numpy.asarray([d["embedding"] for d in got[2]["data"]])
        w = numpy.asarray([d["embedding"] for d in want[2]["data"]])
        numpy.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        numpy.testing.assert_allclose(numpy.linalg.norm(g, axis=-1), 1.0,
                                      rtol=0, atol=1e-5)
        for d in got[2]["data"]:
            d["embedding"] = None
        for d in want[2]["data"]:
            d["embedding"] = None
        assert got[2] == want[2]
    for body in ({"input": [[3, 1, 4]], "top": 3},
                 {"input": [[3, 1, 4], [9, 9, 9, 2]]}):
        got, want = pair.both("/v1/classify", body)
        assert got[0] == want[0] == 200
        g = numpy.asarray([d["logprobs"] for d in got[2]["data"]])
        w = numpy.asarray([d["logprobs"] for d in want[2]["data"]])
        numpy.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        assert numpy.allclose(numpy.exp(g).sum(-1), 1.0, atol=1e-4)
        assert [d["label"] for d in got[2]["data"]] \
            == [d["label"] for d in want[2]["data"]]
        assert [[t["label"] for t in d["top"]] for d in got[2]["data"]] \
            == [[t["label"] for t in d["top"]] for d in want[2]["data"]]
        assert got[2]["usage"] == want[2]["usage"]


# -- errors -------------------------------------------------------------------

#: (path, body) pairs that must answer the same 4xx/5xx in both packages:
#: every 400 of tests/test_serving.py:547-579 (at this fixture's caps) and
#: tests/test_streaming.py:397-414, and the other refusals of the routes
ERRORS = [
    ("/generate", {"steps": 2}),
    ("/generate", {"prompt": 7, "steps": 2}),
    ("/generate", {"prompt": "hi", "steps": 2}),
    ("/generate", {"prompt": [3, [1]], "steps": 2}),
    ("/generate", {"prompt": [3, 1]}),
    ("/generate", {"prompt": [3, 1], "steps": "many"}),
    ("/generate", {"prompt": [3, 1], "steps": -1}),
    ("/generate", {"prompt": [3, 1], "steps": 2, "stop": "eos"}),
    ("/generate", {"prompt": [3, 1], "steps": 99}),
    ("/generate", {"prompt": [[3], [1], [4], [1], [5]], "steps": 2}),
    ("/generate", {"prompt": [], "steps": 2}),
    ("/generate", {"prompt": [[3], []], "steps": 2}),
    ("/generate", {"prompt": [3, 11], "steps": 2}),
    ("/generate", {"prompt": [-1], "steps": 2}),
    ("/generate", {"prompt": [3], "steps": 2, "temperature": "x"}),
    ("/generate", {"prompt": [3], "steps": 2, "top_k": 3}),
    ("/generate", {"prompt": [3], "steps": 2, "beam": "wide"}),
    ("/generate", {"prompt": [3], "steps": 2, "beam": -1}),
    ("/generate", {"prompt": [3], "steps": 2, "beam": 2,
                   "temperature": 0.5}),
    ("/generate", {"prompt": [3], "steps": 2, "beam": 2, "stop": 1}),
    ("/generate", {"prompt": [[3, 1], [2]], "steps": 2, "beam": 2}),
    ("/generate", {"prompt": [3], "steps": 2, "beam": 12}),
    ("/generate", {"prompt": [3], "steps": 2, "priority": "urgent"}),
    ("/generate", {"prompt": [3], "steps": 2, "priority": 7}),
    ("/generate", {"prompt": [[3], [1]], "steps": 2, "stream": True}),
    ("/generate", {"prompt": [3], "steps": 0, "stream": True}),
    ("/generate", {"prompt": [3], "steps": 2, "stream": True, "beam": 2}),
    ("/generate", {"prompt": [3], "steps": 2, "resume_tokens": "x"}),
    ("/generate", {"prompt": [3], "steps": 2, "resume_tokens": [99]}),
    ("/generate", {"prompt": [[3], [1]], "steps": 2,
                   "resume_tokens": [1]}),
    ("/generate", {"prompt": [1] * 20, "steps": 20}),
    ("/generate", {"prompt": [3], "steps": 3, "resume_tokens": [1, 2, 3]}),
    ("/v1/completions", {"max_tokens": 2}),
    ("/v1/completions", {"prompt": "text", "max_tokens": 2}),
    ("/v1/completions", {"prompt": [3, 1], "max_tokens": 2, "n": 3}),
    ("/v1/completions", {"prompt": [3, 1], "max_tokens": 2,
                         "priority": "urgent"}),
    ("/v1/completions", {"prompt": [3, 1], "max_tokens": 99}),
    ("/v1/completions", {"prompt": [[3]] * 5, "max_tokens": 2}),
    ("/v1/completions", {"prompt": [3, 11]}),
    ("/v1/completions", {"prompt": [[3], [1]], "stream": True}),
    ("/v1/completions", {"prompt": [1] * 20, "max_tokens": 10}),
    ("/v1/completions", {"prompt": [3], "top_k": 2}),
    ("/v1/embeddings", {"input": []}),
    ("/v1/embeddings", {"input": [99, 1]}),
    ("/v1/embeddings", {"input": [[1]] * 5}),
    ("/v1/embeddings", {"input": [1] * 30}),
    ("/v1/classify", {"input": [1, 2], "top": "many"}),
    ("/v1/classify", {}),
    ("/nowhere", {}),
]


@pytest.mark.parametrize("path,body", ERRORS,
                         ids=["%s %s" % (p, json.dumps(b)[:40])
                              for p, b in ERRORS])
def test_errors_match_reference(pair, path, body):
    got, want = pair.both(path, body)
    assert got[0] == want[0] >= 400, (got, want)
    assert strip(got[2]) == strip(want[2])
    assert got[2]["error"]["trace_id"] == got[1]["X-Veles-Trace"]
    assert got[1]["Content-Type"] == "application/json"


def test_trace_header_and_get_404(pair):
    got, want = pair.both("/generate", GENERATE["greedy"],
                          headers={"X-Veles-Trace": "client-trace-7"})
    assert got[1]["X-Veles-Trace"] == want[1]["X-Veles-Trace"] \
        == "client-trace-7"
    assert got[1]["X-Veles-Replica"] == pair.port.replica_id
    got, want = pair.both("/nowhere")
    _same(got, want)
    assert got[0] == 404


def test_injected_http_error(pair):
    """``restful.generate=http_error:503`` answers a structured 503 with
    ``Retry-After: 1`` on every client route."""
    for path, body in (("/generate", GENERATE["greedy"]),
                       ("/v1/completions", {"prompt": [3]}),
                       ("/v1/embeddings", {"input": [3]})):
        faults.load("restful.generate=http_error:503x1")
        jax_faults.load("restful.generate=http_error:503x1")
        got, want = pair.both(path, body)
        _same(got, want)
        assert got[0] == 503 and got[1]["Retry-After"] == "1" \
            == want[1]["Retry-After"]
    faults.load("restful.generate=http_error:418x1")
    jax_faults.load("restful.generate=http_error:418x1")
    got, want = pair.both("/generate", GENERATE["greedy"])
    _same(got, want)
    assert got[0] == 418 and got[1]["Retry-After"] is None
    # any other failure of a route answers a structured 500
    faults.load("restful.generate=exceptionx1")
    jax_faults.load("restful.generate=exceptionx1")
    got, want = pair.both("/v1/completions", {"prompt": [3]})
    _same(got, want)
    assert got[0] == 500


@pytest.mark.parametrize("error", [
    ValueError("one\ntwo\r\n\tthree"), RuntimeError(""), KeyError("k"),
    ValueError("naïve → ü " + "x" * 300), ValueError("  \n ")])
def test_status_text_matches_reference(error):
    """Multi-line and non-latin error text fits a status line as the
    reference's does."""
    from veles_tpu.restful_api import _status_text as want
    from veles_tpu_torch.restful_api import _status_text as got
    assert got(error) == want(error)
    assert "\n" not in got(error) and len(got(error)) <= 200
    got(error).encode("latin-1")


def test_queue_full_and_queue_deadline(pair):
    """A full queue answers 503 with the class's Retry-After; a request
    whose deadline passes while it queues answers 408 with
    ``tokens_generated`` 0."""
    for api in pair.apis:
        api.scheduler_.max_queue = 0
    try:
        for prio, after in (("low", "4"), ("normal", "2"), ("high", "1")):
            got, want = pair.both("/generate", dict(GENERATE["greedy"],
                                                    priority=prio))
            _same(got, want)
            assert got[0] == 503
            assert got[1]["Retry-After"] == want[1]["Retry-After"] == after
    finally:
        for api in pair.apis:
            api.scheduler_.max_queue = 32
    replies = []
    for api, reg in ((pair.port, faults), (pair.ref, jax_faults)):
        # the first step of a request hangs the loop; a request sent
        # meanwhile queues past its 0.2 s deadline
        reg.inject("serving.scheduler.step", "hang", 1.5, times=1)
        first = threading.Thread(target=call, args=(
            api, "/generate", {"prompt": [3, 1, 4], "steps": 4}))
        first.start()
        deadline = time.monotonic() + 30
        while not api.scheduler_.metrics()["active_slots"]:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        saved, api.request_timeout = api.request_timeout, 0.2
        try:
            replies.append(call(api, "/generate",
                                {"prompt": [5, 2], "steps": 3}))
        finally:
            api.request_timeout = saved
        first.join(60)
        assert not first.is_alive()
    for code, _, body in replies:
        assert code == 408
        assert body["error"]["tokens_generated"] == 0
        assert body["error"]["message"].startswith("queued ")
    assert set(replies[0][2]["error"]) == set(replies[1][2]["error"])


def test_alerts_history_and_unported_routes(pair):
    """``/alerts`` and ``/metrics/history`` answer the reference's
    replies with both engines off; ``POST /api`` on a server outside a serving
    workflow (no RestfulLoader) is the reference's 500, structured; the
    KV routes are served (their error replies are the reference's)."""
    got, want = pair.both("/alerts")
    _same(got, want)
    assert got[2] == {"enabled": False}
    got, want = pair.both("/metrics/history")
    _same(got, want)
    assert got[0] == 503
    code, _, body = call(pair.port, "/api", {"input": [1]})
    assert code == 500 and body["error"]["code"] == 500
    assert "RestfulLoader" in body["error"]["message"]
    for path, body in (("/serving/prefill", {"prompt": [[1], [2]]}),
                       ("/serving/kv_import", {"export": {}, "steps": 2}),
                       ("/serving/prefix_import", {"record": {}}),
                       ("/serving/kv_export/abc", None)):
        got, want = pair.both(path, body)
        _same(got, want)
        assert got[0] in (400, 404)


def test_healthz_debug_requests_and_metrics_text(pair):
    got, want = pair.both("/healthz?probe=1")
    assert got[0] == want[0] == 200
    assert set(got[2]) == set(want[2])
    for key in ("status", "draining", "role", "tp"):
        assert got[2][key] == want[2][key]
    assert set(got[2]["health"]) == set(want[2]["health"])
    # a request held in flight by a hung step: the in-flight tables
    rows = []
    for api, reg in ((pair.port, faults), (pair.ref, jax_faults)):
        reg.inject("serving.scheduler.step", "hang", 1.0, times=1)
        t = threading.Thread(target=call, args=(
            api, "/generate", {"prompt": [3, 1, 4], "steps": 3}))
        t.start()
        deadline = time.monotonic() + 30
        while not api.scheduler_.metrics()["active_slots"]:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        rows.append(call(api, "/debug/requests")[2])
        t.join(60)
    got, want = rows
    assert set(got) == set(want) and got["draining"] is False
    assert len(got["requests"]) == len(want["requests"]) == 1
    assert set(got["requests"][0]) == set(want["requests"][0])
    assert got["requests"][0]["phase"] == want["requests"][0]["phase"]
    texts = [call(api, "/metrics")[2].decode() for api in pair.apis]

    def families(text):
        return {line.split()[2] for line in text.splitlines()
                if line.startswith("# TYPE veles_serving_")}

    assert families(texts[0]) == families(texts[1])
    assert "veles_serving_requests_completed_total" in families(texts[0])


# -- a fresh pair: metrics, drain, shutdown, stop -----------------------------

@pytest.fixture
def fresh(pair):
    p = Pair()
    try:
        yield p
    finally:
        p.stop()


def test_metrics_drain_shutdown_and_stop(fresh):
    """After the same sequential traffic both ``/serving/metrics`` give
    the same keys and counters; ``/drain`` answers 202, ``/healthz``
    then 503 "draining" and a new ``/generate`` 503 with ``draining``;
    ``/shutdown`` fires the callback; a stopped port refuses
    connections."""
    for body in (GENERATE["greedy"], GENERATE["greedy"], GENERATE["long"],
                 GENERATE["sampled"], dict(GENERATE["sampled"], stream=True),
                 GENERATE["ragged"]):
        got, want = fresh.both("/generate", body)
        assert got[0] == want[0] == 200
    for path, body in (("/v1/completions", {"prompt": [3, 1, 4]}),
                       ("/v1/embeddings", {"input": [[3, 1, 4], [5]]}),
                       ("/v1/classify", {"input": [[3, 1, 4]]})):
        got, want = fresh.both(path, body)
        assert got[0] == want[0] == 200
    got, want = fresh.both("/serving/metrics")
    assert got[0] == want[0] == 200
    _compare_metrics(got[2], want[2])
    assert got[2]["requests_completed"] == 9
    fired = []
    for api in fresh.apis:
        api.shutdown_callback = lambda api=api: fired.append(api)
    got, want = fresh.both("/drain", {})
    _same(got, want)
    assert got[0] == 202 and got[2]["draining"] is True
    got, want = fresh.both("/healthz")
    assert got[0] == want[0] == 503
    assert got[2]["status"] == want[2]["status"] == "draining"
    assert got[2]["drained"] is True and got[2]["in_flight"] == 0
    got, want = fresh.both("/generate", GENERATE["greedy"])
    _same(got, want)
    assert got[0] == 503 and got[2]["error"]["draining"] is True
    assert got[1]["Retry-After"] == want[1]["Retry-After"] == "5"
    got, want = fresh.both("/shutdown", {})
    _same(got, want)
    # both reply before they fire the callback, each from its own
    # thread, so the two may fire in either order
    deadline = time.monotonic() + 10
    while len(fired) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert sorted(map(id, fired)) == sorted(map(id, fresh.apis))
    fresh.port.stop()
    with pytest.raises(urllib.error.URLError) as e:
        urllib.request.urlopen("http://127.0.0.1:%d/healthz"
                               % fresh.port.port, timeout=5)
    assert isinstance(e.value.reason, ConnectionRefusedError)


def test_tune_and_admin_guard(pair):
    """``/serving/tune`` floors the shed factor; ``_admin_ok`` refuses a
    non-loopback peer without the admin token and accepts its bearer."""
    got, want = pair.both("/serving/tune", {"shed_block_factor": 0.01})
    _same(got, want)
    assert got[2]["shed_block_factor"] == 0.1
    got, want = pair.both("/serving/tune", {"shed_block_factor": "x"})
    assert got[0] == want[0] == 400
    pair.both("/serving/tune", {"shed_block_factor": 4.0})
    api = pair.port
    handler = api.handler_class_.__new__(api.handler_class_)
    handler.client_address = ("10.1.2.3", 40000)
    handler.headers = {}
    assert not handler._admin_ok()
    handler.headers = {"Authorization": "Bearer s3cret"}
    assert not handler._admin_ok()
    api.admin_token = "s3cret"
    try:
        assert handler._admin_ok()
        handler.headers = {"Authorization": "Bearer s3cre"}
        assert not handler._admin_ok()
        handler.headers = {}
        assert not handler._admin_ok()
        handler.client_address = ("::1", 40000)
        assert handler._admin_ok()
    finally:
        api.admin_token = None


def test_constructor_refuses_features_not_ported():
    """Tensor parallelism is taken (``serving_tp`` reaches the
    scheduler's knobs; its serving is ``tests/test_torch_tp.py``'s); a
    workflow and a loader are taken (the unit form demands both
    ``loader`` and ``output``); the KV knobs reach the scheduler."""
    from veles_tpu_torch.restful_api import RESTfulAPI, RestfulLoader
    from veles_tpu_torch.units import MissingDemand
    from veles_tpu_torch.workflow import Workflow
    tp = RESTfulAPI(device="cpu", serving_tp=2)
    assert tp.serving_tp == 2 and tp.serving_knobs()["tp"] == 2
    wf = Workflow(None, name="rest-unit")
    loader = RestfulLoader(wf, sample_shape=(3,), minibatch_size=2)
    unit = RESTfulAPI(wf, loader=loader)
    assert unit.device is None and unit in wf.units
    with pytest.raises(MissingDemand, match="output"):
        unit.initialize(device="cpu")
    RESTfulAPI(device="cpu", serving_tp=0, serving_role="both",
               serving_kv_host_bytes=0, serving_kv_export_bytes=None,
               serving_warm_buckets=True)
    with jax_prng.get().preserve_state():
        wf, dev, fw = _jax_chain()
    api = RESTfulAPI(forwards=port_chain(_spec(fw), fw), device="cpu",
                     serving_role="decode", serving_kv_host_bytes=1 << 20,
                     serving_kv_export_bytes=1 << 16)
    api.initialize()
    try:
        sch = api.scheduler_
        assert (sch.role, sch.kv_host_bytes, sch.kv_export_bytes) \
            == ("decode", 1 << 20, 1 << 16)
    finally:
        api.stop()


# -- disaggregation and the prefix store ---------------------------------------

PREFILL = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3]


def _fetch(api, handle, binary):
    """GET /serving/kv_export/<handle> as a decoded record (or the
    error reply)."""
    from veles_tpu_torch.serving import disagg
    headers = {"Accept": disagg.WIRE_CONTENT_TYPE} if binary else {}
    code, hdrs, body = call(api, "/serving/kv_export/%s" % handle,
                            headers=headers)
    if code != 200:
        return code, body
    if binary:
        assert hdrs["Content-Type"] == disagg.WIRE_CONTENT_TYPE
        return code, disagg.decode_export_binary(body)[0]
    return code, disagg.decode_export(body)


def _post_raw(api, path, blob, content_type):
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (api.port, path), data=blob,
        headers={"Content-Type": content_type})
    try:
        resp = urllib.request.urlopen(req, timeout=120)
    except urllib.error.HTTPError as e:
        resp = e
    return resp.code, json.loads(resp.read())


@pytest.mark.parametrize("binary", [False, True], ids=["json", "binary"])
def test_prefill_export_import_match_reference(pair, binary):
    """``/serving/prefill`` → ``/serving/kv_export/<h>`` →
    ``/serving/kv_import`` on each server, and across them (the port's
    record into the reference's server and the reverse), decodes what
    ``/generate`` does; the replies' shapes are the reference's; a
    second fetch is 409 on both, an unknown handle 404."""
    from veles_tpu_torch.serving import disagg
    body = {"prompt": PREFILL, "steps": 5, "seed": 3, "temperature": 0.7,
            "top_k": 4}
    want = call(pair.ref, "/generate", body)[2]["tokens"]
    records = {}
    for api in pair.apis:
        code, _, out = call(api, "/serving/prefill", {"prompt": PREFILL})
        assert code == 200
        assert (out["prompt_tokens"], out["blocks"]) == (len(PREFILL), 2)
        assert set(out) == {"handle", "prompt_tokens", "blocks", "trace_id"}
        code, rec = _fetch(api, out["handle"], binary)
        assert code == 200 and rec["prompt"] == PREFILL
        records[api] = rec
        assert _fetch(api, out["handle"], binary)[0] == 409
        assert _fetch(api, "0" * 32, binary)[0] == 404
    extra = {k: body[k] for k in ("steps", "seed", "temperature", "top_k")}
    for src in pair.apis:
        for dst in pair.apis:
            if binary:
                code, out = _post_raw(
                    dst, "/serving/kv_import",
                    disagg.encode_export_binary(records[src], extra=extra),
                    disagg.WIRE_CONTENT_TYPE)
            else:
                code, _, out = call(dst, "/serving/kv_import", dict(
                    extra, export=disagg.encode_export(records[src])))
            assert code == 200 and out == {"tokens": want}


def test_roles_and_kv_knobs_match_reference():
    """A prefill-role pair refuses ``/generate`` (409) and serves
    ``/serving/prefill``; a decode-role pair the reverse; ``/healthz``
    and ``/serving/metrics`` report the role, the pending exports and
    the host tier's keys as the reference's do."""
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    pre = dec = None
    try:
        # the process-wide generator other files' chains draw from is
        # left as it was
        with jax_prng.get().preserve_state():
            pre = Pair(serving_role="prefill",
                       serving_kv_export_bytes=1 << 20)
            dec = Pair(serving_role="decode", serving_kv_host_bytes=1 << 20)
        got, want = pre.both("/generate", {"prompt": [3, 1], "steps": 2})
        _same(got, want)
        assert got[0] == 409
        got, want = dec.both("/serving/prefill", {"prompt": PREFILL})
        _same(got, want)
        assert got[0] == 409
        got, want = pre.both("/serving/prefill", {"prompt": PREFILL})
        assert got[0] == want[0] == 200
        for p, role in ((pre, "prefill"), (dec, "decode")):
            got, want = p.both("/healthz")
            assert got[2]["role"] == want[2]["role"] == role
            got, want = p.both("/serving/metrics")
            assert got[0] == want[0] == 200
            keys = [k for k in want[2] if k.startswith("kv_host_")
                    or k in ("role", "kv_exports_pending")]
            assert keys and {k: got[2].get(k) for k in keys} \
                == {k: want[2][k] for k in keys}
        assert pre.port.scheduler_.metrics()["kv_exports_pending"] == 1
        assert "kv_host_bytes" in dec.port.scheduler_.metrics()
    finally:
        for p in (pre, dec):
            if p is not None:
                p.stop()
        root.common.precision.compute_dtype = saved


def test_prefix_export_import_match_reference(pair):
    """``/serving/prefix_export`` reads a resident prefix (404 before
    there is one), ``/serving/prefix_import`` adopts it (``{"blocks":
    n}``) on either server, whichever server exported it."""
    from veles_tpu_torch.serving import disagg
    prompt = [7, 7, 1, 2, 8, 3, 0, 4, 6, 6, 2, 9, 1, 1, 5, 10, 4, 2]
    got, want = pair.both("/serving/prefix_export", {"tokens": prompt})
    _same(got, want)
    assert got[0] == 404
    got, want = pair.both("/generate", {"prompt": prompt, "steps": 3})
    _same(got, want)
    records = {}
    for api in pair.apis:
        code, _, body = call(api, "/serving/prefix_export",
                             {"tokens": prompt})
        assert code == 200
        records[api] = disagg.decode_export(body)
        assert records[api]["prompt"] == prompt[:16]
        req = urllib.request.Request(
            "http://127.0.0.1:%d/serving/prefix_export" % api.port,
            data=json.dumps({"tokens": prompt}).encode(),
            headers={"Content-Type": "application/json",
                     "Accept": disagg.WIRE_CONTENT_TYPE})
        blob = urllib.request.urlopen(req, timeout=60).read()
        rec, _ = disagg.decode_export_binary(blob)
        assert rec["prompt"] == records[api]["prompt"]
    for src in pair.apis:
        for dst in pair.apis:
            code, _, out = call(dst, "/serving/prefix_import", {
                "record": disagg.encode_export(records[src])})
            assert code == 200 and out == {"blocks": 0}   # resident there
    got, want = pair.both("/serving/prefix_import", {"record": dict(
        disagg.encode_export(records[pair.port]), block_size=4)})
    _same(got, want)
    assert got[0] == 400
