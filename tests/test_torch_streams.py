"""Token streams and the aux lane of the PyTorch port
(``serving/streams.py``, ``submit(stream=True)``, ``submit_embed``/
``submit_score`` and ``serving/openai_api.py``'s compute half) held
against the JAX package on the CPU, on the suite's trained chain
(``spec_trained_chain``) carried into the port.

Oracles: ``tests/test_streaming.py::test_stream_vs_batch_bit_parity``
and ``::test_stream_cancel_frees_blocks``.

Tolerances: streams are exact — a stream's tokens equal its batch
reply and the JAX scheduler's, across speculative bursts, a forced
preempt→resume and ``resume_tokens``; SSE frames are byte-equal;
embeddings and class log-probabilities agree with JAX's within 1e-5
in f32 and every embedding's norm is 1 within 1e-5."""

import concurrent.futures
import time

import numpy
import pytest

from veles_tpu import faults as jax_faults
from veles_tpu.config import root
from veles_tpu_torch import faults

from tests.test_torch_prefix import _jax_sched, _port_sched
from tests.test_torch_serving import _spec
from tests.test_torch_transformer import port_chain

pytestmark = pytest.mark.torch_port

STEPS = 12


@pytest.fixture
def f32():
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    yield
    root.common.precision.compute_dtype = saved


@pytest.fixture(autouse=True)
def disarm():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


@pytest.fixture(scope="module")
def trained(spec_trained_chain):
    fw, pattern = spec_trained_chain
    return fw, port_chain(_spec(fw), fw), pattern


def _jobs(pattern):
    """A greedy and a seeded request over the pattern."""
    return [((pattern * 4)[:6], dict(seed=0)),
            ((pattern * 4)[3:11], dict(temperature=0.9, top_k=5, seed=41))]


def _wait(cond, what, limit=60.0):
    deadline = time.monotonic() + limit
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


# -- the wire helpers ----------------------------------------------------------

PAYLOADS = [{"token": 7}, {"done": True, "tokens": [1, 2, 3],
                           "usage": {"completion_tokens": 2}},
            {"text": "naïve — ü", "logprob": -0.125, "nested": [None, 1.5]},
            [], "plain", 3]


@pytest.mark.parametrize("payload", PAYLOADS)
def test_sse_frames_byte_equal_to_reference(payload):
    from veles_tpu.serving import streams as jax_streams
    from veles_tpu_torch.serving import SSE_DONE, sse_event
    assert sse_event(payload) == jax_streams.sse_event(payload)
    assert SSE_DONE == jax_streams.SSE_DONE == b"data: [DONE]\n\n"


def test_stream_timeout_error_as_reference():
    """A consumer whose per-token patience runs out gets
    ``StreamTimeoutError`` with the reference's message; the tokens
    pushed before it were yielded, and a resolved future ends the
    iteration after the rest."""
    from veles_tpu.serving.streams import TokenStream as JaxStream
    from veles_tpu_torch.serving import StreamTimeoutError, TokenStream
    for cls in (JaxStream, TokenStream):
        ts = cls([1, 2], token_timeout=0.2)
        fut = concurrent.futures.Future()
        ts._bind(None, fut)
        ts._push(5)
        it = iter(ts)
        assert next(it) == 5
        with pytest.raises(Exception) as err:
            next(it)
        assert type(err.value).__name__ == "StreamTimeoutError"
        assert str(err.value) == "no token within 0.2s"
        assert not ts.done
        ts._push(6)
        fut.set_result([1, 2, 5, 6])
        assert list(ts) == [6] and ts.tokens == [5, 6] and ts.done
    assert issubclass(StreamTimeoutError, Exception)


# -- streams through the scheduler ---------------------------------------------

@pytest.mark.parametrize("spec", [False, True], ids=["spec_off", "spec_on"])
def test_stream_vs_batch_matches_reference(f32, trained, spec):
    """Greedy and seeded streams, spec off and on: the batch replies
    equal JAX's, and streams submitted with a preemption forced after
    their first token iterate exactly the batch replies' generated
    tokens (the resumed request re-emits nothing)."""
    fw, chain, pattern = trained
    jobs = _jobs(pattern)
    jsch = _jax_sched(fw, prefill_chunk=4, spec=spec, prefix_cache=False)
    try:
        want = [jsch.submit(p, STEPS, **k).result(240) for p, k in jobs]
    finally:
        jsch.close()
    sch = _port_sched(chain, prefill_chunk=4, spec=spec, prefix_cache=False)
    try:
        batch = [sch.submit(p, STEPS, **k).result(240) for p, k in jobs]
        # slow steps keep both requests in flight until the preempt
        # lands (spec on, they need only ~3 passes after the first token)
        faults.inject("serving.scheduler.step", "delay", arg=0.05)
        streams = [sch.submit(p, STEPS, stream=True, **k) for p, k in jobs]
        its = [iter(ts) for ts in streams]
        first = [next(it) for it in its]
        sch.request_preempt()
        got = [[f0] + list(it) for f0, it in zip(first, its)]
        assert sch.preempts >= 1 and sch.preempt_resumes >= 1
        if spec:
            assert sch.verify_steps > 0 and sch.spec_accepted_tokens > 0
        sch.check_kv()
    finally:
        sch.close()
    assert batch == want
    for ts, toks, ref, (p, _) in zip(streams, got, want, jobs):
        assert ts.prompt + toks == ref
        assert ts.tokens == toks and ts.result(10) == ref and ts.done
        assert ts.trace


def test_resume_tokens_stream_yields_only_new_tokens(f32, trained):
    """A ``resume_tokens`` admission streams only the tokens it draws;
    its result is the uninterrupted run's."""
    fw, chain, pattern = trained
    jobs = _jobs(pattern)
    sch = _port_sched(chain, prefix_cache=False)
    try:
        full = [sch.submit(p, STEPS, **k).result(240) for p, k in jobs]
        for (p, k), ref in zip(jobs, full):
            kept = ref[len(p):len(p) + 5]
            ts = sch.submit(p, STEPS, stream=True, resume_tokens=kept, **k)
            assert list(ts) == ref[len(p) + 5:]
            assert ts.result(10) == ref
    finally:
        sch.close()


def test_stream_cancel_frees_blocks(f32, trained):
    """Cancelling a stream mid-iteration: the tokens before the cancel
    were yielded, iteration then raises ``RequestCancelledError``, the
    slot and blocks free at the next boundary, the sweep is clean and
    the scheduler serves on."""
    from veles_tpu_torch.serving import RequestCancelledError
    _, chain, pattern = trained
    sch = _port_sched(chain, prefix_cache=False)
    try:
        faults.inject("serving.scheduler.step", "delay", arg=0.01)
        ts = sch.submit(pattern[:3], 40, stream=True)
        it = iter(ts)
        head = [next(it), next(it)]
        assert ts.cancel()
        with pytest.raises(RequestCancelledError):
            for _ in it:
                pass
        assert ts.tokens[:2] == head and len(ts.tokens) < 40
        _wait(lambda: sch.in_flight == 0, "cancel leaked")
        sch.check_kv()
        assert sch.cache_.free_blocks == sch.cache_.capacity_blocks
        assert sch.metrics()["requests_cancelled"] == 1
        faults.clear()
        assert len(sch.submit([5], 2).result(60)) == 3
    finally:
        sch.close()


def test_submit_stream_by_position_matches_reference(f32, trained):
    """``stream`` is ``submit``'s ninth positional parameter in both
    packages: a positional True returns a stream whose tokens equal
    the reference's."""
    from veles_tpu.serving.streams import TokenStream as JaxStream
    from veles_tpu_torch.serving import TokenStream
    fw, chain, pattern = trained
    prompt = (pattern * 2)[1:7]
    args = (prompt, 8, 0.9, 3, 5, None, None, "low", True)
    jsch = _jax_sched(fw, prefix_cache=False)
    try:
        jts = jsch.submit(*args)
        want = list(jts)
    finally:
        jsch.close()
    sch = _port_sched(chain, prefix_cache=False)
    try:
        ts = sch.submit(*args)
        got = list(ts)
    finally:
        sch.close()
    assert isinstance(jts, JaxStream) and isinstance(ts, TokenStream)
    assert got == want and ts.result(1) == jts.result(1)


def test_debug_requests_reports_stream(f32, trained):
    """``debug_requests()["stream"]`` is True for a streamed request
    and False for a plain one, while both decode."""
    _, chain, pattern = trained
    sch = _port_sched(chain, prefix_cache=False)
    try:
        faults.inject("serving.scheduler.step", "delay", arg=0.02)
        ts = sch.submit(pattern[:4], 20, stream=True, trace="streamed")
        fut = sch.submit(pattern[1:5], 20, trace="plain")
        _wait(lambda: len(sch.debug_requests()) == 2, "rows")
        rows = {r["trace"]: r["stream"] for r in sch.debug_requests()}
        assert rows == {"streamed": True, "plain": False}
        faults.clear()
        ts.result(60)
        fut.result(60)
    finally:
        sch.close()


# -- the aux lane --------------------------------------------------------------

ROWS = [[3, 1, 4, 1, 5], [9], [2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4, 6,
                              2, 6]]


def test_embed_and_score_functions_match_reference(f32, trained):
    """``embed_pool``, ``pooled_embeddings`` and ``score_rows`` against
    the JAX package's on ragged rows (padding rows and columns
    bucketed alike)."""
    from veles_tpu.serving import openai_api as jax_api
    from veles_tpu_torch.serving import openai_api
    fw, chain, _ = trained
    assert openai_api.embed_supported(chain) and jax_api.embed_supported(fw)
    assert not openai_api.embed_supported(chain[:1])
    for rows in (ROWS, ROWS[:1]):
        got = numpy.asarray(openai_api.pooled_embeddings(chain, rows, 64))
        want = numpy.asarray(jax_api.pooled_embeddings(fw, rows, 64))
        assert got.shape == (len(rows), 16)
        numpy.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        numpy.testing.assert_allclose(numpy.linalg.norm(got, axis=-1), 1.0,
                                      atol=1e-5)
        got = openai_api.score_rows(chain, rows, 64)
        want = jax_api.score_rows(fw, rows, 64)
        assert got.shape == want.shape == (len(rows), 12)
        numpy.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    padded, lens = openai_api._pad_rows(ROWS, 64)
    want_p, want_l = jax_api._pad_rows(ROWS, 64)
    assert (padded == want_p).all() and (lens == want_l).all()
    with pytest.raises(ValueError):
        openai_api.embed_pool(chain, padded, [0] * len(lens))
    with pytest.raises(ValueError):
        jax_api.embed_pool(fw, padded, [0] * len(lens))


def test_aux_jobs_match_reference(f32, trained):
    """``submit_embed``/``submit_score`` on a running scheduler while
    streams decode: results equal the JAX scheduler's within 1e-5."""
    fw, chain, pattern = trained
    jsch = _jax_sched(fw, prefix_cache=False)
    try:
        want = (jsch.submit_embed(ROWS).result(240),
                jsch.submit_score(ROWS).result(240))
    finally:
        jsch.close()
    sch = _port_sched(chain, prefix_cache=False)
    try:
        streams = [sch.submit(p, STEPS, stream=True, **k)
                   for p, k in _jobs(pattern)]
        emb, score = sch.submit_embed(ROWS), sch.submit_score(ROWS)
        got = (emb.result(240), score.result(240))
        for ts in streams:
            ts.result(240)
    finally:
        sch.close()
    assert isinstance(got[0], list) and len(got[0]) == len(ROWS)
    numpy.testing.assert_allclose(numpy.asarray(got[0]),
                                  numpy.asarray(want[0]), rtol=1e-5,
                                  atol=1e-5)
    numpy.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


def _aux_script(sch, errors):
    """The aux lane's refusals and books on an idle (never started)
    scheduler with ``max_queue`` 2; returns what a client sees."""
    out = []
    for rows in ([], [[1], []], [[1] * 65]):
        with pytest.raises(ValueError):
            sch.submit_embed(rows)
    futs = [sch.submit_embed([[1, 2]]), sch.submit_score([[3]])]
    out.append(sch.in_flight)
    with pytest.raises(errors["QueueFullError"]):
        sch.submit_score([[4]])
    out.append(sch.metrics()["requests_rejected"])
    out.append(sch.drain())
    with pytest.raises(errors["DrainingError"]):
        sch.submit_embed([[1]])
    sch.close()
    for f in futs:
        with pytest.raises(errors["SchedulerError"], match="closed"):
            f.result(5)
    out.append(sch.in_flight)
    return out


def test_aux_errors_match_reference(f32, trained):
    """Empty and over-window rows raise ValueError; the queue cap
    raises QueueFullError and counts a reject; aux jobs count as in
    flight, so a drain is not done; a drain refuses new jobs; close()
    fails the pending ones — in both packages alike.  A chain without
    a head cannot embed in either."""
    import veles_tpu.serving as jax_serving
    import veles_tpu_torch.serving as port_serving
    fw, chain, _ = trained
    kinds = ("QueueFullError", "DrainingError", "SchedulerError")
    jsch = jax_serving.InferenceScheduler(
        fw, max_slots=2, window=64, max_queue=2, kv="paged", block_size=16,
        spec=False, prefix_cache=False, warm_buckets=False)
    want = _aux_script(jsch, {k: getattr(jax_serving, k) for k in kinds})
    sch = port_serving.InferenceScheduler(
        chain, max_slots=2, window=64, max_queue=2, block_size=16,
        spec=False, prefix_cache=False, device="cpu")
    got = _aux_script(sch, {k: getattr(port_serving, k) for k in kinds})
    assert got == want == [2, 1, False, 0]
    # one block alone serves, but has no head to strip
    for s in (port_serving.InferenceScheduler(
            chain[1:2], window=64, spec=False, prefix_cache=False,
            device="cpu"),
            jax_serving.InferenceScheduler(
                fw[1:2], window=64, kv="paged", spec=False,
                prefix_cache=False, warm_buckets=False)):
        with pytest.raises(ValueError, match="embeddings"):
            s.submit_embed([[1]])


def test_drain_waits_for_aux_jobs(f32, trained):
    """A drain is not done while an aux job is queued or running: on a
    scheduler not yet started, and on one whose job the aux fault point
    slows; it completes once the job's result is in."""
    from veles_tpu_torch.serving import InferenceScheduler
    _, chain, _ = trained
    sch = InferenceScheduler(chain, max_slots=2, window=64, spec=False,
                             prefix_cache=False, watchdog=0, device="cpu")
    try:
        fut = sch.submit_embed(ROWS)
        assert sch.in_flight == 1
        assert not sch.drain() and not sch.drained
        sch.start()
        assert sch.drain(timeout=60)
        assert fut.done() and len(fut.result()) == len(ROWS)
        assert sch.in_flight == 0
    finally:
        sch.close()
    sch = _port_sched(chain, prefix_cache=False)
    try:
        faults.inject("serving.scheduler.aux", "delay", arg=0.4)
        fut = sch.submit_score(ROWS)
        time.sleep(0.1)     # queued or inside its (slowed) pass
        assert sch.in_flight == 1 and not sch.drain()
        assert sch.drain(timeout=60)
        assert fut.done() and len(fut.result()) == len(ROWS)
    finally:
        sch.close()


def test_aux_fault_fails_the_job_not_the_loop(f32, trained):
    """An exception at ``serving.scheduler.aux`` fails that job with
    ``SchedulerError``; the loop serves on."""
    from veles_tpu_torch.serving import SchedulerError
    _, chain, pattern = trained
    sch = _port_sched(chain, prefix_cache=False)
    try:
        faults.inject("serving.scheduler.aux", "exception", times=1)
        with pytest.raises(SchedulerError, match="InjectedFault"):
            sch.submit_score(ROWS).result(60)
        assert len(sch.submit_score(ROWS).result(60)) == len(ROWS)
        assert len(sch.submit(pattern[:3], 2).result(60)) == 5
    finally:
        sch.close()


def test_cancelled_aux_job_leaves_the_loop_running(f32, trained):
    """A client that cancels its job's future, queued or while the job
    runs (the aux fault point slows it) and then fails (a token past
    the vocabulary), does not stop the loop: later jobs and requests
    are served."""
    _, chain, pattern = trained
    sch = _port_sched(chain, prefix_cache=False)
    try:
        faults.inject("serving.scheduler.aux", "delay", arg=0.3, times=1)
        running = sch.submit_score([[10 ** 6]])
        queued = sch.submit_embed(ROWS)
        time.sleep(0.1)
        assert queued.cancel() and running.cancel()
        _wait(lambda: sch.in_flight == 0, "the cancelled jobs")
        assert sch.error is None
        assert len(sch.submit_score(ROWS).result(60)) == len(ROWS)
        assert len(sch.submit(pattern[:3], 2).result(60)) == 5
    finally:
        sch.close()
