"""The REST and OpenAI server in front of the serving scheduler — the port
of ``veles_tpu/restful_api.py``.

:class:`RESTfulAPI` owns a stdlib ``ThreadingHTTPServer`` on a daemon
thread.  With an LM ``forwards`` chain, ``POST /generate`` serves
through the continuous-batching :class:`~veles_tpu_torch.serving.
scheduler.InferenceScheduler`: each prompt row is its own request,
concurrent clients interleave in the decode slots, and
``"stream": true`` relays a :class:`~veles_tpu_torch.serving.streams.
TokenStream` as Server-Sent Events (a client that disconnects cancels
its request).  Beam search (``"beam"``) and chains the scheduler cannot
serve (or ``serving=False``) take the serialized decode of
:mod:`veles_tpu_torch.models.generate` on the handler thread.  The
OpenAI facade (``/v1/completions``, ``/v1/models``, ``/v1/embeddings``,
``/v1/classify``; :mod:`veles_tpu_torch.serving.openai_api`) rides the
same scheduler.  Disaggregated serving speaks the KV handoff wire
(:mod:`~veles_tpu_torch.serving.disagg`, b64 JSON or the VKV1 frame
negotiated by ``Accept``/``Content-Type: application/x-veles-kv``):
``POST /serving/prefill`` parks a prompt's KV under a handle, ``GET
/serving/kv_export/<handle>`` serves it once, ``POST /serving/kv_import``
decodes from it; ``POST /serving/prefix_export`` and
``/serving/prefix_import`` move resident prefixes between replicas.
Operators read ``/healthz`` (the health monitor, the
drain), ``/serving/metrics``, ``/debug/requests``, ``/debug/state``
(the flight recorder) and ``/metrics`` (the registry as Prometheus
text), and drive ``/drain``, ``/shutdown`` and ``/serving/tune``, which
answer loopback peers or the bearer of ``admin_token``.  Every reply
carries ``X-Veles-Replica`` and ``X-Veles-Trace``; every error is the
structured ``{"error": {"code", "message", "trace_id", ...}}`` body,
with ``Retry-After`` on a 503.  The fault point ``restful.generate``
(:mod:`veles_tpu_torch.faults`) fires on every client request route.

:class:`RESTfulAPI` is a workflow unit, as the reference's is: in a
serving workflow (``samples/serve.py``) :class:`RestfulLoader` queues
``POST /api`` payloads as minibatches, the forward chain runs on them
and :meth:`RESTfulAPI.run` answers each request with its row of the
chain's ``output``::

    start → repeater → restful_loader → [forwards] → api ─→ repeater
                                         (loop until the feed closes)

Built with ``workflow=None`` it stands alone, as every LM server does:
``initialize()`` starts the scheduler and the server, ``stop()`` ends
them.  Its ``serving_*`` knobs and ``/generate`` caps left None read
``root.common.serving`` and ``root.common.api``
(:mod:`veles_tpu_torch.config`) when it initializes.  With
``root.common.tsdb.enabled`` and ``root.common.alerts.enabled`` (both on
by default) ``initialize()`` also starts the replica's history store
(:class:`~veles_tpu_torch.telemetry.tsdb.TimeSeriesStore`, read at ``GET
/metrics/history``) and alert engine
(:class:`~veles_tpu_torch.telemetry.alerts.AlertEngine`, ``GET
/alerts``); ``stop()`` joins both threads.  Every request is attributed
to a tenant (:func:`~veles_tpu_torch.tenant.resolve_tenant`: a loopback
peer's ``X-Veles-Tenant``, which the router forwards, else the bearer
token's hash), which the scheduler meters.
"""

import concurrent.futures
import hmac
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy

from veles_tpu_torch import faults
from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.loader.interactive import InteractiveLoader
from veles_tpu_torch.logger import events
from veles_tpu_torch.memory import Array
from veles_tpu_torch.models.generate import (
    generate, generate_beam, kv_cache_eligible)
from veles_tpu_torch.prng import threefry
from veles_tpu_torch.serving import disagg, openai_api
from veles_tpu_torch.serving.prefill import serving_supported
from veles_tpu_torch.serving.scheduler import (
    InferenceScheduler, SchedulerError, resolve_priority)
from veles_tpu_torch.serving.streams import (
    SSE_DONE, StreamTimeoutError, sse_event)
from veles_tpu_torch.telemetry import metrics as registry
from veles_tpu_torch.telemetry import reqtrace
from veles_tpu_torch.telemetry.flight_recorder import recorder
from veles_tpu_torch.telemetry.health import monitor
from veles_tpu_torch.telemetry.alerts import AlertEngine
from veles_tpu_torch.telemetry.tsdb import TimeSeriesStore, history_query
from veles_tpu_torch.tenant import resolve_tenant
from veles_tpu_torch.units import Unit

log = logging.getLogger(__name__)

#: peers that pass ``_admin_ok`` without the admin token
LOOPBACK = ("127.0.0.1", "::1", "localhost")

#: the reference's ``root.common.api`` caps of ``/generate``
DEFAULT_MAX_STEPS, DEFAULT_MAX_BATCH = 2048, 64


def _status_text(e):
    """Exception → HTTP status-line-safe text: whitespace (the newlines
    of multi-line errors included) collapsed to spaces — a raw newline
    would split the status line — and latin-1 only, 200 chars."""
    line = " ".join(str(e).split())[:200] or type(e).__name__
    return line.encode("latin-1", "replace").decode("latin-1")


class RestfulLoader(InteractiveLoader):
    """An interactive loader whose samples carry reply futures: each
    ``POST /api`` body becomes one queued sample, and :meth:`run` hands
    the futures of exactly the rows it served to ``pending_futures_``,
    in row order, for :meth:`RESTfulAPI.run` to answer."""

    def init_unpickled(self):
        super(RestfulLoader, self).init_unpickled()
        self._fifo_ = []
        self._feed_lock_ = threading.Lock()
        self.pending_futures_ = []

    def feed_request(self, sample):
        """Queue ``sample`` and return the future of its reply.  The
        sample is checked before its future is registered, and both
        happen under one lock, so concurrent handler threads keep the
        futures aligned with the queue."""
        sample = numpy.asarray(sample, numpy.float32)
        if sample.shape != self.sample_shape:
            raise ValueError("sample shape %s != %s"
                             % (sample.shape, self.sample_shape))
        future = concurrent.futures.Future()
        with self._feed_lock_:
            self._fifo_.append(future)
            self.feed(sample)
        return future

    def run(self):
        super(RestfulLoader, self).run()
        self.pending_futures_ = self._fifo_[:self.minibatch_size]
        del self._fifo_[:self.minibatch_size]


class RESTfulAPI(Unit):
    """HTTP endpoint unit (see the module docstring): ``POST /api
    {"input": [...]}`` → ``{"result": [...]}`` through its ``loader``
    (a :class:`RestfulLoader`) and the chain's ``output`` in a serving
    workflow; ``/generate`` and the rest over an LM ``forwards`` chain.

    The parameters keep the reference's names and order.  Built with a
    ``workflow`` it demands ``loader`` and ``output`` and takes its
    device at ``initialize(device=)``; with ``workflow=None`` it stands
    alone and its ``device`` (default ``cuda``) is resolved at once.
    ``serving_tp`` (N > 1) serves tensor-parallel over N positions
    (``serving/tp.py``; the scheduler's gates may serve unsharded and
    report ``tp`` 0).  The ``serving_*`` knobs go to the scheduler, None meaning
    ``root.common.serving``'s value (the reference's defaults);
    ``serving_warm_buckets`` is recorded there (the port compiles
    nothing).  ``max_steps``/``max_batch`` cap ``/generate`` (None:
    ``root.common.api``'s, 2048 / 64 by default).  ``admin_token``
    (None: ``root.common.api.admin_token``) lets a non-loopback peer
    call ``/drain``, ``/shutdown``, ``/serving/tune`` and
    ``resume_tokens`` with ``Authorization: Bearer <token>``;
    ``model_id`` names the model on ``/v1/*``; ``device`` is the chain's
    device, where the scheduler and the decode outside it run."""

    VIEW_GROUP = "SERVICE"

    def __init__(self, workflow=None, loader=None, port=0, host="127.0.0.1",
                 request_timeout=30.0, forwards=None, serving=True,
                 max_slots=4, serving_window=None, max_queue=32,
                 max_steps=None, max_batch=None, serving_kv=None,
                 serving_block_size=None, serving_kv_blocks=None,
                 serving_kv_dtype=None, serving_prefill_chunk=None,
                 serving_spec=None, serving_spec_k=None,
                 serving_prefix_cache=None, serving_warm_buckets=None,
                 serving_tp=None, serving_role=None,
                 serving_kv_host_bytes=None, serving_kv_export_bytes=None,
                 replica_id=None, *, admin_token=None, model_id="veles-lm",
                 device=None, **kwargs):
        super(RESTfulAPI, self).__init__(workflow, **kwargs)
        self.loader = loader
        #: the chain's output, linked from the head forward unit
        self.output = None
        self.device = None
        if workflow is None or device is not None:
            self._bind_device(device, forwards)
        #: fleet identity, sent as X-Veles-Replica (pid:port once bound)
        self.replica_id = replica_id
        self.port = port
        self.host = host
        self.request_timeout = request_timeout
        #: optional callable fired by POST /shutdown
        self.shutdown_callback = None
        self.forwards = forwards
        #: serving=False pins the serialized decode
        self.serving = bool(serving)
        self.max_slots = int(max_slots)
        self.serving_window = serving_window
        self.max_queue = int(max_queue)
        self.serving_kv = serving_kv
        self.serving_block_size = serving_block_size
        self.serving_kv_blocks = serving_kv_blocks
        self.serving_kv_dtype = serving_kv_dtype
        self.serving_prefill_chunk = serving_prefill_chunk
        self.serving_spec = serving_spec
        self.serving_spec_k = serving_spec_k
        self.serving_prefix_cache = serving_prefix_cache
        self.serving_warm_buckets = serving_warm_buckets
        self.serving_role = serving_role
        self.serving_tp = serving_tp
        self.serving_kv_host_bytes = serving_kv_host_bytes
        self.serving_kv_export_bytes = serving_kv_export_bytes
        self.max_steps = max_steps
        self.max_batch = max_batch
        self.admin_token = admin_token
        self.model_id = openai_api.model_id(model_id)
        if workflow is not None:
            self.demand("loader", "output")

    def init_unpickled(self):
        super(RESTfulAPI, self).init_unpickled()
        self.scheduler_ = None
        #: the handler class the server instantiates per request
        self.handler_class_ = None
        self._server_ = None
        self._thread_ = None
        self._legacy_lock_ = threading.Lock()
        #: POST /drain latched: /healthz answers 503 "draining" and the
        #: scheduler stops admitting
        self._draining_ = False
        #: the replica's alert engine (telemetry/alerts.py), created at
        #: initialize() when root.common.alerts.enabled
        self.alerts_ = None
        #: the replica's history store (telemetry/tsdb.py), created at
        #: initialize() when root.common.tsdb.enabled: it samples the
        #: process registry; GET /metrics/history queries it
        self.tsdb_ = None

    def _bind_device(self, device, forwards):
        self.device = resolve_device(device)
        if forwards is not None and any(u.device != self.device
                                        for u in forwards):
            raise ValueError("the chain lies on %s, the server was given %s"
                             % (forwards[0].device, self.device))

    def _cap(self, name, default):
        """A /generate resource cap: the constructor's, else
        ``root.common.api.<name>``, else the reference's default — read
        per request, so the tree's changes apply live."""
        value = getattr(self, name)
        if value is None:
            from veles_tpu_torch.config import root
            value = root.common.api.get(name, default)
        return int(value)

    def _validate_prompt(self, prompt):
        """Reject malformed /generate prompts with a client error."""
        if prompt.ndim != 2 or prompt.shape[1] < 1 or not prompt.size:
            return "prompt must be a non-empty token list (or a " \
                   "batch of non-empty lists — ragged is fine)"
        vocab = getattr(self.forwards[0], "vocab", None)
        if vocab is not None and \
                (prompt.min() < 0 or prompt.max() >= int(vocab)):
            return "prompt token ids must be in [0, %d)" % vocab
        return None

    def _validate_rows(self, rows):
        """Vocab-bounds check for parsed token rows (the /v1 paths)."""
        vocab = getattr(self.forwards[0], "vocab", None)
        if vocab is not None:
            for r in rows:
                if min(r) < 0 or max(r) >= int(vocab):
                    return "token ids must be in [0, %d)" % vocab
        return None

    def _decode_beam(self, prompt, steps, beam):
        """Beam search for /generate, serialized like :meth:`_decode`.
        Returns (tokens, scores) as lists."""
        with self._legacy_lock_:
            toks, scores = generate_beam(self.forwards, prompt, steps, beam)
        return toks.cpu().tolist(), scores.cpu().tolist()

    def _decode(self, prompt, steps, temperature, top_k, seed,
                prompt_lens=None, stop_token=None):
        """The serialized decode of /generate when the scheduler is off
        or cannot serve the chain.  A pinned seed keys ``jax.random.
        key(seed)``'s Threefry stream; an unpinned sampling request
        draws a fresh seed per call.  Returns [batch, prompt_len +
        steps] tokens as a numpy array."""
        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
        key = threefry.key(int(seed)) if temperature else None
        with self._legacy_lock_:
            out = generate(self.forwards, prompt, steps,
                           temperature=temperature, top_k=top_k, key=key,
                           kv_cache=kv_cache_eligible(self.forwards),
                           prompt_lens=prompt_lens, stop_token=stop_token)
        return out.cpu().numpy()

    def _generate_scheduled(self, rows, steps, temperature, top_k, seed,
                            stop, priority=None, trace=None,
                            resume_tokens=None, tenant=None):
        """Decode a /generate body through the scheduler, each row its
        own request (row i draws from seed + i when the seed is
        pinned).  Any failure cancels the batch's unfinished futures, so
        an abandoned request returns its slot and blocks at the next
        boundary."""
        futures = []
        try:
            for i, row in enumerate(rows):
                futures.append(self.scheduler_.submit(
                    row, steps, temperature=temperature, top_k=top_k,
                    seed=None if seed is None else int(seed) + i,
                    stop_token=stop, timeout=self.request_timeout,
                    priority=priority, trace=trace,
                    resume_tokens=resume_tokens, tenant=tenant))
            # the scheduler enforces the deadline itself; this wait is a
            # backstop against a wedged loop with the watchdog off
            return [f.result(self.request_timeout + 30.0) for f in futures]
        except BaseException:
            for f in futures:
                if not f.done():
                    self.scheduler_.cancel(f)
            raise

    #: scheduler knob -> this unit's attribute; None reads
    #: ``root.common.serving.<knob>``
    SERVING_KNOBS = ("kv", "block_size", "kv_blocks", "kv_dtype",
                     "prefill_chunk", "spec", "spec_k", "prefix_cache",
                     "warm_buckets", "role", "kv_host_bytes",
                     "kv_export_bytes", "tp")

    def serving_knobs(self):
        """The scheduler's knobs: each ``serving_<knob>`` given, else
        ``root.common.serving.<knob>`` (None there too: the scheduler's
        default)."""
        from veles_tpu_torch.config import root
        knobs = {}
        for k in self.SERVING_KNOBS:
            v = getattr(self, "serving_" + k)
            if v is None:
                v = root.common.serving.get(k)
            if v is not None:
                knobs[k] = v
        return knobs

    def initialize(self, device=None, **kwargs):
        """Validate the unit's demands; build and start the scheduler
        (when ``serving`` and the chain is slot-servable), then bind the
        server on a daemon thread and set :attr:`port` and
        :attr:`replica_id`.  In a workflow, ``device`` is the workflow's
        (the chain's)."""
        super(RESTfulAPI, self).initialize(**kwargs)
        if device is not None or self.device is None:
            self._bind_device(device, self.forwards)
        if self.admin_token is None:
            from veles_tpu_torch.config import root
            self.admin_token = root.common.api.get("admin_token")
        if self.forwards is not None and self.serving \
                and self.scheduler_ is None:
            if serving_supported(self.forwards):
                knobs = self.serving_knobs()
                self.scheduler_ = InferenceScheduler(
                    self.forwards, max_slots=self.max_slots,
                    window=self.serving_window, max_queue=self.max_queue,
                    queue_timeout=self.request_timeout,
                    replica_id=self.replica_id, device=self.device,
                    **knobs).start()
                sch = self.scheduler_
                log.info("serving scheduler: %d slots, window %d, queue cap "
                         "%d, kv=%s (block %d), prefill chunk %d, role=%s",
                         sch.max_slots, sch.window, self.max_queue, sch.kv,
                         sch.block_size, sch.prefill_chunk, sch.role)
            else:
                log.info("chain not slot-servable; /generate stays on the "
                         "serialized decode path")
        if self._server_ is not None:
            return
        self.handler_class_ = type("Handler", (_Handler,), {"api": self})
        self._server_ = ThreadingHTTPServer((self.host, self.port),
                                            self.handler_class_)
        self.port = self._server_.server_address[1]
        self.replica_id = self.replica_id \
            or "pid%d:%d" % (os.getpid(), self.port)
        self._thread_ = threading.Thread(
            target=self._server_.serve_forever, daemon=True,
            name="restful-api")
        self._thread_.start()
        from veles_tpu_torch.config import root
        if self.tsdb_ is None and root.common.tsdb.get("enabled", True):
            self.tsdb_ = TimeSeriesStore(name=self.replica_id).start()
        if self.alerts_ is None \
                and root.common.alerts.get("enabled", True):
            self.alerts_ = AlertEngine(name=self.replica_id,
                                       tsdb=self.tsdb_).start()
        log.info("REST API on http://%s:%d/%s", self.host, self.port,
                 "api" if self.loader is not None else "generate")

    def run(self):
        """Answer the requests of the rows the loader served with their
        rows of the chain's ``output`` (an :class:`~veles_tpu_torch.
        memory.Array` or a tensor)."""
        futures = getattr(self.loader, "pending_futures_", None) or []
        if not futures:
            return
        out = self.output
        if isinstance(out, Array):
            out = out.mem
        elif hasattr(out, "detach"):
            out = out.detach().float().cpu().numpy()
        for i, future in enumerate(futures):
            if not future.done():
                future.set_result(numpy.asarray(out[i]).tolist())
        self.loader.pending_futures_ = []

    def stop(self):
        """Stop the alert engine and the history store, close the
        scheduler, shut the server down and close the listening socket
        (a stopped replica refuses connections)."""
        alerts, self.alerts_ = self.alerts_, None
        if alerts is not None:
            alerts.stop()
        tsdb, self.tsdb_ = self.tsdb_, None
        if tsdb is not None:
            tsdb.stop()
        if self.scheduler_ is not None:
            self.scheduler_.close()
            self.scheduler_ = None
        if self._server_ is not None:
            self._server_.shutdown()
            self._server_.server_close()
            self._server_ = None
        if self._thread_ is not None:
            self._thread_.join(10)
            self._thread_ = None


class _Handler(BaseHTTPRequestHandler):
    """One request; :meth:`RESTfulAPI.initialize` subclasses it with
    ``api`` set to the server's :class:`RESTfulAPI`."""

    api = None

    def log_message(self, *args):
        pass

    def _admin_ok(self):
        """Admin endpoints (/drain, /shutdown, /serving/tune, the
        resume lane) answer loopback peers, or a caller presenting
        ``Authorization: Bearer <admin_token>`` (compared in constant
        time)."""
        if self.client_address[0] in LOOPBACK:
            return True
        token = self.api.admin_token
        if not token:
            return False
        auth = self.headers.get("Authorization", "")
        return hmac.compare_digest(auth, "Bearer %s" % token)

    def _trace(self):
        """The request's trace id: the sanitized ``X-Veles-Trace``
        header or a fresh one, cached so headers and frames carry one
        id."""
        tid = getattr(self, "_trace_", None)
        if tid is None:
            headers = getattr(self, "headers", None)
            tid = self._trace_ = reqtrace.ensure_trace_id(
                headers.get(reqtrace.TRACE_HEADER)
                if headers is not None else None)
        return tid

    def _tenant(self):
        """The request's tenant id, cached like the trace id: a loopback
        peer's ``X-Veles-Tenant`` is trusted (the router forwards its
        bounded tenant label that way), a remote caller resolves from
        its own bearer token."""
        ten = getattr(self, "_tenant_", None)
        if ten is None:
            headers = getattr(self, "headers", None)
            ten = self._tenant_ = resolve_tenant(
                {k.lower(): v for k, v in headers.items()}
                if headers is not None else {},
                loopback=self.client_address[0] in LOOPBACK)
        return ten

    # -- replies -------------------------------------------------------------

    def _common_headers(self):
        if self.api.replica_id:
            self.send_header("X-Veles-Replica", str(self.api.replica_id))
        self.send_header(reqtrace.TRACE_HEADER, self._trace())

    def _reply_json(self, obj, code=200):
        blob = json.dumps(obj, default=str).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self._common_headers()
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)

    def _reply_error(self, code, message, retry_after=None, **extra):
        """Structured error reply ``{"error": {"code", "message",
        "trace_id", ...}}``; a 503's Retry-After says when this replica
        is worth another attempt."""
        err = {"code": int(code), "message": str(message or ""),
               "trace_id": self._trace()}
        err.update({k: v for k, v in extra.items() if v is not None})
        blob = json.dumps({"error": err}, default=str).encode()
        self.send_response(int(code))
        self.send_header("Content-Type", "application/json")
        self._common_headers()
        if retry_after is not None:
            self.send_header("Retry-After", str(max(1, int(retry_after))))
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        if getattr(self, "command", None) != "HEAD":
            self.wfile.write(blob)

    def send_error(self, code, message=None, explain=None):
        # every error path, the base class's own included, answers the
        # structured JSON body
        self._reply_error(code, message or explain or "")

    def _reply_injected(self, e):
        """The ``http_error`` fault action: reply the injected status."""
        self._reply_error(e.status, _status_text(e),
                          retry_after=1 if e.status == 503 else None)

    def _reply_scheduler_error(self, e):
        """A SchedulerError as its structured reply: 503 with the class's
        Retry-After, 408 with the tokens generated before the
        deadline."""
        self._reply_error(
            e.http_status, _status_text(e),
            retry_after=getattr(e, "retry_after", None),
            tokens_generated=getattr(e, "tokens_generated", None),
            draining=True if self.api._draining_ else None)

    def _read_raw(self):
        length = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(length)

    def _read_body(self):
        return json.loads(self._read_raw() or b"{}")

    def _reply_binary(self, blob, code=200):
        """A KV wire frame as the body (``application/x-veles-kv``)."""
        self.send_response(code)
        self.send_header("Content-Type", disagg.WIRE_CONTENT_TYPE)
        self._common_headers()
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)

    def _wants_binary(self):
        return disagg.WIRE_CONTENT_TYPE in (self.headers.get("Accept") or "")

    def _sent_binary(self):
        ctype = (self.headers.get("Content-Type") or "").split(";")[0]
        return ctype.strip().lower() == disagg.WIRE_CONTENT_TYPE

    def _reply_record(self, rec):
        """An export record in the wire form the client asked for."""
        if self._wants_binary():
            self._reply_binary(disagg.encode_export_binary(rec))
        else:
            self._reply_json(disagg.encode_export(rec))

    # -- SSE -----------------------------------------------------------------

    def _sse_headers(self):
        """Begin a Server-Sent-Events response; the connection's close
        delimits the stream (HTTP/1.0, no Content-Length)."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self._common_headers()
        self.end_headers()
        self.close_connection = True

    def _relay_sse(self, ts, chunk_fn, final_fn):
        """Pump one TokenStream onto the wire: one frame per accepted
        token (``chunk_fn(token)``), the terminal frame
        ``final_fn(error_or_None)``, then ``data: [DONE]``.  A client
        that disconnects mid-stream cancels the request: its slot and
        blocks return at the next boundary."""
        api = self.api
        # backstop against a wedged loop with the watchdog off
        ts.token_timeout = api.request_timeout + 30.0
        tron = api.scheduler_ is not None and api.scheduler_._tron
        t0 = time.monotonic()
        self._sse_headers()
        err = None
        try:
            for tok in ts:
                self.wfile.write(sse_event(chunk_fn(tok)))
                self.wfile.flush()
        except (BrokenPipeError, ConnectionError, OSError):
            ts.cancel()
            if tron:
                reqtrace.record(ts.trace, "stream",
                                duration=time.monotonic() - t0,
                                tokens=len(ts.tokens), outcome="disconnect")
            return
        except StreamTimeoutError as e:
            ts.cancel()
            err = SchedulerError(_status_text(e))
        except SchedulerError as e:
            err = e
        try:
            self.wfile.write(sse_event(final_fn(err)))
            self.wfile.write(SSE_DONE)
            self.wfile.flush()
        except (BrokenPipeError, ConnectionError, OSError):
            pass
        if tron:
            reqtrace.record(ts.trace, "stream",
                            duration=time.monotonic() - t0,
                            tokens=len(ts.tokens),
                            outcome="ok" if err is None
                            else type(err).__name__)

    def _stream_generate(self, row, steps, temperature, top_k, seed, stop,
                         priority, resume=None):
        """SSE for POST /generate ``{"stream": true}``: one ``{"token":
        t}`` frame per accepted token, a terminal frame with the full
        token list (prompt + resumed + new: equal to the batch reply)
        and usage, then [DONE].  With ``resume`` only the newly drawn
        tokens stream."""
        api = self.api
        resume = resume or []
        try:
            ts = api.scheduler_.submit(
                row, steps, temperature=temperature, top_k=top_k,
                seed=None if seed is None else int(seed), stop_token=stop,
                timeout=api.request_timeout, priority=priority, stream=True,
                trace=self._trace(), resume_tokens=resume,
                tenant=self._tenant())
        except ValueError as e:
            self.send_error(400, _status_text(e))
            return
        except SchedulerError as e:
            self._reply_scheduler_error(e)
            return

        def final(err):
            if err is not None:
                return {"error": {
                    "code": getattr(err, "http_status", 500),
                    "message": _status_text(err), "trace_id": ts.trace,
                    "tokens_generated": len(ts.tokens)}}
            done = resume + ts.tokens
            return {"done": True, "tokens": ts.prompt + done,
                    "trace_id": ts.trace,
                    "usage": {"prompt_tokens": len(ts.prompt),
                              "completion_tokens": len(done),
                              "total_tokens": len(ts.prompt) + len(done)}}

        self._relay_sse(ts, lambda t: {"token": t}, final)

    # -- GET -----------------------------------------------------------------

    def do_GET(self):
        # drop the query string before trimming the trailing slash:
        # load balancers probe /healthz?probe=1
        self._trace_ = None
        self._tenant_ = None
        api = self.api
        route = self.path.split("?")[0].rstrip("/")
        sch = api.scheduler_
        if route == "/debug/requests":
            self._reply_json({
                "replica": api.replica_id,
                "draining": bool(api._draining_),
                "requests": sch.debug_requests() if sch is not None else [],
            })
        elif route == "/serving/metrics":
            if sch is None:
                self.send_error(404, "no serving scheduler")
                return
            self._reply_json(sch.metrics())
        elif route.startswith("/serving/kv_export/"):
            self._kv_export(route.rsplit("/", 1)[1])
        elif route == "/healthz":
            self._healthz()
        elif route == "/debug/state":
            self._reply_json({
                "flightrec": recorder.state(),
                "health": monitor.state(),
                "events": list(events.ring)[-100:],
                "logs": list(recorder.log_ring)[-50:],
            })
        elif route == "/v1/models":
            self._reply_json(openai_api.models_reply(api.model_id))
        elif route == "/alerts":
            # the replica's alert engine: firing and pending instances
            # and the loaded rule set
            if api.alerts_ is None:
                self._reply_json({"enabled": False})
            else:
                self._reply_json(api.alerts_.snapshot())
        elif route == "/metrics/history":
            # windowed queries over the replica's history store
            # (?series=...&window=...&agg=...&label.<k>=<v>&tier=N; no
            # series = the catalog)
            if api.tsdb_ is None:
                self._reply_json({"enabled": False}, code=503)
            else:
                self._reply_json(history_query(
                    api.tsdb_, self.path.partition("?")[2]))
        elif route == "/metrics":
            blob = registry.render_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)
        else:
            self.send_error(404)

    def _healthz(self):
        """Liveness and the health policy's state: 200 while servable,
        503 once the halt policy latched or a drain began.
        "draining" stays a distinct top-level status (a router routes
        around a draining replica without counting a failure)."""
        api = self.api
        state = monitor.state()
        status = state["status"]
        sch = api.scheduler_
        reply = {"status": status, "pid": os.getpid(),
                 "replica": api.replica_id,
                 "draining": bool(api._draining_),
                 "role": sch.role if sch is not None else "both",
                 "tp": sch.tp if sch is not None else 0, "health": state}
        if api._draining_:
            status = reply["status"] = "draining"
            reply["in_flight"] = sch.in_flight if sch is not None else 0
            reply["drained"] = sch.drained if sch is not None else True
        self._reply_json(reply, code=503 if status in ("halted", "draining")
                         else 200)

    # -- POST ----------------------------------------------------------------

    def do_POST(self):
        self._trace_ = None
        self._tenant_ = None
        route = self.path.split("?")[0].rstrip("/")
        if route == "/api":
            self._api()
            return
        client = {"/generate": self._generate,
                  "/serving/prefill": self._serving_prefill,
                  "/serving/kv_import": self._serving_kv_import,
                  "/v1/completions": self._v1_completions,
                  "/v1/embeddings": lambda: self._v1_batch("embed"),
                  "/v1/classify": lambda: self._v1_batch("score")}
        if route in client:
            try:
                faults.fire("restful.generate")
                client[route]()
            except faults.InjectedHTTPError as e:
                self._reply_injected(e)
            except Exception as e:  # one bad request must not kill the
                log.exception("%s failed", route)   # server
                self.send_error(500, _status_text(e))
            return
        # a prefix transfer is cache plumbing, not a client request: not
        # behind restful.generate
        plumbing = {"/serving/prefix_export": self._serving_prefix_export,
                    "/serving/prefix_import": self._serving_prefix_import}
        if route in plumbing:
            try:
                plumbing[route]()
            except Exception as e:
                log.exception("%s failed", route)
                self.send_error(500, _status_text(e))
            return
        admin = {"/serving/tune": self._tune, "/shutdown": self._shutdown,
                 "/drain": self._drain}
        if route in admin:
            admin[route]()
            return
        self.send_error(404)

    def _api(self):
        """POST /api ``{"input": [...]}`` → ``{"result": [...]}``: the
        sample goes through the serving workflow's RestfulLoader and
        forward chain; any failure (a malformed body, a sample of the
        wrong shape, a server without a loader, a timeout) is a 500, as
        the reference answers it."""
        api = self.api
        try:
            if api.loader is None:
                raise RuntimeError("POST /api needs a RestfulLoader: this "
                                   "server runs outside a serving workflow")
            body = self._read_body()
            sample = numpy.asarray(body["input"], numpy.float32)
            future = api.loader.feed_request(sample)
            result = future.result(api.request_timeout)
            self._reply_json({"result": result})
        except Exception as e:  # one bad request must not kill the server
            self.send_error(500, _status_text(e))

    # -- disaggregation and the prefix store -----------------------------------

    def _kv_export(self, handle):
        """GET /serving/kv_export/<handle>: serve one parked prefill
        export, once (the fetch consumes it; the handle is the
        capability).  A second fetch is a 409, an unknown or expired
        handle a 404."""
        sch = self.api.scheduler_
        if sch is None:
            self.send_error(404, "no serving scheduler")
            return
        rec = sch.kv_export(handle)
        if rec is None:
            if sch.kv_export_status(handle) == "fetched":
                self._reply_error(409, "kv export handle already fetched "
                                  "(one-shot)")
            else:
                self.send_error(404, "unknown or expired kv export handle")
            return
        self._reply_record(rec)

    def _job_result(self, submit, what, **timeout_extra):
        """Run a scheduler job for a handler: ``(True, result)``, or
        ``(False, None)`` after replying the error (400 for a ValueError,
        the scheduler's own status, 408 past the deadline with
        ``timeout_extra`` in its body)."""
        try:
            return True, submit().result(self.api.request_timeout + 30.0)
        except ValueError as e:
            self.send_error(400, _status_text(e))
        except SchedulerError as e:
            self._reply_scheduler_error(e)
        except concurrent.futures.TimeoutError:
            self._reply_error(408, "%s timed out" % what, **timeout_extra)
        return False, None

    def _serving_prefill(self):
        """POST /serving/prefill (roles "prefill"/"both"): prefill ONE
        prompt row, park its raw KV blocks and first-token logits under
        a handle, reply ``{"handle", "prompt_tokens", "blocks",
        "trace_id"}``."""
        api = self.api
        if api.forwards is None or api.scheduler_ is None:
            self.send_error(404, "no servable model chain")
            return
        try:
            body = self._read_body()
            prompt = body.get("prompt")
            if not isinstance(prompt, list) or not prompt \
                    or isinstance(prompt[0], list):
                self.send_error(400, "prompt must be ONE flat token list "
                                "(prefill export is per-request)")
                return
            rows = [[int(t) for t in prompt]]
        except (TypeError, ValueError):
            self.send_error(400, "prompt must be a flat list of token ids")
            return
        err = api._validate_rows(rows)
        if err:
            self.send_error(400, err)
            return
        ok, out = self._job_result(lambda: api.scheduler_.submit_prefill(
            rows[0], seed=body.get("seed"), timeout=api.request_timeout,
            priority=body.get("priority"), trace=self._trace()), "prefill")
        if ok:
            out["trace_id"] = self._trace()
            self._reply_json(out)

    def _serving_kv_import(self):
        """POST /serving/kv_import (roles "decode"/"both"): adopt an
        export record — the binary frame as the body with the sampler
        settings in its header's ``extra``, or JSON ``{"export": ...,
        "steps", ...}`` — decode, and reply ``{"tokens": [...]}``."""
        api = self.api
        if api.forwards is None or api.scheduler_ is None:
            self.send_error(404, "no servable model chain")
            return
        try:
            if self._sent_binary():
                export, body = disagg.decode_export_binary(self._read_raw())
            else:
                body = self._read_body()
                export = disagg.decode_export(body.get("export") or {})
            steps = int(body.get("steps", 0))
            temperature = float(body.get("temperature") or 0.0)
            top_k = int(body.get("top_k") or 0)
            stop = body.get("stop")
            stop = int(stop) if stop is not None else None
        except (TypeError, ValueError) as e:
            self.send_error(400, _status_text(e))
            return
        if steps > api._cap("max_steps", DEFAULT_MAX_STEPS):
            self.send_error(400, "steps %d exceeds max_steps" % steps)
            return
        ok, toks = self._job_result(lambda: api.scheduler_.submit_imported(
            export, steps, temperature=temperature, top_k=top_k,
            seed=body.get("seed"), stop_token=stop,
            timeout=api.request_timeout, priority=body.get("priority"),
            trace=self._trace()), "decode", tokens_generated=0)
        if ok:
            self._reply_json({"tokens": toks})

    def _serving_prefix_export(self):
        """POST /serving/prefix_export ``{"tokens": [...]}``: the raw
        blocks of the longest resident prefix of the tokens across both
        tiers, or 404 when none is resident.  Served while draining (a
        drained replica's warm cache is what is worth rescuing)."""
        api = self.api
        if api.forwards is None or api.scheduler_ is None:
            self.send_error(404, "no servable model chain")
            return
        try:
            tokens = [int(t) for t in self._read_body().get("tokens") or ()]
        except (TypeError, ValueError):
            self.send_error(400, "tokens must be a flat list of token ids")
            return
        ok, rec = self._job_result(
            lambda: api.scheduler_.submit_prefix_export(tokens),
            "prefix export")
        if not ok:
            return
        if rec is None:
            self._reply_error(404, "no resident prefix for these tokens")
            return
        self._reply_record(rec)

    def _serving_prefix_import(self):
        """POST /serving/prefix_import: adopt a peer's prefix record (the
        binary frame, or JSON ``{"record": ...}``); replies ``{"blocks":
        adopted}``."""
        api = self.api
        if api.forwards is None or api.scheduler_ is None:
            self.send_error(404, "no servable model chain")
            return
        try:
            if self._sent_binary():
                record, _ = disagg.decode_export_binary(self._read_raw())
            else:
                record = disagg.decode_export(
                    self._read_body().get("record") or {})
        except (TypeError, ValueError) as e:
            self.send_error(400, _status_text(e))
            return
        ok, out = self._job_result(
            lambda: api.scheduler_.submit_prefix_import(record),
            "prefix import")
        if ok:
            self._reply_json(out)

    def _tune(self):
        """The control plane's knob: ``shed_block_factor``, floored at
        0.1 so no tune disables shedding outright."""
        sch = self.api.scheduler_
        if not self._admin_ok():
            self.send_error(403, "tune needs loopback or the admin token")
            return
        if sch is None:
            self.send_error(501, "tune needs the serving scheduler")
            return
        try:
            factor = self._read_body().get("shed_block_factor")
            if factor is not None:
                sch.shed_block_factor = max(0.1, float(factor))
        except (TypeError, ValueError) as e:
            self.send_error(400, _status_text(e))
            return
        self._reply_json({"shed_block_factor": sch.shed_block_factor,
                          "kv_blocks": sch.kv_blocks})

    def _shutdown(self):
        if not self._admin_ok():
            self.send_error(403, "shutdown needs loopback or the admin "
                            "token")
            return
        self._reply_json({"ok": True})
        if self.api.shutdown_callback is not None:
            self.api.shutdown_callback()

    def _drain(self):
        """Rolling-restart hook: stop admitting (new submits 503 with
        Retry-After), finish in flight, flip /healthz to 503."""
        api = self.api
        if not self._admin_ok():
            self.send_error(403, "drain needs loopback or the admin token")
            return
        api._draining_ = True
        reply = {"draining": True}
        if api.scheduler_ is not None:
            api.scheduler_.drain()
            reply["in_flight"] = api.scheduler_.in_flight
            reply["drained"] = api.scheduler_.drained
        self._reply_json(reply, code=202)

    def _generate(self):
        """POST /generate: validation and caps, then SSE, beam search,
        the scheduler or the serialized decode."""
        api = self.api
        if api.forwards is None:
            self.send_error(404, "this endpoint serves no LM chain")
            return
        length = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(length))
        raw = body.get("prompt")
        if not isinstance(raw, list):
            self.send_error(400, "prompt must be a token list or a batch of "
                            "token lists")
            return
        squeeze = bool(raw) and not isinstance(raw[0], list)
        rows = [raw] if squeeze else list(raw)
        max_batch = api._cap("max_batch", DEFAULT_MAX_BATCH)
        if len(rows) > max_batch:
            self.send_error(400, "batch of %d prompts exceeds max_batch %d"
                            % (len(rows), max_batch))
            return
        try:
            lens = [len(r) for r in rows]
        except TypeError:
            self.send_error(400, "prompt rows must be flat lists of token "
                            "ids")
            return
        if not rows or min(lens, default=0) < 1:
            self.send_error(400, "prompt rows must be non-empty token lists")
            return
        # rows may be ragged: pad to the widest, keep the true lengths
        width = max(lens)
        prompt = numpy.zeros((len(rows), width), numpy.int32)
        for i, r in enumerate(rows):
            try:
                row = numpy.asarray(r, numpy.int32)
                if row.ndim != 1:
                    raise ValueError(row.ndim)
            except (TypeError, ValueError):
                self.send_error(400, "prompt rows must be flat lists of "
                                "token ids")
                return
            prompt[i, :len(r)] = row
        err = api._validate_prompt(prompt)
        if err:
            self.send_error(400, err)
            return
        try:
            steps = int(body["steps"])
            if steps < 0:
                raise ValueError(steps)
        except (KeyError, TypeError, ValueError):
            self.send_error(400, "steps must be a non-negative int")
            return
        max_steps = api._cap("max_steps", DEFAULT_MAX_STEPS)
        if steps > max_steps:
            self.send_error(400, "steps %d exceeds max_steps %d"
                            % (steps, max_steps))
            return
        try:
            temperature = float(body.get("temperature", 0.0))
            top_k = int(body.get("top_k", 0))
        except (TypeError, ValueError):
            self.send_error(400, "temperature must be a number and top_k an "
                            "int")
            return
        stop = body.get("stop")
        if stop is not None:
            try:
                stop = int(stop)
            except (TypeError, ValueError):
                self.send_error(400, "stop must be an int token id")
                return
        ragged = min(lens) != width
        try:
            beam = int(body.get("beam", 0))
        except (TypeError, ValueError):
            self.send_error(400, "beam must be an int")
            return
        if beam < 0:
            self.send_error(400, "beam must be >= 1")
            return
        priority = body.get("priority")
        if priority is not None:
            try:
                resolve_priority(priority)
            except ValueError as e:
                self.send_error(400, _status_text(e))
                return
        resume = body.get("resume_tokens")
        if resume is not None:
            # the mid-stream failover lane (a router resubmits with the
            # tokens it already forwarded): loopback/admin only, or any
            # client could bill continuations of fabricated prefixes
            if not self._admin_ok():
                self.send_error(403, "resume_tokens is the loopback/admin "
                                "failover lane")
                return
            try:
                resume = [int(t) for t in resume]
            except (TypeError, ValueError):
                self.send_error(400, "resume_tokens must be a flat list of "
                                "token ids")
                return
            rerr = api._validate_rows([resume]) if resume else None
            if rerr:
                self.send_error(400, rerr)
                return
            if beam or len(rows) != 1 or api.scheduler_ is None \
                    or steps < 1:
                self.send_error(400, "resume_tokens needs the serving "
                                "scheduler, a single prompt row, steps >= 1 "
                                "and no beam")
                return
        if body.get("stream"):
            # SSE rides the scheduler only
            if beam:
                self.send_error(400, "stream does not combine with beam "
                                "search")
                return
            if api.scheduler_ is None or steps < 1:
                self.send_error(400, "stream: true needs the serving "
                                "scheduler and steps >= 1")
                return
            if len(rows) != 1:
                self.send_error(400, "stream: true needs a single prompt "
                                "row")
                return
            self._stream_generate(rows[0], steps, temperature, top_k,
                                  body.get("seed"), stop, priority,
                                  resume=resume)
            return
        if beam:
            if temperature or top_k:
                self.send_error(400, "beam search is deterministic - drop "
                                "temperature/top_k")
                return
            if stop is not None:
                self.send_error(400, "beam search decodes fixed length - "
                                "drop stop")
                return
            if ragged:
                self.send_error(400, "beam search needs equal-length "
                                "prompts")
                return
            try:
                toks, scores = api._decode_beam(prompt, steps, beam)
            except ValueError as e:
                # beam > vocab, a chain without the kv path: the
                # client's request, not a server fault
                self.send_error(400, _status_text(e))
                return
            reply = {"tokens": [r[0] for r in toks], "beams": toks,
                     "scores": scores}
            if squeeze:
                reply = {"tokens": toks[0][0], "beams": toks[0],
                         "scores": scores[0]}
            self._reply_json(reply)
            return
        if api.scheduler_ is not None and steps >= 1:
            # continuous batching: no lock, concurrent clients interleave
            try:
                outs = api._generate_scheduled(
                    rows, steps, temperature, top_k, body.get("seed"), stop,
                    priority=priority, trace=self._trace(),
                    resume_tokens=resume, tenant=self._tenant())
            except ValueError as e:
                self.send_error(400, _status_text(e))
                return
            except SchedulerError as e:
                self._reply_scheduler_error(e)
                return
            except concurrent.futures.TimeoutError:
                self._reply_error(408, "decode timed out", tokens_generated=0)
                return
            self._reply_json({"tokens": outs[0] if squeeze else outs})
            return
        tokens = api._decode(prompt, steps, temperature, top_k,
                             body.get("seed"),
                             prompt_lens=lens if ragged else None,
                             stop_token=stop)
        # each row answers with ITS prompt + steps tokens (shorter rows
        # decode past their quota in lockstep), cut after the first
        # generated stop token
        out = []
        for i in range(len(rows)):
            row = tokens[i, :lens[i] + steps]
            if stop is not None:
                hits = numpy.nonzero(row[lens[i]:] == int(stop))[0]
                if hits.size:
                    row = row[:lens[i] + hits[0] + 1]
            out.append(row.tolist())
        self._reply_json({"tokens": out[0] if squeeze else out})

    def _v1_completions(self):
        """POST /v1/completions — the OpenAI facade over the scheduler
        path /generate uses (batch and SSE)."""
        api = self.api
        if api.forwards is None:
            self.send_error(404, "this endpoint serves no model")
            return
        try:
            params = openai_api.parse_completions(self._read_body(),
                                                  api.model_id)
        except ValueError as e:
            self.send_error(400, _status_text(e))
            return
        rows = params["rows"]
        if len(rows) > api._cap("max_batch", DEFAULT_MAX_BATCH):
            self.send_error(400, "batch of %d prompts exceeds max_batch"
                            % len(rows))
            return
        if params["steps"] > api._cap("max_steps", DEFAULT_MAX_STEPS):
            self.send_error(400, "max_tokens %d exceeds max_steps"
                            % params["steps"])
            return
        err = api._validate_rows(rows)
        if err:
            self.send_error(400, err)
            return
        if api.scheduler_ is None:
            self.send_error(501, "the OpenAI facade needs the serving "
                            "scheduler (serving=False pins legacy /generate "
                            "only)")
            return
        cid = openai_api.completion_id()
        created = int(time.time())
        model = params["model"]
        if params["stream"]:
            if len(rows) != 1:
                self.send_error(400, "stream: true needs a single prompt "
                                "row")
                return
            try:
                ts = api.scheduler_.submit(
                    rows[0], params["steps"],
                    temperature=params["temperature"],
                    top_k=params["top_k"], seed=params["seed"],
                    stop_token=params["stop"], timeout=api.request_timeout,
                    priority=params["priority"], stream=True,
                    trace=self._trace(), tenant=self._tenant())
            except ValueError as e:
                self.send_error(400, _status_text(e))
                return
            except SchedulerError as e:
                self._reply_scheduler_error(e)
                return

            def chunk(tok):
                return openai_api.completion_chunk(cid, created, model, 0,
                                                   [tok])

            def final(err):
                if err is not None:
                    return {"error": {
                        "code": getattr(err, "http_status", 500),
                        "message": _status_text(err), "trace_id": ts.trace}}
                return openai_api.completion_chunk(
                    cid, created, model, 0, [],
                    finish=openai_api.finish_reason(
                        ts.tokens, params["steps"], params["stop"]),
                    usage=openai_api.usage_of(rows, [len(ts.tokens)]),
                    trace_id=ts.trace)

            self._relay_sse(ts, chunk, final)
            return
        try:
            outs = api._generate_scheduled(
                rows, params["steps"], params["temperature"],
                params["top_k"], params["seed"], params["stop"],
                priority=params["priority"], trace=self._trace(),
                tenant=self._tenant())
        except ValueError as e:
            self.send_error(400, _status_text(e))
            return
        except SchedulerError as e:
            self._reply_scheduler_error(e)
            return
        except concurrent.futures.TimeoutError:
            self._reply_error(408, "decode timed out", tokens_generated=0)
            return
        gens = [out[len(r):] for r, out in zip(rows, outs)]
        choices = [openai_api.completion_choice(i, r, g, params)
                   for i, (r, g) in enumerate(zip(rows, gens))]
        self._reply_json(openai_api.completion_reply(
            cid, created, model, choices,
            openai_api.usage_of(rows, [len(g) for g in gens])))

    def _v1_batch(self, kind):
        """POST /v1/embeddings | /v1/classify — batched scoring through
        the scheduler's aux lane (the loop runs the pass between decode
        boundaries)."""
        api = self.api
        if api.forwards is None or api.scheduler_ is None:
            self.send_error(404, "no servable model chain")
            return
        try:
            body = self._read_body()
            rows, _ = openai_api.parse_token_rows(body.get("input"),
                                                  what="input")
        except ValueError as e:
            self.send_error(400, _status_text(e))
            return
        if len(rows) > api._cap("max_batch", DEFAULT_MAX_BATCH):
            self.send_error(400, "batch of %d rows exceeds max_batch"
                            % len(rows))
            return
        err = api._validate_rows(rows)
        if err:
            self.send_error(400, err)
            return
        model = str(body.get("model") or api.model_id)
        try:
            if kind == "embed":
                fut = api.scheduler_.submit_embed(rows)
            else:
                fut = api.scheduler_.submit_score(rows)
            out = fut.result(api.request_timeout + 30.0)
        except ValueError as e:
            self.send_error(400, _status_text(e))
            return
        except SchedulerError as e:
            self._reply_scheduler_error(e)
            return
        except concurrent.futures.TimeoutError:
            self._reply_error(408, "scoring timed out")
            return
        if kind == "embed":
            self._reply_json(openai_api.embeddings_reply(model, out, rows))
            return
        try:
            top = int(body.get("top", 5))
        except (TypeError, ValueError):
            self.send_error(400, "top must be an int")
            return
        self._reply_json(openai_api.classify_reply(model, out, rows, top))
