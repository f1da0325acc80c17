"""Continuous-batching inference scheduler — the port of
``veles_tpu/serving/scheduler.py::InferenceScheduler`` (its core loop).

Requests queue on :meth:`InferenceScheduler.submit` (any thread) and
are served by ONE background loop that owns every tensor:

1. **admit** — while a slot and the request's whole block budget
   (``ceil((prompt + steps) / block_size)`` blocks) are free, the
   oldest queued request claims them;
2. **prefill** — prompts up to ``prefill_chunk`` tokens prefill in one
   pass; longer ones prefill one ``prefill_chunk``-token chunk per loop
   iteration, interleaved with the decode step, so a long prompt
   stalls in-flight streams by one chunk per iteration.  The staging
   row is then inserted into the paged cache and the first token is
   sampled (the TTFT edge);
3. **step** — the active slots advance one token through
   :func:`~veles_tpu_torch.serving.engine.paged_decode_step`, packed
   into a power-of-two occupancy bucket with a power-of-two block
   bucket over the deepest request;
4. **retire** — a request that produced its stop token or its last
   step completes its future with prompt + generated tokens and frees
   its slot and blocks.

Greedy streams are exact: each request attends only over its own
blocks and sampling is row-wise, so a stream is independent of its
slot, the packing order and its co-tenants.

Not ported yet (the JAX scheduler has them): speculative decoding,
the prefix cache and host tier, disaggregation, priorities, deadlines,
cancel, preemption, the watchdog, tensor parallelism, the metrics
registry, embed/score jobs and the dense KV layout.
"""

import collections
import concurrent.futures
import logging
import os
import threading
import time

import numpy

from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.serving.engine import first_tokens, paged_decode_step
from veles_tpu_torch.serving.kv_slots import PagedKVCache, paged_supported
from veles_tpu_torch.serving.prefill import (
    chunked_supported, prefill, prefill_chunk, serving_supported,
    serving_window)

log = logging.getLogger(__name__)

#: narrowest staging row a prompt prefills into (the JAX scheduler's
#: default ``prefill_bucket``, so both pad prompts alike)
PREFILL_BUCKET = 8


class SchedulerError(Exception):
    """Base serving failure."""


class QueueFullError(SchedulerError):
    """Admission control: the queue-depth cap was hit."""


def _bucket(n, floor, cap):
    """Pad widths/counts to power-of-two buckets (the occupancy and
    depth ladders of the decode step)."""
    b = max(int(floor), 1)
    while b < n:
        b *= 2
    return min(b, cap)


class _Request(object):
    __slots__ = ("prompt", "steps", "temperature", "top_k", "stop_token",
                 "seed", "future", "slot", "generated", "t_submit",
                 "t_first", "pf_seq", "pf_caches", "pf_off", "pf_width",
                 "pf_chunk")

    def __init__(self, prompt, steps, temperature, top_k, stop_token,
                 seed):
        self.prompt = prompt
        self.steps = steps
        self.temperature = temperature
        self.top_k = top_k
        self.stop_token = stop_token
        self.seed = seed
        self.future = concurrent.futures.Future()
        self.slot = None
        self.generated = []
        self.t_submit = time.monotonic()
        self.t_first = None
        self.pf_seq = None          # the sequence being prefilled
        self.pf_caches = None       # chunked-prefill staging caches
        self.pf_off = 0
        self.pf_width = 0
        self.pf_chunk = 0

    def fail(self, error):
        if not self.future.done():
            try:
                self.future.set_exception(error)
            except concurrent.futures.InvalidStateError:
                pass


class InferenceScheduler(object):
    """Continuous-batching decode service over a port chain.

    ``max_slots`` — concurrent requests per decode step; ``window`` —
    per-request bound ``prompt_len + steps <= window`` (default: the
    chain's positional table); ``max_queue`` — waiting-request cap
    (:class:`QueueFullError` above it); ``block_size`` /
    ``kv_blocks`` / ``kv_dtype`` ("fp32" or "int8") — the paged cache;
    ``prefill_chunk`` — chunk width of chunked prefill (0 = always
    one-shot).  ``device`` must
    be the chain's device (default ``cuda``).  The parameters after
    ``max_queue`` are keyword-only: the reference's fifth positional
    parameter is ``queue_timeout``, which the port does not have."""

    def __init__(self, forwards, max_slots=4, window=None, max_queue=32,
                 *, block_size=16, kv_blocks=None, kv_dtype="fp32",
                 prefill_chunk=64, device=None):
        self.device = resolve_device(device)
        if any(u.device != self.device for u in forwards):
            raise ValueError("the chain lies on %s, the scheduler was "
                             "given %s" % (forwards[0].device, self.device))
        if not serving_supported(forwards) or not paged_supported(forwards):
            raise ValueError(
                "chain cannot serve through the scheduler (needs causal "
                "cacheable blocks with apply_prefill/apply_step_paged)")
        window = window or serving_window(forwards)
        if not window or int(window) < 2:
            raise ValueError("no usable decode window: pass window=")
        self.forwards = forwards
        self.max_slots = int(max_slots)
        self.window = int(window)
        self.max_queue = int(max_queue)
        self.block_size = int(block_size)
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.blocks_per_slot = -(-self.window // self.block_size)
        self.kv_blocks = int(kv_blocks
                             or self.max_slots * self.blocks_per_slot)
        if kv_dtype not in ("fp32", "int8"):
            raise ValueError("kv_dtype must be 'fp32' or 'int8'")
        self.kv_dtype = kv_dtype
        chunk = int(prefill_chunk or 0)
        if chunk and not chunked_supported(forwards):
            log.info("chain cannot prefill in chunks; long prompts will "
                     "prefill one-shot")
            chunk = 0
        #: chunk widths are powers of two
        self.prefill_chunk = _bucket(chunk, 1, 1 << 30) if chunk else 0
        #: decode steps run so far (one per loop iteration with active
        #: slots) — what kernel launch counts are read against — and
        #: the tokens they emitted and the host seconds they took (each
        #: step ends in the sampled tokens' copy to the host)
        self.decode_steps = 0
        self.decode_tokens = 0
        self.decode_seconds = 0.0
        #: (time to first token, request latency) in seconds, one pair
        #: per completed request, from submit
        self.completed = []
        self.error = None            # what killed the loop, if anything
        self._queue = collections.deque()
        self._active = {}            # slot -> _Request (decoding)
        self._prefilling = []        # admitted, mid-chunked-prefill
        self._admitting = []         # popped this iteration, in prefill
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self._thread = None
        self._ready = threading.Event()
        self.cache_ = None           # built by the loop thread

    # -- client side -----------------------------------------------------------

    def start(self):
        """Start the loop thread and wait until its cache is built."""
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="serving-scheduler")
                self._thread.start()
        self._ready.wait()
        if self.error is not None:
            raise SchedulerError("scheduler failed to start: %r"
                                 % (self.error,))
        return self

    def submit(self, prompt, steps, temperature=0.0, top_k=0, seed=None,
               stop_token=None):
        """Queue one sequence; returns a Future whose result is the
        prompt followed by the generated tokens (ending at the first
        generated stop token, if one fired).  Raises ``ValueError`` on
        a malformed request and :class:`QueueFullError` when the queue
        is full."""
        prompt = [int(t) for t in prompt]
        steps = int(steps)
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if steps < 1:
            raise ValueError("steps must be >= 1")
        if len(prompt) + steps > self.window:
            raise ValueError("prompt_len + steps = %d exceeds the serving "
                             "window (%d)" % (len(prompt) + steps,
                                              self.window))
        need = -(-(len(prompt) + steps) // self.block_size)
        if need > self.kv_blocks:
            raise ValueError("request needs %d KV blocks > pool capacity "
                             "%d (kv_blocks)" % (need, self.kv_blocks))
        temperature = float(temperature or 0.0)
        top_k = int(top_k or 0)
        if top_k and not temperature:
            raise ValueError("top_k only applies to sampling — set "
                             "temperature > 0")
        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
        req = _Request(prompt, steps, temperature, top_k,
                       int(stop_token) if stop_token is not None else None,
                       int(seed) & 0xFFFFFFFF)
        with self._wake:
            if self._closed:
                raise SchedulerError("scheduler is closed")
            if len(self._queue) >= self.max_queue:
                raise QueueFullError("serving queue full (%d waiting)"
                                     % len(self._queue))
            self._queue.append(req)
            self._wake.notify()
        return req.future

    def check_kv(self):
        """The paged cache's invariant sweep (loop idle or closed)."""
        if self.cache_ is not None:
            self.cache_.check()

    def close(self):
        """Stop the loop, fail every unfinished request, and return
        every in-flight slot and block to the cache (``check_kv()``
        holds afterwards)."""
        with self._wake:
            if self._closed and self._thread is None:
                return
            self._closed = True
            self._wake.notify()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        err = SchedulerError("scheduler closed")
        with self._lock:
            pending = list(self._queue) + list(self._prefilling) \
                + list(self._active.values()) + list(self._admitting)
            self._queue.clear()
            self._prefilling = []
            self._active.clear()
            self._admitting = []
        for req in pending:
            if req.slot is not None and self.cache_ is not None:
                self.cache_.release(req.slot)
                req.slot = None
            req.fail(err)

    # -- decode loop -------------------------------------------------------------

    def _loop(self):
        try:
            self.cache_ = PagedKVCache(
                self.forwards, self.max_slots, self.window,
                block_size=self.block_size, kv_blocks=self.kv_blocks,
                kv_dtype=self.kv_dtype)
        except Exception as e:
            self.error = e
            with self._wake:
                self._closed = True
            self._ready.set()
            raise
        self._ready.set()
        try:
            self._serve(self.cache_)
        except Exception as e:
            # a fault in a step is fatal: the loop stops and every
            # waiting client sees the error
            log.exception("serving loop failed")
            self.error = e
            with self._wake:
                self._closed = True
                pending = list(self._queue) + list(self._prefilling) \
                    + list(self._active.values()) + list(self._admitting)
            for req in pending:
                req.fail(SchedulerError(repr(e)))

    def _serve(self, cache):
        while True:
            with self._wake:
                while not self._closed and not self._queue \
                        and not self._active and not self._prefilling:
                    self._wake.wait()
                if self._closed:
                    return
                admits = []
                while self._queue and cache.can_admit(
                        len(self._queue[0].prompt) + self._queue[0].steps):
                    req = self._queue.popleft()
                    req.slot = cache.alloc(len(req.prompt) + req.steps)
                    admits.append(req)
                    self._admitting.append(req)
            for req in admits:
                self._begin_admit(req, cache)
                with self._lock:
                    self._admitting.remove(req)
            if self._prefilling:
                self._prefill_tick(cache)
            if self._active:
                self._step(cache)

    def _staging_width(self, p_len, chunk):
        """Width of the batch-1 staging row a prompt prefills into:
        the power-of-two bucket of the prompt, floored so it tiles the
        chunk width and the block size."""
        floor = max(PREFILL_BUCKET, self.block_size, chunk or 1)
        return _bucket(p_len, floor, 1 << 30)

    def _begin_admit(self, req, cache):
        """Route one joining request: short prompts prefill one-shot,
        long ones start the chunked-prefill ride-along."""
        req.pf_seq = list(req.prompt)
        p_len = len(req.pf_seq)
        chunk = self.prefill_chunk
        if not chunk or p_len <= chunk:
            self._admit_oneshot(req, cache)
            return
        req.pf_chunk = chunk
        req.pf_width = self._staging_width(p_len, chunk)
        req.pf_off = 0
        req.pf_caches = {
            i: u.init_cache(1, req.pf_width, u.dtype)
            for i, u in enumerate(self.forwards)
            if hasattr(u, "init_cache")}
        with self._lock:
            self._prefilling.append(req)

    def _admit_oneshot(self, req, cache):
        """Prefill one request's prompt in a single pass and emit its
        first token."""
        p_len = len(req.pf_seq)
        width = self._staging_width(p_len, 0)
        # the token array stays inside the positional table; the
        # staging cache may be wider (insert reads only the prompt's
        # blocks)
        p_w = min(width, max(self.window, p_len))
        padded = numpy.zeros((1, p_w), numpy.int32)
        padded[0, :p_len] = req.pf_seq
        row_caches, last = prefill(self.forwards, padded,
                                   prompt_lens=[p_len], window=width)
        self._finish_admit(req, cache, row_caches, last)

    def _prefill_tick(self, cache):
        """Advance the oldest mid-prefill request by ONE chunk."""
        with self._lock:
            req = self._prefilling[0]
        p_len = len(req.pf_seq)
        c = req.pf_chunk
        off = req.pf_off
        end = min(off + c, p_len)
        clen = end - off
        padded = numpy.zeros((1, c), numpy.int32)
        padded[0, :clen] = req.pf_seq[off:end]
        kw = _bucket(off + c, c, req.pf_width)
        req.pf_caches, last = prefill_chunk(
            self.forwards, padded, off, [clen], req.pf_caches,
            key_width=kw)
        req.pf_off = end
        if end >= p_len:
            with self._lock:
                self._prefilling.remove(req)
            self._finish_admit(req, cache, req.pf_caches, last)

    def _finish_admit(self, req, cache, row_caches, last):
        """Insert the prefilled staging row and emit the first token."""
        cache.insert(req.slot, row_caches, len(req.pf_seq))
        req.pf_caches = None
        req.pf_seq = None
        self._activate(req, cache, last)

    def _activate(self, req, cache, last):
        """Sample the first token (draw ``len(generated)`` of the
        request's stream) and join the active decode set."""
        tok = int(first_tokens(last, [req.temperature], [req.top_k],
                               [req.seed],
                               counts=[len(req.generated)])[0])
        self._emit(req, tok)
        if req.t_first is None:
            req.t_first = time.monotonic()
        with self._lock:
            self._active[req.slot] = req
        self._maybe_finish(req, cache)

    def _emit(self, req, tok):
        req.generated.append(tok)

    def _step(self, cache):
        with self._lock:
            active = dict(self._active)
        if active:
            self._step_paged(cache, active)

    def _step_paged(self, cache, active):
        """Packed step: only the active slots ride the batch, padded to
        a power-of-two occupancy bucket; the attended range is the
        power-of-two block bucket of the deepest request."""
        slots = sorted(active)
        n = len(slots)
        b = _bucket(n, 1, self.max_slots)
        deepest = max(len(active[s].prompt) + len(active[s].generated)
                      for s in slots)
        t = _bucket(-(-deepest // cache.block_size), 1,
                    cache.blocks_per_slot)
        toks = numpy.zeros((b, 1), numpy.int32)
        pos = numpy.zeros((b,), numpy.int32)
        temps = numpy.zeros((b,), numpy.float32)
        topks = numpy.zeros((b,), numpy.int32)
        seeds = numpy.zeros((b,), numpy.uint32)
        counts = numpy.zeros((b,), numpy.int32)
        tables = numpy.zeros((b, t), numpy.int32)
        for j, slot in enumerate(slots):
            req = active[slot]
            toks[j, 0] = req.generated[-1]
            pos[j] = len(req.prompt) + len(req.generated) - 1
            temps[j] = req.temperature
            topks[j] = req.top_k
            seeds[j] = req.seed
            counts[j] = len(req.generated)
        tables[:n] = cache.table_rows(slots, t)
        t0 = time.perf_counter()
        nxt = paged_decode_step(self.forwards, cache, toks, pos, tables,
                                temps, topks, seeds, counts)
        self.decode_seconds += time.perf_counter() - t0
        self.decode_steps += 1
        self.decode_tokens += n
        for j, slot in enumerate(slots):
            req = active[slot]
            self._emit(req, int(nxt[j]))
            self._maybe_finish(req, cache)

    def _maybe_finish(self, req, cache):
        if len(req.generated) >= req.steps \
                or (req.stop_token is not None
                    and req.generated[-1] == req.stop_token):
            self._retire(req, cache)

    def _retire(self, req, cache):
        with self._lock:
            self._active.pop(req.slot, None)
        cache.release(req.slot)
        req.slot = None
        now = time.monotonic()
        self.completed.append((req.t_first - req.t_submit,
                               now - req.t_submit))
        if not req.future.done():
            req.future.set_result(list(req.prompt) + req.generated)
