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
   bucket over the deepest request.  With ``spec`` on (the default, as
   in the reference) each slot first drafts up to its ``draft_k``
   tokens by n-gram prompt lookup (:mod:`~veles_tpu_torch.serving.
   spec`); when any slot drafted, the step is ONE batched verify pass
   (:func:`~veles_tpu_torch.serving.engine.verify_step_paged`) at the
   fixed width ``spec_k + 1`` — slots without drafts ride it as
   width-1 rows — and each slot keeps its longest matched prefix plus
   the correction token, so one pass emits up to ``spec_k + 1`` tokens
   and the stream stays the spec-off stream;
4. **retire** — a request that produced its stop token or its last
   step completes its future with prompt + generated tokens and frees
   its slot and blocks.

Greedy streams are exact: each request attends only over its own
blocks and sampling is row-wise, so a stream is independent of its
slot, the packing order and its co-tenants.

Not ported yet (the JAX scheduler has them): the Medusa draft heads
and the hidden-state lane, the prefix cache and host tier,
disaggregation, priorities, deadlines, cancel, preemption, the
watchdog, tensor parallelism, the metrics registry, embed/score jobs
and the dense KV layout.
"""

import collections
import concurrent.futures
import logging
import os
import threading
import time

import numpy
import torch

from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.ops.paged_attend import MAX_K1
from veles_tpu_torch.serving.engine import (
    first_tokens, paged_decode_step, verify_step_paged, verify_supported)
from veles_tpu_torch.serving.kv_slots import PagedKVCache, paged_supported
from veles_tpu_torch.serving.prefill import (
    chunked_supported, prefill, prefill_chunk, serving_supported,
    serving_window)
from veles_tpu_torch.serving.spec import (
    NgramIndex, NgramProposer, accept_drafts)

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
                 "pf_chunk", "draft_k", "accept_ema", "gram_ix")

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
        # speculative drafting: the accept-rate-adaptive draft length
        # (set at the first draft), the accept-rate EMA by drafter and
        # the memoized trailing-n-gram index
        self.draft_k = 0
        self.accept_ema = {}
        self.gram_ix = None

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
    one-shot); ``spec`` / ``spec_k`` — speculative decoding with up to
    ``spec_k`` n-gram drafts per slot and step; ``fused_verify`` —
    score fp32 pools' verify runs single-pass; ``draft_k_min`` /
    ``draft_ema`` — the floor of a slot's adaptive draft length and the
    weight of its accept-rate EMA (the reference's defaults throughout).
    ``device`` must be the chain's device (default ``cuda``).  The
    parameters after ``max_queue`` are keyword-only: the reference's
    fifth positional parameter is ``queue_timeout``, which the port
    does not have."""

    #: a slot's draft length halves below this accept-rate EMA and
    #: doubles above ``DRAFT_GROW`` (the reference's thresholds)
    DRAFT_SHRINK, DRAFT_GROW = 0.5, 0.8

    def __init__(self, forwards, max_slots=4, window=None, max_queue=32,
                 *, block_size=16, kv_blocks=None, kv_dtype="fp32",
                 prefill_chunk=64, spec=True, spec_k=4, fused_verify=False,
                 draft_k_min=1, draft_ema=0.5, device=None):
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
        spec = bool(spec)
        self.spec_k = int(spec_k)
        if spec and self.spec_k < 1:
            raise ValueError("spec_k must be >= 1")
        if spec and not verify_supported(forwards):
            log.info("chain cannot run the paged verify step; "
                     "speculative decoding disabled")
            spec = False
        self.fused_verify = bool(fused_verify)
        if spec and self.device.type == "cuda" \
                and (kv_dtype == "int8" or self.fused_verify) \
                and self.spec_k + 1 > MAX_K1:
            raise ValueError("spec_k + 1 = %d exceeds the %d queries per "
                             "row of the paged-attention kernel"
                             % (self.spec_k + 1, MAX_K1))
        self.spec = spec
        self._proposer = NgramProposer(k=self.spec_k) if spec else None
        self.draft_k_min = max(1, min(int(draft_k_min), self.spec_k))
        self.draft_ema = float(draft_ema)
        if not 0.0 < self.draft_ema <= 1.0:
            raise ValueError("draft_ema must be in (0, 1]")
        #: model passes so far: plain decode steps and verify steps (one
        #: of them per loop iteration with active slots) — what kernel
        #: launch counts are read against — and the tokens both kinds
        #: emitted and the host seconds they took (each ends in the
        #: sampled tokens' copy to the host)
        self.decode_steps = 0
        self.verify_steps = 0
        self.decode_tokens = 0
        self.decode_seconds = 0.0
        #: the tokens the verify steps emitted (part of decode_tokens),
        #: the drafts proposed, and those the verify passes kept
        self.verify_tokens = 0
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
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

    @property
    def spec_accept_rate(self):
        """Accepted over drafted tokens, None before the first draft."""
        if not self.spec_drafted_tokens:
            return None
        return self.spec_accepted_tokens / self.spec_drafted_tokens

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
            # serving never differentiates: a chain fresh from training
            # (parameters that require grad) must not record graphs or
            # rebuild its cached weight casts every step
            with torch.no_grad():
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
        power-of-two block bucket of the deepest request.  With spec on
        and any slot drafting, the step is a verify pass instead."""
        if self.spec:
            drafts = self._draft(active)
            if drafts:
                self._step_verify(cache, active, drafts)
                return
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

    def _draft(self, active):
        """Draft tokens per slot: up to its adaptive ``draft_k``, capped
        so accepting every draft and the correction token stays inside
        the request's step budget (so every position written lies in
        the blocks claimed at admission), by n-gram prompt lookup
        through the request's index.  Returns {slot: tokens}."""
        drafts = {}
        for slot, req in active.items():
            room = req.steps - len(req.generated) - 1
            if room < 1:
                continue
            if req.draft_k < 1:
                req.draft_k = self.spec_k  # start optimistic
            limit = min(req.draft_k, room)
            if req.gram_ix is None:
                req.gram_ix = NgramIndex(self._proposer.max_ngram,
                                         self._proposer.min_ngram)
            d = self._proposer.propose(
                list(req.prompt) + list(req.generated), limit,
                index=req.gram_ix)
            if d:
                drafts[slot] = d
        return drafts

    def _adapt_draft_k(self, req, drafted, accepted):
        """Blend this verify's accept rate into the slot's EMA (weight
        ``draft_ema``), then halve its draft length toward
        ``draft_k_min`` below DRAFT_SHRINK or double it toward
        ``spec_k`` above DRAFT_GROW; count the drafts."""
        rate = accepted / drafted
        prev = req.accept_ema.get("ngram")
        ema = rate if prev is None \
            else (1.0 - self.draft_ema) * prev + self.draft_ema * rate
        req.accept_ema["ngram"] = ema
        if ema < self.DRAFT_SHRINK:
            req.draft_k = max(self.draft_k_min, req.draft_k >> 1)
        elif ema > self.DRAFT_GROW:
            req.draft_k = min(self.spec_k, req.draft_k << 1)
        self.spec_drafted_tokens += drafted
        self.spec_accepted_tokens += accepted

    def _step_verify(self, cache, active, drafts):
        """Speculative step: every active slot rides ONE verify pass of
        width ``spec_k + 1`` — its pending token then its drafts
        (padding past ``lens`` goes to the trash block; a slot without
        drafts is a width-1 row).  The block bucket covers the deepest
        request plus ``spec_k``.  Each slot emits its longest matched
        prefix and the correction sample, stopping early at its stop
        token or its step budget."""
        slots = sorted(active)
        n = len(slots)
        b = _bucket(n, 1, self.max_slots)
        k = self.spec_k
        deepest = max(len(active[s].prompt) + len(active[s].generated)
                      for s in slots) + k
        t = _bucket(-(-deepest // cache.block_size), 1,
                    cache.blocks_per_slot)
        toks = numpy.zeros((b, k + 1), numpy.int32)
        pos = numpy.zeros((b,), numpy.int32)
        lens = numpy.ones((b,), numpy.int32)
        temps = numpy.zeros((b,), numpy.float32)
        topks = numpy.zeros((b,), numpy.int32)
        seeds = numpy.zeros((b,), numpy.uint32)
        counts = numpy.zeros((b,), numpy.int32)
        tables = numpy.zeros((b, t), numpy.int32)
        for j, slot in enumerate(slots):
            req = active[slot]
            d = drafts.get(slot, [])
            toks[j, 0] = req.generated[-1]
            toks[j, 1:1 + len(d)] = d
            pos[j] = len(req.prompt) + len(req.generated) - 1
            lens[j] = 1 + len(d)
            temps[j] = req.temperature
            topks[j] = req.top_k
            seeds[j] = req.seed
            counts[j] = len(req.generated)
        tables[:n] = cache.table_rows(slots, t)
        t0 = time.perf_counter()
        nxt = verify_step_paged(self.forwards, cache, toks, pos, lens,
                                tables, temps, topks, seeds, counts,
                                fused_verify=self.fused_verify)
        self.decode_seconds += time.perf_counter() - t0
        self.verify_steps += 1
        for j, slot in enumerate(slots):
            req = active[slot]
            d = drafts.get(slot, [])
            out = accept_drafts(d, nxt[j, :len(d) + 1])
            before = len(req.generated)
            for tok in out:
                self._emit(req, int(tok))
                if len(req.generated) >= req.steps \
                        or (req.stop_token is not None
                            and int(tok) == req.stop_token):
                    break
            emitted = len(req.generated) - before
            self.decode_tokens += emitted
            self.verify_tokens += emitted
            if d:
                self._adapt_draft_k(req, len(d), len(out) - 1)
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
