"""Per-request incremental token delivery — the port's own copy of
``veles_tpu/serving/streams.py`` (pure Python; its SSE frames are
byte-equal to the reference's).

The scheduler produces tokens one decode boundary at a time (and in
BURSTS when speculative decoding accepts drafts).  A
:class:`TokenStream` is a thread-safe subscription over ONE in-flight
request: ``InferenceScheduler.submit(..., stream=True)`` returns one,
and the decode loop pushes every ACCEPTED token into it at the same
boundary it appends to ``generated`` — iteration yields tokens with
per-token latency, spec-decode bursts arrive back to back, and a
preempt→resume emits nothing twice (only newly drawn tokens are
pushed, and the resumed stream is bit-identical anyway).

Termination rides the request future: its done-callback enqueues a
sentinel AFTER the loop thread pushed the final token (same producer
thread, FIFO queue — no token can trail the sentinel), so iteration
ends exactly at completion, or re-raises the scheduler error
(deadline, cancel, watchdog, close) after yielding everything the
client's budget actually bought.

:func:`sse_event` / :data:`SSE_DONE` are the wire helpers the REST
layer and the OpenAI facade share: one Server-Sent-Events frame per
JSON payload, ``data: [DONE]`` as the terminal frame (the OpenAI
convention, harmless on the native endpoint).

This module deliberately imports nothing from the scheduler — the
scheduler imports *it* (streams are a delivery concern, not a
scheduling one).
"""

import json
import queue

#: queue sentinel marking the end of a stream (the request future is
#: resolved by the time a consumer sees it)
_DONE = object()

#: the terminal SSE frame every streaming endpoint sends (OpenAI
#: convention; clients stop reading at it)
SSE_DONE = b"data: [DONE]\n\n"


def sse_event(payload):
    """One Server-Sent-Events frame: ``data: <json>\\n\\n`` bytes.
    Payloads are compact JSON (no spaces) — SSE frames are a wire
    format, not a display one."""
    return b"data: " + json.dumps(
        payload, separators=(",", ":")).encode() + b"\n\n"


class StreamTimeoutError(Exception):
    """No token arrived within the consumer's per-token timeout (the
    request itself keeps decoding — the consumer chose to stop
    waiting)."""


class TokenStream(object):
    """Iterable subscription over one request's accepted tokens.

    Produced by ``InferenceScheduler.submit(..., stream=True)``.
    Iterating yields generated token ids (ints) as the decode loop
    accepts them and ends when the request completes; a failed
    request re-raises its scheduler error from the iterator after
    every already-accepted token was yielded.  ``tokens`` accumulates
    what iteration delivered so far, ``result(timeout)`` blocks for
    the request's full prompt+generated list (the batch-path reply),
    and ``cancel()`` releases the request's slot and KV blocks at the
    next decode boundary — the mid-stream-disconnect hook.
    """

    def __init__(self, prompt, token_timeout=None):
        self.prompt = [int(t) for t in prompt]
        #: generated tokens yielded so far (iteration order)
        self.tokens = []
        #: per-token consumer patience in seconds (None blocks —
        #: safe: every future resolves via deadline/watchdog/close)
        self.token_timeout = token_timeout
        #: the request's trace id (set at submit) — what the SSE
        #: terminal frame echoes so a streamed reply is correlatable
        #: with the server-side phase timeline
        self.trace = None
        self.future = None
        self._scheduler = None
        self._q = queue.SimpleQueue()

    # -- producer side (scheduler) --------------------------------------

    def _bind(self, scheduler, future):
        """Called once at submit: wire the request future in.  The
        done-callback runs on whichever thread resolves the future —
        for tokens that is the decode loop AFTER its final push, so
        FIFO order guarantees the sentinel trails every token."""
        self._scheduler = scheduler
        self.future = future
        future.add_done_callback(lambda _f: self._q.put(_DONE))

    def _push(self, token):
        """Decode-loop hook: one accepted token (spec bursts call
        this back to back)."""
        self._q.put(int(token))

    # -- consumer side ---------------------------------------------------

    def __iter__(self):
        while True:
            try:
                item = self._q.get(timeout=self.token_timeout)
            except queue.Empty:
                raise StreamTimeoutError(
                    "no token within %.1fs" % self.token_timeout)
            if item is _DONE:
                err = self.future.exception()
                if err is not None:
                    raise err
                return
            self.tokens.append(item)
            yield item

    def result(self, timeout=None):
        """The complete prompt + generated token list — exactly the
        non-streaming submit's future result."""
        return self.future.result(timeout)

    def cancel(self, reason="stream consumer disconnected"):
        """Cancel the underlying request (client went away): queued
        requests fail immediately, in-flight ones free their slot and
        KV blocks at the next decode boundary."""
        return self._scheduler.cancel(self.future, reason=reason)

    @property
    def done(self):
        return self.future is not None and self.future.done()
