"""Continuous-batching inference scheduler — the port of
``veles_tpu/serving/scheduler.py::InferenceScheduler``.

Requests queue on :meth:`InferenceScheduler.submit` (any thread) and
are served by ONE background loop that owns every tensor:

1. **admit** — the class-ordered queue's head (highest priority first,
   FIFO within a class) claims a slot and its block budget
   (``ceil((prompt + steps) / block_size)`` blocks).  With the radix
   prefix cache (``prefix_cache``, on by default as in the reference;
   :mod:`~veles_tpu_torch.serving.prefix_cache`) admission first
   matches the longest resident prefix of the prompt: the matched
   blocks head the slot's table read-only, only the cold blocks are
   claimed, and refcount-0 residents are evicted LRU when the free
   list is short (``prefix_evict``);
2. **prefill** — a cold prompt up to ``prefill_chunk`` tokens
   prefills in one pass; a longer one prefills one
   ``prefill_chunk``-token chunk per loop iteration, interleaved with
   the decode step.  A warm prompt gathers its matched blocks into the
   staging row and chunk-prefills only its cold tail, in block-wide
   chunks.  The staging row is then inserted into the paged cache past
   the shared blocks and the next token is sampled (the TTFT edge);
3. **step** — the active slots advance one token through
   :func:`~veles_tpu_torch.serving.engine.paged_decode_step`, packed
   into a power-of-two occupancy bucket with a power-of-two block
   bucket over the deepest request.  With ``spec`` on (the default, as
   in the reference) each slot first drafts up to its ``draft_k``
   tokens by n-gram prompt lookup (:mod:`~veles_tpu_torch.serving.
   spec`), or, with ``drafter="model"`` and a trained ``draft_head``
   (:mod:`~veles_tpu_torch.serving.draft`), from the Medusa heads over
   the hidden state the last pass returned for it (the engine's
   ``want_hidden`` lane; a slot with no hidden yet, or whose model
   drafts accept worse than its n-gram ones, drafts by n-gram).  When
   any slot drafted, the step is ONE batched verify pass
   (:func:`~veles_tpu_torch.serving.engine.verify_step_paged`) — slots
   without drafts ride it as width-1 rows — at the width ``spec_k + 1``,
   or with a draft head attached at one more than the power-of-two
   bucket of the widest drafting slot's ``draft_k`` (the verify width
   ladder).  Each slot keeps its longest matched prefix plus the
   correction token, so one pass emits up to ``spec_k + 1`` tokens and
   the stream stays the spec-off stream;
4. **retire** — a request that produced its stop token or its last
   step completes its future with prompt + generated tokens, donates
   the full blocks of its written positions to the prefix cache, and
   frees its slot and the rest of its blocks.

The request lifecycle: every request carries a deadline (``timeout``,
else ``request_timeout``, else ``queue_timeout``) enforced at each loop
boundary — an expired request frees its slot and blocks and fails with
:class:`DeadlineExceededError` carrying the tokens generated so far.
:meth:`cancel` fails a queued request at once and reaps an in-flight
one at the next boundary.  :meth:`request_preempt` (and a high-class
head that cannot admit) evicts an active lower-class request: its
blocks return to the pool, it keeps its generated prefix, requeues at
the front of its class and resumes by re-prefilling prompt + prefix;
its next token is draw ``len(generated)`` of its stream, so the stream
never forks.  Block-pressure shedding (``shed_block_factor``, tripping
earlier for lower classes) and the queue-depth cap raise
:class:`QueueFullError` with a class-aware ``retry_after``;
:meth:`drain` closes admission and finishes what is in flight; a
watchdog thread fails every pending future when one loop iteration
stalls past ``watchdog`` seconds (it never touches a tensor or the
cache: the loop reaps the failed requests' blocks when it runs on).
Injection points ``serving.scheduler.{loop,prefill,step}``
(:mod:`veles_tpu_torch.faults`) exercise each path.

Greedy streams are exact: each request attends only over its own
blocks (its shared prefix blocks hold the K/V its own prefill would
have written) and sampling is row-wise, so a stream is independent of
its slot, the packing order, its co-tenants and whether it was
admitted warm.

Observability, as in the reference: every request carries a trace id
(``submit(trace=)``, sanitized, or minted) and, with ``reqtrace`` on,
records ``req.queue``/``req.admit``/``req.prefill``/
``req.prefill_chunk``/``req.first_token``/``req.retire`` events at its
phase boundaries and ONE batched ``req.step`` event per decode or
verify boundary (:mod:`veles_tpu_torch.telemetry.reqtrace`).  The
counters and latency windows live in a
:class:`~veles_tpu_torch.serving.metrics.ServingMetrics`
(``self.stats``), mirrored into the process-wide registry;
:meth:`InferenceScheduler.metrics` is their snapshot with the queue,
KV and prefix-cache state, and :meth:`debug_requests` the live
in-flight table.

Delivery and the aux lane, as in the reference: ``submit(...,
stream=True)`` returns a :class:`~veles_tpu_torch.serving.streams.
TokenStream` that :meth:`_emit` pushes every accepted token into in the
boundary that appends it (spec bursts back to back, a resumed request
only its newly drawn tokens); :meth:`submit_embed` and
:meth:`submit_score` queue batched embedding and class-scoring jobs
(:mod:`~veles_tpu_torch.serving.openai_api`), of which the loop runs
ONE per boundary (injection point ``serving.scheduler.aux``); they
count as in flight, so :meth:`drain` waits for them.

``kv="dense"`` swaps the block-paged cache for the reference's legacy
slot-major :class:`~veles_tpu_torch.serving.kv_slots.SlotKVCache`: each
step is one full-batch :func:`~veles_tpu_torch.serving.engine.
slot_decode_step` over every slot, and int8 pools, speculative
decoding, the prefix cache and the block budget and shed switch off
where the reference switches them off.

The KV tiers, as in the reference: with ``kv_host_bytes`` a prefix-cache
eviction first copies the block off the card into the host-RAM tier
(:mod:`~veles_tpu_torch.serving.kv_host`), and an admission whose
prompt runs past its device-resident prefix promotes the host blocks
back (``_promote_host``) before it matches.  Disaggregation (``role``):
a ``"prefill"`` scheduler takes only :meth:`submit_prefill`, prefills,
copies the finished blocks and the last-position logits into a record
parked under a handle (:meth:`kv_export`, one-shot, bounded by
``kv_export_bytes`` and a TTL); a ``"decode"`` scheduler adopts such a
record through :meth:`submit_imported` — its blocks scatter into the
slot's table, the first token samples from the exported logits — and
the stream is the colocated one.  :meth:`submit_prefix_export` and
:meth:`submit_prefix_import` move resident prefixes between replicas
(one job per loop boundary, ``_prefix_tick``).  The wire forms are
:mod:`~veles_tpu_torch.serving.disagg`'s.

Each request carries its tenant (``submit(tenant=)``, the bounded label
the router forwards as ``X-Veles-Tenant``) into its trace events and
:meth:`debug_requests`; with ``root.common.tsdb.metering`` on, every
decode and verify boundary charges each active request's tenant its KV
blocks held × the step's wall time and an even share of the step as
compute seconds, and retire attributes its prompt and generated tokens
(``metrics()["tenants"]``, the ``veles_tenant_usage_*`` series).
Metering is host work on the loop: no launch and no device sync.
"""

import collections
import concurrent.futures
import itertools
import logging
import os
import threading
import time

import numpy
import torch

from veles_tpu_torch import faults
from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.serving.disagg import mint_handle, record_nbytes
from veles_tpu_torch.serving.draft import draft_supported
from veles_tpu_torch.serving.engine import (
    first_tokens, paged_decode_step, slot_decode_step, verify_step_paged,
    verify_supported)
from veles_tpu_torch.serving.kv_host import HostKVTier
from veles_tpu_torch.serving.kv_slots import (
    PagedKVCache, SlotKVCache, paged_supported)
from veles_tpu_torch.serving.metrics import ServingMetrics
from veles_tpu_torch.serving.openai_api import (
    embed_supported, pooled_embeddings, score_rows)
from veles_tpu_torch.serving.prefill import (
    chunked_supported, prefill, prefill_chunk, serving_supported,
    serving_window)
from veles_tpu_torch.serving.prefix_cache import RadixPrefixCache
from veles_tpu_torch.serving.spec import (
    NgramIndex, NgramProposer, accept_drafts)
from veles_tpu_torch.serving.streams import TokenStream
from veles_tpu_torch.telemetry import reqtrace as tracing

log = logging.getLogger(__name__)

#: narrowest staging row a prompt prefills into by default (the JAX
#: scheduler's default ``prefill_bucket``, so both pad prompts alike)
PREFILL_BUCKET = 8

#: priority classes, lowest to highest; ints in [0, 2] also accepted
PRIORITIES = {"low": 0, "normal": 1, "high": 2}
CLASS_NAMES = ("low", "normal", "high")
#: block-pressure shed trips at shed_block_factor x this fraction: the
#: low class sheds at half the budget, normal at it, high at 1.5x
_SHED_FRAC = (0.5, 1.0, 1.5)
#: Retry-After seconds of a shed request, by class
_RETRY_AFTER = (4, 2, 1)
#: process-unique replica names of schedulers given no ``replica_id``
_SCHED_SEQ = itertools.count(1)
#: most prefix digests ``metrics()`` advertises
_DIGEST_MAX = 512
#: how long an unclaimed KV export survives (seconds), and the parked
#: exports' default byte budget (``kv_export_bytes``)
EXPORT_TTL = 120.0
EXPORT_BYTES = 256 << 20


def resolve_priority(value):
    """Normalize a client priority (class name or int) to [0, 2];
    ``None`` means normal.  Raises ``ValueError`` on anything else."""
    if value is None:
        return PRIORITIES["normal"]
    if isinstance(value, str):
        try:
            return PRIORITIES[value.lower()]
        except KeyError:
            raise ValueError(
                "priority must be one of %s (or an int in [0, 2])"
                % "/".join(CLASS_NAMES))
    if isinstance(value, bool) or not isinstance(value, int):
        raise ValueError("priority must be a class name or int")
    if not 0 <= value <= 2:
        raise ValueError("priority int must be in [0, 2]")
    return value


class SchedulerError(Exception):
    """Base serving failure."""
    http_status = 500


class QueueFullError(SchedulerError):
    """Admission control: the queue-depth cap was hit or block pressure
    shed the request (``retry_after`` seconds to wait)."""
    http_status = 503
    retry_after = 1


class DrainingError(QueueFullError):
    """Admission closed for a graceful drain."""
    retry_after = 5


class DeadlineExceededError(SchedulerError):
    """The request crossed its deadline, still queued
    (``tokens_generated == 0``) or mid-decode."""
    http_status = 408

    def __init__(self, message, tokens_generated=0):
        super(DeadlineExceededError, self).__init__(message)
        self.tokens_generated = int(tokens_generated)


class RequestCancelledError(SchedulerError):
    """The request was cancelled; its slot and blocks were released at
    the next boundary."""


class RoleMismatchError(SchedulerError):
    """The request does not match this replica's disaggregation role (a
    decode submit on a prefill replica or the reverse)."""
    http_status = 409


def _metering_enabled():
    """``root.common.tsdb.metering`` — gates the per-tenant usage
    attribution (token counts at retire, KV-block-seconds and
    compute-seconds at step boundaries)."""
    from veles_tpu_torch.config import root
    return bool(root.common.tsdb.get("metering", True))


def _serving_conf(name, default):
    """``root.common.serving.<name>`` of the port's config tree, or
    ``default`` where the tree lacks the key: the value an argument
    left None takes."""
    from veles_tpu_torch.config import root
    return root.common.serving.get(name, default)


def _bucket(n, floor, cap):
    """Pad widths/counts to power-of-two buckets (the occupancy and
    depth ladders of the decode step)."""
    b = max(int(floor), 1)
    while b < n:
        b *= 2
    return min(b, cap)


class _Request(object):
    __slots__ = ("prompt", "steps", "temperature", "top_k", "stop_token",
                 "seed", "deadline", "priority", "future", "slot",
                 "generated", "cancelled", "preempts", "t_submit",
                 "t_admit", "t_first", "pf_seq", "pf_caches", "pf_off",
                 "pf_width", "pf_chunk", "pf_matched", "prefix_handle",
                 "export_only", "kv_import", "hid", "draft_k",
                 "accept_ema", "gram_ix", "sink", "trace", "tenant")

    def __init__(self, prompt, steps, temperature, top_k, stop_token,
                 seed, deadline, priority, sink=None, trace=None,
                 tenant=None):
        self.prompt = prompt
        self.steps = steps
        self.temperature = temperature
        self.top_k = top_k
        self.stop_token = stop_token
        self.seed = seed
        self.deadline = deadline
        self.priority = int(priority)   # 0 low / 1 normal / 2 high
        self.sink = sink                # TokenStream._push (or None)
        self.trace = trace              # request trace id
        self.tenant = tenant            # bounded tenant label (or None)
        self.future = concurrent.futures.Future()
        self.slot = None
        self.generated = []
        self.cancelled = False      # client gone: reap at next boundary
        self.preempts = 0           # times evicted (resume re-prefills)
        self.t_submit = time.monotonic()
        self.t_admit = None
        self.t_first = None
        self.pf_seq = None          # the sequence being prefilled: the
        #                             prompt, plus the generated prefix
        #                             on resume
        self.pf_caches = None       # chunked-prefill staging caches
        self.pf_off = 0
        self.pf_width = 0
        self.pf_chunk = 0
        self.pf_matched = 0         # warm prefix blocks heading the slot
        self.prefix_handle = None   # pinned radix-cache match
        self.export_only = False    # prefill role: stop after the export
        self.kv_import = None       # decode role: the adopted record
        # speculative drafting: the hidden state (on the device) of the
        # position behind the pending token, set by each model pass and
        # None until the first one after an admission (the model drafter
        # drafts by n-gram there); the accept-rate-adaptive draft length
        # (set at the first draft), the accept-rate EMA by drafter and
        # the memoized trailing-n-gram index
        self.hid = None
        self.draft_k = 0
        self.accept_ema = {}
        self.gram_ix = None

    def fail(self, error):
        """Set the future's exception unless a racing path (watchdog,
        cancel) beat us to it."""
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
    (:class:`QueueFullError` above it); ``queue_timeout`` — the
    deadline in seconds of a request given no ``timeout`` while
    ``request_timeout`` is 0; ``prefill_bucket`` — the narrowest
    staging row a prompt prefills into (prompts pad to a power of two
    at least this wide); ``warm_buckets`` — accepted for the
    reference's signature, where it pre-compiles the step's buckets:
    the eager step has nothing to compile, so it only records the
    value; ``kv`` — the KV layout, "paged" (the
    reference's default) or "dense" (:class:`~veles_tpu_torch.serving.
    kv_slots.SlotKVCache`: a window row per slot, no int8 pools,
    speculative decoding, prefix cache or block budget — each falls back
    off as in the reference); ``block_size`` /
    ``kv_blocks`` / ``kv_dtype`` ("fp32" or "int8") — the paged cache;
    ``prefill_chunk`` — chunk width of chunked prefill (0 = always
    one-shot); ``spec`` / ``spec_k`` — speculative decoding with up to
    ``spec_k`` drafts per slot and step; ``drafter`` ("ngram", the
    default, or "model") / ``draft_head`` — the draft source, a trained
    :class:`~veles_tpu_torch.serving.draft.MedusaDraftHead` for "model"
    (without one, or on a chain with no hidden-state lane, n-gram);
    ``fused_verify`` —
    score fp32 pools' verify runs single-pass; ``draft_k_min`` /
    ``draft_ema`` — the floor of a slot's adaptive draft length and the
    weight of its accept-rate EMA; ``request_timeout`` — the default
    whole-request deadline in seconds; ``watchdog`` — the stalled-loop
    threshold in seconds; ``shed_block_factor`` — shed new submits once
    the queue's committed blocks exceed this many pools (by class);
    ``prefix_cache`` / ``prefix_evict`` — the radix prefix cache and
    its LRU eviction under pool pressure (each 0 or False disables;
    the reference's defaults throughout); ``kv_host_bytes`` — the
    host-RAM tier's byte budget (0, the default, disables; needs the
    prefix cache); ``role`` — "both" (the default), "prefill" or
    "decode" (disaggregation); ``kv_export_bytes`` — the parked
    exports' byte budget (default 256 MiB); ``reqtrace`` — record each
    request's phase events (``req.*``) in the event sink (trace ids are
    minted either way); ``replica_id`` — the label of this scheduler's
    per-replica gauges.  ``device`` must be the
    chain's device (default ``cuda``).  Every knob the reference reads
    from the config tree (``kv`` … ``tp``, ``draft_shrink`` and
    ``draft_grow`` included) falls back to the port's
    ``root.common.serving`` when left None, with the reference's
    default where the tree lacks the key; an explicit value wins
    (``tp=0`` is off).  The parameters after
    ``max_queue`` are keyword-only, so no positional call binds the
    reference's order (``queue_timeout`` is its fifth) to other
    knobs."""

    #: the defaults of ``draft_shrink`` / ``draft_grow``: a slot's draft
    #: length halves below the first accept-rate EMA and doubles above
    #: the second (the reference's thresholds)
    DRAFT_SHRINK, DRAFT_GROW = 0.5, 0.8

    def __init__(self, forwards, max_slots=4, window=None, max_queue=32,
                 *, queue_timeout=30.0, prefill_bucket=PREFILL_BUCKET,
                 warm_buckets=None, kv=None, block_size=None,
                 kv_blocks=None, kv_dtype=None, prefill_chunk=None,
                 spec=None, spec_k=None, fused_verify=False, drafter=None,
                 draft_head=None, draft_k_min=None, draft_ema=None,
                 request_timeout=None, watchdog=None,
                 shed_block_factor=None, prefix_cache=None,
                 prefix_evict=None, role=None, kv_host_bytes=None,
                 kv_export_bytes=None, reqtrace=True, replica_id=None,
                 tp=None, device=None):
        self.device = resolve_device(device)
        if any(u.device != self.device for u in forwards):
            raise ValueError("the chain lies on %s, the scheduler was "
                             "given %s" % (forwards[0].device, self.device))
        if not serving_supported(forwards):
            raise ValueError(
                "chain cannot serve through the scheduler (needs causal "
                "cacheable blocks with apply_prefill/apply_step_slots)")
        window = window or serving_window(forwards)
        if not window or int(window) < 2:
            raise ValueError("no usable decode window: pass window=")
        self.forwards = forwards
        self.max_slots = int(max_slots)
        self.window = int(window)
        self.max_queue = int(max_queue)
        self.queue_timeout = float(queue_timeout or 0)
        self.prefill_bucket = int(prefill_bucket)
        self.warm_buckets = bool(_serving_conf("warm_buckets", True)
                                 if warm_buckets is None else warm_buckets)
        kv = kv or _serving_conf("kv", "paged")
        if kv not in ("paged", "dense"):
            raise ValueError("kv must be 'paged' or 'dense'")
        if kv == "paged" and not paged_supported(forwards):
            log.info("chain has no paged decode step; falling back to the "
                     "dense slot cache")
            kv = "dense"
        self.kv = kv
        self.block_size = int(block_size or _serving_conf("block_size", 16))
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.blocks_per_slot = -(-self.window // self.block_size)
        if kv_blocks is None:
            kv_blocks = _serving_conf("kv_blocks", None)
        self.kv_blocks = int(kv_blocks
                             or self.max_slots * self.blocks_per_slot) \
            if self.kv == "paged" else 0
        kv_dtype = kv_dtype or _serving_conf("kv_dtype", "fp32")
        if kv_dtype not in ("fp32", "int8"):
            raise ValueError("kv_dtype must be 'fp32' or 'int8'")
        if kv_dtype == "int8" and self.kv != "paged":
            log.info("kv_dtype='int8' needs the paged cache; falling back "
                     "to fp32")
            kv_dtype = "fp32"
        self.kv_dtype = kv_dtype
        chunk = prefill_chunk if prefill_chunk is not None \
            else _serving_conf("prefill_chunk", 64)
        chunk = int(chunk or 0)
        if chunk and not chunked_supported(forwards):
            log.info("chain cannot prefill in chunks; long prompts will "
                     "prefill one-shot")
            chunk = 0
        #: chunk widths are powers of two
        self.prefill_chunk = _bucket(chunk, 1, 1 << 30) if chunk else 0
        # the reference's fallbacks where the tree lacks a key: spec
        # and prefix_cache read False there, while the tree holds True
        spec = bool(_serving_conf("spec", False) if spec is None else spec)
        self.spec_k = int(_serving_conf("spec_k", 4)
                          if spec_k is None else spec_k)
        if spec and self.spec_k < 1:
            raise ValueError("spec_k must be >= 1")
        if spec and (self.kv != "paged" or not verify_supported(forwards)):
            log.info("chain/kv mode cannot run the paged verify step; "
                     "speculative decoding disabled")
            spec = False
        self.fused_verify = bool(fused_verify)
        self.spec = spec
        self._proposer = NgramProposer(k=self.spec_k) if spec else None
        # the draft source, arbitrated per slot at run time (the model
        # head needs a hidden state; per-drafter accept-rate EMAs pick
        # whichever source earns its drafts)
        drafter_ = str(_serving_conf("drafter", "ngram")
                       if drafter is None else drafter)
        if drafter_ not in ("ngram", "model"):
            raise ValueError("drafter must be 'ngram' or 'model'")
        if drafter_ == "model" and spec:
            if draft_head is None:
                log.info("drafter='model' needs a trained draft_head; "
                         "falling back to n-gram")
                drafter_ = "ngram"
            elif not draft_supported(forwards):
                log.info("chain has no hidden-state lane for the model "
                         "drafter; falling back to n-gram")
                drafter_ = "ngram"
        self.drafter = drafter_ if spec else "ngram"
        self._draft_head = draft_head \
            if spec and self.drafter == "model" else None
        if self._draft_head is not None:
            d, v = forwards[-1].params["weights"].shape
            if (self._draft_head.d_model, self._draft_head.vocab) != (d, v):
                raise ValueError(
                    "draft_head sized (d=%d, vocab=%d) but the chain serves "
                    "(d=%d, vocab=%d)" % (self._draft_head.d_model,
                                          self._draft_head.vocab, d, v))
        self.draft_k_min = int(_serving_conf("draft_k_min", 1)
                               if draft_k_min is None else draft_k_min)
        self.draft_k_min = max(1, min(self.draft_k_min, self.spec_k))
        self.draft_ema = float(_serving_conf("draft_ema", 0.5)
                               if draft_ema is None else draft_ema)
        if not 0.0 < self.draft_ema <= 1.0:
            raise ValueError("draft_ema must be in (0, 1]")
        #: a slot's draft length halves below this accept-rate EMA and
        #: doubles above ``draft_grow``
        self.draft_shrink = float(_serving_conf("draft_shrink",
                                                self.DRAFT_SHRINK))
        self.draft_grow = float(_serving_conf("draft_grow",
                                              self.DRAFT_GROW))
        self.request_timeout = float(
            _serving_conf("request_timeout", 120.0)
            if request_timeout is None else request_timeout or 0)
        self.watchdog = float(_serving_conf("watchdog", 300.0)
                              if watchdog is None else watchdog or 0)
        self.shed_block_factor = float(
            _serving_conf("shed_block_factor", 4.0)
            if shed_block_factor is None else shed_block_factor or 0)
        #: the warm cold-tail prefill needs chunked prefill, and the
        #: staging and chunk tilings a power-of-two block size
        pfx = bool(_serving_conf("prefix_cache", False)
                   if prefix_cache is None else prefix_cache)
        if pfx and (self.kv != "paged" or not self.prefill_chunk
                    or self.block_size & (self.block_size - 1)):
            log.info("prefix cache needs kv='paged', chunked prefill and a "
                     "power-of-two block size; disabled")
            pfx = False
        self.prefix_cache = pfx
        self.prefix_evict = bool(_serving_conf("prefix_evict", True)
                                 if prefix_evict is None else prefix_evict)
        #: the host-RAM tier's byte budget (0: off); it is keyed by the
        #: prefix cache's token paths
        hb = int(_serving_conf("kv_host_bytes", 0)
                 if kv_host_bytes is None else kv_host_bytes or 0)
        if hb and not pfx:
            log.info("kv_host_bytes needs the prefix cache; host tier "
                     "disabled")
            hb = 0
        self.kv_host_bytes = hb
        #: the parked exports' byte budget: the oldest unclaimed record
        #: pays when a new one would overflow it (counted as expired)
        self.kv_export_bytes = int(
            _serving_conf("kv_export_bytes", EXPORT_BYTES)
            if kv_export_bytes is None else kv_export_bytes
            or EXPORT_BYTES)
        #: tensor-parallel positions (0 = off): Megatron weight splits
        #: and head-wise paged pools over a {"tp": N} mesh
        #: (serving/tp.py).  Needs the paged cache, N positions and a
        #: chain whose blocks declare tp layouts; otherwise the chain
        #: serves unsharded and ``tp`` reads 0, as in the reference.
        tp = int(_serving_conf("tp", 0) if tp is None else tp or 0)
        if tp == 1:
            tp = 0
        self.tp_ = None
        if tp:
            from veles_tpu_torch.parallel.mesh import default_positions
            from veles_tpu_torch.serving.tp import ServingTP, tp_supported
            positions = default_positions(self.device)
            if self.kv != "paged":
                log.info("tp needs the paged cache; serving unsharded")
                tp = 0
            elif len(positions) < tp:
                log.info("tp=%d needs %d positions, found %d; serving "
                         "unsharded", tp, tp, len(positions))
                tp = 0
            elif not tp_supported(forwards, tp):
                log.info("chain does not divide over tp=%d (heads/d_model/"
                         "hidden divisibility, or a MoE/int8_decode "
                         "block); serving unsharded", tp)
                tp = 0
            else:
                self.tp_ = ServingTP(tp, positions)
        self.tp = tp
        role = str(role or _serving_conf("role", "both")).lower()
        if role not in ("both", "prefill", "decode"):
            raise ValueError("role must be 'prefill', 'decode' or 'both'")
        if role == "prefill" and self.kv != "paged":
            raise ValueError("role='prefill' needs the paged cache (block "
                             "export is block-granular)")
        self.role = role
        #: model passes so far: plain decode steps and verify steps (one
        #: of them per loop iteration with active slots) — what kernel
        #: launch counts are read against — and the tokens both kinds
        #: emitted and the host seconds they took (each ends in the
        #: sampled tokens' copy to the host)
        self.decode_steps = 0
        self.verify_steps = 0
        self.decode_tokens = 0
        self.decode_seconds = 0.0
        #: the tokens the verify steps emitted (part of decode_tokens)
        self.verify_tokens = 0
        #: verify passes by width K1 (the ladder's rungs with a draft
        #: head; ``spec_k + 1`` alone without one)
        self.verify_widths = {}
        #: (time to first token, request latency) in seconds, one pair
        #: per completed request, from submit
        self.completed = []
        #: the label of this scheduler's per-replica series
        self.replica_id = str(replica_id) if replica_id \
            else "sched%d" % next(_SCHED_SEQ)
        #: counters and latency windows behind ``metrics()``, mirrored
        #: into the process-wide registry
        self.stats = ServingMetrics(replica=self.replica_id)
        #: request tracing: phase events on (trace ids minted either way)
        self._tron = bool(reqtrace)
        #: per-tenant metering gate (root.common.tsdb.metering), read
        #: once: the step boundary is the hot path
        self._metering = _metering_enabled()
        self.error = None            # what killed the loop, if anything
        self._queue = collections.deque()
        self._active = {}            # slot -> _Request (decoding)
        self._prefilling = []        # admitted, mid-chunked-prefill
        self._admitting = []         # popped this iteration, in prefill
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self._draining = False
        self._drained = threading.Event()
        self._stop = threading.Event()   # wakes the watchdog at close()
        self._preempts_owed = []     # eviction demands: class bound per
        #                              entry (None = any victim)
        self._aux = collections.deque()  # embed/score jobs (loop-run)
        self._prefix_jobs = collections.deque()  # prefix export/import
        #                              jobs (loop-run, one per boundary)
        self._exports = {}           # handle -> export record (lock)
        self._exports_bytes = 0      # parked payload bytes (lock)
        self._exports_claimed = {}   # handle -> fetch time (lock): tells
        #                              a second fetch from a junk handle
        self._queued_blocks = 0      # block budget committed in-queue
        self._beat = None            # loop-iteration heartbeat stamp
        self._working = False        # loop mid-iteration (not parked)
        self._tripped_beat = None    # last beat the watchdog fired on
        self._thread = None
        self._watchdog_thread = None
        self._ready = threading.Event()
        self.cache_ = None           # built by the loop thread
        self.prefix_ = None          # radix cache (loop thread too)
        #: the host tier (only the loop thread changes its contents)
        self.host_ = HostKVTier(self.kv_host_bytes, self.block_size) \
            if self.kv_host_bytes > 0 else None

    # the lifecycle and spec counters, read from ``stats`` under the
    # reference's ``metrics()`` names: drafts proposed and kept; tokens
    # the chunked-prefill ticks ran; requests that expired (queued or
    # in flight), were cancelled, shed by block pressure or a higher
    # class, or rejected (sheds, a full queue, a drain); preemptions,
    # resumed re-prefills and watchdog trips

    spec_drafted_tokens = property(lambda self:
                                   self.stats.spec_drafted_tokens)
    spec_accepted_tokens = property(lambda self:
                                    self.stats.spec_accepted_tokens)
    prefill_chunk_tokens = property(lambda self:
                                    self.stats.prefill_chunk_tokens)
    requests_expired = property(lambda self: self.stats.expired)
    requests_cancelled = property(lambda self: self.stats.cancelled)
    requests_shed = property(lambda self: self.stats.shed)
    requests_rejected = property(lambda self: self.stats.rejected)
    preempts = property(lambda self: self.stats.preempts)
    preempt_resumes = property(lambda self: self.stats.preempt_resumes)
    watchdog_trips = property(lambda self: self.stats.watchdog_trips)

    @property
    def spec_accept_rate(self):
        """Accepted over drafted tokens, None before the first draft."""
        if not self.spec_drafted_tokens:
            return None
        return self.spec_accepted_tokens / self.spec_drafted_tokens

    def _prefix_stat(self, name):
        return getattr(self.prefix_, name) if self.prefix_ is not None \
            else 0

    @property
    def prefix_cache_hits(self):
        """Admissions that matched >= 1 resident block."""
        return self._prefix_stat("hits")

    @property
    def prefix_cache_misses(self):
        return self._prefix_stat("misses")

    @property
    def prefix_cache_evictions(self):
        """Resident blocks evicted, cumulative."""
        return self._prefix_stat("evictions")

    @property
    def prefix_cache_blocks_resident(self):
        return self._prefix_stat("resident")

    @property
    def active_slots(self):
        """Requests in the decode set."""
        with self._lock:
            return len(self._active)

    @property
    def kv_blocks_free(self):
        cache = self.cache_ if self.kv == "paged" else None
        return cache.free_blocks if cache is not None else self.kv_blocks

    # -- client side -----------------------------------------------------------

    def start(self):
        """Start the loop thread, wait until its cache is built, then
        start the watchdog (``watchdog`` > 0)."""
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
        with self._lock:
            if self.watchdog > 0 and self._watchdog_thread is None:
                self._watchdog_thread = threading.Thread(
                    target=self._watchdog_loop, daemon=True,
                    name="serving-watchdog")
                self._watchdog_thread.start()
        # the in-flight registry (held weakly: close() needs no
        # deregistration)
        tracing.register("scheduler", self)
        return self

    def submit(self, prompt, steps, temperature=0.0, top_k=0, seed=None,
               stop_token=None, timeout=None, priority=None, stream=False,
               *, trace=None, resume_tokens=None, tenant=None):
        """Queue one sequence; returns a Future whose result is the
        prompt followed by the generated tokens (ending at the first
        generated stop token, if one fired).  ``stream=True`` returns a
        :class:`~veles_tpu_torch.serving.streams.TokenStream` instead
        (its ``.future`` is that Future) that yields each token as the
        loop accepts it; ``stream`` is the ninth positional parameter,
        as in the reference.

        ``timeout`` overrides the whole-request deadline (default
        ``request_timeout``; it covers queueing and decoding).
        ``priority`` ("low"/"normal"/"high" or 0-2, default normal) sets
        the request's class: admission order, shed threshold and
        Retry-After, and preemption victimhood.  ``trace`` attaches a
        request trace id (sanitized; None mints one): every phase event
        of the request carries it.  ``tenant`` names the request's
        tenant (the bounded label; None is "anon" in the usage rollup).
        ``resume_tokens``
        adopts an already-generated prefix: the request admits with it
        as its generated tokens, re-prefills prompt + prefix and draws
        its next token at counter ``len(resume_tokens)``, so the stream
        continues an uninterrupted run's (a stream yields only the
        newly drawn tokens); ``steps`` stays the total budget, the
        prefix included.

        Raises ``ValueError`` on a malformed request,
        :class:`QueueFullError` when admission control rejects it (a
        full queue, block-pressure shed, :class:`DrainingError` once a
        drain began), :class:`RoleMismatchError` on a prefill replica
        and :class:`SchedulerError` once closed."""
        if self.role == "prefill":
            raise RoleMismatchError(
                "prefill-role replica serves POST /serving/prefill only — "
                "decode requests belong on the decode pool")
        prio = resolve_priority(priority)
        prompt = [int(t) for t in prompt]
        steps = int(steps)
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if steps < 1:
            raise ValueError("steps must be >= 1")
        resume = [int(t) for t in resume_tokens] if resume_tokens else []
        if len(resume) >= steps:
            raise ValueError(
                "resume_tokens already cover the %d-step budget (%d "
                "resumed) — nothing left to generate"
                % (steps, len(resume)))
        if len(prompt) + steps > self.window:
            raise ValueError("prompt_len + steps = %d exceeds the serving "
                             "window (%d)" % (len(prompt) + steps,
                                              self.window))
        if self.kv == "paged":
            need = -(-(len(prompt) + steps) // self.block_size)
            if need > self.kv_blocks:
                raise ValueError("request needs %d KV blocks > pool "
                                 "capacity %d (kv_blocks)"
                                 % (need, self.kv_blocks))
        temperature = float(temperature or 0.0)
        top_k = int(top_k or 0)
        if top_k and not temperature:
            raise ValueError("top_k only applies to sampling — set "
                             "temperature > 0")
        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
        ttl = float(timeout or self.request_timeout
                    or self.queue_timeout or 0)
        trace = tracing.ensure_trace_id(trace)
        ts = TokenStream(prompt) if stream else None
        if ts is not None:
            ts.trace = trace
        req = _Request(prompt, steps, temperature, top_k,
                       int(stop_token) if stop_token is not None else None,
                       int(seed) & 0xFFFFFFFF,
                       time.monotonic() + ttl if ttl > 0 else None, prio,
                       sink=ts._push if ts is not None else None,
                       trace=trace,
                       tenant=str(tenant) if tenant is not None else None)
        # a resumed prefix is the request's, not the stream's: the sink
        # sees only the tokens drawn here
        req.generated = resume
        self._admission_enqueue(req)
        if ts is not None:
            ts._bind(self, req.future)
            return ts
        return req.future

    def _admission_enqueue(self, req):
        """Admission control and enqueue under the wake lock: closed,
        draining, the depth cap (a higher class may shed a queued lower
        one), then the class-fractioned block-pressure shed."""
        prio = req.priority
        need = self._blocks_for(req)
        cls = CLASS_NAMES[prio]
        with self._wake:
            if self._closed:
                raise SchedulerError("scheduler is closed")
            if self._draining:
                self.stats.record_reject(len(self._queue))
                raise DrainingError("scheduler is draining")
            if len(self._queue) >= self.max_queue \
                    and not self._evict_queued_locked(prio):
                self.stats.record_reject(len(self._queue))
                err = QueueFullError("serving queue full (%d waiting)"
                                     % len(self._queue))
                err.retry_after = _RETRY_AFTER[prio]
                raise err
            if self.kv == "paged" and self.shed_block_factor > 0 \
                    and self._queued_blocks + need \
                    > self.shed_block_factor * _SHED_FRAC[prio] \
                    * self.kv_blocks:
                self.stats.record_shed(self._queued_blocks, cls=cls,
                                       trace=req.trace)
                err = QueueFullError(
                    "overloaded: %d KV blocks committed in-queue (pool "
                    "%d, %s-class shed at factor %.1f)"
                    % (self._queued_blocks, self.kv_blocks, cls,
                       self.shed_block_factor * _SHED_FRAC[prio]))
                err.retry_after = _RETRY_AFTER[prio]
                raise err
            self.stats.record_submit(cls=cls)
            self._enqueue_locked(req)
            self._queued_blocks += need
            self._wake.notify()

    def submit_prefill(self, prompt, seed=None, timeout=None,
                       priority=None, trace=None):
        """Queue one prompt for prefill only (roles "prefill"/"both"): it
        admits and prefills as any request does, then its finished
        blocks (raw, scales included under int8) and its last-position
        logits are parked under a handle for :meth:`kv_export`.  The
        future resolves to ``{"handle", "prompt_tokens", "blocks"}``.
        Sampling is the decode replica's: it draws from the exported
        logits with its own settings."""
        if self.role == "decode":
            raise RoleMismatchError(
                "decode-role replica imports KV (POST /serving/kv_import) "
                "— prefill belongs on the prefill pool")
        if self.kv != "paged":
            raise ValueError("prefill export needs the paged cache")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if len(prompt) > self.window:
            raise ValueError("prompt of %d tokens exceeds the serving "
                             "window (%d)" % (len(prompt), self.window))
        prio = resolve_priority(priority)
        ttl = float(timeout or self.request_timeout
                    or self.queue_timeout or 0)
        trace = tracing.ensure_trace_id(trace)
        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
        req = _Request(prompt, 1, 0.0, 0, None, int(seed) & 0xFFFFFFFF,
                       time.monotonic() + ttl if ttl > 0 else None, prio,
                       trace=trace)
        req.export_only = True
        self._admission_enqueue(req)
        return req.future

    def kv_export(self, handle):
        """Claim one parked export record (the fetch consumes it), or None
        when the handle is unknown, expired or fetched already
        (:meth:`kv_export_status` tells them apart).  The record holds
        host numpy arrays; :mod:`~veles_tpu_torch.serving.disagg` puts it
        on the wire."""
        now = time.monotonic()
        with self._lock:
            self._sweep_exports_locked(now)
            rec = self._exports.pop(str(handle), None)
            if rec is not None:
                self._exports_bytes -= rec.get("bytes", 0)
                self._exports_claimed[str(handle)] = now
                self.stats.record_kv_export_fetched()
                self.stats.set_kv_exports_pending(len(self._exports))
            return rec

    def kv_export_status(self, handle):
        """``"pending"`` (parked), ``"fetched"`` (claimed already: a second
        fetch is a race, not a missing record) or ``"unknown"``."""
        with self._lock:
            if str(handle) in self._exports:
                return "pending"
            if str(handle) in self._exports_claimed:
                return "fetched"
            return "unknown"

    def _sweep_exports_locked(self, now=None):
        """Drop parked exports past :data:`EXPORT_TTL` and forget claimed
        handles after twice that (caller holds the lock); returns how
        many records expired."""
        now = time.monotonic() if now is None else now
        stale = [h for h, r in self._exports.items()
                 if now - r["t"] > EXPORT_TTL]
        for h in stale:
            self._exports_bytes -= self._exports[h].get("bytes", 0)
            del self._exports[h]
        if stale:
            self.stats.record_kv_export_expired(len(stale))
            self.stats.set_kv_exports_pending(len(self._exports))
        dead = [h for h, t in self._exports_claimed.items()
                if now - t > 2 * EXPORT_TTL]
        for h in dead:
            del self._exports_claimed[h]
        return len(stale)

    def submit_imported(self, export, steps, temperature=0.0, top_k=0,
                        seed=None, stop_token=None, timeout=None,
                        priority=None, stream=False, trace=None):
        """Adopt a prefill replica's export record (roles "decode"/"both")
        and decode ``steps`` tokens: admission claims the prompt + steps
        budget, the exported blocks scatter into the slot's table (no
        prefill pass) and the first token samples from the exported
        logits with these settings, so the stream is a colocated
        ``submit``'s.  Raises ``ValueError`` on a record that does not
        fit this replica's pools (kv_dtype, block_size, window)."""
        if self.role == "prefill":
            raise RoleMismatchError(
                "prefill-role replica exports KV — imports belong on the "
                "decode pool")
        if self.kv != "paged":
            raise ValueError("kv import needs the paged cache")
        prompt = [int(t) for t in export.get("prompt", ())]
        steps = int(steps)
        if not prompt or int(export.get("length", -1)) != len(prompt):
            raise ValueError("export record prompt/length mismatch")
        if steps < 1:
            raise ValueError("steps must be >= 1")
        if str(export.get("kv_dtype")) != self.kv_dtype:
            raise ValueError(
                "export kv_dtype %r != this replica's %r — disaggregated "
                "pools must share a storage dtype"
                % (export.get("kv_dtype"), self.kv_dtype))
        if int(export.get("block_size", 0)) != self.block_size:
            raise ValueError("export block_size %s != this replica's %d"
                             % (export.get("block_size"), self.block_size))
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
        prio = resolve_priority(priority)
        ttl = float(timeout or self.request_timeout
                    or self.queue_timeout or 0)
        trace = tracing.ensure_trace_id(trace)
        ts = TokenStream(prompt) if stream else None
        if ts is not None:
            ts.trace = trace
        req = _Request(prompt, steps, temperature, top_k,
                       int(stop_token) if stop_token is not None else None,
                       int(seed) & 0xFFFFFFFF,
                       time.monotonic() + ttl if ttl > 0 else None, prio,
                       sink=ts._push if ts is not None else None,
                       trace=trace)
        req.kv_import = export
        self._admission_enqueue(req)
        if ts is not None:
            ts._bind(self, req.future)
            return ts
        return req.future

    def _submit_prefix_job(self, kind, payload):
        if self.kv != "paged" or not self.prefix_cache:
            raise ValueError("prefix %s needs the paged cache with the "
                             "prefix cache enabled" % kind)
        fut = concurrent.futures.Future()
        with self._wake:
            if self._closed:
                raise SchedulerError("scheduler is closed")
            if len(self._prefix_jobs) >= self.max_queue:
                raise QueueFullError("prefix-transfer queue full (%d "
                                     "waiting)" % len(self._prefix_jobs))
            self._prefix_jobs.append((kind, payload, fut))
            self._wake.notify()
        return fut

    def submit_prefix_export(self, tokens):
        """Queue a read of the longest resident prefix of ``tokens``
        across both tiers (the trie, then its host-tier extension): the
        future resolves to an export-shaped record (no logits, the
        prompt cut to the covered prefix) or None.  Works while
        draining."""
        tokens = [int(t) for t in tokens]
        if not tokens:
            raise ValueError("tokens must be non-empty")
        return self._submit_prefix_job("export", tokens)

    def submit_prefix_import(self, record):
        """Queue the adoption of a peer's prefix record: new chunks take
        freshly claimed blocks and join the trie, so later prompts admit
        warm here.  The future resolves to ``{"blocks": adopted}``.
        Raises ``ValueError`` on a record that does not fit this
        replica's pools."""
        if str(record.get("kv_dtype")) != self.kv_dtype:
            raise ValueError("prefix record kv_dtype %r != this replica's "
                             "%r" % (record.get("kv_dtype"), self.kv_dtype))
        if int(record.get("block_size", 0)) != self.block_size:
            raise ValueError("prefix record block_size %s != this "
                             "replica's %d" % (record.get("block_size"),
                                               self.block_size))
        prompt = [int(t) for t in record.get("prompt", ())]
        if not prompt or int(record.get("length", -1)) != len(prompt):
            raise ValueError("prefix record prompt/length mismatch")
        if len(prompt) % self.block_size:
            raise ValueError("prefix record must be block-aligned")
        return self._submit_prefix_job("import", record)

    def _enqueue_locked(self, req, front=False):
        """Insert one request into the class-ordered queue (highest
        class first, FIFO within a class); ``front=True`` requeues a
        preempted victim at the head of its class."""
        q = self._queue
        if front:
            i = 0
            while i < len(q) and q[i].priority > req.priority:
                i += 1
        else:
            i = len(q)
            while i > 0 and q[i - 1].priority < req.priority:
                i -= 1
        q.insert(i, req)

    def _evict_queued_locked(self, prio):
        """Depth-cap relief for a higher-class arrival: shed the
        youngest queued strictly-lower-class request; returns whether
        a seat opened."""
        victim = None
        for req in reversed(self._queue):
            if req.priority < prio:
                victim = req
                break
        if victim is None:
            return False
        self._queue.remove(victim)
        self._queued_blocks -= self._blocks_for(victim)
        self.stats.record_shed(self._queued_blocks,
                               cls=CLASS_NAMES[victim.priority],
                               trace=victim.trace)
        err = QueueFullError("shed while queued: a higher-priority "
                             "request took the last queue seat")
        err.retry_after = _RETRY_AFTER[victim.priority]
        victim.fail(err)
        return True

    def _budget_tokens(self, req):
        """The tokens a request's block budget covers: prompt + steps, or
        the prompt alone for a prefill export (the decode replica claims
        the steps' blocks)."""
        if req.export_only:
            return len(req.prompt)
        return len(req.prompt) + req.steps

    def _blocks_for(self, req):
        """The paged block budget a request commits (0 when dense)."""
        if self.kv != "paged":
            return 0
        return -(-self._budget_tokens(req) // self.block_size)

    def cancel(self, future, reason="cancelled by client"):
        """Cancel the request behind ``future``: a queued request fails
        at once; an in-flight one is reaped at the next boundary, its
        slot and blocks returned.  Returns True when the future belonged
        to this scheduler and was still queued or in flight."""
        victim = None
        with self._wake:
            for req in self._queue:
                if req.future is future:
                    self._queue.remove(req)
                    self._queued_blocks -= self._blocks_for(req)
                    victim = req
                    break
            else:
                for req in list(self._prefilling) \
                        + list(self._active.values()) \
                        + list(self._admitting):
                    if req.future is future:
                        req.cancelled = True
                        victim = req
                        self._wake.notify()
                        break
        if victim is None:
            return False
        if victim.slot is None and not victim.cancelled:
            # was queued: nothing on the card to release
            victim.fail(RequestCancelledError(reason))
            self.stats.record_cancel(len(victim.generated),
                                     trace=victim.trace)
        return True

    def request_preempt(self, n=1, below=None):
        """Ask the loop to evict ``n`` active requests at the next
        boundary, lowest class first, youngest within it; ``below``
        bounds victimhood to classes strictly under it (a demand with
        no qualifying victim is dropped).  Each victim keeps its
        generated prefix and requeues at the front of its class."""
        with self._wake:
            self._preempts_owed.extend(
                [None if below is None else int(below)] * int(n))
            self._wake.notify()

    def submit_embed(self, rows):
        """Queue ONE batched embedding job (``/v1/embeddings``): ``rows``
        are non-empty token lists; the future resolves to a list of
        pooled unit-norm vectors (:func:`~veles_tpu_torch.serving.
        openai_api.embed_pool`).  The job runs on the loop thread
        between decode boundaries."""
        return self._submit_aux("embed", rows)

    def submit_score(self, rows):
        """Queue ONE batched classifier-scoring job (``/v1/classify``):
        the future resolves to per-row class log-probabilities [n,
        classes] from the full chain's last-position logits."""
        return self._submit_aux("score", rows)

    def _submit_aux(self, kind, rows):
        rows = [[int(t) for t in r] for r in rows]
        if not rows or any(not r for r in rows):
            raise ValueError("input must be non-empty token rows")
        widest = max(len(r) for r in rows)
        if widest > self.window:
            raise ValueError("input row of %d tokens exceeds the serving "
                             "window (%d)" % (widest, self.window))
        if kind == "embed" and not embed_supported(self.forwards):
            raise ValueError("chain cannot serve embeddings")
        fut = concurrent.futures.Future()
        with self._wake:
            if self._closed:
                raise SchedulerError("scheduler is closed")
            if self._draining:
                raise DrainingError("scheduler is draining")
            if len(self._aux) >= self.max_queue:
                self.stats.record_reject(len(self._aux))
                raise QueueFullError("aux queue full (%d waiting)"
                                     % len(self._aux))
            self._aux.append((kind, rows, fut))
            self._wake.notify()
        return fut

    def _aux_tick(self):
        """Run ONE queued embed/score job at this boundary: like a
        prefill chunk, it delays in-flight decode by one bounded pass,
        not by the whole aux backlog.  The job leaves the queue only
        once its future is settled, so :attr:`in_flight` and
        :meth:`drain` count it while it runs (the reference pops it
        first)."""
        with self._lock:
            if not self._aux:
                return
            job = self._aux[0]
        kind, rows, fut = job
        try:
            if not fut.done():   # else the consumer already gave up
                self._run_aux(kind, rows, fut)
        finally:
            with self._lock:
                if self._aux and self._aux[0] is job:
                    self._aux.popleft()

    def _run_aux(self, kind, rows, fut):
        try:
            faults.fire("serving.scheduler.aux")
            if kind == "embed":
                out = pooled_embeddings(self.forwards, rows, self.window)
            else:
                out = score_rows(self.forwards, rows, self.window)
        except Exception as e:
            out = e if isinstance(e, SchedulerError) \
                else SchedulerError(repr(e))
        # a client may cancel the future meanwhile: that must not reach
        # the loop
        try:
            if isinstance(out, Exception):
                fut.set_exception(out)
            else:
                fut.set_result(out)
        except concurrent.futures.InvalidStateError:
            pass

    def _prefix_tick(self, cache):
        """Run ONE queued prefix export/import job at this boundary (the
        decode stall of one bounded job, like an aux pass)."""
        with self._lock:
            if not self._prefix_jobs:
                return
            kind, payload, fut = self._prefix_jobs.popleft()
        if fut.done():   # the consumer gave up
            return
        try:
            if kind == "export":
                out = self._prefix_export_job(cache, payload)
            else:
                out = self._prefix_import_job(cache, payload)
        except Exception as e:
            out = e if isinstance(e, SchedulerError) \
                else SchedulerError(repr(e))
        try:
            if isinstance(out, Exception):
                fut.set_exception(out)
            else:
                fut.set_result(out)
        except concurrent.futures.InvalidStateError:
            pass

    def _prefix_export_job(self, cache, tokens):
        """The longest resident prefix of ``tokens`` — the trie walk, then
        its host-tier extension — as an export-shaped record."""
        if self.prefix_ is None:
            return None
        ids = self.prefix_.resident_prefix(tokens)
        layers = cache.export_blocks(ids) if ids else None
        if self.host_ is not None:
            for e in self.host_.match(tokens, len(ids)):
                if layers is None:
                    layers = {i: {nm: a.copy() for nm, a in row.items()}
                              for i, row in e.layers.items()}
                    continue
                if set(e.layers) != set(layers):
                    break
                layers = {i: {nm: numpy.concatenate(
                    [layers[i][nm], e.layers[i][nm]]) for nm in layers[i]}
                    for i in layers}
        if layers is None:
            return None
        blocks = next(iter(next(iter(layers.values())).values())).shape[0]
        covered = blocks * self.block_size
        return {"handle": mint_handle(),
                "prompt": [int(t) for t in tokens[:covered]],
                "length": covered, "kv_dtype": self.kv_dtype,
                "block_size": self.block_size, "layers": layers}

    def _prefix_import_job(self, cache, record):
        """Adopt a peer's prefix record: chunks already resident keep
        their blocks; the new consecutive extension scatters into
        freshly claimed blocks and joins the trie (the fault point
        ``scheduler.kv.promote`` fires: an import is a promotion from a
        remote source)."""
        pfx = self.prefix_
        if pfx is None:
            raise SchedulerError("no prefix cache on this replica")
        bs = self.block_size
        tokens = record["prompt"]
        total = int(record["length"]) // bs
        dev = pfx.resident_prefix(tokens)
        n_new = total - len(dev)
        ids = None
        while n_new > 0:
            ids = cache.take_free_blocks(n_new)
            if ids is not None:
                break
            n_new -= 1   # adopt the longest extension that fits
        if not n_new or ids is None:
            return {"blocks": 0}
        try:
            faults.fire("scheduler.kv.promote")
            cache.import_blocks(ids, {
                i: {nm: a[len(dev):len(dev) + n_new]
                    for nm, a in layer.items()}
                for i, layer in record["layers"].items()})
        except Exception:
            cache.reclaim(ids)
            raise
        covered = (len(dev) + n_new) * bs
        _, rejected = pfx.insert([int(t) for t in tokens[:covered]],
                                 dev + ids)
        if rejected:
            cache.reclaim(rejected)
        self._sync_prefix_gauges()
        return {"blocks": n_new}

    def drain(self, timeout=None):
        """Begin a graceful drain: submits raise :class:`DrainingError`,
        every queued and in-flight request runs to completion, then
        ``drained`` sets.  With ``timeout`` the call waits for that and
        returns whether it happened; otherwise it returns at once."""
        with self._wake:
            first = not self._draining
            self._draining = True
            if not (self._queue or self._active or self._prefilling
                    or self._admitting or self._aux):
                self._drained.set()
            self._wake.notify()
        if first:
            self.stats.record_drain()
            log.info("draining: admission closed, %d in flight",
                     self.in_flight)
        if timeout is not None:
            return self._drained.wait(timeout)
        return self._drained.is_set()

    @property
    def draining(self):
        return self._draining

    @property
    def drained(self):
        return self._drained.is_set()

    @property
    def in_flight(self):
        """Requests still owed an answer (queued, admitting, prefilling,
        decoding) and aux jobs not yet settled."""
        with self._lock:
            return len(self._queue) + len(self._prefilling) \
                + len(self._active) + len(self._admitting) \
                + len(self._aux)

    def _kv_snapshot(self):
        """The KV, speculative-decoding and prefix-cache part of
        :meth:`metrics`.  The loop thread owns the cache and the trie;
        these reads are monitoring-grade (``len()`` and int reads)."""
        cache = self.cache_
        out = {"kv_mode": self.kv,
               "prefill_chunk": self.prefill_chunk,
               "prefilling": len(self._prefilling),
               "tp": self.tp,
               "role": self.role,
               "replica": self.replica_id,
               "kv_exports_pending": len(self._exports)}
        if self.kv == "paged":
            out.update({
                "kv_dtype": self.kv_dtype,
                "kv_bytes_per_token":
                    cache.bytes_per_token() if cache is not None else None,
                "kv_block_size": self.block_size,
                "kv_blocks_total": self.kv_blocks,
                "kv_blocks_used": cache.used_blocks if cache is not None
                else 0,
                "kv_blocks_free": cache.free_blocks if cache is not None
                else self.kv_blocks})
        out.update({"spec": self.spec,
                    "spec_k": self.spec_k if self.spec else 0,
                    "drafter": self.drafter if self.spec else None,
                    "draft_k_min": self.draft_k_min if self.spec else 0})
        pfx = self.prefix_
        out["prefix_cache"] = pfx is not None
        if pfx is not None:
            total = pfx.hits + pfx.misses
            out["prefix_cache_hits"] = pfx.hits
            out["prefix_cache_misses"] = pfx.misses
            out["prefix_cache_evictions"] = pfx.evictions
            out["prefix_cache_hit_blocks"] = pfx.hit_blocks
            out["prefix_cache_blocks_resident"] = pfx.resident
            out["prefix_cache_hit_rate"] = \
                round(pfx.hits / total, 4) if total else None
            # the trie walks: its shared blocks, and the rolling digests
            # of every resident prefix (what a router would match
            # prompts against).  A walk that meets a node list the loop
            # is changing raises, and is taken again
            for attempt in range(8):
                try:
                    shared = pfx.shared_blocks()
                    digests = pfx.path_digests(_DIGEST_MAX)
                    break
                except RuntimeError:
                    if attempt == 7:
                        raise
            out["prefix_cache_blocks_shared"] = shared
            # a host-resident prefix is promotable, so it is advertised
            # beside the trie's
            host = self.host_
            if host is not None:
                digests.extend(host.digests()[:max(
                    0, _DIGEST_MAX - len(digests))])
                out["kv_host_blocks"] = host.blocks
                out["kv_host_bytes"] = host.bytes
                out["kv_host_promotions"] = host.promotions
                out["kv_host_demotions"] = host.demotions
                out["kv_host_evictions"] = host.evictions
            out["prefix_digests"] = digests
        return out

    def metrics(self):
        """The serving snapshot (the reference's ``metrics()`` keys):
        request, token, slot-step, prefill, lifecycle and speculative
        counters, TTFT and queue-wait percentiles, goodput and padding
        efficiency over the recent steps, the SLO block, and the queue,
        KV and prefix-cache state.  The keys of features the port does
        not have read as the reference's do with them off."""
        with self._lock:
            depth, active = len(self._queue), len(self._active)
            draining = self._draining
            queued_blocks = self._queued_blocks
        snap = self.stats.snapshot(queue_depth=depth, active_slots=active,
                                   max_slots=self.max_slots,
                                   kv=self._kv_snapshot())
        snap["window"] = self.window
        snap["draining"] = draining
        snap["drained"] = self._drained.is_set()
        snap["queued_kv_blocks"] = queued_blocks
        snap["tenants"] = self.stats.tenant_usage_snapshot()
        return snap

    def debug_requests(self):
        """The live in-flight table: one row per request still owed an
        answer, with its trace id, phase (queued, admitting, prefill,
        decode), class, age, tokens and the KV blocks it holds.  The
        loop owns the cache's tables, so block counts are
        monitoring-grade reads, not a transaction."""
        now = time.monotonic()
        cache = self.cache_
        with self._lock:
            rows = [("queued", r) for r in self._queue] \
                + [("admitting", r) for r in self._admitting] \
                + [("prefill", r) for r in self._prefilling] \
                + [("decode", r) for r in self._active.values()]
        out = []
        for phase, req in rows:
            blocks = shared = 0
            if req.slot is not None and self.kv == "paged" \
                    and cache is not None:
                blocks = int(cache.n_blocks[req.slot])
                shared = int(cache.n_shared[req.slot])
            row = {
                "trace": req.trace,
                "phase": phase,
                "cls": CLASS_NAMES[req.priority],
                "tenant": req.tenant,
                "age_s": round(now - req.t_submit, 3),
                "prompt_tokens": len(req.prompt),
                "tokens": len(req.generated),
                "steps": req.steps,
                "blocks": blocks,
                "blocks_shared": shared,
                "blocks_budget": self._blocks_for(req),
                "preempts": req.preempts,
                "stream": req.sink is not None,
                "deadline_in_s": round(req.deadline - now, 3)
                if req.deadline is not None else None,
            }
            if phase == "prefill":
                row["prefill_off"] = req.pf_off
            out.append(row)
        return out

    def check_kv(self):
        """The paged cache's invariant sweep, the prefix cache's
        resident blocks included (loop idle or closed); the dense cache
        has no blocks to sweep."""
        if self.cache_ is not None and self.kv == "paged":
            self.cache_.check(
                resident=self.prefix_.resident_blocks()
                if self.prefix_ is not None else ())

    def close(self):
        """Stop the loop and the watchdog, fail every unfinished
        request, and return every in-flight slot, block and prefix pin
        (``check_kv()`` holds afterwards; resident prefix blocks stay
        the trie's)."""
        with self._wake:
            if self._closed and self._thread is None:
                return
            self._closed = True
            self._wake.notify()
        self._stop.set()
        thread, self._thread = self._thread, None
        loop_dead = True
        if thread is not None:
            thread.join(30)
            loop_dead = not thread.is_alive()
        err = SchedulerError("scheduler closed")
        with self._lock:
            pending = list(self._queue) + list(self._prefilling) \
                + list(self._active.values()) + list(self._admitting)
            aux = list(self._aux) + list(self._prefix_jobs)
            self._queue.clear()
            self._prefilling = []
            self._active.clear()
            self._admitting = []
            self._aux.clear()
            self._prefix_jobs.clear()
            self._exports.clear()
            self._exports_bytes = 0
            self._exports_claimed.clear()
            self._queued_blocks = 0
        for _, _, fut in aux:
            if not fut.done():
                try:
                    fut.set_exception(err)
                except concurrent.futures.InvalidStateError:
                    pass
        # the loop thread is joined: its cache and trie are ours now
        if self.host_ is not None and loop_dead:
            self.host_.clear()
        cache = self.cache_ if loop_dead else None
        for req in pending:
            if req.slot is not None and cache is not None:
                self._release_slot(req, cache)
            req.fail(err)
        if cache is not None:
            self._sync_kv_gauges(cache)
        self._drained.set()
        with self._lock:
            wd, self._watchdog_thread = self._watchdog_thread, None
        if wd is not None:
            wd.join(5)

    # -- decode loop -------------------------------------------------------------

    def _loop(self):
        try:
            self.cache_ = self._make_cache()
            if self.prefix_cache:
                self.prefix_ = RadixPrefixCache(self.block_size)
            if self.kv == "paged":
                self.stats.set_kv_dtype(self.kv_dtype,
                                        self.cache_.bytes_per_token())
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
                self._working = False
                pending = list(self._queue) + list(self._prefilling) \
                    + list(self._active.values()) + list(self._admitting)
            for req in pending:
                req.fail(SchedulerError(repr(e)))

    def _make_cache(self):
        if self.kv == "paged":
            cache = PagedKVCache(
                self.forwards, self.max_slots, self.window,
                block_size=self.block_size, kv_blocks=self.kv_blocks,
                kv_dtype=self.kv_dtype, tp=self.tp_)
            if self.tp_ is not None:
                log.info("tensor-parallel serving over %d positions",
                         self.tp)
            return cache
        return SlotKVCache(self.forwards, self.max_slots, self.window)

    def _serve(self, cache):
        while True:
            with self._wake:
                self._working = False
                while not self._closed and not self._queue \
                        and not self._active and not self._prefilling \
                        and not self._preempts_owed and not self._aux \
                        and not self._prefix_jobs:
                    if self._draining:
                        self._drained.set()
                    # parked exports keep a 1 s tick alive so their TTL
                    # holds on an idle prefill replica
                    self._wake.wait(1.0 if self._exports else None)
                    if self._exports:
                        self._sweep_exports_locked()
                if self._closed:
                    return
                # the watchdog measures from here: one iteration = one
                # reap + admit + chunk + step
                self._working = True
                self._beat = time.monotonic()
                self._expire_locked()
                if self._exports:
                    self._sweep_exports_locked()
                admits = []
                while self._queue and self._can_admit(cache,
                                                      self._queue[0]):
                    req = self._queue.popleft()
                    self._queued_blocks -= self._blocks_for(req)
                    if not self._admit_claim(cache, req):
                        self._queue.appendleft(req)
                        self._queued_blocks += self._blocks_for(req)
                        break
                    admits.append(req)
                    self._admitting.append(req)
                # priority preemption: the head outranks an active
                # lower-class request but cannot admit — owe ONE
                # eviction at this boundary
                if self._queue and not self._preempts_owed:
                    head = self._queue[0]
                    if head.priority > 0 \
                            and not self._can_admit(cache, head) \
                            and any(r.priority < head.priority
                                    for r in self._active.values()):
                        self._preempts_owed.append(head.priority)
            faults.fire("serving.scheduler.loop")
            self._reap(cache)
            self._do_preempts(cache)
            self._sync_kv_gauges(cache)
            for req in admits:
                self._begin_admit(req, cache)
                with self._lock:
                    self._admitting.remove(req)
            if self._aux:
                self._aux_tick()
            if self._prefix_jobs:
                self._prefix_tick(cache)
            if self._prefilling:
                self._prefill_tick(cache)
            if self._active:
                self._step(cache)

    def _can_admit(self, cache, req):
        """Admission sizing for the head of the queue: a warm prompt
        needs only its cold blocks, and refcount-0 residents count as
        headroom when they may be evicted.  A dense slot needs only
        itself."""
        total = self._budget_tokens(req)
        if self.kv != "paged":
            return cache.can_admit(total)
        if not cache.free_slots:
            return False
        need = cache.blocks_needed(total)
        head = cache.free_blocks
        if self.prefix_ is not None:
            if req.kv_import is None:   # an import never matches warm
                seq = list(req.prompt) + list(req.generated)
                need -= self.prefix_.peek(
                    seq, max_blocks=(len(seq) - 1) // cache.block_size)
            if self.prefix_evict:
                head += self.prefix_.evictable_blocks()
        return need <= head

    def _admit_claim(self, cache, req):
        """Claim a slot and blocks for one admitted request: pin the
        longest resident prefix (capped so >= 1 token stays cold: the
        first-token logits come from a prefill pass), evict cold
        residents if the free list is short, then alloc with the
        matched blocks heading the table."""
        total = self._budget_tokens(req)
        if self.kv != "paged":
            req.slot = cache.alloc(total)
            return req.slot is not None
        handle = None
        # an import scatters into its leading table blocks, so they must
        # be its own: imports skip the warm match
        if self.prefix_ is not None and req.kv_import is None:
            seq = list(req.prompt) + list(req.generated)
            if self.host_ is not None:
                # promote the host-tier extension first, so the match
                # below pins (and counts) the whole warm prefix
                self._promote_host(cache, seq)
            handle = self.prefix_.match(
                seq, max_blocks=(len(seq) - 1) // cache.block_size)
            self.stats.record_prefix_lookup(len(handle), cache.block_size)
            if not len(handle):
                handle = None
        matched = len(handle) if handle is not None else 0
        need_new = cache.blocks_needed(total) - matched
        if self.prefix_ is not None and self.prefix_evict \
                and need_new > cache.free_blocks:
            freed = self._evict_prefix(cache, need_new - cache.free_blocks)
            if freed:
                cache.reclaim(freed)
                self.stats.record_prefix_evict(len(freed))
        slot = cache.alloc(
            total, shared=handle.blocks if handle is not None else ())
        if slot is None:
            if handle is not None:
                self.prefix_.release(handle)
            return False
        req.slot = slot
        req.prefix_handle = handle
        req.pf_matched = matched
        return True

    def _release_slot(self, req, cache, finished=False):
        """Return one request's slot, blocks and prefix pins.  A request
        that FINISHED donates the full blocks of its written positions
        to the prefix cache (insert-on-release)."""
        if req.slot is None:
            if req.prefix_handle is not None:
                self.prefix_.release(req.prefix_handle)
                req.prefix_handle = None
            return
        if self.kv != "paged" or self.prefix_ is None:
            cache.release(req.slot)
        else:
            donate = 0
            seq = None
            if finished:
                seq = list(req.prompt) + list(req.generated)
                # the FINAL token was sampled but never fed back, so its
                # K/V row was never written (and a rejected draft's may
                # sit there): donate only blocks fully covered by the
                # written positions [0, len - 1), the admission match's
                # own cap
                donate = (len(seq) - 1) // cache.block_size \
                    - req.pf_matched
            shared, donated = cache.release(req.slot,
                                            donate=max(0, donate))
            if req.prefix_handle is not None:
                self.prefix_.release(req.prefix_handle)
                req.prefix_handle = None
            if seq is not None and (shared or donated):
                _, rejected = self.prefix_.insert(seq, shared + donated)
                if rejected:  # an identical twin donated first
                    cache.reclaim(rejected)
            self._sync_prefix_gauges()
        req.slot = None
        req.pf_matched = 0
        # the hidden the draft head reads belongs to a position of this
        # admission: a resume re-prefills and earns it again
        req.hid = None

    def _sync_kv_gauges(self, cache):
        if self.kv == "paged":
            self.stats.set_kv_blocks(cache.used_blocks, cache.free_blocks)

    def _sync_prefix_gauges(self):
        if self.prefix_ is not None:
            self.stats.set_prefix_blocks(self.prefix_.resident,
                                         self.prefix_.shared_blocks())

    def _sync_host_gauges(self):
        if self.host_ is not None:
            self.stats.set_kv_host(self.host_.blocks, self.host_.bytes)

    def _evict_prefix(self, cache, n):
        """Trie eviction with host-tier demotion: before the blocks return
        to the free list their contents are copied off the card into the
        host tier, keyed by the token path each completed.  A failed
        demotion loses warmth, never the eviction."""
        if self.host_ is None:
            return self.prefix_.evict(n)
        pairs = self.prefix_.evict_with_paths(n)
        if not pairs:
            return []
        demoted = 0
        try:
            layers = cache.export_blocks([b for b, _ in pairs])
            for j, (_, path) in enumerate(pairs):
                one = {i: {nm: a[j:j + 1] for nm, a in layer.items()}
                       for i, layer in layers.items()}
                if self.host_.put(path, one):
                    demoted += 1
        except Exception as e:
            log.info("host-tier demotion failed: %r", e)
        if demoted:
            self.stats.record_kv_host(demoted=demoted)
        self._sync_host_gauges()
        return [b for b, _ in pairs]

    def _promote_host(self, cache, seq):
        """Promote the host-tier extension of ``seq``'s device-resident
        prefix into freshly claimed blocks and insert them into the trie
        (the fault point ``scheduler.kv.promote`` fires first).  Returns
        the blocks promoted; on a failure 0, and the request admits
        colder."""
        bs = self.block_size
        limit = (len(seq) - 1) // bs   # >= 1 token stays cold
        dev = self.prefix_.resident_prefix(seq, limit)
        entries = self.host_.match(seq, len(dev),
                                   max_blocks=limit - len(dev))
        ids = None
        while entries:
            ids = cache.take_free_blocks(len(entries))
            if ids is not None:
                break
            entries.pop()   # promote the longest extension that fits
        if not entries:
            return 0
        try:
            faults.fire("scheduler.kv.promote")
            cache.import_blocks(ids, {
                i: {nm: numpy.concatenate([e.layers[i][nm]
                                           for e in entries])
                    for nm in entries[0].layers[i]}
                for i in entries[0].layers})
        except Exception as e:
            cache.reclaim(ids)
            log.info("host-tier promotion failed: %r", e)
            return 0
        covered = (len(dev) + len(entries)) * bs
        _, rejected = self.prefix_.insert(list(seq[:covered]), dev + ids)
        if rejected:   # only on a digest collision
            cache.reclaim(rejected)
        self.host_.pop(entries)
        self.stats.record_kv_host(promoted=len(entries))
        self._sync_host_gauges()
        self._sync_prefix_gauges()
        return len(entries)

    def _reap(self, cache):
        """Boundary sweep over the in-flight set: release the slot and
        blocks of every request that was cancelled, crossed its
        deadline, or whose future the watchdog already failed."""
        now = time.monotonic()
        with self._lock:
            flight = list(self._prefilling) + list(self._active.values())
        for req in flight:
            if req.future.done():      # the watchdog raced ahead
                self._drop_inflight(req, cache)
            elif req.cancelled:
                self._drop_inflight(req, cache)
                self.stats.record_cancel(len(req.generated),
                                         trace=req.trace)
                req.fail(RequestCancelledError(
                    "cancelled after %d generated tokens"
                    % len(req.generated)))
            elif req.deadline is not None and now > req.deadline:
                self._drop_inflight(req, cache)
                age_ms = (now - req.t_submit) * 1e3
                self.stats.record_expire(age_ms, tokens=len(req.generated),
                                         trace=req.trace)
                req.fail(DeadlineExceededError(
                    "deadline exceeded after %.0f ms (%d tokens "
                    "generated)" % (age_ms, len(req.generated)),
                    tokens_generated=len(req.generated)))

    def _drop_inflight(self, req, cache):
        """Remove one admitted request from the in-flight set and
        return its slot and blocks (loop thread only)."""
        with self._lock:
            if req in self._prefilling:
                self._prefilling.remove(req)
            self._active.pop(req.slot, None)
        self._release_slot(req, cache)
        req.pf_seq = req.pf_caches = None
        self._sync_kv_gauges(cache)

    def _do_preempts(self, cache):
        """Evict the owed preemptions: lowest class first, youngest
        admission within it.  The victim keeps its generated prefix and
        requeues at the front of its class."""
        while True:
            with self._lock:
                if not self._preempts_owed:
                    return
                if not self._active:
                    del self._preempts_owed[:]   # no targets: the demand
                    return                       # dies here
                below = self._preempts_owed.pop(0)
                victims = [r for r in self._active.values()
                           if below is None or r.priority < below]
                if not victims:
                    continue   # bounded demand, no qualifying victim
                req = max(victims,
                          key=lambda r: (-r.priority, r.t_admit, r.slot))
                self._active.pop(req.slot, None)
            self._release_slot(req, cache)
            req.preempts += 1
            self.stats.record_preempt(len(req.generated),
                                      cls=CLASS_NAMES[req.priority],
                                      trace=req.trace)
            self._sync_kv_gauges(cache)
            with self._lock:
                self._enqueue_locked(req, front=True)
                self._queued_blocks += self._blocks_for(req)

    def _watchdog_loop(self):
        """Fail the pending futures when one loop iteration stalls past
        ``watchdog`` seconds; when the loop runs on, :meth:`_reap`
        returns the failed requests' slots and blocks."""
        period = max(0.02, min(1.0, self.watchdog / 8.0))
        while not self._stop.wait(period):
            with self._lock:
                if self._closed:
                    return
                beat, working = self._beat, self._working
                tripped = self._tripped_beat
            if not working or beat is None or beat == tripped:
                continue
            stalled = time.monotonic() - beat
            if stalled <= self.watchdog:
                continue
            with self._lock:
                self._tripped_beat = beat
                victims = [r for r in list(self._queue)
                           + list(self._prefilling)
                           + list(self._active.values())
                           + list(self._admitting)
                           if not r.future.done()]
            err = SchedulerError(
                "decode loop stalled %.1fs (watchdog %.1fs) — request "
                "failed instead of hanging" % (stalled, self.watchdog))
            for req in victims:
                req.fail(err)
            self.stats.record_watchdog_trip(len(victims), stalled)
            log.warning("decode loop stalled %.1fs — failed %d pending "
                        "requests", stalled, len(victims))

    def _expire_locked(self):
        """Drop queued requests past their deadline (or failed by the
        watchdog) — caller holds the lock."""
        now = time.monotonic()
        kept = collections.deque()
        while self._queue:
            req = self._queue.popleft()
            if req.future.done():
                self._queued_blocks -= self._blocks_for(req)
            elif req.deadline is not None and now > req.deadline:
                self._queued_blocks -= self._blocks_for(req)
                queued_ms = (now - req.t_submit) * 1e3
                self.stats.record_expire(queued_ms,
                                         tokens=len(req.generated),
                                         trace=req.trace)
                req.fail(DeadlineExceededError(
                    "queued %.0f ms without a free slot" % queued_ms,
                    tokens_generated=len(req.generated)))
            else:
                kept.append(req)
        self._queue = kept

    def _staging_width(self, p_len, chunk):
        """Width of the batch-1 staging row a prompt prefills into:
        the power-of-two bucket of the prompt, floored so it tiles the
        chunk width and (paged) the block size."""
        bs = self.block_size if self.kv == "paged" else 1
        floor = max(self.prefill_bucket, bs, chunk or 1)
        return _bucket(p_len, floor, 1 << 30)

    def _staging(self, width):
        return {i: u.init_cache(1, width, u.dtype)
                for i, u in enumerate(self.forwards)
                if hasattr(u, "init_cache")}

    def _begin_admit(self, req, cache):
        """Route one joining request: a warm match gathers its blocks
        and prefills the cold tail, short sequences prefill one-shot,
        long ones start the chunked-prefill ride-along.  A preempted
        request resumes here: its sequence is prompt + the kept
        generated prefix."""
        req.t_admit = time.monotonic()
        if req.kv_import is not None and not req.preempts:
            # a disaggregated handoff: the exported blocks are the
            # prefill (a resumed import re-prefills below instead: its
            # blocks were freed)
            self._admit_import(req, cache)
            return
        req.pf_seq = list(req.prompt) + list(req.generated)
        if req.preempts and req.generated:
            self.stats.record_resume(len(req.pf_seq))
        if self._tron:
            # the queue wait [submit, admit], then the admission: warm
            # blocks matched and cold blocks claimed
            tracing.record(req.trace, "queue",
                           duration=req.t_admit - req.t_submit,
                           cls=CLASS_NAMES[req.priority],
                           tenant=req.tenant,
                           resume=bool(req.preempts))
            tracing.record(req.trace, "admit", slot=req.slot,
                           tokens=len(req.pf_seq),
                           warm_blocks=req.pf_matched,
                           blocks_claimed=max(0, self._blocks_for(req)
                                              - req.pf_matched),
                           resume=bool(req.preempts))
        if req.pf_matched:
            self._admit_warm(req, cache)
            return
        p_len = len(req.pf_seq)
        chunk = self.prefill_chunk
        if not chunk or p_len <= chunk:
            self._admit_oneshot(req, cache)
            return
        req.pf_chunk = chunk
        req.pf_width = self._staging_width(p_len, chunk)
        req.pf_off = 0
        try:
            req.pf_caches = self._staging(req.pf_width)
        except Exception as e:
            self._retire(req, cache, error=e)
            return
        with self._lock:
            self._prefilling.append(req)

    def _admit_warm(self, req, cache):
        """Prefix-cache hit: the matched blocks hold the K/V of tokens
        [0, matched · block_size); gather them into the staging row and
        chunk-prefill the cold tail only.  The chunk narrows to the
        block size so every offset stays chunk-aligned from the warm
        boundary."""
        bs = self.block_size
        req.pf_chunk = min(self.prefill_chunk, bs)
        req.pf_width = self._staging_width(len(req.pf_seq),
                                           self.prefill_chunk)
        req.pf_off = req.pf_matched * bs
        try:
            req.pf_caches = cache.load_staging(
                self._staging(req.pf_width), req.prefix_handle.blocks)
        except Exception as e:
            self._retire(req, cache, error=e)
            return
        with self._lock:
            self._prefilling.append(req)

    def _admit_oneshot(self, req, cache):
        """Prefill one request's sequence in a single pass and emit its
        next token."""
        p_len = len(req.pf_seq)
        width = self._staging_width(p_len, 0)
        # the token array stays inside the positional table; the
        # staging cache may be wider (insert reads only the prompt's
        # blocks)
        p_w = min(width, max(self.window, p_len))
        padded = numpy.zeros((1, p_w), numpy.int32)
        padded[0, :p_len] = req.pf_seq
        t0 = time.perf_counter()
        try:
            faults.fire("serving.scheduler.prefill")
            row_caches, last = prefill(self.forwards, padded,
                                       prompt_lens=[p_len], window=width,
                                       tp=self.tp_)
        except Exception as e:
            self._retire(req, cache, error=e)
            return
        if self._tron:
            tracing.record(req.trace, "prefill",
                           duration=time.perf_counter() - t0, tokens=p_len)
        self._finish_admit(req, cache, row_caches, last)

    def _prefill_tick(self, cache):
        """Advance the oldest mid-prefill request by ONE chunk."""
        with self._lock:
            if not self._prefilling:
                return
            req = self._prefilling[0]
        p_len = len(req.pf_seq)
        c = req.pf_chunk
        off = req.pf_off
        end = min(off + c, p_len)
        clen = end - off
        padded = numpy.zeros((1, c), numpy.int32)
        padded[0, :clen] = req.pf_seq[off:end]
        kw = _bucket(off + c, c, req.pf_width)
        t0 = time.perf_counter()
        try:
            faults.fire("serving.scheduler.prefill")
            req.pf_caches, last = prefill_chunk(
                self.forwards, padded, off, [clen], req.pf_caches,
                key_width=kw, tp=self.tp_)
        except Exception as e:
            with self._lock:
                if req in self._prefilling:
                    self._prefilling.remove(req)
            self._retire(req, cache, error=e)
            return
        dt = time.perf_counter() - t0
        self.stats.record_prefill_chunk(clen, dt * 1e3)
        if self._tron:
            tracing.record(req.trace, "prefill_chunk", duration=dt, off=off,
                           tokens=clen)
        req.pf_off = end
        if end >= p_len:
            with self._lock:
                if req in self._prefilling:
                    self._prefilling.remove(req)
            self._finish_admit(req, cache, req.pf_caches, last)

    def _finish_admit(self, req, cache, row_caches, last):
        """Insert the prefilled staging row past the warm shared blocks
        (they are the prefix cache's and already hold these rows) and
        emit the next token."""
        try:
            if self.kv == "paged":
                cache.insert(req.slot, row_caches, len(req.pf_seq),
                             from_block=req.pf_matched)
            else:
                cache.insert(req.slot, row_caches, len(req.pf_seq))
        except Exception as e:
            self._retire(req, cache, error=e)
            return
        if req.export_only:
            # the prefill role's end: copy the blocks and the logits out,
            # park the record, hand the blocks back
            self._retire_export(req, cache, last)
            return
        req.pf_caches = None
        req.pf_seq = None
        self._activate(req, cache, last)

    def _activate(self, req, cache, last):
        """Sample the next token — draw ``len(generated)`` of the
        request's stream, so a resumed stream never forks — and join
        the active decode set."""
        tok = int(first_tokens(last, [req.temperature], [req.top_k],
                               [req.seed],
                               counts=[len(req.generated)])[0])
        self._emit(req, tok)
        if req.t_first is None:   # TTFT is the FIRST first token only
            req.t_first = time.monotonic()
            ttft_ms = (req.t_first - req.t_submit) * 1e3
            self.stats.record_first_token(
                ttft_ms, (req.t_admit - req.t_submit) * 1e3,
                cls=CLASS_NAMES[req.priority])
            if self._tron:
                tracing.record(req.trace, "first_token",
                               ttft_ms=round(ttft_ms, 3))
        with self._lock:
            self._active[req.slot] = req
        self._maybe_finish(req, cache)

    def _admit_import(self, req, cache):
        """Adopt an export record: its blocks scatter raw into the slot's
        leading table blocks (no prefill pass) and the first token
        samples from the exported logits (draw 0 of the stream, as the
        colocated path draws it)."""
        imp = req.kv_import
        try:
            faults.fire("serving.scheduler.kv_import")
            n = cache.blocks_needed(imp["length"])
            ids = [int(b) for b in cache.tables[req.slot, :n]]
            cache.import_blocks(ids, imp["layers"])
        except Exception as e:
            self._retire(req, cache, error=e)
            return
        if self._tron:
            tracing.record(req.trace, "queue",
                           duration=req.t_admit - req.t_submit,
                           cls=CLASS_NAMES[req.priority],
                           tenant=req.tenant,
                           resume=False)
            tracing.record(req.trace, "kv_import", slot=req.slot,
                           tokens=int(imp["length"]), blocks=len(ids))
        last = torch.tensor(numpy.asarray(imp["logits"], numpy.float32)
                               .reshape(1, -1)).to(cache.device)
        self._activate(req, cache, last)

    def _retire_export(self, req, cache, last):
        """Finish a prefill export: copy the slot's blocks (raw) and the
        last-position logits into a handle-addressed record, release the
        slot (its blocks donate to the prefix cache like any finished
        request's) and park the record within ``kv_export_bytes``."""
        p_len = len(req.pf_seq)
        try:
            faults.fire("serving.scheduler.kv_export")
            n = cache.blocks_needed(p_len)
            ids = [int(b) for b in cache.tables[req.slot, :n]]
            handle = mint_handle()
            record = {
                "handle": handle,
                "prompt": list(req.prompt),
                "length": p_len,
                "kv_dtype": self.kv_dtype,
                "block_size": self.block_size,
                "logits": torch.as_tensor(last, dtype=torch.float32)[0]
                .cpu().numpy().copy(),
                "layers": cache.export_blocks(ids),
                "t": time.monotonic(),
            }
        except Exception as e:
            self._retire(req, cache, error=e)
            return
        req.pf_caches = None
        req.pf_seq = None
        with self._lock:
            self._active.pop(req.slot, None)
        self._release_slot(req, cache, finished=True)
        self._sync_kv_gauges(cache)
        now = time.monotonic()
        record["bytes"] = record_nbytes(record)
        with self._lock:
            self._sweep_exports_locked(now)
            capped = 0
            while self._exports and self._exports_bytes \
                    + record["bytes"] > self.kv_export_bytes:
                # the oldest unclaimed record pays for the budget
                oldest = min(self._exports,
                             key=lambda h: self._exports[h]["t"])
                self._exports_bytes -= self._exports[oldest].get("bytes", 0)
                del self._exports[oldest]
                capped += 1
            if capped:
                self.stats.record_kv_export_expired(capped)
            self._exports[handle] = record
            self._exports_bytes += record["bytes"]
            self.stats.set_kv_exports_pending(len(self._exports))
        if self._tron:
            tracing.record(req.trace, "kv_export", tokens=p_len, blocks=n,
                           total_s=round(now - req.t_submit, 6))
        if not req.future.done():
            try:
                req.future.set_result({"handle": handle,
                                       "prompt_tokens": p_len,
                                       "blocks": n})
            except concurrent.futures.InvalidStateError:
                pass

    def _emit(self, req, tok):
        """Accept one token: append it and push it to the request's
        stream in the same boundary (a resumed request re-prefills but
        never re-emits: only newly drawn tokens pass here)."""
        req.generated.append(tok)
        if req.sink is not None:
            req.sink(tok)

    def _step(self, cache):
        with self._lock:
            active = dict(self._active)
        if not active:
            return
        faults.fire("serving.scheduler.step")
        if self.kv == "paged":
            self._step_paged(cache, active)
        else:
            self._step_dense(cache, active)

    def _step_dense(self, cache, active):
        """The dense layout's full-batch step: every slot rides it, free
        ones decoding garbage rows."""
        s = self.max_slots
        toks = numpy.zeros((s, 1), numpy.int32)
        pos = numpy.zeros((s,), numpy.int32)
        temps = numpy.zeros((s,), numpy.float32)
        topks = numpy.zeros((s,), numpy.int32)
        seeds = numpy.zeros((s,), numpy.uint32)
        counts = numpy.zeros((s,), numpy.int32)
        for slot, req in active.items():
            toks[slot, 0] = req.generated[-1]
            pos[slot] = len(req.prompt) + len(req.generated) - 1
            temps[slot] = req.temperature
            topks[slot] = req.top_k
            seeds[slot] = req.seed
            counts[slot] = len(req.generated)
        t0 = time.perf_counter()
        nxt = slot_decode_step(self.forwards, cache, toks, pos, temps,
                               topks, seeds, counts)
        dt = time.perf_counter() - t0
        stamp = time.time()
        n = len(active)
        self.decode_seconds += dt
        self.decode_steps += 1
        self.decode_tokens += n
        self.stats.record_step(n, s, tokens=n, duration_s=dt)
        self._meter_step(active, cache, dt)
        for slot, req in active.items():
            self._emit(req, int(nxt[slot]))
            self._maybe_finish(req, cache)
        if self._tron:
            emitted = {}
            for r in active.values():
                emitted[r.trace] = emitted.get(r.trace, 0) + 1
            tracing.record_step(emitted, duration=dt, mode="decode",
                                slots=n, bucket=s, time=stamp)

    def _step_paged(self, cache, active):
        """Packed step: only the active slots ride the batch, padded to
        a power-of-two occupancy bucket; the attended range is the
        power-of-two block bucket of the deepest request.  With spec on
        and any slot drafting, the step is a verify pass instead."""
        if self.spec:
            drafts, sources = self._draft(active)
            if drafts:
                self._step_verify(cache, active, drafts, sources)
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
        want_h = self._draft_head is not None
        t0 = time.perf_counter()
        got = paged_decode_step(self.forwards, cache, toks, pos, tables,
                                temps, topks, seeds, counts,
                                want_hidden=want_h)
        nxt, hid = got if want_h else (got, None)
        dt = time.perf_counter() - t0
        stamp = time.time()
        self.decode_seconds += dt
        self.decode_steps += 1
        self.decode_tokens += n
        # plain decode: every active slot emits exactly one token
        self.stats.record_step(n, b, tokens=n, duration_s=dt)
        self._meter_step(active, cache, dt)
        for j, slot in enumerate(slots):
            req = active[slot]
            if want_h:
                # the hidden of the position just decoded: the heads
                # read it at the next boundary
                req.hid = hid[j]
            self._emit(req, int(nxt[j]))
            self._maybe_finish(req, cache)
        if self._tron:
            emitted = {}
            for slot in slots:   # rows may share a client's trace id
                tr = active[slot].trace
                emitted[tr] = emitted.get(tr, 0) + 1
            tracing.record_step(emitted, duration=dt, mode="decode",
                                slots=n, bucket=b, time=stamp)

    def _pick_model(self, req):
        """Per-slot drafter arbitration: the model head unless its
        accept-rate EMA has fallen below the n-gram proposer's (an unseen
        drafter scores 1.0, ties go to the model)."""
        em = req.accept_ema.get("model")
        en = req.accept_ema.get("ngram")
        return (1.0 if em is None else em) >= (1.0 if en is None else en)

    def _draft(self, active):
        """Draft tokens per slot: up to its adaptive ``draft_k``, capped
        so accepting every draft and the correction token stays inside
        the request's step budget (so every position written lies in the
        blocks claimed at admission), from its arbitrated source — the
        draft head, batched over every slot with a hidden state, or
        n-gram prompt lookup through the request's index.  Returns
        ``(drafts, sources)``: {slot: tokens} and {slot: "model" |
        "ngram"}."""
        drafts, sources = {}, {}
        model_out = {}
        if self._draft_head is not None:
            rows = [s for s in sorted(active) if active[s].hid is not None]
            if rows:
                out = self._draft_head.propose(
                    torch.stack([active[s].hid for s in rows]))
                for j, slot in enumerate(rows):
                    model_out[slot] = out[j]
        for slot, req in active.items():
            room = req.steps - len(req.generated) - 1
            if room < 1:
                continue
            if req.draft_k < 1:
                req.draft_k = self.spec_k  # start optimistic
            limit = min(req.draft_k, room)
            d = None
            if slot in model_out and self._pick_model(req):
                d = [int(t) for t in model_out[slot][:limit]]
                sources[slot] = "model"
            if not d:
                if req.gram_ix is None:
                    req.gram_ix = NgramIndex(self._proposer.max_ngram,
                                             self._proposer.min_ngram)
                d = self._proposer.propose(
                    list(req.prompt) + list(req.generated), limit,
                    index=req.gram_ix)
                sources[slot] = "ngram"
            if d:
                drafts[slot] = d[:limit]
            else:
                sources.pop(slot, None)
        return drafts, sources

    def _adapt_draft_k(self, req, drafted, accepted, drafter):
        """Blend this verify's accept rate into the slot's EMA for
        ``drafter`` (weight ``draft_ema``), then halve its draft length
        toward ``draft_k_min`` below ``draft_shrink`` or double it toward
        ``spec_k`` above ``draft_grow``; count the drafts by drafter."""
        rate = accepted / drafted
        prev = req.accept_ema.get(drafter)
        ema = rate if prev is None \
            else (1.0 - self.draft_ema) * prev + self.draft_ema * rate
        req.accept_ema[drafter] = ema
        if ema < self.draft_shrink:
            req.draft_k = max(self.draft_k_min, req.draft_k >> 1)
        elif ema > self.draft_grow:
            req.draft_k = min(self.spec_k, req.draft_k << 1)
        self.stats.record_spec(drafted, accepted, drafter=drafter,
                               draft_k=req.draft_k)

    def _step_verify(self, cache, active, drafts, sources):
        """Speculative step: every active slot rides ONE verify pass — its
        pending token then its drafts (padding past ``lens`` goes to the
        trash block; a slot without drafts is a width-1 row).  The width
        is ``k + 1``: ``k = spec_k`` without a draft head; with one, the
        power-of-two bucket of the widest drafting slot's ``draft_k``
        (the ladder: a batch whose drafts shrank stops paying for
        ``spec_k``-wide passes).  The block bucket covers the deepest
        request plus ``k``.  Each slot emits its longest matched prefix
        and the correction sample, stopping early at its stop token or
        its step budget."""
        slots = sorted(active)
        n = len(slots)
        b = _bucket(n, 1, self.max_slots)
        if self._draft_head is not None:
            k = _bucket(max(active[s].draft_k for s in drafts), 1,
                        self.spec_k)
        else:
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
            d = drafts.get(slot, [])[:k]
            toks[j, 0] = req.generated[-1]
            toks[j, 1:1 + len(d)] = d
            pos[j] = len(req.prompt) + len(req.generated) - 1
            lens[j] = 1 + len(d)
            temps[j] = req.temperature
            topks[j] = req.top_k
            seeds[j] = req.seed
            counts[j] = len(req.generated)
        tables[:n] = cache.table_rows(slots, t)
        want_h = self._draft_head is not None
        t0 = time.perf_counter()
        got = verify_step_paged(self.forwards, cache, toks, pos, lens,
                                tables, temps, topks, seeds, counts,
                                fused_verify=self.fused_verify,
                                want_hidden=want_h)
        nxt, hid = got if want_h else (got, None)
        dt = time.perf_counter() - t0
        stamp = time.time()
        self.decode_seconds += dt
        self.verify_steps += 1
        self.verify_widths[k + 1] = self.verify_widths.get(k + 1, 0) + 1
        # metered before acceptance retires finished slots: the pass's
        # residency belongs to every row that rode it
        self._meter_step(active, cache, dt)
        traced = {}
        for j, slot in enumerate(slots):
            req = active[slot]
            d = list(drafts.get(slot, []))[:k]
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
            if want_h and emitted > 0:
                # the hidden of the last position this pass scored and
                # kept: row [j, emitted - 1] predicted the token now
                # pending, so the heads read it next
                req.hid = hid[j, emitted - 1]
            if d:
                self._adapt_draft_k(req, len(d), len(out) - 1,
                                    sources.get(slot, "ngram"))
            traced[req.trace] = traced.get(req.trace, 0) + emitted
            self._maybe_finish(req, cache)
        # recorded after acceptance: goodput counts what the pass emitted
        self.stats.record_step(n, b, tokens=sum(traced.values()),
                               duration_s=dt)
        if self._tron:
            tracing.record_step(traced, duration=dt, mode="verify",
                                slots=n, bucket=b, k=k, time=stamp)

    def _meter_step(self, active, cache, dt):
        """Step-boundary usage attribution: each active request charges
        its tenant KV blocks held × the step's wall time, plus an even
        1/n share of the step as compute seconds.  Sampled here, not at
        retire, so a long stream's residency accrues while it runs and
        a preempted request stops being charged once its blocks go."""
        if not self._metering or not active or dt <= 0:
            return
        share = dt / len(active)
        usage = {}
        for slot, req in active.items():
            if self.kv == "paged":
                blocks = int(cache.n_blocks[slot])
            else:
                blocks = -(-(len(req.prompt) + len(req.generated))
                           // self.block_size)
            rec = usage.setdefault(req.tenant or "anon", [0.0, 0.0])
            rec[0] += blocks * dt
            rec[1] += share
        self.stats.record_tenant_step(usage)

    def _maybe_finish(self, req, cache):
        if len(req.generated) >= req.steps \
                or (req.stop_token is not None
                    and req.generated[-1] == req.stop_token):
            self._retire(req, cache)

    def _retire(self, req, cache, error=None):
        """Leave the decode set and release the slot (a clean finish
        donates to the prefix cache), then settle the future: the
        error, or the tokens unless the watchdog or a cancel failed it
        first."""
        with self._lock:
            self._active.pop(req.slot, None)
        self._release_slot(req, cache, finished=error is None)
        self._sync_kv_gauges(cache)
        if self._metering:
            # failures attribute too: the prefill and decode compute
            # was spent either way
            self.stats.record_tenant_tokens(
                req.tenant, prompt=len(req.prompt),
                generated=len(req.generated))
        if self._tron:
            # an instant at the retire boundary; total_s is the whole
            # submit-to-retire time
            tracing.record(req.trace, "retire", tokens=len(req.generated),
                           total_s=round(time.monotonic() - req.t_submit,
                                         6),
                           preempts=req.preempts,
                           outcome="ok" if error is None
                           else type(error).__name__)
        if error is not None:
            req.fail(error if isinstance(error, SchedulerError)
                     else SchedulerError(repr(error)))
            return
        if req.future.done():
            return
        now = time.monotonic()
        self.completed.append((req.t_first - req.t_submit,
                               now - req.t_submit))
        self.stats.record_complete(
            len(req.generated), now - req.t_submit,
            (req.t_first - req.t_submit) * 1e3,
            (req.t_admit - req.t_submit) * 1e3,
            cls=CLASS_NAMES[req.priority], trace=req.trace)
        try:
            req.future.set_result(list(req.prompt) + req.generated)
        except concurrent.futures.InvalidStateError:
            pass
