"""Serving of the LM chain: the paged and dense KV caches, prefill,
the decode and verify steps, the n-gram draft proposer and the Medusa
draft heads, the radix prefix cache and its host-RAM tier, the KV
handoff wire of disaggregated serving, the KV and weight quality gates,
token streams, the embed/score computations and the continuous-batching
scheduler with its request lifecycle and its serving metrics.  The HTTP server in front of it is
:mod:`veles_tpu_torch.restful_api`; the OpenAI facade's parsing and
reply shaping live in :mod:`~veles_tpu_torch.serving.openai_api`.  The
fleet tier over several such servers is the health-aware
:class:`~veles_tpu_torch.serving.router.Router`, the replica supervisor
:class:`~veles_tpu_torch.serving.fleet.Fleet` and the control plane
:class:`~veles_tpu_torch.serving.controller.FleetController`."""

from veles_tpu_torch.serving.disagg import (  # noqa: F401
    decode_export, decode_export_binary, encode_export,
    encode_export_binary)
from veles_tpu_torch.serving.draft import (  # noqa: F401
    MedusaDraftHead, draft_supported)
from veles_tpu_torch.serving.engine import (  # noqa: F401
    first_tokens, hidden_supported, paged_decode_logits, paged_decode_step,
    sample_first, sample_slots, slot_decode_step, verify_logits,
    verify_step_paged, verify_supported)
from veles_tpu_torch.serving.kv_host import HostKVTier  # noqa: F401
from veles_tpu_torch.serving.kv_quality import (  # noqa: F401
    kv_quant_quality, weight_quant_quality)
from veles_tpu_torch.serving.kv_slots import (  # noqa: F401
    PagedKVCache, SlotKVCache, paged_supported)
from veles_tpu_torch.serving.metrics import (  # noqa: F401
    RouterMetrics, ServingMetrics)
from veles_tpu_torch.serving.prefill import (  # noqa: F401
    chunked_supported, prefill, prefill_chunk, serving_supported,
    serving_window)
from veles_tpu_torch.serving.prefix_cache import (  # noqa: F401
    MatchHandle, RadixPrefixCache, chunk_digests)
from veles_tpu_torch.serving.scheduler import (  # noqa: F401
    CLASS_NAMES, PRIORITIES, DeadlineExceededError, DrainingError,
    InferenceScheduler, QueueFullError, RequestCancelledError,
    RoleMismatchError, SchedulerError, resolve_priority)
from veles_tpu_torch.serving.spec import (  # noqa: F401
    NgramIndex, NgramProposer, accept_drafts)
from veles_tpu_torch.serving.tp import per_chip_bytes  # noqa: F401
from veles_tpu_torch.serving.streams import (  # noqa: F401
    SSE_DONE, StreamTimeoutError, TokenStream, sse_event)
from veles_tpu_torch.serving.fleet import (  # noqa: F401
    Fleet, LocalReplica, SubprocessReplica, free_port)
from veles_tpu_torch.serving.router import Router  # noqa: F401
from veles_tpu_torch.serving import openai_api  # noqa: F401
