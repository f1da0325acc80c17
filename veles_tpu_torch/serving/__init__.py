"""Serving of the LM chain: the paged and dense KV caches, prefill,
the decode and verify steps, the n-gram draft proposer, the radix
prefix cache, token streams, the embed/score computations and the
continuous-batching scheduler with its request lifecycle and its
serving metrics.  The HTTP server in front of it is
:mod:`veles_tpu_torch.restful_api`; the OpenAI facade's parsing and
reply shaping live in :mod:`~veles_tpu_torch.serving.openai_api`."""

from veles_tpu_torch.serving.engine import (  # noqa: F401
    first_tokens, paged_decode_logits, paged_decode_step, sample_first,
    sample_slots, slot_decode_step, verify_logits, verify_step_paged,
    verify_supported)
from veles_tpu_torch.serving.kv_slots import (  # noqa: F401
    PagedKVCache, SlotKVCache, paged_supported)
from veles_tpu_torch.serving.metrics import ServingMetrics  # noqa: F401
from veles_tpu_torch.serving.prefill import (  # noqa: F401
    chunked_supported, prefill, prefill_chunk, serving_supported,
    serving_window)
from veles_tpu_torch.serving.prefix_cache import (  # noqa: F401
    MatchHandle, RadixPrefixCache, chunk_digests)
from veles_tpu_torch.serving.scheduler import (  # noqa: F401
    CLASS_NAMES, PRIORITIES, DeadlineExceededError, DrainingError,
    InferenceScheduler, QueueFullError, RequestCancelledError,
    SchedulerError, resolve_priority)
from veles_tpu_torch.serving.spec import (  # noqa: F401
    NgramIndex, NgramProposer, accept_drafts)
from veles_tpu_torch.serving.streams import (  # noqa: F401
    SSE_DONE, StreamTimeoutError, TokenStream, sse_event)
from veles_tpu_torch.serving import openai_api  # noqa: F401
