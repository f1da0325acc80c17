"""Paged-KV serving of the LM chain: cache, prefill, decode and verify
steps, the n-gram draft proposer and the continuous-batching
scheduler."""

from veles_tpu_torch.serving.engine import (  # noqa: F401
    first_tokens, paged_decode_logits, paged_decode_step, sample_first,
    sample_slots, verify_logits, verify_step_paged, verify_supported)
from veles_tpu_torch.serving.kv_slots import (  # noqa: F401
    PagedKVCache, paged_supported)
from veles_tpu_torch.serving.prefill import (  # noqa: F401
    chunked_supported, prefill, prefill_chunk, serving_supported,
    serving_window)
from veles_tpu_torch.serving.scheduler import (  # noqa: F401
    InferenceScheduler, QueueFullError, SchedulerError)
from veles_tpu_torch.serving.spec import (  # noqa: F401
    NgramIndex, NgramProposer, accept_drafts)
