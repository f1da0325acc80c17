"""Paged-KV serving of the LM chain: cache, prefill, decode step and
the continuous-batching scheduler."""

from veles_tpu_torch.serving.engine import (  # noqa: F401
    first_tokens, paged_decode_logits, paged_decode_step, sample_first,
    sample_slots)
from veles_tpu_torch.serving.kv_slots import (  # noqa: F401
    PagedKVCache, paged_supported)
from veles_tpu_torch.serving.prefill import (  # noqa: F401
    chunked_supported, prefill, prefill_chunk, serving_supported,
    serving_window)
from veles_tpu_torch.serving.scheduler import (  # noqa: F401
    InferenceScheduler, QueueFullError, SchedulerError)
