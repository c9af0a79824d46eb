"""Serving: slotted and paged KV caches, inference engine, continuous
batching scheduler."""

from pytorch_distributed_tpu_torch.serving.engine import (  # noqa: F401
    InferenceEngine,
    SamplingParams,
    sample_tokens,
)
from pytorch_distributed_tpu_torch.serving.kv_cache import KVCache  # noqa: F401
from pytorch_distributed_tpu_torch.serving.paging import PagedKVCache  # noqa: F401
from pytorch_distributed_tpu_torch.serving.scheduler import (  # noqa: F401
    FinishedRequest,
    Request,
    Scheduler,
)

__all__ = [
    "FinishedRequest",
    "InferenceEngine",
    "KVCache",
    "PagedKVCache",
    "Request",
    "SamplingParams",
    "Scheduler",
    "sample_tokens",
]
