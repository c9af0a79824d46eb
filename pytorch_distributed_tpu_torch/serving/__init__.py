"""Serving: slotted and paged KV caches, inference engine, continuous
batching scheduler, speculative decoding."""

from pytorch_distributed_tpu_torch.serving.engine import (  # noqa: F401
    InferenceEngine,
    SamplingParams,
    SwapCost,
    sample_tokens,
)
from pytorch_distributed_tpu_torch.serving.kv_cache import KVCache  # noqa: F401
from pytorch_distributed_tpu_torch.serving.paging import PagedKVCache  # noqa: F401
from pytorch_distributed_tpu_torch.serving.scheduler import (  # noqa: F401
    FinishedRequest,
    Request,
    Scheduler,
)
from pytorch_distributed_tpu_torch.serving.speculative import (  # noqa: F401
    DraftConfig,
    greedy_accept,
    rejection_accept,
)

__all__ = [
    "DraftConfig",
    "FinishedRequest",
    "InferenceEngine",
    "KVCache",
    "PagedKVCache",
    "Request",
    "SamplingParams",
    "Scheduler",
    "SwapCost",
    "greedy_accept",
    "rejection_accept",
    "sample_tokens",
]
