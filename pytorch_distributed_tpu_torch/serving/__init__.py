"""Serving: slotted and paged KV caches, inference engine, continuous
batching scheduler, speculative decoding, and the tensor-parallel serving
layout (``sharding``: the mesh, the weights' and the caches' placements,
``load_gpt2_params``), and multihost serving (``multihost``: a router over
one scheduler a host)."""

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
from pytorch_distributed_tpu_torch.serving.multihost import (  # noqa: F401
    HostWorker,
    Keys,
    Router,
)
from pytorch_distributed_tpu_torch.serving.sharding import (  # noqa: F401
    CacheSharding,
    draft_param_shardings,
    gpt2_param_shardings,
    kv_cache_sharding,
    load_gpt2_params,
    paged_kv_cache_sharding,
    reshard_gpt2_params,
    serving_mesh,
    shard_gpt2_params,
)
from pytorch_distributed_tpu_torch.serving.speculative import (  # noqa: F401
    DraftConfig,
    greedy_accept,
    rejection_accept,
)

__all__ = [
    "CacheSharding",
    "DraftConfig",
    "FinishedRequest",
    "HostWorker",
    "InferenceEngine",
    "KVCache",
    "Keys",
    "PagedKVCache",
    "Request",
    "Router",
    "SamplingParams",
    "Scheduler",
    "SwapCost",
    "draft_param_shardings",
    "gpt2_param_shardings",
    "greedy_accept",
    "kv_cache_sharding",
    "load_gpt2_params",
    "paged_kv_cache_sharding",
    "rejection_accept",
    "reshard_gpt2_params",
    "sample_tokens",
    "serving_mesh",
    "shard_gpt2_params",
]
