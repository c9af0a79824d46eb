"""Placement strategies, the train state and context parallelism.

``NoShard`` (one card holds the whole model), ``DataParallel`` and
``CPStrategy`` (replicas over a mesh axis); ring and Ulysses attention are
in ``parallel.context_parallel``. The parameter-sharding strategies (FSDP,
ZeRO1, hybrid) are ROADMAP A.11.
"""

from pytorch_distributed_tpu_torch.parallel.context_parallel import (
    make_ring_attention,
    make_ulysses_attention,
    ring_attention,
    ulysses_attention,
    zigzag_reorder,
    zigzag_restore,
)
from pytorch_distributed_tpu_torch.parallel.state import TrainState
from pytorch_distributed_tpu_torch.parallel.strategies import (
    CPStrategy,
    DataParallel,
    NoShard,
    ShardingStrategy,
)

__all__ = [
    "CPStrategy",
    "DataParallel",
    "NoShard",
    "ShardingStrategy",
    "TrainState",
    "make_ring_attention",
    "make_ulysses_attention",
    "ring_attention",
    "ulysses_attention",
    "zigzag_reorder",
    "zigzag_restore",
]
