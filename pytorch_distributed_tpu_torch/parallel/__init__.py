"""Placement strategies, the train state and context parallelism.

``NoShard`` (one card holds the whole model), ``DataParallel`` and
``CPStrategy`` (replicas over a mesh axis), and the strategies that shard:
``FullyShardedDataParallel`` and ``HybridShard`` (the parameters held as
shards, ``parallel.fsdp``) and ``ZeRO1`` (the optimizer state and the
update as shards); the sharded weight update is
``parallel.sharded_update``, the placement rule
``shard_spec_with_reason``. Ring and Ulysses attention are in
``parallel.context_parallel``.
"""

from pytorch_distributed_tpu_torch.parallel.context_parallel import (
    make_ring_attention,
    make_ulysses_attention,
    ring_attention,
    ulysses_attention,
    zigzag_reorder,
    zigzag_restore,
)
from pytorch_distributed_tpu_torch.parallel.state import (
    TrainState,
    make_state_specs,
)
from pytorch_distributed_tpu_torch.parallel.strategies import (
    SHARD_REASONS,
    CPStrategy,
    DataParallel,
    FullyShardedDataParallel,
    HybridShard,
    NoShard,
    ShardingStrategy,
    ZeRO1,
    shard_spec_with_reason,
)

__all__ = [
    "SHARD_REASONS",
    "CPStrategy",
    "DataParallel",
    "FullyShardedDataParallel",
    "HybridShard",
    "NoShard",
    "ShardingStrategy",
    "TrainState",
    "ZeRO1",
    "make_state_specs",
    "shard_spec_with_reason",
    "make_ring_attention",
    "make_ulysses_attention",
    "ring_attention",
    "ulysses_attention",
    "zigzag_reorder",
    "zigzag_restore",
]
