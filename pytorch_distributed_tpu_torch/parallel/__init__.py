"""Placement strategies and the train state of the port.

Only ``NoShard`` exists so far: one card holds the whole model. The
sharding strategies (DataParallel, FSDP, ZeRO1, hybrid) are ROADMAP A.4 and
A.11.
"""

from pytorch_distributed_tpu_torch.parallel.state import TrainState
from pytorch_distributed_tpu_torch.parallel.strategies import (
    NoShard,
    ShardingStrategy,
)

__all__ = ["NoShard", "ShardingStrategy", "TrainState"]
