"""Placement strategies, the train state and context parallelism.

``NoShard`` (one card holds the whole model), ``DataParallel`` and
``CPStrategy`` (replicas over a mesh axis), and the strategies that shard:
``FullyShardedDataParallel`` and ``HybridShard`` (the parameters held as
shards, ``parallel.fsdp``) and ``ZeRO1`` (the optimizer state and the
update as shards); the sharded weight update is
``parallel.sharded_update``, the placement rule
``shard_spec_with_reason``. Ring and Ulysses attention are in
``parallel.context_parallel``. The gradient communication hooks
(``comm_hooks``: allreduce, bf16/fp16 compression, bucketed
reduce-scatter, ring all-reduce; ``powersgd.PowerSGD``) and model
averaging (``averagers``) run on the data-parallel group. Tensor and
sequence parallelism (``TensorParallel`` and its styles; TP x DP and TP x
FSDP) is ``parallel.tensor_parallel``; expert parallelism (the MoE layer,
``ExpertParallel``, ``ExpertDataParallel``) ``parallel.expert``;
pipeline parallelism (``gpipe_spmd``, ``PipelineParallel`` and
``GPT2Pipe``, the eager executor and its schedules) ``parallel.pipeline``,
over the stage links of ``parallel.stage_links``.
"""

from pytorch_distributed_tpu_torch.parallel.averagers import (
    EMAAverager,
    PeriodicModelAverager,
    average_parameters,
)
from pytorch_distributed_tpu_torch.parallel.comm_hooks import (
    allreduce_hook,
    bf16_compress,
    fp16_compress,
    get_comm_hook,
    make_bucketed_rs_hook,
    make_ring_allreduce_hook,
    reduce_scatter_hook,
    ring_allreduce_hook,
)
from pytorch_distributed_tpu_torch.parallel.context_parallel import (
    make_ring_attention,
    make_ulysses_attention,
    ring_attention,
    ulysses_attention,
    zigzag_reorder,
    zigzag_restore,
)
from pytorch_distributed_tpu_torch.parallel.expert import (
    ExpertDataParallel,
    ExpertParallel,
    MoEMLP,
    make_dispatch_masks,
)
from pytorch_distributed_tpu_torch.parallel.pipeline import (
    EagerPipelineExecutor,
    GPT2Pipe,
    PipelineParallel,
    Schedule1F1B,
    ScheduleDualPipeV,
    ScheduleGPipe,
    ScheduleInterleaved1F1B,
    ScheduleInterleavedZeroBubble,
    ScheduleLoopedBFS,
    ScheduleZBVZeroBubble,
    ScheduleZeroBubble,
    gpipe_spmd,
    stack_stage_params,
)
from pytorch_distributed_tpu_torch.parallel.powersgd import PowerSGD
from pytorch_distributed_tpu_torch.parallel.state import (
    TrainState,
    make_state_specs,
)
from pytorch_distributed_tpu_torch.parallel.tensor_parallel import (
    ColwiseParallel,
    ParallelStyle,
    Replicated,
    RowwiseParallel,
    SequenceParallel,
    TensorParallel,
    gpt2_tp_plan,
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
    "EagerPipelineExecutor",
    "GPT2Pipe",
    "PipelineParallel",
    "Schedule1F1B",
    "ScheduleDualPipeV",
    "ScheduleGPipe",
    "ScheduleInterleaved1F1B",
    "ScheduleInterleavedZeroBubble",
    "ScheduleLoopedBFS",
    "ScheduleZBVZeroBubble",
    "ScheduleZeroBubble",
    "gpipe_spmd",
    "stack_stage_params",
    "ExpertDataParallel",
    "ExpertParallel",
    "MoEMLP",
    "make_dispatch_masks",
    "ColwiseParallel",
    "ParallelStyle",
    "Replicated",
    "RowwiseParallel",
    "SequenceParallel",
    "TensorParallel",
    "gpt2_tp_plan",
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
    "EMAAverager",
    "PeriodicModelAverager",
    "PowerSGD",
    "allreduce_hook",
    "average_parameters",
    "bf16_compress",
    "fp16_compress",
    "get_comm_hook",
    "make_bucketed_rs_hook",
    "make_ring_allreduce_hook",
    "reduce_scatter_hook",
    "ring_allreduce_hook",
]
