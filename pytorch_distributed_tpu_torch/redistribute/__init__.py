"""Any-mesh <-> any-mesh redistribution over ``torch.distributed``.

Port of ``pytorch_distributed_tpu/redistribute``: one planner for every
(mesh, spec) -> (mesh', spec') transfer of the port: live weights onto the
serving layout (``serving.reshard_gpt2_params``), a live training state
onto a resized world (``elastic.reshard_state``), and weight swaps while
serving (``InferenceEngine.swap_params``, the multihost push). The planner
lowers each leaf into one all-gather / all-to-all / dynamic-slice /
device_put step with a cost model (bytes moved, peak live bytes per rank)
against the naive gather-then-slice (the memory-efficient array
redistribution problem of arXiv 2112.01075); the executor runs it on every
rank with the collectives or point-to-point pieces it names, and counts
the bytes it really sent.

Public surface:
  Sharding                    -- a mesh and the axes of each dim
  Placed                      -- a rank's block (or None) and its sharding
  plan_transfer / plan_tree   -- pure planning; no collective
  execute_plan / redistribute / redistribute_tree -- execution, between
                                 steps (the reference's ``apply_in_jit`` and
                                 ``donated_update_jit`` have no counterpart:
                                 see ``executor``)
"""

from pytorch_distributed_tpu_torch.redistribute.plan import (  # noqa: F401
    OPS,
    LeafPlan,
    Sharding,
    TransferCost,
    TransferStep,
    TreePlan,
    plan_transfer,
    plan_tree,
)
from pytorch_distributed_tpu_torch.redistribute.executor import (  # noqa: F401
    Placed,
    execute_plan,
    redistribute,
    redistribute_tree,
)

__all__ = [
    "Sharding",
    "Placed",
    "TransferStep",
    "TransferCost",
    "LeafPlan",
    "TreePlan",
    "plan_transfer",
    "plan_tree",
    "execute_plan",
    "redistribute",
    "redistribute_tree",
]
