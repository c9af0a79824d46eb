"""graftir inventory: the collectives a step issued, from ``parallel.comm``'s
record.

Counterpart of ``pytorch_distributed_tpu/analysis/ir/hlo.py``. The
reference parses its compiled step's optimized HLO for the collective
instructions XLA placed; the port issues every collective of a step itself,
through ``parallel.comm``, which records each call (``comm.calls`` since
``reset_counts``, or a ``comm.recording()`` block's). A step's inventory is
that record, in the reference's terms:

* the families keep the HLO names: ``all-reduce``, ``all-gather``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute`` (a
  point-to-point exchange: one per tensor received; what a rank sends is
  its peer's receipt), and ``broadcast``, which XLA has no instruction
  for (a step issues none unless a pipeline shares its last stage's
  metrics);
* the bytes are the tensor the HLO result holds, which do not depend on
  the group's size: the tensor reduced, the whole gathered tensor, the
  tensor received; a reduce-scatter counts the whole tensor it reduces,
  which is what the reference's CPU pipeline (it lowers a reduce-scatter
  as an all-reduce of the whole) records;
* ``scalar`` ops (one element: a loss or metric reduction) are kept apart
  from ``tensor`` traffic, so they never mask its regressions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "CollectiveOp",
    "COLLECTIVE_FAMILIES",
    "REDUCE_FAMILIES",
    "GATHER_FAMILIES",
    "collective_inventory",
    "summarize_collectives",
]

#: the families the auditor inventories
COLLECTIVE_FAMILIES = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
    "broadcast",
)

#: families implementing a gradient reduction
REDUCE_FAMILIES = frozenset({"all-reduce", "reduce-scatter"})

#: families implementing a parameter/activation gather
GATHER_FAMILIES = frozenset({"all-gather"})

#: ``parallel.comm`` call name -> family (``send`` and ``barrier`` carry
#: no result of their own)
_FAMILY = {
    "all_reduce": "all-reduce",
    "all_gather": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "all_to_all": "all-to-all",
    "recv": "collective-permute",
    "broadcast": "broadcast",
}


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective call of a step."""

    family: str          # "all-reduce", ... (see COLLECTIVE_FAMILIES)
    dtype: str           # element type, "float32", ...
    shape: Tuple[int, ...]
    bytes: int           # the result's bytes (see the module docstring)
    scalar: bool         # one element: a loss/metric reduction
    group_size: int = 1  # ranks of the group it ran on

    def describe(self) -> str:
        dims = ",".join(map(str, self.shape))
        return f"{self.family} {self.dtype}[{dims}] ({self.bytes} B)"


def _group_size(group) -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def collective_inventory(calls: Optional[Sequence] = None
                         ) -> List[CollectiveOp]:
    """Every collective of ``calls`` (``parallel.comm.Call`` records;
    default: ``comm.calls``, the calls since ``comm.reset_counts``) as
    :class:`CollectiveOp` records, in order. Raises where ``comm.calls``
    dropped calls past its limit: the inventory would be short."""
    from pytorch_distributed_tpu_torch.parallel import comm

    if calls is None:
        if comm.calls_dropped:
            raise ValueError(
                f"comm.calls dropped {comm.calls_dropped} calls past its "
                f"limit: reset_counts() before the step audited")
        calls = comm.calls
    ops: List[CollectiveOp] = []
    for call in calls:
        family = _FAMILY.get(call.name)
        if family is None:
            continue
        numel = 1
        for d in call.shape:
            numel *= d
        ops.append(CollectiveOp(
            family=family,
            dtype=str(call.dtype).removeprefix("torch."),
            shape=tuple(call.shape),
            bytes=call.nbytes,
            scalar=numel == 1,
            group_size=_group_size(call.group),
        ))
    return ops


def summarize_collectives(ops: Sequence[CollectiveOp]) -> Dict[str, Dict]:
    """``{"tensor": {family: {count, bytes}}, "scalar": {...}}``: the
    budget entry's form (the reference's)."""
    out: Dict[str, Dict] = {"tensor": {}, "scalar": {}}
    for op in ops:
        grade = "scalar" if op.scalar else "tensor"
        row = out[grade].setdefault(op.family, {"count": 0, "bytes": 0})
        row["count"] += 1
        row["bytes"] += op.bytes
    return out
