"""graftir program registry: the port's own step programs, to audit.

Port of ``pytorch_distributed_tpu/analysis/ir/programs.py``. Each
:class:`StepProgram` is one (strategy x AMP policy) train step of the probe
MLP (flatten 8x8x1, Linear 64->256, ReLU, Linear 256->10: the reference's
``_mlp``), SGD with lr 0.1 and momentum 0.9, on the rank's process group:
the CLI spawns 4 gloo ranks on the CPU, as every multi-rank test of the
port does, and on the card the same functions run on a one-rank NCCL
group. ``hybrid`` runs on ``init_hybrid_mesh((n // 2,), (2,), ("dcn",
"fsdp"))``: at 4 ranks a (2,) x (2,) mesh.

The registry is the seam between the auditor and the trainer stack:
checks read the program's trainer, its declared layout
(``parallel.make_state_specs``, taken before ``Trainer.init`` cuts the
parameters) and the step's recorded collectives, never the trainer's
internals.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "ProbeMLP",
    "StepProgram",
    "FAST_GRID",
    "FULL_GRID",
    "MIN_SHARD_SIZE",
    "host_batch",
    "build_program",
    "build_grid",
]

#: tier-1 subset: the two strategies whose comm budgets bracket the
#: pure-DP path (replicated update vs ZeRO1 sharded update)
FAST_GRID: Tuple[Tuple[str, str], ...] = (
    ("dp", "fp32"),
    ("dp", "fp16"),
    ("zero1", "fp32"),
    ("zero1", "fp16"),
)

#: the full strategy x AMP grid
FULL_GRID: Tuple[Tuple[str, str], ...] = FAST_GRID + (
    ("fsdp", "fp32"),
    ("fsdp", "fp16"),
    ("hybrid", "fp32"),
    ("hybrid", "fp16"),
)

#: params below this element count stay whole (keeps the probe's Linear
#: weights sharded while the 10-wide head bias falls back to whole where
#: the axis does not divide it: the ``indivisible`` branch)
MIN_SHARD_SIZE = 8


class ProbeMLP(nn.Module):
    """The reference's probe MLP with flax's names (``Dense_0``,
    ``Dense_1``), computing in ``dtype`` over fp32 parameters. The weights
    are a seeded numpy draw (flax's Dense init: lecun-normal kernels, zero
    biases); the tests load flax's own."""

    def __init__(self, dtype=torch.float32, device=None, seed: int = 0):
        super().__init__()
        self.Dense_0 = nn.Linear(64, 256, device=device)
        self.Dense_1 = nn.Linear(256, 10, device=device)
        self.dtype = dtype
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for lin in (self.Dense_0, self.Dense_1):
                w = rng.standard_normal(lin.weight.shape) / np.sqrt(
                    lin.in_features)
                lin.weight.copy_(torch.from_numpy(w.astype(np.float32)))
                lin.bias.zero_()

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        h = self.Dense_0
        x = F.relu(F.linear(x, h.weight.to(self.dtype),
                            h.bias.to(self.dtype)))
        out = self.Dense_1
        return F.linear(x, out.weight.to(self.dtype), out.bias.to(self.dtype))


def host_batch(batch_size: int):
    """The reference's ``_host_batch``: a seed-0 numpy draw of images and
    labels."""
    rng = np.random.default_rng(0)
    return (
        rng.normal(size=(batch_size, 8, 8, 1)).astype(np.float32),
        rng.integers(0, 10, (batch_size,)).astype(np.int32),
    )


@dataclasses.dataclass
class StepProgram:
    """One auditable (strategy x AMP) train step on this rank.

    ``declared`` is ``make_state_specs``'s layout and ``shapes`` the whole
    parameters' torch shapes, both read before ``Trainer.init`` cut them.
    """

    name: str
    strategy_name: str
    amp: str
    trainer: object
    state: object
    batch: tuple
    declared: Dict
    shapes: Dict[str, Tuple[int, ...]]

    @property
    def strategy(self):
        return self.trainer.strategy

    def param_bytes(self) -> int:
        """fp32 bytes of the whole parameters: what a gradient reduction
        moves (the strategies reduce in fp32)."""
        return sum(int(np.prod(s)) * 4 for s in self.shapes.values())


def _build_mesh(strategy_name: str):
    from pytorch_distributed_tpu_torch import distributed as pdist
    from pytorch_distributed_tpu_torch.mesh import (
        init_device_mesh,
        init_hybrid_mesh,
    )

    n = pdist.get_world_size()
    if strategy_name in ("dp", "zero1"):
        return init_device_mesh((n,), ("dp",))
    if strategy_name == "fsdp":
        return init_device_mesh((n,), ("fsdp",))
    if strategy_name == "hybrid":
        if n % 2:
            raise RuntimeError(
                f"hybrid audit mesh needs an even rank count, have {n}")
        return init_hybrid_mesh((n // 2,), (2,), ("dcn", "fsdp"))
    raise ValueError(f"unknown strategy {strategy_name!r}")


def _build_strategy(strategy_name: str, mesh):
    from pytorch_distributed_tpu_torch.parallel import (
        DataParallel,
        FullyShardedDataParallel,
        HybridShard,
        ZeRO1,
    )

    if strategy_name == "dp":
        return DataParallel(mesh)
    if strategy_name == "zero1":
        return ZeRO1(mesh, min_shard_size=MIN_SHARD_SIZE)
    if strategy_name == "fsdp":
        return FullyShardedDataParallel(mesh, min_shard_size=MIN_SHARD_SIZE)
    if strategy_name == "hybrid":
        return HybridShard(mesh, min_shard_size=MIN_SHARD_SIZE)
    raise ValueError(f"unknown strategy {strategy_name!r}")


def build_program(strategy_name: str, amp: str = "fp32", *,
                  state_dict: Optional[Dict[str, torch.Tensor]] = None,
                  batch_size: Optional[int] = None) -> StepProgram:
    """The step of ``strategy_name`` under ``amp`` on the current process
    group (every rank calls it, in the same order): the probe MLP (its
    weights ``state_dict`` where given), SGD(0.1, momentum 0.9), the
    batch ``host_batch(2 x world)``."""
    from pytorch_distributed_tpu_torch.parallel import make_state_specs
    from pytorch_distributed_tpu_torch.trainer import (
        Trainer,
        classification_loss,
    )

    mesh = _build_mesh(strategy_name)
    strategy = _build_strategy(strategy_name, mesh)
    if batch_size is None:
        batch_size = 2 * len(mesh.ranks)
    dtype = torch.float16 if amp == "fp16" else torch.float32
    model = ProbeMLP(dtype=dtype, device=strategy.device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    trainer = Trainer(model, opt, strategy, loss_fn=classification_loss,
                      policy=amp)
    declared = make_state_specs(model, opt, strategy)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    state = trainer.init()
    return StepProgram(
        name=f"{strategy_name}:{amp}",
        strategy_name=strategy_name,
        amp=amp,
        trainer=trainer,
        state=state,
        batch=host_batch(batch_size),
        declared=declared,
        shapes=shapes,
    )


def build_grid(grid: str = "fast") -> List[StepProgram]:
    entries = {"fast": FAST_GRID, "full": FULL_GRID}.get(grid)
    if entries is None:
        raise ValueError(f"unknown grid {grid!r} (expected fast|full)")
    return [build_program(s, amp) for s, amp in entries]
