"""What the harness takes from the program (``pytorch_distributed_tpu_torch``):
its process group, strategies, optimizers' state and runner. The port is
imported inside the functions, so that the harness's own modules import
without it (the CPU tests, and a checkout that holds only the benchmark).
"""

from __future__ import annotations

from typing import Dict

import torch


def init_group(rank: int, world: int, store, device: torch.device) -> None:
    """The port's default process group (NCCL on the card) over ``store``."""
    from pytorch_distributed_tpu_torch import distributed as pdist

    pdist.init_process_group(store=store, rank=rank, world_size=world,
                             device=device)


def destroy_group() -> None:
    from pytorch_distributed_tpu_torch import distributed as pdist

    if pdist.is_initialized():
        pdist.destroy_process_group()


def strategy(device: torch.device, world: int):
    """``NoShard`` on one chip; ``DataParallel`` over a ``("dp",)`` mesh of
    every rank otherwise (BatchNorm over the dp group)."""
    from pytorch_distributed_tpu_torch.parallel import DataParallel, NoShard

    if world == 1:
        return NoShard(device)
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh

    return DataParallel(init_device_mesh((world,), ("dp",)))


def local_batch(batch, world: int):
    """A rank's own rows as the strategy takes them (``LocalBatch`` under
    a dp split, the plain tuple on one chip)."""
    if world == 1:
        return tuple(batch)
    from pytorch_distributed_tpu_torch.data import LocalBatch

    return LocalBatch(tuple(batch))


@torch.no_grad()
def load_params(model: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's weights into ``model`` by name; every
    parameter must be given, at its shape."""
    named = dict(model.named_parameters())
    if set(named) != set(params):
        raise ValueError(
            f"weights and model differ: missing {sorted(set(named) - set(params))[:5]}"
            f", extra {sorted(set(params) - set(named))[:5]}")
    for n, p in named.items():
        if p.shape != params[n].shape:
            raise ValueError(f"{n}: model {tuple(p.shape)}, weights "
                             f"{tuple(params[n].shape)}")
        p.copy_(params[n])


def optimizer(model: torch.nn.Module, spec: dict) -> torch.optim.Optimizer:
    """The torch optimizer a configuration's ``optimizer`` entry names."""
    if spec["name"] == "AdamW":
        return torch.optim.AdamW(model.parameters(), lr=spec["lr"],
                                 weight_decay=spec["weight_decay"],
                                 betas=tuple(spec["betas"]), eps=spec["eps"])
    if spec["name"] == "SGD":
        return torch.optim.SGD(model.parameters(), lr=spec["lr"],
                               momentum=spec["momentum"])
    raise ValueError(f"optimizer {spec['name']!r}")


@torch.no_grad()
def first_grad(trainer, spec: dict) -> Dict[str, torch.Tensor]:
    """The gradient the optimizer got at its first step, read back from its
    state: AdamW's first moment over ``1 - beta1``, SGD's momentum buffer
    (zero before the step, so the gradient itself)."""
    opt = trainer.optimizer
    out = {}
    for n, p in trainer.model.named_parameters():
        st = opt.state[p]
        if spec["name"] == "AdamW":
            out[n] = st["exp_avg"] / (1 - spec["betas"][0])
        else:
            out[n] = st["momentum_buffer"]
    return out


def params_now(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p.detach() for n, p in model.named_parameters()}


def runner(trainer, cell: dict):
    from pytorch_distributed_tpu_torch.pipeline_exec import AsyncRunner

    return AsyncRunner(trainer, depth=cell["depth"],
                       drain_every=cell["drain_every"])
