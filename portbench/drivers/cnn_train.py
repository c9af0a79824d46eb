"""ResNet training through the port's ``Trainer``.

The model is ``models.resnet50`` (ResNet v1.5 over NHWC images) in the
configuration's compute dtype (bf16 on the card: the ``bf16`` policy,
fp32 parameters and BatchNorm statistics), trained by SGD with momentum.
The feed is a ring of ``ring`` distinct batches a rank, made on the
device from the seed (images normal(0, 1), labels uniform over the
classes), replayed in order: the data layer is bypassed. On more than one
rank the strategy is ``DataParallel`` over ``("dp",)``: each rank trains on
its own rows, BatchNorm takes the statistics of the whole global batch
and the gradients are averaged over the ranks.
"""

from __future__ import annotations

import itertools

import torch

from portbench import generate, program
from portbench.reference import common, resnet as ref

WORK = "images"
specs = ref.param_specs
views = ref.views


def work_per_step(cell: dict) -> int:
    return cell["batch"]


def ring_batch(cfg: dict, cell: dict, seed: int, device: torch.device,
               rank: int, i: int):
    g = generate.generator(device, seed, generate.IMAGES, rank, i)
    size = cfg["image_size"]
    images = torch.randn((cell["batch"], size, size, 3), generator=g,
                         device=device)
    labels = torch.randint(0, cfg["num_classes"], (cell["batch"],),
                           generator=g, device=device, dtype=torch.int32)
    return images, labels


def build(cfg: dict, cell: dict, seed: int, device: torch.device,
          world: int, rank: int):
    """``(trainer, feed)``: the port's trainer holding the benchmark's
    weights, and the endless stream of batches the runner is fed."""
    from pytorch_distributed_tpu_torch.models import resnet50
    from pytorch_distributed_tpu_torch.trainer import Trainer, classification_loss

    if cfg["layers"] != [3, 4, 6, 3]:
        raise ValueError("the port's resnet50 has the layers [3, 4, 6, 3]")
    on_card = device.type == "cuda"
    if on_card:
        torch.backends.cudnn.benchmark = True
    model = resnet50(num_classes=cfg["num_classes"],
                     num_filters=cfg["width"],
                     dtype=getattr(torch, cfg["compute_dtype"]) if on_card
                     else torch.float32, device=device)
    program.load_params(model, generate.make_params(specs(cfg), seed, device))
    trainer = Trainer(model, program.optimizer(model, cfg["optimizer"]),
                      program.strategy(device, world),
                      loss_fn=classification_loss,
                      policy=cfg["policy"] if on_card else "fp32")
    ring = [program.local_batch(ring_batch(cfg, cell, seed, device, rank, i),
                                world) for i in range(cell["ring"])]
    return trainer, itertools.cycle(ring)


def reference_batches(cfg: dict, cell: dict, seed: int, device: torch.device,
                      rank: int, n: int):
    return [ring_batch(cfg, cell, seed, device, rank, i) for i in range(n)]


def reference(cfg: dict, cell: dict, params0, batches, precision: str = "fp32",
              keep=None, group=None) -> dict:
    """The plain reference's reading over ``batches`` from ``params0`` (with
    ``group``: BatchNorm's sums and the gradients over its ranks)."""
    with common.exact_fp32():
        f = ref.loss_and_grads(cfg, common.Precision(precision), group)
        return common.train(f, params0, batches,
                            common.optimizer(cfg["optimizer"]), views, keep)
