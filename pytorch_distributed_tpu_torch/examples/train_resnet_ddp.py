"""DDP ResNet training: the port's twin of ``examples/train_resnet_ddp.py``
(the reference's configs #1, #2 and #3), with the same flags and defaults.

One process trains under ``NoShard`` on the CUDA card::

    python -m pytorch_distributed_tpu_torch.examples.train_resnet_ddp \\
        --model resnet50 --dataset imagenet --global-batch 128 --policy bf16

Under ``torchrun`` (``env://``) every process is one rank of a
``DataParallel`` ``("dp",)`` mesh of ``WORLD_SIZE`` ranks (NCCL between
cards, gloo with ``--device cpu``), each loading its own shard of the
global batch (``--global-batch / WORLD_SIZE`` examples)::

    torchrun --standalone --nproc-per-node 4 -m \\
        pytorch_distributed_tpu_torch.examples.train_resnet_ddp \\
        --model resnet50 --dataset imagenet

AMP and accumulation (config #3): ``--policy fp16 --grad-accum 2``. On the
card the model computes in the policy's dtype (bf16, or fp16 with the loss
scaler, as ``torch.amp`` does); on the CPU it computes in fp32, as the JAX
script does off the TPU. The data are the synthetic CIFAR-10 / ImageNet
datasets, made from ``--seed``. Gradient communication hooks
(``--comm-hook``) and the JPEG ImageFolder path (``--data-dir``) are not
ported yet and raise, naming their ROADMAP items.

``--ckpt-dir D`` saves the model, the optimizer and the step every
``--ckpt-every`` steps and at the end (``checkpoint.CheckpointManager``,
the newest 3 kept), and a run that finds a committed checkpoint in ``D``
resumes from the newest: ``start_epoch = step // steps_per_epoch``,
re-entered at its first batch, as the JAX script does. Under the elastic
launcher this is BASELINE config #5: a worker that dies is restarted and
resumes::

    python -m pytorch_distributed_tpu_torch.elastic.run --standalone \
        --nproc-per-node 1 -m \
        pytorch_distributed_tpu_torch.examples.train_resnet_ddp \
        --model resnet50 --dataset imagenet --ckpt-dir ckpt

``main(argv)`` returns the run's losses and step times (and the step it
started from, and wall-clock marks of its start, of the model being ready,
of the restore and of its first step), so a caller can drive it
in-process; run as a script it prints them as its last line, in JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="resnet18",
                   choices=["resnet18", "resnet34", "resnet50", "resnet101"])
    p.add_argument("--dataset", default="cifar10",
                   choices=["cifar10", "imagenet"])
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="cap steps per epoch")
    p.add_argument("--global-batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--policy", default="fp32",
                   choices=["fp32", "bf16", "fp16"])
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--clip-norm", type=float, default=None)
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory: save there, and resume from "
                        "its newest checkpoint")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--dataset-size", type=int, default=512)
    p.add_argument("--data-dir", default=None,
                   help="ImageFolder root of JPEGs (not ported: ROADMAP "
                        "A.8); default synthetic")
    p.add_argument("--num-workers", type=int, default=0,
                   help="DataLoader worker processes")
    p.add_argument("--mp-context", default="fork", choices=["fork", "spawn"],
                   help="worker start method")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches copied to the device ahead of the step, "
                        "and each loader worker's prefetch (0 = "
                        "synchronous copies)")
    p.add_argument("--comm-hook", default=None,
                   choices=["allreduce", "bf16_compress", "fp16_compress",
                            "reduce_scatter", "ring_allreduce"],
                   help="gradient communication hook (not ported: ROADMAP "
                        "A.14)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def _not_ported(args) -> Optional[str]:
    if args.comm_hook:
        return "--comm-hook (gradient communication hooks): ROADMAP A.14"
    if args.data_dir:
        return "--data-dir (the JPEG ImageFolder dataset): ROADMAP A.8"
    return None


def main(argv=None) -> Dict:
    marks = {"start": time.time()}
    args = parse_args(argv)
    missing = _not_ported(args)
    if missing:
        raise NotImplementedError(f"not ported yet: {missing}")

    from pytorch_distributed_tpu_torch import distributed as pdist
    from pytorch_distributed_tpu_torch import models, resolve_device
    from pytorch_distributed_tpu_torch.amp import get_policy
    from pytorch_distributed_tpu_torch.checkpoint import (
        CheckpointManager,
        get_state_dict,
        set_state_dict,
    )
    from pytorch_distributed_tpu_torch.data import (
        DistributedSampler,
        SyntheticCIFAR10,
        SyntheticImageNet,
        make_loader,
        prefetch_to_device,
        shard_batch_for_mesh,
    )
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.observability import IterationLogger
    from pytorch_distributed_tpu_torch.parallel import DataParallel, NoShard
    from pytorch_distributed_tpu_torch.trainer import (
        Trainer,
        classification_loss,
    )

    launched = "WORLD_SIZE" in os.environ   # torchrun's env:// contract
    device = resolve_device(args.device)
    if launched:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        pdist.init_process_group(init_method="env://",
                                 rank=int(os.environ["RANK"]),
                                 world_size=int(os.environ["WORLD_SIZE"]),
                                 device=device)
        nproc, pid = pdist.get_world_size(), pdist.get_rank()
        mesh = init_device_mesh((nproc,), ("dp",))
        strategy = DataParallel(mesh)
    else:
        nproc, pid, mesh = 1, 0, None
        strategy = NoShard(device)
    device = strategy.device
    on_card = device.type == "cuda"
    try:
        dtype = (get_policy(args.policy).compute_dtype if on_card
                 else torch.float32)
        if args.dataset == "cifar10":
            dataset = SyntheticCIFAR10(args.dataset_size, seed=args.seed)
        else:
            dataset = SyntheticImageNet(args.dataset_size, seed=args.seed)
        model = getattr(models, args.model)(
            num_classes=dataset.num_classes,
            cifar_stem=args.dataset == "cifar10", dtype=dtype, device=device,
            seed=args.seed)
        trainer = Trainer(
            model,
            torch.optim.SGD(model.parameters(), lr=args.lr,
                            momentum=args.momentum),
            strategy,
            loss_fn=classification_loss,
            policy=args.policy,
            grad_accum_steps=args.grad_accum,
            clip_norm=args.clip_norm,
        )
        if args.global_batch % (nproc * args.grad_accum):
            raise SystemExit(
                "--global-batch must divide by process count * grad accum")
        batch_size = args.global_batch // nproc
        sampler = DistributedSampler(dataset, num_replicas=nproc, rank=pid,
                                     shuffle=True, seed=args.seed)
        loader = make_loader(dataset, batch_size, sampler, device=device,
                             num_workers=args.num_workers,
                             prefetch_factor=max(args.prefetch, 1),
                             mp_context=args.mp_context)
        state = trainer.init()
        n_params = sum(p.numel() for p in model.parameters())
        print(f"[rank {pid}] {args.model}: {n_params / 1e6:.1f}M params on "
              f"{device} ({dtype}, policy {args.policy}, {nproc} rank(s))",
              flush=True)
        marks["ready"] = time.time()
        ckpt, resumed = None, None
        if args.ckpt_dir:
            ckpt = CheckpointManager(args.ckpt_dir, max_to_keep=3)
            resumed = ckpt.latest_step()
            if resumed is not None:
                state = set_state_dict(trainer, state, ckpt.restore(
                    get_state_dict(trainer, state)))
                restart = int(os.environ.get("TPURUN_RESTART_COUNT", "0"))
                print(f"[rank {pid}] resumed from step {resumed} "
                      f"(restart #{restart})", flush=True)
        marks["restored"] = time.time()
        first_step = state.step + 1

        log = IterationLogger(sample_rate=1)
        steps_per_epoch = args.steps_per_epoch or len(sampler) // batch_size
        if steps_per_epoch < 1 or len(sampler) < batch_size:
            raise SystemExit(
                f"dataset shard ({len(sampler)} examples) smaller than the "
                f"per-process batch ({batch_size}): nothing to train on; "
                f"grow --dataset-size or shrink --global-batch")
        losses = []
        for epoch in range(state.step // steps_per_epoch, args.epochs):
            sampler.set_epoch(epoch)
            batches = (prefetch_to_device(loader, device, args.prefetch)
                       if args.prefetch else loader)
            for i, batch in enumerate(batches):
                if i >= steps_per_epoch:
                    break
                if mesh is not None:
                    batch = shard_batch_for_mesh(batch, mesh, "dp",
                                                 global_batch=False)
                log.start_iteration()
                state, metrics = trainer.step(state, tuple(batch))
                loss = float(metrics["loss"])
                log.end_iteration(loss=loss)
                losses.append(loss)
                marks.setdefault("first_step_done", time.time())
                if state.step % args.log_every == 0:
                    print(f"[rank {pid}] step {state.step} loss {loss:.4f} "
                          f"({log.samples[-1]['step_time_s'] * 1e3:.1f} ms)",
                          flush=True)
                if ckpt and state.step % args.ckpt_every == 0:
                    ckpt.save(state.step, get_state_dict(trainer, state))
            if args.prefetch:
                batches.close()   # ends the loader's workers
            if losses:
                print(f"[rank {pid}] epoch {epoch} done at step {state.step} "
                      f"loss {losses[-1]:.4f}", flush=True)
        if ckpt:
            ckpt.save(state.step, get_state_dict(trainer, state))
            ckpt.close()             # waits for the save to finish
    finally:
        if launched:
            pdist.destroy_process_group()

    return {
        "n_params": n_params,
        "images_per_step": args.global_batch,
        "losses": losses,
        "step_s": [s["step_time_s"] for s in log.samples],
        "device": str(device),
        "dtype": str(dtype).removeprefix("torch."),
        "world": nproc,
        "first_step": first_step,
        "resumed_from": resumed,
        "marks": marks,
    }


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
    sys.exit(0)
