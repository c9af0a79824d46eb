"""FSDP GPT-2 language-model training: the port's training entry point.

The twin of ``examples/train_gpt2_fsdp.py`` (BASELINE config #4: GPT-2
125M by default, AdamW, LM loss over synthetic WikiText-shaped token
windows), with the same flags and defaults. One process per rank: under
``torchrun`` (or any launcher that sets ``RANK`` and ``WORLD_SIZE``) the
script joins the process group (NCCL on the card, gloo with ``--device
cpu``); without a launcher it makes a one-rank group. The ranks form the
mesh ``(dp, world // dp)`` over ``("dp", "fsdp")`` and train under
``FullyShardedDataParallel(mesh, dp_axis="dp" if dp > 1 else None,
min_shard_size=8)``, as the JAX script does: parameters, gradients and
AdamW state held as 1/fsdp shards, the batch split over every rank. On
one rank the rule keeps every parameter whole (``trivial_axis``), and
the steps are ``NoShard``'s. The attention is the causal flash kernels
(``--attn flash``, the default). The bf16 policy runs the model in bf16
on the card, with fp32 parameters; on the CPU it runs in fp32, as the JAX
script does off the TPU. ``--device cpu`` runs the plain versions of the
kernels::

    python -m pytorch_distributed_tpu_torch.examples.train_gpt2 \\
        --device cpu --layers 2 --embd 64 --heads 4 --seq-len 64 --steps 5
    torchrun --standalone --nproc-per-node 4 -m \\
        pytorch_distributed_tpu_torch.examples.train_gpt2 --dp 2 \\
        --device cpu --layers 2 --embd 64 --heads 4 --seq-len 64 --steps 5

``main(argv)`` returns the run's metrics (per-step losses, the mean over
the ranks, the same on every rank; step times; the step it started from
and wall-clock marks of its start, of the model being ready, of the
restore and of its first step), so a caller can drive it
in-process; a caller that made the process group already keeps it.
Run as a script, it prints them as its last line, in JSON. MoE
(``--moe-experts``) and the token-file corpus (``--data-bin``) are not
ported yet and raise, naming their ROADMAP items.

``--ckpt-dir D`` saves the sharded state (each rank its blocks, through
``checkpoint.CheckpointManager``) every ``--ckpt-every`` steps and at the
end, and a run that finds a committed checkpoint in ``D`` resumes from
the newest (its data from the first epoch's first batch again, as the JAX
script does), on whatever world it runs now: under
``python -m pytorch_distributed_tpu_torch.elastic.run`` a failed worker
group restarts and resumes.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--embd", type=int, default=768)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--vocab", type=int, default=50257)
    p.add_argument("--seq-len", type=int, default=1024)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--policy", default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--remat", action="store_true",
                   help="recompute each block in the backward (activation "
                        "memory for FLOPs)")
    p.add_argument("--dp", type=int, default=1,
                   help="extra pure-DP axis size (mesh = dp x fsdp)")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory: save there, and resume from "
                        "its newest checkpoint")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--dataset-size", type=int, default=2048)
    p.add_argument("--data-bin", default=None,
                   help="binary token corpus (not ported: ROADMAP A.8); "
                        "default synthetic")
    p.add_argument("--num-workers", type=int, default=0,
                   help="DataLoader worker processes")
    p.add_argument("--mp-context", default="fork", choices=["fork", "spawn"],
                   help="worker start method")
    p.add_argument("--chunked-loss", type=int, default=0, metavar="N",
                   help="use the vocab-chunked CE with N chunks")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches each loader worker prefetches")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="routed experts per MoE block (not ported: ROADMAP "
                        "A.14)")
    p.add_argument("--moe-top-k", type=int, default=2)
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel size (MoE only; not ported)")
    p.add_argument("--attn", default="flash", choices=["flash", "dense"],
                   help="flash: the causal flash kernels; dense: the "
                        "reference softmax attention")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def _not_ported(args) -> Optional[str]:
    if args.moe_experts or args.ep > 1:
        return "--moe-experts/--ep (mixture of experts): ROADMAP A.14"
    if args.data_bin:
        return "--data-bin (the token-file dataset): ROADMAP A.8"
    return None


def main(argv=None) -> Dict:
    marks = {"start": time.time()}
    args = parse_args(argv)
    missing = _not_ported(args)
    if missing:
        raise NotImplementedError(f"not ported yet: {missing}")

    from pytorch_distributed_tpu_torch import distributed as pdist
    from pytorch_distributed_tpu_torch import resolve_device

    device = resolve_device(args.device)
    own_group = not dist.is_initialized()
    if own_group:
        if "WORLD_SIZE" in os.environ:          # torchrun's env:// contract
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda",
                                      int(os.environ.get("LOCAL_RANK", 0)))
            pdist.init_process_group(init_method="env://",
                                     rank=int(os.environ["RANK"]),
                                     world_size=int(os.environ["WORLD_SIZE"]),
                                     device=device)
        else:
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            pdist.init_process_group(init_method=f"tcp://localhost:{port}",
                                     rank=0, world_size=1, device=device)
    try:
        return _train(args, marks)
    finally:
        if own_group:
            pdist.destroy_process_group()


def _train(args, marks) -> Dict:
    from pytorch_distributed_tpu_torch import distributed as pdist
    from pytorch_distributed_tpu_torch.checkpoint import (
        CheckpointManager,
        get_state_dict,
        set_state_dict,
    )
    from pytorch_distributed_tpu_torch.data import (
        DistributedSampler,
        SyntheticLMDataset,
        make_loader,
        shard_batch_for_mesh,
    )
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from pytorch_distributed_tpu_torch.parallel import (
        FullyShardedDataParallel,
    )
    from pytorch_distributed_tpu_torch.trainer import (
        Trainer,
        lm_loss,
        make_chunked_lm_loss,
    )

    nproc, pid = pdist.get_world_size(), pdist.get_rank()
    if nproc % args.dp:
        raise SystemExit("--dp must divide the process count")
    mesh = init_device_mesh((args.dp, nproc // args.dp), ("dp", "fsdp"))
    strategy = FullyShardedDataParallel(
        mesh, dp_axis="dp" if args.dp > 1 else None, min_shard_size=8)
    device = strategy.device
    on_card = device.type == "cuda"
    cfg = GPT2Config(
        vocab_size=args.vocab,
        n_positions=args.seq_len,
        n_embd=args.embd,
        n_layer=args.layers,
        n_head=args.heads,
        dtype=torch.bfloat16 if (on_card and args.policy == "bf16")
        else torch.float32,
        remat=args.remat,
        attn_impl=flash_attention if args.attn == "flash" else None,
    )
    model = GPT2(cfg, device=device, seed=args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr,
                                  weight_decay=args.weight_decay, eps=1e-8)
    loss_fn = (make_chunked_lm_loss(args.chunked_loss) if args.chunked_loss
               else lm_loss)
    trainer = Trainer(model, optimizer, strategy, loss_fn=loss_fn,
                      policy=args.policy if on_card else "fp32")

    shards = strategy.data_shard_count
    if args.global_batch % shards:
        raise SystemExit("--global-batch must divide by the process count")
    dataset = SyntheticLMDataset(args.dataset_size, seq_len=args.seq_len,
                                 seed=args.seed)
    dataset.vocab_size = min(args.vocab, dataset.vocab_size)
    sampler = DistributedSampler(dataset, num_replicas=shards,
                                 rank=strategy.data_shard_index,
                                 shuffle=True, seed=args.seed)
    loader = make_loader(dataset, args.global_batch // shards, sampler,
                         device=device, num_workers=args.num_workers,
                         prefetch_factor=args.prefetch,
                         mp_context=args.mp_context)

    state = trainer.init()
    if pid == 0:
        print(f"GPT-2: {n_params / 1e6:.1f}M params on {device} "
              f"({cfg.dtype}, attention {args.attn}), mesh {mesh.shape}",
              flush=True)
    marks["ready"] = time.time()
    ckpt, resumed = None, None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, max_to_keep=3)
        resumed = ckpt.latest_step()
        if resumed is not None:
            state = set_state_dict(trainer, state,
                                   ckpt.restore(get_state_dict(trainer, state)))
            restart = int(os.environ.get("TPURUN_RESTART_COUNT", "0"))
            print(f"[rank {pid}] resumed from step {state.step} "
                  f"(restart #{restart})", flush=True)
    marks["restored"] = time.time()
    first_step = state.step + 1

    losses: List[torch.Tensor] = []
    step_s: List[float] = []
    epoch = 0
    while state.step < args.steps:
        sampler.set_epoch(epoch)
        for batch in loader:
            if state.step >= args.steps:
                break
            placed = shard_batch_for_mesh(batch, mesh, strategy.batch_axes,
                                          global_batch=shards == 1)
            t0 = time.perf_counter()
            state, metrics = trainer.step(state, placed)
            if on_card:
                torch.cuda.synchronize(device)
            step_s.append(time.perf_counter() - t0)
            losses.append(metrics["loss"].detach())
            marks.setdefault("first_step_done", time.time())
            if state.step % args.log_every == 0 and pid == 0:
                print(f"step {state.step} loss {float(metrics['loss']):.4f} "
                      f"ppl {float(metrics['perplexity']):.1f}", flush=True)
            if ckpt and state.step % args.ckpt_every == 0:
                ckpt.save(state.step, get_state_dict(trainer, state))
        epoch += 1
    if ckpt:
        ckpt.save(state.step, get_state_dict(trainer, state))
        ckpt.close()                 # waits for the save to finish

    # each rank's loss is its shard's: the mean over the ranks is the
    # global batch's
    mean = (torch.stack(losses).float() if losses
            else torch.zeros(0, device=device))
    if shards > 1:
        dist.all_reduce(mean, group=strategy.group)
        mean /= shards
    return {
        "n_params": n_params,
        "tokens_per_step": args.global_batch * args.seq_len,
        "losses": mean.tolist(),
        "step_s": step_s,
        "device": str(device),
        "dtype": str(cfg.dtype).removeprefix("torch."),
        "attn": args.attn,
        "world": nproc,
        "mesh": mesh.shape,
        "strategy": type(strategy).__name__,
        "first_step": first_step,
        "resumed_from": resumed,
        "marks": marks,
    }


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
    sys.exit(0)
