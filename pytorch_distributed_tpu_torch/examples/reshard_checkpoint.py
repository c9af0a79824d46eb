"""Redistribution demo: train on one mesh, serve on another, swap live.

Port of ``examples/reshard_checkpoint.py``. Three planned moves in one
run, printing the cost model of each:

  1. "Training" lays GPT-2's weights out FSDP-style over a 1-D ``dp``
     mesh of every rank (dim 0 sharded where it divides) and checkpoints
     them (``CheckpointManager``, each rank its blocks).
  2. Serving reads only the ``model/...`` entries onto a ``dp x tp``
     inference mesh (``load_gpt2_params``): each rank reads its
     Megatron-TP blocks, c_attn read whole and cut.
  3. Mid-stream, while requests are decoding, the trainer "pushes" its
     weights: ``Scheduler.swap_params`` moves the dp-laid-out blocks onto
     the engine's serving placement between decode steps, in place (no
     new capture); the move is bit-exact, so request 0's tokens are
     asserted against the teacher-forcing oracle straight through the
     swap.

Run on every rank of a group (``torchrun --nproc-per-node N``: NCCL, one
card a rank; gloo with ``--device cpu``) or alone at world 1::

    torchrun --nproc-per-node 4 -m \\
        pytorch_distributed_tpu_torch.examples.reshard_checkpoint \\
        --device cpu --layers 2 --embd 48 --tp 2

Inspect a planned transfer without executing anything::

    python -m pytorch_distributed_tpu_torch.examples.reshard_checkpoint \\
        --plan-only --device cpu

Like every entry point of the port it runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import socket
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--embd", type=int, default=48)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=97)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--dp", type=int, default=0,
                   help="serving-mesh data axis (0 = infer from --tp)")
    p.add_argument("--tp", type=int, default=-1,
                   help="serving-mesh tensor axis (-1 = all ranks)")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--swap-after-steps", type=int, default=3,
                   help="decode steps before the live weight swap")
    p.add_argument("--plan-only", action="store_true",
                   help="print the tree plan and exit (no execution)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cpu, or the card (the default)")
    return p.parse_args(argv)


def fsdp_style_shardings(state, mesh):
    """Dim-0 ``dp`` sharding where it divides, whole otherwise: the layout
    a 1-D FSDP trainer holds."""
    from pytorch_distributed_tpu_torch.redistribute import Sharding

    n = mesh.size("dp")
    return {k: Sharding(mesh, ("dp",) if t.dim() >= 1 and t.shape[0] % n == 0
                        else ())
            for k, t in state.items()}


def fmt_cost(cost):
    mb = 1 / (1024 * 1024)
    return (f"moved {cost.bytes_moved * mb:.2f} MiB/rank, "
            f"peak {cost.peak_bytes * mb:.2f} MiB "
            f"(naive gather-then-slice would peak "
            f"{cost.naive_gather_bytes * mb:.2f} MiB)")


@torch.no_grad()
def greedy_oracle(model, prompt, n_tokens):
    """Teacher forcing on the uncached forward: the argmax continuation."""
    device = next(model.parameters()).device
    seq = [int(t) for t in prompt]
    out = []
    for _ in range(n_tokens):
        logits = model(torch.tensor([seq], device=device))
        out.append(int(torch.argmax(logits[0, -1].float())))
        seq.append(out[-1])
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
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
        return _demo(args, device)
    finally:
        if own_group:
            pdist.destroy_process_group()


def _demo(args, device) -> int:
    from pytorch_distributed_tpu_torch.checkpoint import CheckpointManager
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.redistribute import (
        plan_tree,
        redistribute_tree,
    )
    from pytorch_distributed_tpu_torch.redistribute.executor import to_dtensor
    from pytorch_distributed_tpu_torch.serving import (
        InferenceEngine,
        Request,
        Scheduler,
        kv_cache_sharding,
        load_gpt2_params,
        serving_mesh,
    )

    n_dev = dist.get_world_size()
    rank0 = dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    cfg = GPT2Config(vocab_size=args.vocab, n_positions=args.seq_len,
                     n_embd=args.embd, n_layer=args.layers,
                     n_head=args.heads, dtype=torch.float32)
    model = GPT2(cfg, device=device, seed=args.seed)
    whole = {k: t.detach() for k, t in model.state_dict().items()}

    # -- 1. "training": FSDP-style layout on a 1-D dp mesh, checkpointed --
    train_mesh = init_device_mesh((n_dev,), ("dp",))
    train_shardings = fsdp_style_shardings(whole, train_mesh)
    plan = plan_tree(whole, train_shardings)
    say(f"host -> train mesh ({n_dev}-way fsdp): {fmt_cost(plan.cost)}")
    if args.plan_only:
        for p in plan.leaves:
            dtype = str(p.dtype).removeprefix("torch.")
            say(f"  {p.shape} {dtype}: {' -> '.join(p.ops) or 'noop'}")
        return 0
    train_blocks = redistribute_tree(whole, train_shardings, plan=plan)
    train_state = {k: to_dtensor(b, train_shardings[k], whole[k].shape)
                   for k, b in train_blocks.items()}

    box = [tempfile.mkdtemp(prefix="reshard_demo_") if rank0 else None]
    dist.broadcast_object_list(box, src=0)
    ckpt_dir = box[0]
    try:
        with CheckpointManager(ckpt_dir, max_to_keep=1) as mgr:
            mgr.save(1, {f"model/{k}": v for k, v in train_state.items()})
            mgr.wait_until_finished()
        say(f"checkpointed step 1 -> {ckpt_dir}")

        # -- 2. serve on another mesh: a partial restore onto the TP layout
        dp = args.dp or (n_dev // args.tp if args.tp > 0 else 1)
        smesh = serving_mesh(dp=dp, tp=args.tp)
        tp = smesh.size("tp")
        served = GPT2(cfg, device=device, seed=args.seed + 1)
        load_gpt2_params(ckpt_dir, served, smesh)
        say(f"restored params subtree onto serving mesh (dp={dp}, tp={tp}) "
            "-- optimizer state never left disk")
    finally:
        dist.barrier()
        if rank0:
            shutil.rmtree(ckpt_dir, ignore_errors=True)

    engine = InferenceEngine(served, n_slots=args.requests,
                             max_len=args.seq_len, prefill_len=16,
                             cache_sharding=kv_cache_sharding(smesh),
                             device=device)
    sched = Scheduler(engine)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, args.vocab, int(rng.integers(4, 9)))
               for _ in range(args.requests)]
    oracle = greedy_oracle(model, prompts[0], args.max_new_tokens)
    for prompt in prompts:
        sched.submit(Request(prompt=prompt,
                             max_new_tokens=args.max_new_tokens))

    for _ in range(args.swap_after_steps):
        sched.step()

    # -- 3. live weight push: trainer layout -> serving layout, mid-decode
    t0 = time.perf_counter()
    cost = sched.swap_params(train_state)
    dt = time.perf_counter() - t0
    say(f"live swap between decode steps ({dt * 1e3:.1f}ms): "
        f"{fmt_cost(cost)}")

    finished = sched.run()
    first = next(f for f in finished if f.request_id == 0)
    assert first.tokens == oracle, "stream diverged across the swap!"
    say(f"served {len(finished)} requests; request 0's "
        f"{len(first.tokens)} tokens match the teacher-forcing oracle "
        f"straight through the swap")
    say(f"weight swaps: {sched.weight_swaps}, tokens: "
        f"{sched.tokens_generated}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
