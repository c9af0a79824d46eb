"""Rank bodies of the port's TP x MoE tests: ``TensorParallel`` training of
the MoE GPT-2 on the gloo ranks of ``tests/_torch_port_ranks.py``. Imports
no JAX: every rank imports this module afresh.

The model is a tiny MoE GPT-2 (vocab 64, n_positions 32, width 64, 2
layers, 4 heads; block 1 routed over E=4 experts, top-2) with routing
groups of 64 tokens, one dp shard's rows of the B=8, T=16 batch at dp 2 (a
routing group never spans two data shards in the port), trained with AdamW
(lr 1e-3, weight decay 1e-4) for ``STEPS`` steps. A job is ``(tag, mesh
kind, placement of the expert stacks, sequence_parallel)``: ``dp2tp2`` is
``(dp 2, tp 2)``, ``fsdp2tp2`` ``(fsdp 2, tp 2)`` with ``min_shard_size=8``,
``tp4`` ``(dp 1, tp 4)``; ``whole`` leaves the stacks out of the plan,
``ep`` puts ``ExpertParallel()`` in it (the stacks cut on E over tp).
"""

import numpy as np
import torch

TINY = dict(vocab_size=64, n_positions=32, n_embd=64, n_layer=2, n_head=4,
            moe_experts=4, moe_top_k=2, moe_group_size=64)
LR, WD = 1e-3, 1e-4
STEPS = 2
MESHES = {"dp2tp2": ((2, 2), ("dp", "tp")),
          "fsdp2tp2": ((2, 2), ("fsdp", "tp")),
          "tp4": ((1, 4), ("dp", "tp"))}
JOBS = [(f"{kind}_{experts}_sp{int(sp)}", kind, experts, sp)
        for kind in ("dp2tp2", "fsdp2tp2") for experts in ("whole", "ep")
        for sp in (False, True)] + [
        ("tp4_ep_sp1", "tp4", "ep", True), ("tp4_whole_sp1", "tp4", "whole",
                                            True)]
CKPT_JOB = "dp2tp2_ep_sp1"      # saved after the steps, loaded at tp 1
#: the gradients held against the reference's, each step
GRADS = ("h.1.moe.router.weight", "h.1.moe.experts_up", "h.1.moe.experts_down",
         "wte")


def lm_batch(B=8, T=16, vocab=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (B, T)).astype(np.int32)
    return x, np.roll(x, -1, 1).astype(np.int32)


def plan(experts):
    from pytorch_distributed_tpu_torch.parallel import (
        ExpertParallel,
        gpt2_tp_plan,
    )

    if experts == "whole":
        return gpt2_tp_plan()
    return {r"moe\.experts_": ExpertParallel(), **gpt2_tp_plan()}


def make_strategy(kind, experts, sp):
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.parallel import TensorParallel

    mesh = init_device_mesh(*MESHES[kind])
    if kind == "fsdp2tp2":
        return TensorParallel(mesh, plan(experts), dp_axis=None,
                              fsdp_axis="fsdp", min_shard_size=8,
                              sequence_parallel=sp)
    return TensorParallel(mesh, plan(experts), sequence_parallel=sp)


def train(strategy, state_dict, steps=STEPS, ckpt_dir=None):
    """``steps`` AdamW steps on the one batch: per-step metrics and the
    whole gradients of ``GRADS`` the optimizer stepped on, the collectives
    of the last step, the whole parameters after, the shapes a rank
    holds."""
    from pytorch_distributed_tpu_torch.models import (
        GPT2,
        GPT2Config,
        full_state_dict,
    )
    from pytorch_distributed_tpu_torch.parallel import comm
    from pytorch_distributed_tpu_torch.trainer import Trainer, lm_loss
    from tests._torch_port_tp import whole_grads

    model = GPT2(GPT2Config(**TINY), device="cpu")
    model.load_state_dict(state_dict)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD,
                            eps=1e-8)
    trainer = Trainer(model, opt, strategy, loss_fn=lm_loss)
    state = trainer.init()
    metrics, grads = {}, {}
    for i in range(steps):
        if i == steps - 1:
            comm.reset_counts()
        state, m = trainer.step(state, lm_batch())
        counts, wire = dict(comm.counts), dict(comm.wire_bytes)
        for k, v in m.items():
            metrics.setdefault(k, []).append(float(v))
        whole = whole_grads(trainer)
        for n in GRADS:
            grads.setdefault(n, []).append(whole[n])
    if ckpt_dir is not None:
        from pytorch_distributed_tpu_torch.checkpoint import (
            CheckpointManager,
            get_state_dict,
        )

        with CheckpointManager(ckpt_dir) as mgr:
            mgr.save(state.step, get_state_dict(trainer, state))
    return {"metrics": metrics, "grads": grads, "counts": counts,
            "wire": wire, "params": full_state_dict(model),
            "held": {n: tuple(p.shape) for n, p in model.named_parameters()},
            "ep": [type(m.moe.ep).__name__ for m in model.h if m.use_moe]}


def train_body(rank, store_dir, jobs, state_dict):
    for tag, kind, experts, sp in jobs:
        out = train(make_strategy(kind, experts, sp), state_dict,
                    ckpt_dir=f"{store_dir}/ckpt" if tag == CKPT_JOB else None)
        torch.save(out, f"{store_dir}/{tag}.rank{rank}.pt")
