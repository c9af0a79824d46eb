"""Rank bodies of the port's expert-parallel tests: ``ExpertDataParallel``
training on the gloo ranks of ``tests/_torch_port_ranks.py``. Imports no
JAX: every rank imports this module afresh.

The model is ``tests/test_expert.py``'s MoE GPT-2 (vocab 64, n_positions
32, width 32, 4 layers, 4 heads, MoE in blocks 1 and 3 with E=4, top-2)
with routing groups of 64 tokens, one dp shard's rows of the B=8, T=16
batch at dp 2 (a routing group never spans two data shards in the port),
trained with AdamW (lr 1e-3, weight decay 1e-4) for ``STEPS`` steps.
"""

import numpy as np
import torch

TINY = dict(vocab_size=64, n_positions=32, n_embd=32, n_layer=4, n_head=4,
            moe_experts=4, moe_top_k=2, moe_group_size=64)
LR, WD = 1e-3, 1e-4
STEPS = 3
MESHES = {"dp2ep2": (2, 2), "dp1ep4": (1, 4)}
CKPT_JOB = "dp1ep4"          # the job whose state is saved and resumed
CKPT_STEP = 2                 # saved after this many steps


def lm_batch(B=8, T=16, vocab=64, seed=0):
    """``tests/test_expert.py``'s ``_batch``."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (B, T)).astype(np.int32)
    return x, np.roll(x, -1, 1).astype(np.int32)


def _trainer(mesh, state_dict, **cfg):
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.parallel import ExpertDataParallel
    from pytorch_distributed_tpu_torch.trainer import Trainer, lm_loss

    model = GPT2(GPT2Config(**{**TINY, **cfg}), device="cpu", seed=5)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD,
                            eps=1e-8)
    trainer = Trainer(model, opt, ExpertDataParallel(mesh), loss_fn=lm_loss)
    return trainer, trainer.init()


def _replicas_equal(trainer) -> bool:
    """Every parameter outside the expert stacks, bit for bit the same on
    every ep rank (the parameters after the steps)."""
    import torch.distributed as dist

    strategy = trainer.strategy
    flat = torch.cat([p.detach().reshape(-1) for p in
                      trainer.model.parameters() if not hasattr(p, "ep")])
    every = [torch.empty_like(flat) for _ in range(strategy.ep_size)]
    dist.all_gather(every, flat, group=strategy.ep_group)
    return all(torch.equal(every[0], t) for t in every)


def _steps(trainer, state, n):
    from pytorch_distributed_tpu_torch.parallel import comm

    metrics = {}
    for i in range(n):
        if i == n - 1:
            comm.reset_counts()
        state, m = trainer.step(state, lm_batch())
        for k, v in m.items():
            metrics.setdefault(k, []).append(float(v))
    return state, metrics, dict(comm.counts), dict(comm.wire_bytes)


def train_body(rank, store_dir, state_dict):
    """Each mesh: ``STEPS`` steps; the rank's metrics, the collectives of
    the last step, the experts it holds, whether the replicas agree across
    ep, and the whole parameters after. ``CKPT_JOB`` also saves after
    ``CKPT_STEP`` steps, and a fresh trainer restores that checkpoint and
    takes the last step again."""
    from pytorch_distributed_tpu_torch.checkpoint import (
        CheckpointManager,
        get_state_dict,
        set_state_dict,
    )
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.models import full_state_dict

    for tag, shape in MESHES.items():
        mesh = init_device_mesh(shape, ("dp", "ep"))
        trainer, state = _trainer(mesh, state_dict)
        out = {"held": {n: tuple(p.shape)
                        for n, p in trainer.model.named_parameters()},
               "param_bytes": sum(p.numel() * p.element_size()
                                  for p in trainer.model.parameters())}
        if tag == CKPT_JOB:
            state, first, _, _ = _steps(trainer, state, CKPT_STEP)
            with CheckpointManager(f"{store_dir}/ckpt") as mgr:
                mgr.save(state.step, get_state_dict(trainer, state))
            state, last, counts, wire = _steps(trainer, state,
                                               STEPS - CKPT_STEP)
            metrics = {k: first[k] + last[k] for k in first}
            fresh, fstate = _trainer(mesh, None)
            with CheckpointManager(f"{store_dir}/ckpt") as mgr:
                fstate = set_state_dict(fresh, fstate, mgr.restore(
                    get_state_dict(fresh, fstate)))
            fstate, resumed, _, _ = _steps(fresh, fstate, STEPS - CKPT_STEP)
            out["resumed"] = resumed
            out["resumed_step"] = fstate.step
            out["resumed_params"] = full_state_dict(fresh.model)
        else:
            state, metrics, counts, wire = _steps(trainer, state, STEPS)
        out.update(metrics=metrics, counts=counts, wire=wire,
                   replicas_equal=_replicas_equal(trainer),
                   params=full_state_dict(trainer.model),
                   data_shard=trainer.strategy.data_shard_index)
        torch.save(out, f"{store_dir}/{tag}.rank{rank}.pt")


def dropout_body(rank, store_dir):
    """Dropout under ``ExpertDataParallel`` at (dp 2, ep 2): the first
    mask the model draws at steps 0 and 1, and at step 0 again."""
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh

    mesh = init_device_mesh((2, 2), ("dp", "ep"))
    trainer, _ = _trainer(mesh, None, dropout=0.5)
    model = trainer.model
    model.train(True)
    masks = []
    for step in (0, 1, 0):
        trainer.seed_dropout(step)
        masks.append(model._mask_drawer((2, 16, 32))())
    torch.save({"masks": masks, "data_shard": trainer.strategy.
                data_shard_index}, f"{store_dir}/dropout.rank{rank}.pt")
