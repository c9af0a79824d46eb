"""A reshard of expert-parallel training state across ep sizes, on 4 gloo
ranks.

``tests/_torch_port_expert.py``'s MoE GPT-2 (E=4, top-2) trains 2 AdamW
steps under ``ExpertDataParallel`` at ``(dp 1, ep 4)``, one expert a
rank; its state (``get_state_dict``: the expert stacks and their moments
``Shard(0)`` over ep) is saved, then moved by ``elastic.reshard_state``
onto ``state_shardings`` of an ``ExpertDataParallel`` on a ``(dp 2, ep
2)`` mesh: two experts a rank, with their moments. Held:

* every block equals the JAX package's ``reshard_state`` of the same
  global arrays between the same mesh shapes over 4 virtual CPU devices,
  bit for bit;
* loaded into a trainer on the new mesh (``set_state_dict``), the state
  equals the checkpoint's resume at ``(dp 2, ep 2)`` bit for bit, and both
  take the next step to the same loss;
* each expert leaf's planned peak on a rank is at most a source block
  plus a destination block, and the executor allocated no buffer beside
  them (whole experts go from the source block to the destination block
  point to point): no stack was gathered whole.

JAX is imported inside the tests only: the ranks re-import this module.
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_expert as eph
from tests import _torch_port_ranks as ranks

torch.set_num_threads(2)

STEPS = 2
SRC, DST = (1, 4), (2, 2)


def _trainer(mesh, seed):
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.parallel import ExpertDataParallel
    from pytorch_distributed_tpu_torch.trainer import Trainer, lm_loss

    cfg = GPT2Config(**{**eph.TINY, "moe_group_size": None})
    model = GPT2(cfg, device="cpu", seed=seed)
    opt = torch.optim.AdamW(model.parameters(), lr=eph.LR,
                            weight_decay=eph.WD, eps=1e-8)
    trainer = Trainer(model, opt, ExpertDataParallel(mesh), loss_fn=lm_loss)
    return trainer, trainer.init()


def _local(v):
    return (v.to_local() if hasattr(v, "to_local") else v).clone()


def _live(trainer, state):
    from pytorch_distributed_tpu_torch.checkpoint import get_state_dict

    return {k: _local(v) for k, v in get_state_dict(trainer,
                                                     state).items()}


def reshard_body(rank, store_dir):
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch.checkpoint import (
        CheckpointManager,
        get_state_dict,
        set_state_dict,
    )
    from pytorch_distributed_tpu_torch.elastic import (
        reshard_state,
        resume_from_checkpoint,
        state_shardings,
    )
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.parallel import ExpertDataParallel
    from pytorch_distributed_tpu_torch.redistribute import executor, plan_tree

    src_mesh = init_device_mesh(SRC, ("dp", "ep"))
    dst_mesh = init_device_mesh(DST, ("dp", "ep"))
    trainer, state = _trainer(src_mesh, seed=5)
    for _ in range(STEPS):
        state, _ = trainer.step(state, eph.lm_batch())
    sd = get_state_dict(trainer, state)
    with CheckpointManager(f"{store_dir}/ckpt") as mgr:
        mgr.save(state.step, sd)
    shardings = state_shardings(sd, ExpertDataParallel(dst_mesh))
    plan = plan_tree(sd, shardings)
    executor.reset_counts()
    moved = reshard_state(sd, shardings)
    counts = dict(executor.counts)
    out = {"src": {k: _local(v) for k, v in sd.items()},
           "src_dims": {k: [p.dim for p in v.placements if hasattr(p, "dim")]
                        if hasattr(v, "placements") else []
                        for k, v in sd.items()},
           "dst_specs": {k: s.spec for k, s in shardings.items()},
           "moved": {k: _local(v) for k, v in moved.items()},
           "peaks": {k: p.cost.peak_bytes for k, p in zip(sd, plan.leaves)},
           "counts": counts}
    resized, rstate = _trainer(dst_mesh, seed=6)
    rstate = set_state_dict(resized, rstate, moved)
    resumed, qstate = _trainer(dst_mesh, seed=7)
    qstate = resume_from_checkpoint(f"{store_dir}/ckpt", resumed, qstate)
    out["resized"] = _live(resized, rstate)
    out["resumed"] = _live(resumed, qstate)
    out["held"] = {n: tuple(p.shape) for n, p in
                   resized.model.named_parameters() if "experts" in n}
    out["steps"] = (rstate.step, qstate.step)
    _, m1 = resized.step(rstate, eph.lm_batch(seed=1))
    _, m2 = resumed.step(qstate, eph.lm_batch(seed=1))
    out["losses"] = (float(m1["loss"]), float(m2["loss"]))
    dist.barrier()
    torch.save(out, f"{store_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def resharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep_reshard")
    ctx = ranks.start(reshard_body, tmp)
    ranks.finish(ctx, timeout=180)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(ranks.WORLD)]


def _global(blocks, dims):
    """The whole tensor from the four source ranks' blocks (dim 0 over ep
    at (dp 1, ep 4): rank order)."""
    if not dims:
        return blocks[0]
    (dim,) = dims
    return torch.cat(blocks, dim)


def test_two_experts_a_rank_with_their_moments(resharded):
    E, C = eph.TINY["moe_experts"], eph.TINY["n_embd"]
    for r in resharded:
        assert r["held"]["h.1.moe.experts_up"] == (E // 2, C, 4 * C)
        for key in ("model/h.1.moe.experts_up",
                    "optim/h.1.moe.experts_up/exp_avg",
                    "optim/h.1.moe.experts_down/exp_avg_sq"):
            assert r["src_dims"][key] == [0]
            assert r["dst_specs"][key][0] == ("ep",)
            assert r["moved"][key].shape[0] == E // 2
            assert r["src"][key].shape[0] == E // 4
        assert r["dst_specs"]["model/wte"] == ((), ())
        assert r["dst_specs"]["train/step"] == ()


def test_blocks_equal_jax_reshard_state(resharded):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from pytorch_distributed_tpu.elastic import reshard_state as jax_reshard

    devs = np.asarray(jax.devices()[:4])
    src = Mesh(devs.reshape(SRC), ("dp", "ep"))
    dst = Mesh(devs.reshape(DST), ("dp", "ep"))
    state, targets = {}, {}
    r0 = resharded[0]
    for k, dims in r0["src_dims"].items():
        whole = _global([r["src"][k] for r in resharded], dims)
        if not whole.is_floating_point():
            continue
        spec = [None] * whole.dim()
        for d in dims:
            spec[d] = "ep"
        state[k] = jax.device_put(whole.numpy(), NamedSharding(src, P(*spec)))
        targets[k] = NamedSharding(dst, P(*[a[0] if a else None
                                           for a in r0["dst_specs"][k]]))
    out = jax_reshard(state, targets)
    n_sharded = sum(1 for d in r0["src_dims"].values() if d)
    assert n_sharded == 2 * 2 * 3      # 2 blocks, 2 stacks, param + moments
    for k in state:
        shards = {s.device.id: np.asarray(s.data)
                  for s in out[k].addressable_shards}
        for rank, r in enumerate(resharded):
            np.testing.assert_array_equal(r["moved"][k].numpy(),
                                          shards[devs.ravel()[rank].id],
                                          err_msg=k)


def test_resized_state_equals_the_checkpoint_resume(resharded):
    for r in resharded:
        assert r["steps"] == (STEPS, STEPS)
        assert r["resized"].keys() == r["resumed"].keys()
        for k, t in r["resumed"].items():
            assert torch.equal(r["resized"][k], t), k
        a, b = r["losses"]
        assert a == b and np.isfinite(a)


def test_no_rank_gathers_a_stack(resharded):
    for r in resharded:
        for k, dims in r["src_dims"].items():
            if not dims:
                continue
            src = r["src"][k].numel() * r["src"][k].element_size()
            dst = r["moved"][k].numel() * r["moved"][k].element_size()
            assert r["peaks"][k] <= src + dst, (k, r["peaks"][k], src, dst)
        # every piece is whole experts along dim 0: sent from the source
        # block and received into the destination block, no buffer
        assert r["counts"]["buffer_bytes_max"] == 0, r["counts"]
        assert r["counts"]["sent_bytes"] > 0, r["counts"]
