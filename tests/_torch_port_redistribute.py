"""Rank bodies of the port's redistribution tests, on the gloo ranks of
``tests/_torch_port_ranks.py``. Imports no JAX: every rank imports this
module afresh.

* :func:`exec_body` runs the executor's cases: a tensor of ``(16, 24)``
  (a case may give another shape and dtype) drawn from a seed, each
  rank's source block cut by the index map the test computed with JAX,
  moved to the destination and back; it saves each rank's destination
  block, whether the way back was bit-exact, the plan's cost and the
  executor's counts.
* :func:`state_body` trains the tiny GPT-2 under FSDP on 4 ranks, saves a
  checkpoint, moves the live state to FSDP on ranks 0 and 1 through
  ``reshard_state`` (ranks 2 and 3 only send) and loads it into a trainer
  there; the same trainer built afresh resumes from the checkpoint.
* :func:`serve_body` lays GPT-2 out FSDP over the 4 ranks, moves it to TP
  ``(1, 4)`` through ``reshard_gpt2_params`` and serves; then swaps other
  weights, laid out FSDP over ranks 2 and 3, into running TP schedulers
  with a staging bound.
"""

import math

import numpy as np
import torch

from tests import _torch_port_sharding as sh
from tests import _torch_port_tp as tph

#: the meshes of the executor's cases, built in this order on every rank
MESHES = {
    "a4": ((4,), ("a",), None),
    "ab22": ((2, 2), ("a", "b"), None),
    "a2lo": ((2,), ("a",), (0, 1)),
    "a2hi": ((2,), ("a",), (2, 3)),
}
STATE_STEPS = 2
SWAP_AT = 3
SWAP_STAGING = 1024


def meshes():
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh

    return {k: init_device_mesh(shape, names, ranks=ranks)
            for k, (shape, names, ranks) in MESHES.items()}


def case_array(case):
    rng = np.random.default_rng(case["seed"])
    a = rng.normal(size=case.get("shape", (16, 24))).astype(np.float32)
    return torch.from_numpy(a).to(case.get("dtype", torch.float32))


def _cut(t, box):
    return t[tuple(slice(lo, hi) for lo, hi in box)].clone()


def exec_body(rank, store_dir, cases):
    from pytorch_distributed_tpu_torch.redistribute import (
        Placed,
        Sharding,
        plan_transfer,
        redistribute,
    )
    from pytorch_distributed_tpu_torch.redistribute import executor

    ms = meshes()
    out = {}
    for case in cases:
        ref = case_array(case)
        src = (Sharding(ms[case["src"]], case["src_spec"])
               if case["src"] is not None else None)
        dst = Sharding(ms[case["dst"]], case["dst_spec"])
        staging = case.get("staging")
        plan = plan_transfer(ref.shape, ref.dtype, src, dst,
                             max_staging_bytes=staging)
        if src is None:
            x = ref.clone()
        else:
            box = case["src_idx"].get(rank)
            x = Placed(None if box is None else _cut(ref, box), src,
                       tuple(ref.shape), ref.dtype)
        executor.reset_counts()
        there = redistribute(x, dst, max_staging_bytes=staging,
                             name=case["name"])
        counts = dict(executor.counts)
        back_exact = None
        if src is not None:
            back = redistribute(Placed(there, dst, tuple(ref.shape),
                                       ref.dtype), src)
            block = x.block
            back_exact = (back is None and block is None) or (
                back is not None and block is not None
                and torch.equal(back, block))
        out[case["name"]] = {"there": there, "back_exact": back_exact,
                             "counts": counts, "cost": plan.cost,
                             "ops": plan.ops, "chunks": plan.steps[0].chunks}
    torch.save(out, f"{store_dir}/exec.rank{rank}.pt")


def _fsdp(mesh):
    from pytorch_distributed_tpu_torch.parallel import FullyShardedDataParallel

    return FullyShardedDataParallel(mesh, min_shard_size=sh.MIN_SHARD)


def _local_state(trainer, state):
    from pytorch_distributed_tpu_torch.checkpoint import get_state_dict

    return {k: (v.to_local() if hasattr(v, "to_local") else v).clone()
            for k, v in get_state_dict(trainer, state).items()}


def state_shardings(sd, mesh):
    """The dp-``n`` FSDP placement of every entry of a state dict on
    ``mesh`` (FSDP's rule on the whole shape; a whole tensor replicated)."""
    from pytorch_distributed_tpu_torch.parallel.strategies import (
        shard_spec_with_reason,
    )
    from pytorch_distributed_tpu_torch.redistribute import Sharding

    n = mesh.size("fsdp")
    out = {}
    for k, v in sd.items():
        dim = None
        if hasattr(v, "to_local"):
            dim = shard_spec_with_reason(tuple(v.shape), "fsdp", n,
                                         sh.MIN_SHARD)[0]
        out[k] = Sharding.from_placement(
            mesh, {} if dim is None else {"fsdp": dim}, v.dim())
    return out


def state_body(rank, store_dir, ckpt_dir, staging):
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch.checkpoint import (
        CheckpointManager,
        get_state_dict,
        set_state_dict,
    )
    from pytorch_distributed_tpu_torch.elastic import (
        reshard_state,
        resume_from_checkpoint,
    )
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.redistribute import executor

    job = {"model": "gpt2", "state_dict": GPT2(
        GPT2Config(**sh.GPT2_TINY), device="cpu", seed=0).state_dict()}
    batches = sh.lm_batches(STATE_STEPS + 1, 8, seed=4)
    mesh4 = init_device_mesh((4,), ("fsdp",))
    mesh2 = init_device_mesh((2,), ("fsdp",), ranks=(0, 1))
    trainer, state = sh.build(job, _fsdp(mesh4))
    for batch in batches[:STATE_STEPS]:
        state, _ = trainer.step(state, batch)
    sd = get_state_dict(trainer, state)
    with CheckpointManager(ckpt_dir) as mgr:
        mgr.save(state.step, sd)
    result = {"src": {k: (v.to_local() if hasattr(v, "to_local") else v)
                      .clone() for k, v in sd.items()},
              "src_dims": {k: [p.dim for p in v.placements
                               if hasattr(p, "dim")]
                           if hasattr(v, "placements") else []
                           for k, v in sd.items()}}
    shardings = state_shardings(sd, mesh2)
    result["dst_specs"] = {k: s.spec for k, s in shardings.items()}
    executor.reset_counts()
    moved = reshard_state(sd, shardings, max_staging_bytes=staging)
    result["counts"] = dict(executor.counts)
    result["moved"] = moved
    if rank < 2:
        trainer2, state2 = sh.build(job, _fsdp(mesh2))
        state2 = set_state_dict(trainer2, state2, moved)
        result["resized"] = _local_state(trainer2, state2)
        trainer3, state3 = sh.build(job, _fsdp(mesh2))
        state3 = resume_from_checkpoint(ckpt_dir, trainer3, state3)
        result["resumed"] = _local_state(trainer3, state3)
        result["steps"] = (state2.step, state3.step)
        _, m2 = trainer2.step(state2, batches[-1])
        _, m3 = trainer3.step(state3, batches[-1])
        result["losses"] = (float(m2["loss"]), float(m3["loss"]))
    else:
        # the other ranks of the world take part in the checkpoint's
        # collectives, reading nothing
        with CheckpointManager(ckpt_dir) as mgr:
            mgr.restore({}, step=state.step)
    dist.barrier()
    torch.save(result, f"{store_dir}/state.rank{rank}.pt")


def _serve_streams(model, kind, mesh):
    from pytorch_distributed_tpu_torch.serving import (
        kv_cache_sharding,
        paged_kv_cache_sharding,
    )

    sharding = (kv_cache_sharding(mesh) if kind == "slotted"
                else paged_kv_cache_sharding(mesh))
    return tph.streams(model, kind, 0, sharding)[0]


def _engine(model, kind, mesh):
    from pytorch_distributed_tpu_torch.serving import (
        InferenceEngine,
        Scheduler,
        kv_cache_sharding,
        paged_kv_cache_sharding,
    )

    kw = dict(n_slots=2, max_len=32, prefill_len=8)
    if kind == "paged":
        kw.update(cache_kind="paged", page_size=4)
    sharding = (kv_cache_sharding(mesh) if kind == "slotted"
                else paged_kv_cache_sharding(mesh))
    return Scheduler(InferenceEngine(model, device="cpu",
                                     cache_sharding=sharding, **kw))


def swap_prompts(seed=2, n=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, tph.SERVE["vocab_size"], size=5).astype(np.int32)
            for _ in range(n)]


def _fsdp_blocks(sd, mesh, rank, ranks):
    """``sd`` laid out FSDP over ``mesh`` (dim by FSDP's rule): this rank's
    ``Placed`` blocks, None where it is not among ``ranks``."""
    from pytorch_distributed_tpu_torch.parallel.fsdp import local_block
    from pytorch_distributed_tpu_torch.parallel.strategies import (
        shard_spec_with_reason,
    )
    from pytorch_distributed_tpu_torch.redistribute import Placed, Sharding

    n = len(ranks)
    out = {}
    for k, t in sd.items():
        dim = shard_spec_with_reason(tuple(t.shape), "fsdp", n,
                                     sh.MIN_SHARD)[0]
        s = Sharding.from_placement(mesh, {} if dim is None
                                    else {"fsdp": dim}, t.dim())
        block = None
        if rank in ranks:
            i = ranks.index(rank)
            block = t.clone() if dim is None else local_block(t, dim, i, n)
        out[k] = Placed(block, s, tuple(t.shape), t.dtype)
    return out


def serve_body(rank, store_dir, state_dict, other):
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.observability import recent_events
    from pytorch_distributed_tpu_torch.parallel.fsdp import shard_module
    from pytorch_distributed_tpu_torch.redistribute import executor
    from pytorch_distributed_tpu_torch.serving import (
        Request,
        reshard_gpt2_params,
        serving_mesh,
        shard_gpt2_params,
    )

    fsdp_mesh = init_device_mesh((4,), ("fsdp",))
    half = init_device_mesh((2,), ("fsdp",), ranks=(2, 3))
    smesh = serving_mesh(dp=1, tp=4)
    result = {}
    # FSDP(4) -> TP(1, 4): the trainer's blocks onto the serving layout
    src = GPT2(GPT2Config(**tph.SERVE), device="cpu")
    src.load_state_dict(state_dict)
    strategy = _fsdp(fsdp_mesh)
    shard_module(src, strategy)
    executor.reset_counts()
    blocks, cost = reshard_gpt2_params(src, smesh, strategy=strategy,
                                       with_cost=True)
    result["reshard_counts"] = dict(executor.counts)
    result["reshard_cost"] = cost
    want = GPT2(GPT2Config(**tph.SERVE), device="cpu")
    want.load_state_dict(state_dict)
    shard_gpt2_params(want, smesh)
    result["blocks_equal"] = all(torch.equal(blocks[n], t)
                                 for n, t in want.state_dict().items())
    result["streams"] = {}
    for kind in ("slotted", "paged"):
        model = GPT2(GPT2Config(**tph.SERVE), device="cpu", seed=3)
        shard_gpt2_params(model, smesh)
        model.load_state_dict(blocks)
        result["streams"][kind] = _serve_streams(model, kind, smesh)
    # a staged swap mid-stream: other weights laid out FSDP over ranks 2
    # and 3 (ranks 0 and 1 hold none) into TP schedulers on all four
    source = _fsdp_blocks(other, half, rank, [2, 3])
    result["swap"] = {}
    for kind in ("slotted", "paged"):
        model = GPT2(GPT2Config(**tph.SERVE), device="cpu")
        model.load_state_dict(state_dict)
        shard_gpt2_params(model, smesh)
        sched = _engine(model, kind, smesh)
        ptrs = {n: p.data_ptr() for n, p in model.named_parameters()}
        for p in swap_prompts():
            sched.submit(Request(prompt=p, max_new_tokens=12))
        for _ in range(SWAP_AT):
            sched.step()
        executor.reset_counts()
        cost = sched.swap_params(source, max_staging_bytes=SWAP_STAGING)
        counts = dict(executor.counts)
        (ev,) = [e for e in recent_events(50)
                 if e.name == "serving.weight_swap"][-1:]
        finished = sched.run()
        result["swap"][kind] = {
            "streams": {f.request_id: list(f.tokens) for f in finished},
            "cost": cost, "counts": counts, "event": dict(ev.metadata),
            "ptrs_kept": ptrs == {n: p.data_ptr()
                                  for n, p in model.named_parameters()},
            "replays": sched.engine.replays}
    torch.save(result, f"{store_dir}/serve.rank{rank}.pt")


def global_of(blocks, dims):
    """The whole tensor from each rank's block along ``dims`` (one dim or
    none)."""
    if not dims:
        return blocks[0]
    (d,) = dims
    return torch.cat(blocks, d)


def total_bytes(shape, dtype):
    return math.prod(shape) * torch.empty(0, dtype=dtype).element_size()
