"""Rank bodies of the port's communication tests (the process-group API,
the mesh-axis collectives, the gradient hooks, PowerSGD, model averaging),
run on the gloo ranks of ``tests/_torch_port_ranks.py``.

Imports no JAX: every rank imports this module afresh. Each body saves
``{name}.rank{r}.pt`` in the store directory, which the tests read.
"""

from datetime import timedelta

import torch

WS = 4
#: the gradient of the hook tests held in bf16
BF16_LEAF = 2


def _save(obj, store_dir, name, rank):
    torch.save(obj, f"{store_dir}/{name}.rank{rank}.pt")


def load(store_dir, name, world=WS):
    return [torch.load(f"{store_dir}/{name}.rank{r}.pt", weights_only=False)
            for r in range(world)]


# -- the process-group API ---------------------------------------------------
def pg_cases(rank, pg):
    """``tests/test_process_group.py``'s ``TestCollectives`` on the port's
    group (tensors where the reference has numpy arrays)."""
    from pytorch_distributed_tpu_torch.distributed import ReduceOp

    out = {}
    out["all_reduce_sum"] = pg.all_reduce(
        torch.full((3,), float(rank + 1))).result()
    x = torch.tensor([float(rank + 1)])
    out["all_reduce_ops"] = {
        name: float(pg.all_reduce(x.clone(), op).result()[0])
        for name, op in (("max", ReduceOp.MAX), ("min", ReduceOp.MIN),
                         ("avg", ReduceOp.AVG), ("prod", ReduceOp.PRODUCT))}
    out["broadcast"] = pg.broadcast(torch.full((2,), float(rank)),
                                    src=2).result()
    out["all_gather"] = pg.all_gather(torch.tensor([rank, rank * 10])).result()
    out["reduce_to_dst"] = pg.reduce(torch.tensor([1.0]), dst=1).result()
    chunks = ([torch.tensor([10.0 * r]) for r in range(WS)] if rank == 0
              else None)
    out["scatter"] = pg.scatter(chunks, src=0,
                                out=torch.empty(1)).result()
    out["reduce_scatter"] = pg.reduce_scatter(
        torch.arange(8, dtype=torch.float64)).result()
    out["all_to_all"] = pg.all_to_all(
        [torch.tensor([rank * 10 + c]) for c in range(WS)]).result()
    if rank == 0:
        pg.send(torch.tensor([42.0]), dst=3)
        out["send_recv"] = None
    elif rank == 3:
        out["send_recv"] = pg.recv(torch.empty(1), src=0)
    else:
        out["send_recv"] = None
    w = pg.barrier(async_op=True)
    w.wait(timeout=timedelta(seconds=30))
    out["barrier_and_async"] = w.is_success() and w.is_completed()
    out["object_collectives"] = (
        pg.all_gather_object({"rank": rank, "data": [rank] * 2}),
        pg.broadcast_object("hello" if rank == 0 else None, src=0))
    return out


def pg_rank(rank, store_dir):
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch import distributed as pdist
    from pytorch_distributed_tpu_torch.distributed import (
        C10dBackend,
        P2POp,
        ProcessGroupWrapper,
        batch_isend_irecv,
        coalescing_manager,
    )
    from pytorch_distributed_tpu_torch.observability import recent_events

    pg = pdist.get_default_group()
    out = {"cases": pg_cases(rank, pg)}

    # the desync wrapper, over the default group's c10d object
    wrapped = ProcessGroupWrapper(
        C10dBackend(dist.group.WORLD), "wrapped",
        store=dist.PrefixStore("wrapped", pdist._world.store),
        timeout=timedelta(seconds=30))
    out["wrapper_match"] = wrapped.all_reduce(torch.ones(3)).result()
    out["wrapper_objects"] = (
        wrapped.all_gather_object("x" * (rank * 100 + 1)),
        wrapped.broadcast_object({"big": "B" * 500} if rank == 0 else None))
    try:
        wrapped.all_reduce(torch.ones(3 if rank != 2 else 5))
        out["wrapper_mismatch"] = None
    except RuntimeError as e:
        out["wrapper_mismatch"] = str(e)

    # batch_isend_irecv: send right, receive left, on the default group
    # and on the mesh-free c10d group object
    recv = torch.empty(3)
    works = batch_isend_irecv(pg, [
        P2POp("isend", torch.full((3,), float(rank)), (rank + 1) % WS, 1),
        P2POp("irecv", recv, (rank - 1) % WS, 1)])
    out["ring"] = works[1].result()
    works[0].wait()

    # one wire operation per dtype
    calls = {"n": 0}
    orig = pg.backend.all_reduce

    def counting(t, op):
        calls["n"] += 1
        return orig(t, op)

    pg.backend.all_reduce = counting
    with coalescing_manager(pg) as cm:
        ha = cm.all_reduce(torch.full((2, 2), float(rank),
                                      dtype=torch.float64))
        hb = cm.all_reduce(torch.arange(3, dtype=torch.float64) + rank)
        hc = cm.all_reduce(torch.full((4,), float(rank)))
    pg.backend.all_reduce = orig
    out["coalescing"] = (calls["n"], ha.result, hb.result, hc.result)

    # the module API: module-level collectives and a subgroup
    out["module_all_reduce"] = pdist.all_reduce(torch.ones(2))
    out["rank_size"] = (pdist.get_rank(), pdist.get_world_size())
    sub = pdist.new_group([0, 1])
    out["subgroup"] = (None if sub is None else
                       (sub.rank, sub.world_size,
                        sub.all_reduce(torch.full((2,), float(rank))).result()))

    # shrink_group: rank 1 is "dead" and takes no part
    if rank != 1:
        try:
            pdist.shrink_group([rank])
        except ValueError as e:
            out["shrink_self"] = str(e)
        shrunk = pdist.shrink_group([1])
        out["shrink"] = (shrunk.rank, shrunk.world_size,
                         float(shrunk.all_reduce(
                             torch.tensor([float(rank)])).result()[0]))
        shrunk.barrier()
    pg.barrier()
    out["events"] = [(e.metadata or {}) for e in recent_events(500)
                     if e.name == "collective"]
    _save(out, store_dir, "pg", rank)


# -- the mesh-axis collectives ----------------------------------------------
def collectives_rank(rank, store_dir, xs):
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.ops import collectives as ops
    from pytorch_distributed_tpu_torch.parallel import comm

    mesh = init_device_mesh((WS,), ("dp",))
    mesh22 = init_device_mesh((2, 2), ("a", "b"))
    mine = {k: torch.tensor(v[rank]) for k, v in xs.items()}
    out = {
        "all_reduce_sum": ops.all_reduce(mine["x"], mesh, "dp"),
        "all_reduce_ops": {op: ops.all_reduce(mine["x"], mesh, "dp", op)
                           for op in ("mean", "max", "min")},
        "all_reduce_prod": ops.all_reduce(mine["neg"], mesh, "dp", "prod"),
        "all_gather": ops.all_gather(mine["rows"], mesh, "dp", gather_dim=0),
        "all_gather_dim1": ops.all_gather(mine["rows"], mesh, "dp",
                                          gather_dim=1),
        "all_gather_stacked": ops.all_gather(mine["rows"], mesh, "dp",
                                             tiled=False),
        "reduce_scatter": ops.reduce_scatter(mine["square"], mesh, "dp"),
        "reduce_scatter_mean_dim1": ops.reduce_scatter(
            mine["square"], mesh, "dp", op="mean", scatter_dim=1),
        "broadcast": ops.broadcast(mine["x"], mesh, "dp", src=2),
        "all_to_all": ops.all_to_all(mine["a2a"], mesh, "dp", split_dim=1,
                                     concat_dim=0),
        "all_to_all_untiled": ops.all_to_all(mine["a2a_u"], mesh, "dp",
                                             split_dim=0, concat_dim=1,
                                             tiled=False),
        "permute_ring": ops.permute(mine["x"], mesh, "dp",
                                    [(i, (i + 1) % WS) for i in range(WS)]),
        "permute_partial": ops.permute(mine["x"], mesh, "dp", [(0, 2)]),
        "send_to": ops.send_to(mine["x"], mesh, "dp", dst_offset=1),
        "recv_from": ops.recv_from(mine["x"], mesh, "dp", src_offset=1),
        "axis_index_size": (ops.axis_index(mesh, "dp"),
                            ops.axis_size(mesh, "dp")),
        "submesh": (ops.all_reduce(mine["x"], mesh22, "b"),
                    ops.all_reduce(mine["x"], mesh22, ("a", "b")),
                    ops.axis_index(mesh22, "b"), ops.axis_size(mesh22, "a")),
    }
    comm.reset_counts()
    out["barrier"] = ops.barrier(mesh, "dp")
    ops.all_reduce(mine["x"], mesh, "dp")
    ops.send_to(mine["x"], mesh, "dp")
    out["counts"] = (dict(comm.counts), dict(comm.wire_bytes))
    _save(out, store_dir, "collectives", rank)


# -- the gradient hooks ------------------------------------------------------
def hooks_rank(rank, store_dir, grads, cap_mb):
    """Each hook on this rank's gradients (``grads[rank]``: numpy arrays),
    with the collectives and bytes it issued."""
    from pytorch_distributed_tpu_torch.parallel import comm, comm_hooks

    group = torch.distributed.group.WORLD
    mine = [torch.tensor(g) for g in grads[rank]]
    mine[BF16_LEAF] = mine[BF16_LEAF].to(torch.bfloat16)
    hooks = {
        "allreduce": comm_hooks.allreduce_hook,
        "bf16_compress": comm_hooks.bf16_compress,
        "fp16_compress": comm_hooks.fp16_compress,
        "reduce_scatter": comm_hooks.reduce_scatter_hook,
        "ring_allreduce": comm_hooks.ring_allreduce_hook,
        "reduce_scatter_small": comm_hooks.make_bucketed_rs_hook(cap_mb),
        "ring_allreduce_small": comm_hooks.make_ring_allreduce_hook(cap_mb),
    }
    out = {}
    for name, hook in hooks.items():
        comm.reset_counts()
        synced = hook([g.clone() for g in mine], group)
        out[name] = {"synced": synced, "counts": dict(comm.counts),
                     "wire_bytes": dict(comm.wire_bytes),
                     "dtypes": [g.dtype for g in synced]}
    _save(out, store_dir, "hooks", rank)


def hooks_and_trainer_rank(rank, store_dir, grads, cap_mb, *trainer_args):
    hooks_rank(rank, store_dir, grads, cap_mb)
    trainer_rank(rank, store_dir, *trainer_args)


# -- Trainer with a hook -----------------------------------------------------
def resnet_trainer(rank, mesh, state_dict, hook, bn_axis_name, width,
                   lr, momentum):
    from pytorch_distributed_tpu_torch.models import resnet18
    from pytorch_distributed_tpu_torch.parallel import DataParallel
    from pytorch_distributed_tpu_torch.trainer import (
        Trainer,
        classification_loss,
    )

    model = resnet18(10, cifar_stem=True, num_filters=width,
                     bn_axis_name=bn_axis_name, device="cpu", seed=rank)
    if rank == 0:
        model.load_state_dict(state_dict)
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum)
    trainer = Trainer(model, opt, DataParallel(mesh, "dp"),
                      loss_fn=classification_loss, comm_hook=hook)
    return trainer, trainer.init()


def trainer_rank(rank, store_dir, jobs, state_dict, batch, steps, width,
                 lr, momentum):
    """One ResNet-18 run per job (``tag``, ``hook``: a name or PowerSGD's
    keywords, ``bn_axis_name``, optionally ``q``: PowerSGD's Q per torch
    parameter index, carried from the JAX run, and ``runner``)."""
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.parallel import PowerSGD, comm

    mesh = init_device_mesh((WS,), ("dp",))
    out = {}
    for job in jobs:
        hook = job["hook"]
        if isinstance(hook, dict):
            hook = PowerSGD(**hook)
        trainer, state = resnet_trainer(rank, mesh, state_dict, hook,
                                        job["bn_axis_name"], width, lr,
                                        momentum)
        for idx, q in job.get("q", {}).items():
            state.comm_state[str(idx)]["q"].copy_(torch.tensor(q))
        losses, counts = [], []
        if job.get("runner"):
            state, hist = trainer.run(state, [batch] * steps)
            losses = [float(v) for v in hist["loss"]]
        else:
            for _ in range(steps):
                comm.reset_counts()
                state, m = trainer.step(state, batch)
                losses.append(float(m["loss"]))
                counts.append((dict(comm.counts), dict(comm.wire_bytes)))
        out[job["tag"]] = {
            "losses": losses, "counts": counts,
            "state": {k: v.detach().clone()
                      for k, v in trainer.model.state_dict().items()},
            "comm_state": state.comm_state, "step": state.step}
    _save(out, store_dir, "trainer", rank)


# -- model averaging ---------------------------------------------------------
def averager_rank(rank, store_dir):
    from pytorch_distributed_tpu_torch import distributed as pdist
    from pytorch_distributed_tpu_torch.parallel import (
        PeriodicModelAverager,
        average_parameters,
    )

    pg = pdist.get_default_group()
    avg = PeriodicModelAverager(pg, period=2, warmup_steps=1)
    params = {"w": torch.full((3,), float(rank)),
              "b": torch.tensor(float(rank))}
    hist = []
    for _ in range(4):
        params = avg.average(params)
        hist.append(params["w"].clone())
    calls = {"n": 0}
    orig = pg.backend.all_reduce

    def counting(t, op):
        calls["n"] += 1
        return orig(t, op)

    pg.backend.all_reduce = counting
    mixed = average_parameters(
        {"a": torch.full((2, 2), float(rank)),
         "b": torch.arange(3, dtype=torch.float64) + rank}, pg)
    module = torch.nn.Linear(3, 2)
    with torch.no_grad():
        for p in module.parameters():
            p.fill_(float(rank))
    average_parameters(module, torch.distributed.group.WORLD)
    pg.backend.all_reduce = orig
    _save({"hist": hist, "calls": calls["n"], "mixed": mixed,
           "module": [p.detach().clone() for p in module.parameters()]},
          store_dir, "averager", rank)


# -- PowerSGD ------------------------------------------------------------------
def powersgd_rank(rank, store_dir, state_dict, batch, q_by_param, width, lr,
                  momentum, psgd):
    """ResNet-18 under PowerSGD (``psgd``: its keywords) with the JAX run's
    Q carried in (``q_by_param``: torch parameter index -> Q), 3 steps; the
    warm-up branch against the allreduce hook; the runner across
    ``start_iter`` against sequential steps; the collectives a step."""
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.parallel import PowerSGD, comm

    mesh = init_device_mesh((WS,), ("dp",))
    out = {}

    def run(hook, steps, q=None, runner=False):
        trainer, state = resnet_trainer(rank, mesh, state_dict, hook, None,
                                        width, lr, momentum)
        for idx, value in (q or {}).items():
            state.comm_state[str(idx)]["q"].copy_(torch.tensor(value))
        losses, counts = [], []
        if runner:
            from pytorch_distributed_tpu_torch.pipeline_exec import (
                AsyncRunner,
            )

            r = AsyncRunner(trainer, depth=2, drain_every=steps)
            state, hist = r.run(state, [batch] * steps)
            losses = [float(v) for v in hist["loss"]]
            programs = sorted(r.programs)
        else:
            programs = None
            for _ in range(steps):
                comm.reset_counts()
                state, m = trainer.step(state, batch)
                losses.append(float(m["loss"]))
                counts.append((dict(comm.counts), dict(comm.wire_bytes)))
        return {"losses": losses, "counts": counts, "programs": programs,
                "state": {k: v.detach().clone() for k, v in
                          trainer.model.state_dict().items()},
                "comm_state": state.comm_state, "step": state.step}

    out["carried"] = run(PowerSGD(**psgd), 3, q_by_param)
    out["warmup"] = run(PowerSGD(**{**psgd, "start_iter": 100}), 3)
    out["allreduce"] = run("allreduce", 3)
    across = dict(psgd, start_iter=2)
    out["sequential"] = run(PowerSGD(**across), 5)
    out["runner"] = run(PowerSGD(**across), 5, runner=True)
    out["cold"] = run(PowerSGD(**dict(psgd, warm_start=False)), 3)
    _save(out, store_dir, "powersgd", rank)


def powersgd_ckpt_rank(rank, store_dir, state_dict, batch, q_by_param, width,
                       lr, momentum, psgd, steps, at):
    """ResNet-18 under PowerSGD (``psgd``) with the JAX run's Q carried in:
    ``steps`` steps straight through; ``at`` steps, a ``CheckpointManager``
    save, a fresh trainer from other weights (and its own Q) restored from
    it, the rest; and on the runner, a save after ``at`` steps, the rest,
    a restore into the live runner, the rest again. Records losses, the
    model's state, the comm state, and whether the restore kept the comm
    state's tensors in place."""
    from pytorch_distributed_tpu_torch.checkpoint import (
        CheckpointManager,
        get_state_dict,
        set_state_dict,
    )
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.models import resnet18
    from pytorch_distributed_tpu_torch.parallel import PowerSGD
    from pytorch_distributed_tpu_torch.pipeline_exec import AsyncRunner

    mesh = init_device_mesh((WS,), ("dp",))
    other = resnet18(10, cifar_stem=True, num_filters=width, device="cpu",
                     seed=123).state_dict()

    def fresh(sd, carry):
        trainer, state = resnet_trainer(rank, mesh, sd, PowerSGD(**psgd),
                                        None, width, lr, momentum)
        if carry:
            for idx, value in q_by_param.items():
                state.comm_state[str(idx)]["q"].copy_(torch.tensor(value))
        return trainer, state

    def snapshot(trainer, state, losses):
        return {"losses": losses, "step": state.step,
                "state": {k: v.detach().clone() for k, v in
                          trainer.model.state_dict().items()},
                "comm_state": {k: {n: t.clone() for n, t in e.items()}
                               for k, e in state.comm_state.items()}}

    def steps_of(trainer, state, n):
        losses = []
        for _ in range(n):
            state, m = trainer.step(state, batch)
            losses.append(float(m["loss"]))
        return state, losses

    out = {}
    trainer, state = fresh(state_dict, True)
    state, losses = steps_of(trainer, state, steps)
    out["straight"] = snapshot(trainer, state, losses)

    ckpt = f"{store_dir}/psgd_ckpt"
    trainer, state = fresh(state_dict, True)
    state, first = steps_of(trainer, state, at)
    with CheckpointManager(ckpt) as mgr:
        mgr.save(state.step, get_state_dict(trainer, state))
    trainer, state = fresh(other, False)
    ptrs = [t.data_ptr() for e in state.comm_state.values()
            for t in e.values()]
    with CheckpointManager(ckpt) as mgr:
        state = set_state_dict(trainer, state,
                               mgr.restore(get_state_dict(trainer, state)))
    in_place = ptrs == [t.data_ptr() for e in state.comm_state.values()
                        for t in e.values()]
    restored = snapshot(trainer, state, [])
    state, rest = steps_of(trainer, state, steps - at)
    out["resumed"] = snapshot(trainer, state, first + rest)
    out["resumed"].update(in_place=in_place, restored=restored)

    trainer, state = fresh(state_dict, True)
    runner = AsyncRunner(trainer, depth=2, drain_every=at)
    state, h = runner.run(state, [batch] * at)
    programs = dict(runner.programs)
    with CheckpointManager(f"{ckpt}_runner") as mgr:
        mgr.save(state.step, get_state_dict(trainer, state))
        state, h_first = runner.run(state, [batch] * (steps - at))
        after = snapshot(trainer, state, [float(v) for v in h_first["loss"]])
        state = set_state_dict(trainer, state,
                               mgr.restore(get_state_dict(trainer, state)))
    state, h_again = runner.run(state, [batch] * (steps - at))
    out["runner"] = {
        "first": after,
        "again": snapshot(trainer, state, [float(v) for v in
                                           h_again["loss"]]),
        "losses_before": [float(v) for v in h["loss"]],
        "same_programs": all(runner.programs[k] is p
                             for k, p in programs.items()),
    }
    _save(out, store_dir, "psgd_ckpt", rank)
