"""Rank bodies of the port's pipeline tests, on the gloo ranks of
``tests/_torch_port_ranks.py``. Imports no JAX: every rank imports this
module afresh.

* ``gpipe_body``: ``gpipe_spmd`` at pp 4 on ``tests/test_pipeline.py``'s
  stacked tanh layers (8 layers of 8 x 8, two a stage), forward on 8
  microbatches and the gradient of ``sum(out ** 2)`` on 4; then the same
  layers times uniform noise from ``with_rng``'s tick generators, with
  remat on and off, again, and with another ``rng``;
* ``train_body``: ``tests/test_pipeline.py``'s tiny GPT-2 (vocab 64,
  n_positions 32, width 32, 4 layers, 4 heads) as ``GPT2Pipe`` under
  ``PipelineParallel`` at pp 4 and at (dp 2, pp 2), from the weights the
  JAX ``GPT2Pipe`` drew, ``STEPS`` AdamW steps, and 4 steps through
  ``make_chunked_lm_loss(4)`` (vocab 61, the JAX test's);
* ``ckpt_body``: the pp 4 run saved after ``CKPT_STEP`` steps and resumed
  by a fresh trainer, then the checkpoint loaded at (dp 2, pp 2); the same
  run through ``Trainer.run``, and a step of two accumulated halves;
* ``dropout_body``: every mask a (dp 2, pp 2) step draws, by (stage, dp
  shard, microbatch), a step drawn twice, eval (the model's and
  ``Trainer.eval_step``'s), 3 training steps, and the first of them with
  remat off;
* ``executor_body``: ``EagerPipelineExecutor`` on subgroups of the four
  ranks under every schedule of ``tests/test_pipeline.py``'s cases.
"""

import numpy as np
import torch

TINY = dict(vocab_size=64, n_positions=32, n_embd=32, n_layer=4, n_head=4)
LR, WD = 1e-3, 1e-4          # optax.adamw(1e-3)'s weight decay is 1e-4
STEPS = 4
MESHES = {"pp4": (1, 4), "dp2pp2": (2, 2)}
REMAT = {"pp4": True, "dp2pp2": False}   # as the reference tests build them
CKPT_STEP = 2
CHUNKED = dict(TINY, vocab_size=61)


def lm_batch(B=8, T=16, vocab=64, seed=0):
    """``tests/test_pipeline.py``'s ``lm_batch``."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (B, T)).astype(np.int32)
    return x, np.roll(x, -1, 1).astype(np.int32)


def chunked_batch():
    """``tests/test_chunked_xent.py``'s pipelined batch."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 61, (8, 32)).astype(np.int32)
    return toks, np.roll(toks, -1, 1).astype(np.int32)


def gpipe_inputs():
    """``tests/test_pipeline.py``'s ``TestGpipeSPMD`` arrays: the stacked
    weights, 8 forward microbatches and 4 gradient ones."""
    ws = (np.random.default_rng(0).standard_normal((8, 8, 8)) * 0.3
          ).astype(np.float32)
    fwd = np.random.default_rng(1).standard_normal((8, 2, 8)).astype(
        np.float32)
    grad = np.random.default_rng(2).standard_normal((4, 2, 8)).astype(
        np.float32)
    return ws, fwd, grad


def _mesh(shape):
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh

    return init_device_mesh(shape, ("dp", "pp"))


def gpipe_body(rank, store_dir):
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.parallel import gpipe_spmd
    from pytorch_distributed_tpu_torch.parallel import stage_links

    mesh = init_device_mesh((4,), ("pp",))
    ws, fwd, grad = gpipe_inputs()
    local = torch.tensor(ws[2 * rank:2 * rank + 2], requires_grad=True)

    def stage_fn(local_ws, x):
        for w in local_ws:
            x = torch.tanh(x @ w)
        return x

    run = gpipe_spmd(stage_fn, mesh, axis="pp")
    with torch.no_grad():
        out = run(local, torch.tensor(fwd))
    stage_links.reset_counts()
    y = run(local, torch.tensor(grad))
    (y ** 2).sum().backward()
    links = dict(stage_links.counts)

    # with_rng: each tick's generator from (rng, stage, dp shard,
    # microbatch), made again by the recomputation
    def noisy(local_ws, x, gen):
        for w in local_ws:
            x = torch.tanh(x @ w) * torch.rand(x.shape, generator=gen)
        return x

    rng = {}
    for remat in (True, False):
        run = gpipe_spmd(noisy, mesh, axis="pp", remat=remat, with_rng=True)
        w = local.detach().clone().requires_grad_(True)
        y_rng = run(w, torch.tensor(grad), 5)
        (y_rng ** 2).sum().backward()
        rng[remat] = {"out": y_rng.detach(), "grad": w.grad}
    with torch.no_grad():
        rng["again"] = run(local, torch.tensor(grad), 5)
        rng["other"] = run(local, torch.tensor(grad), 6)
    try:
        run(local, torch.tensor(grad))
    except ValueError as e:
        rng["no_rng"] = str(e)
    torch.save({"out": out, "grad": local.grad, "links": links,
                "zeros": bool((y == 0).all()), "rng": rng},
               f"{store_dir}/gpipe.rank{rank}.pt")


def _trainer(mesh, state_dict, *, remat, seed=0, loss_fn=None, **cfg):
    from pytorch_distributed_tpu_torch.models import (
        GPT2Config,
        gpt2_state_dict_from_flax,
    )
    from pytorch_distributed_tpu_torch.parallel import (
        GPT2Pipe,
        PipelineParallel,
    )
    from pytorch_distributed_tpu_torch.trainer import Trainer, lm_loss

    model = GPT2Pipe(GPT2Config(**{**TINY, **cfg}), mesh, dp_axis="dp",
                     n_microbatches=4, remat=remat, seed=seed)
    if state_dict is not None:
        model.load_state_dict(gpt2_state_dict_from_flax(
            state_dict, layers=model.layers))
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD,
                            eps=1e-8)
    trainer = Trainer(model, opt, PipelineParallel(mesh, dp_axis="dp"),
                      loss_fn=loss_fn or lm_loss)
    return trainer, trainer.init()


def _steps(trainer, state, n, batch=None):
    from pytorch_distributed_tpu_torch.parallel import comm, stage_links

    out = {}
    for i in range(n):
        if i == n - 1:
            comm.reset_counts()
            stage_links.reset_counts()
        state, m = trainer.step(state, batch or lm_batch())
        for k, v in m.items():
            out.setdefault(k, []).append(float(v))
    return state, out, dict(comm.counts), dict(stage_links.counts)


def train_body(rank, store_dir, flax_params, chunked_params):
    """Each mesh: ``STEPS`` steps from the JAX GPT2Pipe's weights; the
    rank's metrics, the collectives and links of the last step, what it
    holds, and its parameters after. Then the chunked loss at pp 4."""
    from pytorch_distributed_tpu_torch.trainer import make_chunked_lm_loss

    out = {}
    for tag, shape in MESHES.items():
        trainer, state = _trainer(_mesh(shape), flax_params,
                                  remat=REMAT[tag])
        model = trainer.model
        r = {"held": sorted(model.state_dict()),
             "layers": list(model.layers),
             "param_bytes": sum(p.numel() * p.element_size()
                                for p in model.parameters()),
             "data_shard": trainer.strategy.data_shard_index,
             "stage": trainer.strategy.stage_index}
        state, r["metrics"], r["counts"], r["links"] = _steps(
            trainer, state, STEPS)
        r["params"] = {k: v.clone() for k, v in model.state_dict().items()}
        out[tag] = r
    mesh = _mesh((1, 4))
    trainer, state = _trainer(mesh, chunked_params, remat=False,
                              loss_fn=make_chunked_lm_loss(4), **CHUNKED)
    _, out["chunked"], _, _ = _steps(trainer, state, 4, chunked_batch())
    out["refusal"] = _refusal(mesh)
    torch.save(out, f"{store_dir}/train.rank{rank}.pt")


def _refusal(mesh) -> str:
    """The Trainer's message for a model that is not a pipeline stage."""
    from pytorch_distributed_tpu_torch.parallel import PipelineParallel
    from pytorch_distributed_tpu_torch.trainer import Trainer, lm_loss

    lin = torch.nn.Linear(2, 2)
    try:
        Trainer(lin, torch.optim.AdamW(lin.parameters()),
                PipelineParallel(mesh, dp_axis="dp"), loss_fn=lm_loss).init()
    except ValueError as e:
        return str(e)
    return ""


def ckpt_body(rank, store_dir):
    """pp 4: ``STEPS`` steps, saved after ``CKPT_STEP``; a fresh trainer
    (other weights) restores and retakes the last steps; then a (dp 2, pp
    2) trainer restores the same checkpoint and takes one step."""
    from pytorch_distributed_tpu_torch.checkpoint import (
        CheckpointManager,
        get_state_dict,
        set_state_dict,
    )

    ckpt = f"{store_dir}/ckpt"
    mesh = _mesh((1, 4))
    trainer, state = _trainer(mesh, None, remat=True, seed=3)
    state, first, _, _ = _steps(trainer, state, CKPT_STEP)
    saved = get_state_dict(trainer, state)
    with CheckpointManager(ckpt) as mgr:
        mgr.save(state.step, saved)
    state, last, _, _ = _steps(trainer, state, STEPS - CKPT_STEP)
    out = {"keys": sorted(saved),
           "metrics": {k: first[k] + last[k] for k in first},
           "params": {k: v.clone() for k, v in
                      trainer.model.state_dict().items()},
           "exp_avg": {n: trainer.optimizer.state[p]["exp_avg"].clone()
                       for n, p in trainer.model.named_parameters()}}
    fresh, fstate = _trainer(mesh, None, remat=True, seed=11)
    with CheckpointManager(ckpt) as mgr:
        fstate = set_state_dict(fresh, fstate,
                                mgr.restore(get_state_dict(fresh, fstate)))
    out["restored_step"] = fstate.step
    fstate, again, _, _ = _steps(fresh, fstate, STEPS - CKPT_STEP)
    out["resumed"] = again
    out["resumed_params"] = {k: v.clone() for k, v in
                             fresh.model.state_dict().items()}
    out["resumed_exp_avg"] = {
        n: fresh.optimizer.state[p]["exp_avg"].clone()
        for n, p in fresh.model.named_parameters()}
    pp2, pstate = _trainer(_mesh((2, 2)), None, remat=False, seed=12)
    with CheckpointManager(ckpt) as mgr:
        pstate = set_state_dict(pp2, pstate,
                                mgr.restore(get_state_dict(pp2, pstate)))
    out["pp2_layers"] = list(pp2.model.layers)
    _, out["pp2_next"], _, _ = _steps(pp2, pstate, 1)
    # Trainer.run on the gloo pipeline (eager bodies), and a step of two
    # accumulated halves, from the same weights as the steps above
    run, rstate = _trainer(mesh, None, remat=True, seed=3)
    out["graph_capturable"] = run.graph_capturable
    _, hist = run.run(rstate, [lm_batch()] * STEPS)
    out["run_losses"] = hist["loss"].tolist()
    acc, astate = _trainer(mesh, None, remat=True, seed=3)
    acc.grad_accum_steps = 2
    _, out["accum"], _, _ = _steps(acc, astate, 1)
    torch.save(out, f"{store_dir}/ckpt.rank{rank}.pt")


def dropout_body(rank, store_dir):
    """(dp 2, pp 2), dropout 0.2: the masks a train step draws (as
    (microbatch, layer site) -> mask, in draw order), the same step's
    drawn again, the next step's; eval logits twice and train logits on
    the last stage; 3 steps of the trainer."""
    from pytorch_distributed_tpu_torch.parallel import pipeline

    trainer, state = _trainer(_mesh((2, 2)), None, remat=True, dropout=0.2)
    model = trainer.model
    drawn = []
    keep = pipeline._keep_mask

    def record(shape, rate, gen):
        m = keep(shape, rate, gen)
        drawn.append(m.clone())
        return m

    tokens = torch.tensor(lm_batch()[0][:4])

    def draws(step):
        drawn.clear()
        trainer.seed_dropout(step)
        model.train(True)
        with torch.no_grad():
            y = model(tokens)
        return list(drawn), y

    pipeline._keep_mask = record
    try:
        first, y_train = draws(0)
        again, y_again = draws(0)
        other, _ = draws(1)
    finally:
        pipeline._keep_mask = keep
    model.train(False)
    with torch.no_grad():
        ev1, ev2 = model(tokens), model(tokens)
    model.train(True)
    evals = [float(trainer.eval_step(state, lm_batch())["loss"])
             for _ in range(2)]
    # one step with remat off from the same seed: the recomputation
    # reuses the masks drawn before each stage application
    plain, pstate = _trainer(_mesh((2, 2)), None, remat=False, dropout=0.2)
    _, once, _, _ = _steps(plain, pstate, 1)
    _, metrics, _, _ = _steps(trainer, state, 3)
    torch.save({"eval_step": evals, "first": first, "again": again, "other": other,
                "no_remat": once,
                "y_train": y_train, "y_again": y_again, "eval": (ev1, ev2),
                "stage": trainer.strategy.stage_index,
                "data_shard": trainer.strategy.data_shard_index,
                "losses": metrics["loss"], "grad_norm": metrics["grad_norm"]},
               f"{store_dir}/dropout.rank{rank}.pt")


# -- the executor -----------------------------------------------------------
def chain_case(name, world, n_chunks, n_micro, seed):
    """``tests/test_pipeline.py``'s virtual-stage chains: the weight of
    each virtual stage, the microbatches and the targets."""
    n_virtual = world * n_chunks
    if name == "hetero":
        dims = [8, 16, 4, 2, 1]
    else:
        dims = [6 + (i % 3) * 2 for i in range(n_virtual)] + [1]
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((dims[v], dims[v + 1])) * 0.4).astype(
        np.float32) for v in range(n_virtual)]
    mbs = [rng.standard_normal((3, dims[0])).astype(np.float32)
           for _ in range(n_micro)]
    tgts = [rng.standard_normal((3, 1)).astype(np.float32)
            for _ in range(n_micro)]
    return ws, mbs, tgts


#: (case id, schedule, world, n_chunks, n_micro, seed): the reference
#: tests' cases (TestEager*, TestInterleaved1F1B, TestZBV, TestLoopedBFS,
#: TestDualPipeV)
EXECUTOR_CASES = (
    [(f"hetero-{s}", s, 4, 1, 4, 0) for s in ("gpipe", "1f1b", "zb")]
    + [(f"{s}-{w}-{c}-{n}", s, w, c, n, 1)
       for s in ("interleaved", "interleaved_zb")
       for w, c, n in ((2, 2, 4), (2, 3, 4), (4, 2, 8))]
    + [(f"zbv-{w}-{n}", "zbv", w, 2, n, 5) for w, n in ((2, 4), (3, 6))]
    + [(f"looped_bfs-{w}-{c}-{n}", "looped_bfs", w, c, n, 11)
       for w, c, n in ((2, 2, 4), (3, 2, 6), (2, 3, 4))]
    + [(f"dualpipev-{w}-{n}", "dualpipev", w, 2, n, 7)
       for w, n in ((2, 4), (2, 6), (4, 8))]
)


def placement(schedule, world, n_chunks, rank):
    """The virtual stages rank ``rank`` hosts, by chunk."""
    if schedule in ("zbv", "dualpipev"):
        return [rank, 2 * world - 1 - rank]
    return [c * world + rank for c in range(n_chunks)]


def _run_case(rank, group, case):
    from pytorch_distributed_tpu_torch.parallel import EagerPipelineExecutor

    cid, schedule, world, n_chunks, n_micro, seed = case
    ws, mbs, tgts = chain_case(cid.split("-")[0], world, n_chunks, n_micro,
                               seed)
    vs = placement(schedule, world, n_chunks, rank)
    last = world * n_chunks - 1
    params = [torch.tensor(ws[v]) for v in vs]

    def stage_fn(w, x):
        return torch.tanh(x @ w)

    def loss_fn(y, t):
        return ((y - t) ** 2).mean()

    ex = EagerPipelineExecutor(
        stage_fn, params if n_chunks > 1 else params[0], group,
        loss_fn=loss_fn if last in vs else None, schedule=schedule,
        n_chunks=n_chunks)
    kwargs = {}
    if 0 in vs:
        kwargs["microbatches"] = [torch.tensor(m) for m in mbs]
    if last in vs:
        kwargs["targets"] = [torch.tensor(t) for t in tgts]
    if not kwargs:
        kwargs["n_microbatches"] = n_micro
    loss, grads = ex.run(**kwargs)
    return {"loss": loss, "grads": grads if n_chunks > 1 else [grads],
            "stages": vs}


def executor_body(rank, store_dir):
    """Every case on the subgroup of its first ``world`` ranks (each
    subgroup made on every rank, in one order), then the reference's
    twice-on-one-group case on two ranks."""
    import torch.distributed as dist

    groups = {w: dist.new_group(list(range(w))) for w in (2, 3, 4)}
    out = {}
    for case in EXECUTOR_CASES:
        world = case[2]
        if rank < world:
            out[case[0]] = _run_case(rank, groups[world], case)
    if rank < 2:
        from pytorch_distributed_tpu_torch.parallel import (
            EagerPipelineExecutor,
        )

        ex = EagerPipelineExecutor(
            lambda w, x: x @ w, torch.eye(4), groups[2],
            loss_fn=(lambda y, t: ((y - t) ** 2).mean()) if rank == 1
            else None)
        mbs = [torch.ones(2, 4)] * 2
        tgts = [torch.zeros(2, 4)] * 2
        out["twice"] = [ex.run(**({"microbatches": mbs} if rank == 0
                                  else {"targets": tgts}))[0]
                        for _ in range(2)]
    torch.save(out, f"{store_dir}/executor.rank{rank}.pt")
