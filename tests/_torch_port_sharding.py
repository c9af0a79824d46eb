"""Shared pieces of the port's sharding tests: the test MLP, batches, and a
rank body that trains one model under a list of strategies on the gloo
ranks of ``tests/_torch_port_ranks.py`` and saves what each run did.

Imports no JAX: every rank imports this module afresh.

A job is a dict: ``tag``, ``strategy`` (``noshard``, ``dp``, ``zero1``,
``zero1_state`` (``sharded_update=False``), ``fsdp``, ``fsdp_dp`` (mesh
``(2, 2)`` over ``("dp", "fsdp")``) or ``hybrid`` (``init_hybrid_mesh((2,),
(2,), ("dcn", "fsdp"))``)), ``model`` (``gpt2``, ``mlp`` or ``resnet``: a
ResNet-18 8 filters wide), ``state_dict``,
``batches``, and optionally ``opt_state`` (an optax state to load whole:
``("adamw", count, mu, nu)`` or ``("sgd", trace)``), ``policy``,
``dtype``, ``scaler`` (GradScaler keywords), ``clip``, ``runner`` (run the
batches through ``AsyncRunner``) and ``min_shard_size`` (8). A rank saves
``{tag}.rank{r}.pt``: per-step metrics, the gathered parameters and
optimizer state, the shapes it holds, and the collectives of its last
step.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

GPT2_TINY = dict(vocab_size=256, n_positions=32, n_embd=64, n_layer=2,
                 n_head=2)
LR, WD = 1e-3, 1e-4          # optax.adamw's default weight decay
SGD_LR, MOMENTUM = 0.1, 0.9
MIN_SHARD = 8


class MLP(nn.Module):
    """``tests/test_sharded_update.py``'s MLP (Dense 64, relu, Dense 64,
    relu, Dense 10 over a flattened 8x8x1 image) with its flax names,
    computing in ``dtype`` over fp32 parameters."""

    def __init__(self, width=64, n_out=10, dtype=torch.float32, seed=0):
        super().__init__()
        torch.manual_seed(seed)
        self.Dense_0 = nn.Linear(64, width)
        self.Dense_1 = nn.Linear(width, width)
        self.Dense_2 = nn.Linear(width, n_out)
        self.dtype = dtype

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i, lin in enumerate((self.Dense_0, self.Dense_1, self.Dense_2)):
            x = F.linear(x.to(self.dtype), lin.weight.to(self.dtype),
                         lin.bias.to(self.dtype))
            if i < 2:
                x = F.relu(x)
        return x


def mlp_state_dict_from_flax(params):
    """flax ``Dense_<i>`` kernels ``[in, out]`` as torch ``[out, in]``
    weights (also any tree of the same structure: optax's moments)."""
    sd = {}
    for i in range(3):
        d = params[f"Dense_{i}"]
        sd[f"Dense_{i}.weight"] = torch.tensor(np.asarray(d["kernel"]).T.copy())
        sd[f"Dense_{i}.bias"] = torch.tensor(np.asarray(d["bias"]))
    return sd


def mlp_batch(n=32, seed=0):
    """``tests/test_sharded_update.py``'s ``make_batch``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, y


def lm_batches(n, B, seed, T=32):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, GPT2_TINY["vocab_size"],
                           (B, T + 1)).astype(np.int32)
        out.append((tok[:, :-1], tok[:, 1:]))
    return out


def make_strategy(kind, min_shard_size=MIN_SHARD, device="cpu"):
    from pytorch_distributed_tpu_torch import distributed as pdist
    from pytorch_distributed_tpu_torch.mesh import (
        init_device_mesh,
        init_hybrid_mesh,
    )
    from pytorch_distributed_tpu_torch.parallel import (
        DataParallel,
        FullyShardedDataParallel,
        HybridShard,
        NoShard,
        ZeRO1,
    )

    if kind == "noshard":
        return NoShard(device)
    n = pdist.get_world_size()
    if kind == "dp":
        return DataParallel(init_device_mesh((n,), ("dp",)))
    if kind in ("zero1", "zero1_state"):
        return ZeRO1(init_device_mesh((n,), ("dp",)),
                     min_shard_size=min_shard_size,
                     sharded_update=kind == "zero1")
    if kind == "fsdp":
        return FullyShardedDataParallel(init_device_mesh((n,), ("fsdp",)),
                                        min_shard_size=min_shard_size)
    if kind == "fsdp_dp":
        mesh = init_device_mesh((2, n // 2), ("dp", "fsdp"))
        return FullyShardedDataParallel(mesh, dp_axis="dp",
                                        min_shard_size=min_shard_size)
    if kind == "hybrid":
        mesh = init_hybrid_mesh((n // 2,), (2,), ("dcn", "fsdp"))
        return HybridShard(mesh, min_shard_size=min_shard_size)
    raise ValueError(kind)


def build(job, strategy, device="cpu"):
    from pytorch_distributed_tpu_torch.amp import GradScaler
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.trainer import (
        Trainer,
        classification_loss,
        lm_loss,
    )

    dtype = job.get("dtype", torch.float32)
    if job["model"] == "gpt2":
        model = GPT2(GPT2Config(dtype=dtype, **GPT2_TINY), device=device,
                     seed=0)
        opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD,
                                eps=1e-8)
        loss_fn = lm_loss
    elif job["model"] == "resnet":
        from pytorch_distributed_tpu_torch.models import resnet18

        model = resnet18(10, cifar_stem=True, num_filters=8, device=device,
                         seed=0)
        opt = torch.optim.SGD(model.parameters(), lr=0.05,
                              momentum=MOMENTUM)
        loss_fn = classification_loss
    else:
        model = MLP(dtype=dtype).to(device)
        opt = torch.optim.SGD(model.parameters(), lr=SGD_LR,
                              momentum=MOMENTUM)
        loss_fn = classification_loss
    model.load_state_dict(job["state_dict"])
    scaler = GradScaler(**job["scaler"]) if "scaler" in job else None
    trainer = Trainer(model, opt, strategy, loss_fn=loss_fn,
                      policy=job.get("policy", "fp32"), scaler=scaler,
                      clip_norm=job.get("clip"))
    state = trainer.init()
    if "opt_state" in job:
        from pytorch_distributed_tpu_torch.models import convert

        kind, *rest = job["opt_state"]
        if kind == "adamw":
            convert.load_adamw_state_from_optax(opt, model, *rest,
                                                layout=trainer.layout)
        else:
            convert.load_sgd_state_from_optax(opt, model, *rest,
                                              layout=trainer.layout)
    return trainer, state


def held_shapes(trainer):
    """The shapes this rank holds: parameters and optimizer state."""
    opt = trainer.optimizer
    return {
        "params": {n: tuple(p.shape)
                   for n, p in trainer.model.named_parameters()},
        "opt": {i: {k: tuple(v.shape) for k, v in opt.state[t].items()}
                for group in opt.param_groups
                for i, t in enumerate(group["params"])},
        "opt_bytes": sum(v.numel() * v.element_size()
                         for st in opt.state.values() for v in st.values()
                         if isinstance(v, torch.Tensor)),
        "param_bytes": sum(p.numel() * p.element_size()
                           for p in trainer.model.parameters()),
    }


NOISE_FLOOR = 1e-6


def full_grads(trainer):
    """The gradients the optimizer stepped on, whole (collective)."""
    from pytorch_distributed_tpu_torch.parallel.fsdp import full_tensor

    if trainer.layout is None:
        return {n: p.grad for n, p in trainer.model.named_parameters()}
    return {leaf.name: full_tensor(leaf.tensor.grad,
                                   trainer.layout.spec(leaf.name))
            for leaf in trainer.layout.leaves}


def run_job(job, device="cpu"):
    """Train ``job`` on this rank; returns what ``rank_body`` saves.
    ``small`` marks the elements whose gradient fell below NOISE_FLOOR at
    some step, where Adam's step is ill-conditioned."""
    from pytorch_distributed_tpu_torch.models import (
        full_optimizer_state,
        full_state_dict,
    )
    from pytorch_distributed_tpu_torch.parallel import comm

    strategy = make_strategy(job["strategy"],
                             job.get("min_shard_size", MIN_SHARD), device)
    trainer, state = build(job, strategy, device)
    batches = job["batches"]
    metrics, small = {}, {}
    if job.get("runner"):
        from pytorch_distributed_tpu_torch.pipeline_exec import AsyncRunner

        runner = AsyncRunner(trainer, depth=2, drain_every=len(batches))
        state, hist = runner.run(state, batches)
        metrics = {k: [float(x) for x in hist[k]] for k in hist.keys()}
        counts = None
    else:
        for i, batch in enumerate(batches):
            if i == len(batches) - 1:
                comm.reset_counts()
            state, m = trainer.step(state, batch)
            counts = dict(comm.counts)
            for k, v in m.items():
                metrics.setdefault(k, []).append(float(v))
            for n, g in full_grads(trainer).items():
                tiny = g.abs() < NOISE_FLOOR
                small[n] = small[n] | tiny if n in small else tiny
    return {
        "metrics": metrics,
        "small": small,
        "params": full_state_dict(trainer.model),
        "opt": full_optimizer_state(trainer.optimizer, trainer.model,
                                    trainer.layout),
        "held": held_shapes(trainer),
        "counts": counts,
        "n_leaves_sharded": sum(
            leaf.sharded for leaf in (trainer.layout.leaves
                                      if trainer.layout else ())),
    }


def rank_body(rank, store_dir, jobs):
    torch.set_num_threads(1)
    for job in jobs:
        torch.save(run_job(job), f"{store_dir}/{job['tag']}.rank{rank}.pt")


def load(store_dir, tag, world):
    return [torch.load(f"{store_dir}/{tag}.rank{r}.pt", weights_only=False)
            for r in range(world)]


def check_against(results, trace, last, rtol, start=0):
    """The ranks' results against a reference run's ``trace`` (loss, grad
    norm per step, from step ``start``) and final parameters ``last``:
    the mean of the ranks' losses and each rank's norm within ``rtol``,
    every rank holding the same parameters, each within rtol 1e-4 plus
    1e-5 where Adam is well-conditioned and within ``2 x steps x lr``
    where it is not (an element whose gradient fell below NOISE_FLOOR at
    some step, and GPT-2's key bias; under 1% of all besides those)."""
    for step, (loss, norm) in enumerate(trace[start:]):
        mean = np.mean([res["metrics"]["loss"][step] for res in results])
        np.testing.assert_allclose(mean, loss, rtol=rtol)
        for res in results:
            np.testing.assert_allclose(res["metrics"]["grad_norm"][step],
                                       norm, rtol=rtol)
    for res in results:
        for name, p in res["params"].items():
            assert torch.equal(p, results[0]["params"][name]), name
    steps = len(trace) - start
    C = GPT2_TINY["n_embd"]
    n_small = n_all = 0
    for name, p in results[0]["params"].items():
        w, ill = last[name], results[0]["small"][name].clone()
        if name.endswith("attn.c_attn.bias"):
            ill[C:2 * C] = True
        assert float((p - w).abs().where(ill, 0).max()) <= 2 * steps * LR
        torch.testing.assert_close(p[~ill], w[~ill], rtol=1e-4, atol=1e-5,
                                   msg=name)
        if name.endswith("attn.c_attn.bias"):
            ill[C:2 * C] = False
        n_small += int(ill.sum())
        n_all += ill.numel()
    assert n_small <= 1e-2 * n_all, (n_small, n_all)


# -- the JAX side (imported lazily: the ranks never call these) ------------
def jax_strategy(kind, min_shard_size=MIN_SHARD, n=4):
    import jax

    from pytorch_distributed_tpu.mesh import init_device_mesh, init_hybrid_mesh
    from pytorch_distributed_tpu.parallel import (
        DataParallel,
        FullyShardedDataParallel,
        HybridShard,
        NoShard,
        ZeRO1,
    )

    devs = jax.devices()[:n]
    if kind == "noshard":
        return NoShard(init_device_mesh((n,), ("x",), devices=devs))
    if kind == "dp":
        return DataParallel(init_device_mesh((n,), ("dp",), devices=devs))
    if kind in ("zero1", "zero1_state"):
        return ZeRO1(init_device_mesh((n,), ("dp",), devices=devs),
                     min_shard_size=min_shard_size,
                     sharded_update=kind == "zero1")
    if kind == "fsdp":
        return FullyShardedDataParallel(
            init_device_mesh((n,), ("fsdp",), devices=devs),
            min_shard_size=min_shard_size)
    if kind == "fsdp_dp":
        return FullyShardedDataParallel(
            init_device_mesh((2, n // 2), ("dp", "fsdp"), devices=devs),
            dp_axis="dp", min_shard_size=min_shard_size)
    if kind == "hybrid":
        mesh = init_hybrid_mesh((n // 2,), (2,), ("dcn", "fsdp"),
                                devices=devs, stub_slices=True)
        return HybridShard(mesh, min_shard_size=min_shard_size)
    raise ValueError(kind)


def flax_mlp():
    """``tests/test_sharded_update.py``'s flax MLP and loss."""
    import flax.linen as fnn
    import jax.numpy as jnp
    import optax

    class FlaxMLP(fnn.Module):
        @fnn.compact
        def __call__(self, x, train: bool = True):
            x = x.reshape((x.shape[0], -1))
            x = fnn.relu(fnn.Dense(64)(x))
            x = fnn.relu(fnn.Dense(64)(x))
            return fnn.Dense(10)(x)

    def mlp_loss(model, variables, batch, train, rngs=None):
        x, y = batch
        logits = model.apply(variables, x, train=train)
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), y).mean()
        return loss, ({}, {})

    return FlaxMLP(), mlp_loss


def jax_run(kind, model, batches, clip=None, keep_after=None):
    """The JAX ``Trainer`` under strategy ``kind`` on 4 virtual devices:
    (initial params as the port's state dict, per-step (loss, grad_norm),
    final params as the port's state dict, and after ``keep_after`` steps
    the params as the port's state dict with the optax state as a job's
    ``opt_state``)."""
    import jax
    import optax

    from pytorch_distributed_tpu.trainer import Trainer as JaxTrainer
    from pytorch_distributed_tpu_torch.models import gpt2_state_dict_from_flax

    if model == "gpt2":
        from pytorch_distributed_tpu.models import GPT2 as JaxGPT2
        from pytorch_distributed_tpu.models import GPT2Config as JaxCfg
        from pytorch_distributed_tpu.trainer import lm_loss as jax_lm_loss

        net, loss_fn, tx = (JaxGPT2(JaxCfg(**GPT2_TINY)), jax_lm_loss,
                            optax.adamw(LR))
        to_torch = gpt2_state_dict_from_flax
    else:
        net, loss_fn = flax_mlp()
        tx = optax.sgd(SGD_LR, momentum=MOMENTUM)
        to_torch = mlp_state_dict_from_flax
    trainer = JaxTrainer(net, tx, jax_strategy(kind), loss_fn=loss_fn,
                         clip_norm=clip)
    state = trainer.init(jax.random.key(0), batches[0])
    first = to_torch(jax.tree_util.tree_map(np.asarray, state.params))
    trace, kept = [], None
    for i, batch in enumerate(batches):
        if i == keep_after:
            kept = _kept(state, model, to_torch)
        state, m = trainer.step(state, batch)
        trace.append((float(m["loss"]), float(m["grad_norm"])))
    last = to_torch(jax.tree_util.tree_map(np.asarray, state.params))
    return first, trace, last, kept


def _kept(state, model, to_torch):
    import jax

    host = jax.tree_util.tree_map(np.asarray, state)   # the step donates
    opt = host.opt_state[0]
    if model == "gpt2":
        return to_torch(host.params), ("adamw", opt.count, opt.mu, opt.nu)
    return to_torch(host.params), ("sgd", opt.trace)


def gpt2_against_jax(tmp, kinds, carry=(), fsdp_dp=False, steps=3):
    """GPT-2 on the 4 gloo ranks under each strategy of ``kinds`` (and
    ``fsdp_dp``), from the weights flax drew, while the JAX ``Trainer``
    runs the same strategies; each of ``carry`` also loads the JAX NoShard
    run's params and AdamW state after its first step and takes its next
    steps. Returns (the ranks' results by tag, the JAX runs by kind, with
    ``noshard`` among them)."""
    from tests import _torch_port_ranks as ranks

    batches = lm_batches(steps, 8, seed=0)
    first, ns_trace, ns_last, (kept_sd, kept_opt) = jax_run(
        "noshard", "gpt2", batches, keep_after=1)
    base = dict(model="gpt2", state_dict=first, batches=batches)
    jobs = [dict(base, tag=k, strategy=k)
            for k in tuple(kinds) + (("fsdp_dp",) if fsdp_dp else ())]
    for k in carry:
        jobs.append(dict(base, tag=f"{k}_carry", strategy=k,
                         state_dict=kept_sd, opt_state=kept_opt,
                         batches=batches[1:]))
    ctx = ranks.start(rank_body, tmp, jobs)
    want = {k: jax_run(k, "gpt2", batches) for k in kinds}
    want["noshard"] = (first, ns_trace, ns_last, None)
    ranks.finish(ctx)
    got = {job["tag"]: load(tmp, job["tag"], ranks.WORLD) for job in jobs}
    return got, want
