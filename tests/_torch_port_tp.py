"""Rank bodies of the port's tensor-parallel tests: TP training on the gloo
ranks of ``tests/_torch_port_ranks.py``, TP serving streams, and
``load_gpt2_params`` onto tp ranks. Imports no JAX: every rank imports this
module afresh.

The model is ``tests/test_tensor_parallel.py``'s tiny GPT-2 (vocab 64,
n_positions 32, width 32, 2 layers, 4 heads), trained with AdamW (lr 1e-3,
optax's weight decay 1e-4) on its batch (B=8, T=16) for ``STEPS`` steps.
A training job is ``(tag, mesh kind, sequence_parallel)``: ``tp4`` is
``(dp 1, tp 4)``, ``dp2tp2`` ``(dp 2, tp 2)``, ``fsdp2tp2`` ``(fsdp 2, tp
2)`` with ``min_shard_size=8``.
"""

import math

import numpy as np
import torch

TINY = dict(vocab_size=64, n_positions=32, n_embd=32, n_layer=2, n_head=4)
SERVE = dict(vocab_size=97, n_positions=48, n_embd=48, n_layer=2, n_head=4)
LR, WD = 1e-3, 1e-4
STEPS = 4
MESHES = {"tp4": ((1, 4), ("dp", "tp")), "dp2tp2": ((2, 2), ("dp", "tp")),
          "fsdp2tp2": ((2, 2), ("fsdp", "tp"))}


class StubMesh:
    """Sizes and this rank's coordinates of a mesh, no process groups:
    enough for the placement rules of ``TensorParallel``."""

    def __init__(self, shape, names, coords=None):
        self.shape = dict(zip(names, shape))
        self.axis_names = tuple(names)
        self.coords = coords or dict.fromkeys(names, 0)
        self.device = torch.device("cpu")

    def _axes(self, axis):
        return (axis,) if isinstance(axis, str) else tuple(axis)

    def size(self, axis):
        return math.prod(self.shape[a] for a in self._axes(axis))

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        rank = 0
        for a in self._axes(axis):
            rank = rank * self.shape[a] + self.coords[a]
        return rank


def lm_batch(B=8, T=16, vocab=64, seed=0):
    """``tests/test_tensor_parallel.py``'s ``lm_batch``."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (B, T)).astype(np.int32)
    return x, np.roll(x, -1, 1).astype(np.int32)


def make_strategy(kind, sequence_parallel):
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.parallel import (
        NoShard,
        TensorParallel,
        gpt2_tp_plan,
    )

    if kind == "noshard":
        return NoShard("cpu")
    shape, names = MESHES[kind]
    mesh = init_device_mesh(shape, names)
    if kind == "fsdp2tp2":
        return TensorParallel(mesh, gpt2_tp_plan(), dp_axis=None,
                              fsdp_axis="fsdp", min_shard_size=8,
                              sequence_parallel=sequence_parallel)
    return TensorParallel(mesh, gpt2_tp_plan(),
                          sequence_parallel=sequence_parallel)


NOISE_FLOOR = 1e-6


def whole_grads(trainer):
    """The gradients the optimizer stepped on, whole (collective)."""
    from pytorch_distributed_tpu_torch.models.convert import _whole

    if trainer.layout is None:
        return {n: _whole(p.grad, None, p)
                for n, p in trainer.model.named_parameters()}
    return {leaf.name: _whole(leaf.tensor.grad, trainer.layout.spec(leaf.name),
                              leaf.param)
            for leaf in trainer.layout.leaves}


def train(strategy, state_dict, steps=STEPS):
    """``steps`` AdamW steps on the one batch: per-step metrics, the
    collectives of the last step, the whole parameters after, the
    parameter bytes this rank holds, and ``small``: the elements whose
    reduced gradient fell below ``NOISE_FLOOR`` at some step (where Adam's
    step is ill-conditioned)."""
    from pytorch_distributed_tpu_torch.models import (
        GPT2,
        GPT2Config,
        full_state_dict,
    )
    from pytorch_distributed_tpu_torch.parallel import comm
    from pytorch_distributed_tpu_torch.trainer import Trainer, lm_loss

    model = GPT2(GPT2Config(**TINY), device="cpu")
    model.load_state_dict(state_dict)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD,
                            eps=1e-8)
    trainer = Trainer(model, opt, strategy, loss_fn=lm_loss)
    state = trainer.init()
    batch = lm_batch()
    metrics, small = {}, {}
    for i in range(steps):
        if i == steps - 1:
            comm.reset_counts()
        state, m = trainer.step(state, batch)
        counts = dict(comm.counts)
        for k, v in m.items():
            metrics.setdefault(k, []).append(float(v))
        for n, g in whole_grads(trainer).items():
            tiny = g.abs() < NOISE_FLOOR
            small[n] = small[n] | tiny if n in small else tiny
    return {
        "metrics": metrics,
        "small": small,
        "counts": counts,
        "params": full_state_dict(model),
        "param_bytes": sum(p.numel() * p.element_size()
                           for p in model.parameters()),
        "held": {n: tuple(p.shape) for n, p in model.named_parameters()},
    }


def train_body(rank, store_dir, jobs, state_dict):
    for tag, kind, sp in jobs:
        out = train(make_strategy(kind, sp), state_dict)
        torch.save(out, f"{store_dir}/{tag}.rank{rank}.pt")


def tp1_body(rank, store_dir, state_dict):
    """One rank: TensorParallel at (dp 1, tp 1), with and without SP,
    against NoShard from the same weights."""
    out = {"noshard": train(make_strategy("noshard", False), state_dict)}
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.parallel import (
        TensorParallel,
        gpt2_tp_plan,
    )

    mesh = init_device_mesh((1, 1), ("dp", "tp"))
    for sp in (False, True):
        out[f"tp1_sp{int(sp)}"] = train(
            TensorParallel(mesh, gpt2_tp_plan(), sequence_parallel=sp),
            state_dict)
    torch.save(out, f"{store_dir}/tp1.pt")


def serve_requests(seed=1, n=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, SERVE["vocab_size"], int(rng.integers(3, 14))),
             int(rng.integers(4, 12))) for _ in range(n)]


def streams(model, cache_kind, spec_k, cache_sharding=None):
    """Greedy streams of :func:`serve_requests` through the port's
    scheduler."""
    from pytorch_distributed_tpu_torch.serving import (
        InferenceEngine,
        Request,
        Scheduler,
    )

    kw = dict(n_slots=3, max_len=40, prefill_len=16)
    if cache_kind == "paged":
        kw.update(cache_kind="paged", page_size=4)
    if spec_k:
        kw.update(spec_k=spec_k, draft_layers=1)
    engine = InferenceEngine(model, device="cpu",
                             cache_sharding=cache_sharding, **kw)
    sched = Scheduler(engine, emit_events=False)
    for prompt, n_new in serve_requests():
        sched.submit(Request(prompt=prompt, max_new_tokens=n_new))
    return ({f.request_id: list(f.tokens) for f in sched.run()},
            engine.graphs)


def serve_body(rank, store_dir, tp, state_dict):
    """Every (cache kind, spec_k) stream on the ``(4 / tp, tp)`` serving
    mesh, and the parameter and cache shapes this rank holds."""
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.serving import (
        kv_cache_sharding,
        paged_kv_cache_sharding,
        serving_mesh,
        shard_gpt2_params,
    )

    mesh = serving_mesh(dp=4 // tp, tp=tp)
    out = {}
    for kind in ("slotted", "paged"):
        sharding = (kv_cache_sharding(mesh) if kind == "slotted"
                    else paged_kv_cache_sharding(mesh))
        for spec_k in (0, 3):
            model = GPT2(GPT2Config(**SERVE), device="cpu")
            model.load_state_dict(state_dict)
            shard_gpt2_params(model, mesh)
            out[(kind, spec_k)] = streams(model, kind, spec_k, sharding)
    out["held"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
    torch.save(out, f"{store_dir}/serve{tp}.rank{rank}.pt")


def load_body(rank, store_dir, ckpt_dir, cfg):
    """``load_gpt2_params`` onto tp ranks (the world is the tp axis), the
    checkpoint entries DCP read recorded."""
    from unittest import mock

    import torch.distributed.checkpoint as dcp

    from pytorch_distributed_tpu_torch.models import (
        GPT2,
        GPT2Config,
        full_state_dict,
    )
    from pytorch_distributed_tpu_torch.serving import (
        load_gpt2_params,
        serving_mesh,
    )

    read = []
    original = dcp.FileSystemReader.read_data

    def recording(self, plan, planner):
        read.extend(item.storage_index.fqn for item in plan.items)
        return original(self, plan, planner)

    model = GPT2(GPT2Config(**cfg), device="cpu", seed=99)
    mesh = serving_mesh(dp=1)
    with mock.patch.object(dcp.FileSystemReader, "read_data", recording):
        step = load_gpt2_params(ckpt_dir, model, mesh)
    torch.save({"step": step, "read": sorted(set(read)),
                "held": {n: tuple(p.shape)
                         for n, p in model.named_parameters()},
                "params": full_state_dict(model)},
               f"{store_dir}/load.rank{rank}.pt")


def train_ckpt_body(rank, store_dir, argv):
    """``examples.train_gpt2``'s ``main`` on the one-rank group the rank
    runs in (it keeps a caller's group): a checkpoint for the serving
    tests, made in a process of its own."""
    from pytorch_distributed_tpu_torch.examples.train_gpt2 import main

    torch.save(main(argv)["losses"], f"{store_dir}/train_losses.pt")


def cut_stream_body(rank, store_dir, state_dict, cfg):
    """On a one-rank ``(dp 1, tp 1)`` serving mesh: the greedy stream of a
    prompt through the whole model and through the model cut to its tp
    blocks with its cache on tp."""
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.serving import (
        InferenceEngine,
        Request,
        Scheduler,
        kv_cache_sharding,
        serving_mesh,
        shard_gpt2_params,
    )

    def stream(model, **kw):
        sched = Scheduler(InferenceEngine(model, n_slots=2, max_len=32,
                                          prefill_len=16, device="cpu", **kw),
                          emit_events=False)
        sched.submit(Request(prompt=np.array([5, 17, 3, 9, 44]),
                             max_new_tokens=8))
        return sched.run()[0].tokens

    out = {}
    for cut in (False, True):
        model = GPT2(GPT2Config(**cfg), device="cpu")
        model.load_state_dict(state_dict)
        kw = {}
        if cut:
            mesh = serving_mesh(dp=1, tp=1)
            shard_gpt2_params(model, mesh)
            kw = dict(cache_sharding=kv_cache_sharding(mesh))
        out[cut] = stream(model, **kw)
    torch.save(out, f"{store_dir}/cut_stream.pt")
