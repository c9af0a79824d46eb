"""The multi-rank dry-run grid: one tiny training step per parallelism family.

Port of ``pytorch_distributed_tpu/dryrun.py``. Each mode builds a mesh of
the group's ranks, runs ONE step of the port's ``Trainer`` under that
family's strategy on the reference's tiny model, batch (``_lm_batch``,
numpy seed 0), mesh factorization, optimizer and options, and asserts the
family's signature:

  * shard shapes: a sharded parameter's block on every rank is its whole
    torch shape cut ``ways`` on the torch dim that holds the reference's
    axis (the reference asserts it on the flax shape);
  * the family's collectives, from ``parallel.comm``'s counts of the step
    (the reference reads them off the compiled HLO): all-gather and a
    gradient reduction for fsdp and hsdp, all-gather and all-reduce for
    tp_sp, point to point for the pipeline's links and the ring's hops, a
    collective on the ep group for ep;
  * a finite loss;
  * loss parity with a one-rank twin: the same model on the same batch
    under ``NoShard`` on this rank, within 1e-3.

Families (``MODES``): ``fsdp`` (dp x fsdp GPT-2, 2 accumulated
microbatches, clipping at 1.0), ``hsdp`` (``HybridShard`` over a dcn x
fsdp mesh), ``tp_sp`` (the Megatron plan with sequence parallelism),
``pp`` (``GPT2Pipe`` under ``PipelineParallel``, dp x pp, 2
microbatches), ``cp`` (ring flash attention over cp, the batch
replicated) and ``ep`` (the MoE GPT-2 with ``moe_experts = ep``, top-2,
under ``ExpertDataParallel``).

The reference's tp_sp check is differential on HLO: the SP program holds
fewer all-reduce/all-gather instructions than the one without SP. The
port's collectives are written out, so its check reads the counted bytes
instead: with SP the step all-reduces no ``[B, T, C]`` activation (its
all-reduces are the dp mean, the norm and the sum of the partial
gradients), and it reduce-scatters exactly the activation bytes the step
without SP all-reduces.

The loss a mode reports is the global batch's: the mean over the ranks of
their losses (every data shard has as many ranks). :func:`run_grid` runs
on every rank of an initialized group; ``weights`` (``{mode: state
dict}``, the unsharded model's keys) replaces the seeded init, so a test
can start from the reference's parameters. Run the grid from the command
line::

    python -m pytorch_distributed_tpu_torch.dryrun --nproc 4 --device cpu
    python -m pytorch_distributed_tpu_torch.dryrun --nproc 4

It spawns the ranks: NCCL, one card a rank, where the machine has
``--nproc`` cards; otherwise gloo ranks sharing the first card; CPU gloo
ranks with ``--device cpu``. Rank 0 prints one line a mode.
"""

from __future__ import annotations

import argparse
import socket
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["run_grid", "MODES", "main"]

#: the reference's tolerance of the parallel step's loss against the twin's
PARITY_TOL = 1e-3
LR, WD = 1e-3, 1e-4          # optax.adamw(1e-3): weight decay 1e-4
_NAMES = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
          "send": "p2p", "recv": "p2p"}


def _check(cond, msg) -> None:
    """The grid's assertion: raises ``AssertionError`` (also under
    ``python -O``, which strips ``assert`` statements)."""
    if not cond:
        raise AssertionError(msg)


def _lm_batch(vocab: int, B: int, T: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, T)).astype(np.int32)
    return toks, np.roll(toks, -1, 1).astype(np.int32)


def _cfg(**kw):
    from pytorch_distributed_tpu_torch.models import GPT2Config

    return GPT2Config(**{**dict(vocab_size=256, n_positions=64, n_embd=64,
                                n_layer=2, n_head=4), **kw})


def _model(cfg, weights):
    """GPT-2 of ``cfg`` on the group's device: the seeded init, or
    ``weights``."""
    from pytorch_distributed_tpu_torch import distributed as pdist
    from pytorch_distributed_tpu_torch.models import GPT2

    model = GPT2(cfg, device=pdist.get_device(), seed=0)
    if weights is not None:
        model.load_state_dict(weights)
    return model


def _trainer(model, strategy, **kw):
    from pytorch_distributed_tpu_torch.trainer import Trainer, lm_loss

    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD,
                            eps=1e-8)
    return Trainer(model, opt, strategy, loss_fn=lm_loss, **kw)


def _step(trainer, batch):
    """One step from ``init``, its collectives counted: the metrics, and
    ``comm``'s and the stage links' counts of the step."""
    from pytorch_distributed_tpu_torch.parallel import comm, stage_links

    state = trainer.init()
    comm.reset_counts()
    stage_links.reset_counts()
    state, metrics = trainer.step(state, batch)
    _check(state.step == 1, f"the step left the state at {state.step}")
    return metrics, {"counts": dict(comm.counts),
                     "wire": dict(comm.wire_bytes),
                     "groups": dict(comm.group_counts),
                     "links": dict(stage_links.counts)}


def _collectives(seen) -> List[str]:
    """The collective families a step issued, in the reference's names
    (``p2p`` for sends and receives: the reference's collective-permute)."""
    names = {_NAMES.get(k, k) for k, n in seen["counts"].items() if n}
    if seen["links"].get("sends"):
        names.add("p2p")
    return sorted(names)


def _assert_strict_slice(held, whole, *, dim: int, ways: int, what: str):
    """``held`` is ``whole`` cut ``ways`` on ``dim`` (and whole elsewhere)."""
    expect = list(whole)
    expect[dim] = whole[dim] // ways
    _check(tuple(held) == tuple(expect), (
        f"{what}: expected a block {tuple(expect)} ({ways}-way on dim {dim} "
        f"of {tuple(whole)}), got {tuple(held)}"))


def _global_loss(metrics) -> float:
    """The global batch's loss: the mean of every rank's (each data shard
    has as many ranks), finite."""
    loss = float(metrics["loss"])
    every: List[float] = [0.0] * dist.get_world_size()
    dist.all_gather_object(every, loss)
    loss = float(np.mean(every))
    _check(np.isfinite(loss), f"non-finite loss {loss}")
    return loss


def _parity(build_twin: Callable, batch, loss_parallel: float, what: str,
            tol: float = PARITY_TOL) -> float:
    """``build_twin()`` is a trainer of the same model and loss under
    ``NoShard`` on this rank; the same step gives the same loss."""
    twin = build_twin()
    _, metrics = twin.step(twin.init(), batch)
    delta = abs(float(metrics["loss"]) - loss_parallel)
    _check(delta < tol, (
        f"{what}: parallel loss {loss_parallel:.6f} != one-rank "
        f"{float(metrics['loss']):.6f} (|delta| {delta:.2e} >= {tol})"))
    return delta


def _noshard():
    from pytorch_distributed_tpu_torch import distributed as pdist
    from pytorch_distributed_tpu_torch.parallel import NoShard

    return NoShard(pdist.get_device())


def _result(mode: str, mesh_desc: str, loss: float, seen,
            parity: float) -> Dict:
    return {"mode": mode, "mesh": mesh_desc, "loss": loss,
            "collectives": _collectives(seen), "parity_delta": parity}


def _assert_sharded_step(seen, what):
    names = _collectives(seen)
    _check("all-gather" in names, (
        f"{what} step without an all-gather: {names}"))
    _check("reduce-scatter" in names or "all-reduce" in names, (
        f"{what} step without a gradient reduction: {names}"))


# -- modes ------------------------------------------------------------------
def _mode_fsdp(n: int, weights=None) -> Dict:
    """dp x fsdp GPT-2: parameters sharded over fsdp, the batch over both
    axes, 2 accumulated microbatches, clipping at 1.0."""
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.parallel import (
        FullyShardedDataParallel,
    )

    dp = 2 if n % 2 == 0 and n > 2 else 1
    fsdp = n // dp
    mesh = init_device_mesh((dp, fsdp), ("dp", "fsdp"))
    cfg = _cfg()
    trainer = _trainer(_model(cfg, weights),
                       FullyShardedDataParallel(mesh, "fsdp", dp_axis="dp",
                                                min_shard_size=8),
                       grad_accum_steps=2, clip_norm=1.0)
    batch = _lm_batch(cfg.vocab_size, B=2 * n, T=32)
    metrics, seen = _step(trainer, batch)
    c_attn = trainer.model.h[0].attn.c_attn._parameters["weight"]
    # the reference's kernel [C, 3C] on its out dim: torch's dim 0
    _assert_strict_slice(c_attn.shape, (3 * cfg.n_embd, cfg.n_embd), dim=0,
                         ways=fsdp, what="fsdp c_attn weight")
    _assert_sharded_step(seen, "FSDP")
    _check(np.isfinite(float(metrics["grad_norm"])),
           f"non-finite grad norm {float(metrics['grad_norm'])}")
    loss = _global_loss(metrics)
    parity = _parity(lambda: _trainer(_model(cfg, weights), _noshard(),
                                      grad_accum_steps=2, clip_norm=1.0),
                     batch, loss, "fsdp")
    return _result("fsdp", f"(dp={dp},fsdp={fsdp})", loss, seen, parity)


def _mode_hsdp(n: int, weights=None) -> Dict:
    """Two-node HybridShard: parameters sharded over the inner fsdp axis
    only (replicated over dcn), the batch over both."""
    from pytorch_distributed_tpu_torch.mesh import init_hybrid_mesh
    from pytorch_distributed_tpu_torch.parallel import HybridShard

    fsdp = n // 2
    mesh = init_hybrid_mesh((fsdp,), (2,), ("dcn", "fsdp"))
    cfg = _cfg()
    trainer = _trainer(_model(cfg, weights),
                       HybridShard(mesh, "fsdp", "dcn", min_shard_size=8))
    batch = _lm_batch(cfg.vocab_size, B=2 * n, T=32)
    metrics, seen = _step(trainer, batch)
    c_attn = trainer.model.h[0].attn.c_attn._parameters["weight"]
    # fsdp-ways, not n-ways: the dcn axis replicates
    _assert_strict_slice(c_attn.shape, (3 * cfg.n_embd, cfg.n_embd), dim=0,
                         ways=fsdp, what="hsdp c_attn weight")
    _assert_sharded_step(seen, "HSDP")
    loss = _global_loss(metrics)
    parity = _parity(lambda: _trainer(_model(cfg, weights), _noshard()),
                     batch, loss, "hsdp")
    return _result("hsdp", f"(dcn=2,fsdp={fsdp})", loss, seen, parity)


def _sp_differential(trainer_sp, seen_sp, seen_dense, cfg, b_local, T):
    """With SP the step all-reduces no ``[B, T, C]`` activation, and it
    reduce-scatters the activation bytes the step without SP all-reduces
    (4 a layer: f and g of the attention and of the MLP)."""
    act = 4 * cfg.n_layer * b_local * T * cfg.n_embd * 4       # fp32
    params = [p for p in trainer_sp.model.parameters() if p.requires_grad]
    partial = 4 * sum(p.numel() for p, part in
                      zip(params, trainer_sp.strategy._partial) if part)
    sp, dense = seen_sp["wire"], seen_dense["wire"]
    ar_sp = sp.get("all_reduce.float32", 0)
    ar_dense = dense.get("all_reduce.float32", 0)
    _check(ar_sp - partial == ar_dense - act, (
        f"sequence parallelism all-reduced an activation: {ar_sp} bytes "
        f"all-reduced with SP ({partial} of them partial gradients), "
        f"{ar_dense} without ({act} of them activations)"))
    _check(sp.get("reduce_scatter.float32", 0) == act and not dense.get(
        "reduce_scatter.float32"), (
        f"sequence parallelism did not reduce-scatter the activations the "
        f"step without it all-reduces: {sp} with SP, {dense} without"))


def _mode_tp_sp(n: int, weights=None) -> Dict:
    """Megatron TP plan with sequence parallelism: the colwise and rowwise
    weights sharded over tp, the residual stream sharded along T between
    the tp regions."""
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.parallel import (
        TensorParallel,
        gpt2_tp_plan,
    )

    tp = n // 2
    mesh = init_device_mesh((2, tp), ("dp", "tp"))
    T = 2 * tp * 4              # divisible by tp: SP shards the sequence
    cfg = _cfg(n_positions=T)

    def build(sp: bool):
        strategy = TensorParallel(mesh, gpt2_tp_plan(), tp_axis="tp",
                                  dp_axis="dp", sequence_parallel=sp)
        return _trainer(_model(cfg, weights), strategy)

    batch = _lm_batch(cfg.vocab_size, B=4, T=T)
    trainer = build(True)
    metrics, seen = _step(trainer, batch)
    mlp, C = trainer.model.h[0].mlp, cfg.n_embd
    # colwise c_fc [4C, C] shards its outputs (dim 0), rowwise c_proj
    # [C, 4C] its inputs (dim 1)
    _assert_strict_slice(mlp.c_fc.weight.shape, (4 * C, C), dim=0, ways=tp,
                         what="tp colwise c_fc weight")
    _assert_strict_slice(mlp.c_proj.weight.shape, (C, 4 * C), dim=1,
                         ways=tp, what="tp rowwise c_proj weight")
    names = _collectives(seen)
    _check("all-gather" in names and "all-reduce" in names, names)
    _, seen_dense = _step(build(False), batch)
    _sp_differential(trainer, seen, seen_dense, cfg, 4 // 2, T)
    loss = _global_loss(metrics)
    parity = _parity(lambda: _trainer(_model(cfg, weights), _noshard()),
                     batch, loss, "tp_sp")
    return _result("tp_sp", f"(dp=2,tp={tp})", loss, seen, parity)


def _mode_pp(n: int, weights=None) -> Dict:
    """GPipe over dp x pp: each rank holds its stage's blocks; activations
    hop stage to stage + 1 over the links."""
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.parallel import (
        GPT2Pipe,
        PipelineParallel,
    )

    pp, dp = 2, n // 2
    mesh = init_device_mesh((dp, pp), ("dp", "pp"))
    cfg = _cfg()
    model = GPT2Pipe(cfg, mesh, dp_axis="dp", n_microbatches=2, remat=False,
                     seed=0)
    if weights is not None:
        model.load_state_dict({k: weights[k] for k in model.state_dict()})
    trainer = _trainer(model, PipelineParallel(mesh, dp_axis="dp"))
    batch = _lm_batch(cfg.vocab_size, B=2 * dp, T=32)
    metrics, seen = _step(trainer, batch)
    # the stage's blocks, stacked: the reference's [n_layer, ...] leaves cut
    # pp-ways on their leading dim
    blocks = model.blocks()
    held = (len(blocks), *blocks[0].attn.c_attn.weight.shape)
    _assert_strict_slice(held, (cfg.n_layer, 3 * cfg.n_embd, cfg.n_embd),
                         dim=0, ways=pp, what="pp stacked block weight")
    _check("p2p" in _collectives(seen), (
        f"pipeline step without the stage hop: {_collectives(seen)}"))
    loss = _global_loss(metrics)
    parity = _parity(lambda: _trainer(_model(cfg, weights), _noshard()),
                     batch, loss, "pp")
    return _result("pp", f"(dp={dp},pp={pp})", loss, seen, parity)


def _mode_cp(n: int, weights=None) -> Dict:
    """Ring flash attention over cp: the sequence sharded n-ways inside
    the attention, K/V chunks hopping point to point, B4-B6 (or their
    plain versions) the local op; the batch replicated."""
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.parallel import (
        CPStrategy,
        make_ring_attention,
    )

    mesh = init_device_mesh((n,), ("cp",))
    T = 8 * n                   # 8 positions a ring rank
    cfg = _cfg(n_positions=T,
               attn_impl=make_ring_attention(mesh, "cp", causal=True))
    trainer = _trainer(_model(cfg, weights), CPStrategy(mesh))
    batch = _lm_batch(cfg.vocab_size, B=2, T=T)
    metrics, seen = _step(trainer, batch)
    _check("p2p" in _collectives(seen), (
        f"ring attention without the K/V hops: {_collectives(seen)}"))
    loss = _global_loss(metrics)
    parity = _parity(lambda: _trainer(_model(_cfg(n_positions=T), weights),
                                      _noshard()),
                     batch, loss, "cp")
    return _result("cp", f"(cp={n})", loss, seen, parity)


def _mode_ep(n: int, weights=None) -> Dict:
    """The MoE GPT-2 with its expert stacks sharded over ep (dim 0): the
    layer's f and g run over the ep group."""
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.parallel import ExpertDataParallel

    ep = n // 2
    mesh = init_device_mesh((2, ep), ("dp", "ep"))
    cfg = _cfg(moe_experts=ep, moe_top_k=2, moe_every=2)
    strategy = ExpertDataParallel(mesh)
    trainer = _trainer(_model(cfg, weights), strategy)
    batch = _lm_batch(cfg.vocab_size, B=8, T=16)
    metrics, seen = _step(trainer, batch)
    moe = [b.moe for b in trainer.model.h if b.use_moe]
    _check(moe, "no MoE block")
    C = cfg.n_embd
    _assert_strict_slice(moe[0].experts_up.shape, (ep, C, 4 * C), dim=0,
                         ways=ep, what="ep experts_up")
    _check("moe_aux" in metrics, sorted(metrics))
    on_ep = sum(k for (name, group), k in seen["groups"].items()
                if group is strategy.ep_group)
    _check(on_ep, (
        f"no collective over the ep group: the expert shards exchange no "
        f"tokens; collectives {_collectives(seen)}"))
    loss = _global_loss(metrics)
    parity = _parity(lambda: _trainer(_model(cfg, weights), _noshard()),
                     batch, loss, "ep")
    return _result("ep", f"(dp=2,ep={ep})", loss, seen, parity)


MODES = {
    "fsdp": _mode_fsdp,
    "hsdp": _mode_hsdp,
    "tp_sp": _mode_tp_sp,
    "pp": _mode_pp,
    "cp": _mode_cp,
    "ep": _mode_ep,
}


def _mode_fits(name: str, n: int) -> bool:
    """Whether a mode's mesh fits ``n`` ranks: fsdp and cp any n >= 2, the
    2 x (n // 2) modes an even n >= 4."""
    if name in ("fsdp", "cp"):
        return n >= 2
    return n >= 4 and n % 2 == 0


def run_grid(world: int, modes: Optional[Sequence[str]] = None, *,
             weights: Optional[Dict[str, Dict]] = None,
             verbose: bool = True) -> List[Dict]:
    """Run the grid on every rank of an initialized group of ``world``
    ranks, rank 0 printing one line a mode; returns the per-mode results
    (every rank the same losses). Raises on the first failing mode.

    ``modes=None`` runs every mode whose mesh fits ``world`` (the others
    are printed as skipped); named modes are validated: an unknown name
    or a factorization that does not fit raises ``ValueError``.
    ``weights`` maps a mode to the state dict its model starts from."""
    if not dist.is_initialized() or dist.get_world_size() != world:
        raise ValueError(f"run_grid({world}) runs on every rank of a group "
                         f"of {world} ranks")
    loud = verbose and dist.get_rank() == 0
    if modes is None:
        selected = []
        for name in MODES:
            if _mode_fits(name, world):
                selected.append(name)
            elif loud:
                print(f"mode={name} skipped: mesh does not fit {world} "
                      "ranks", flush=True)
    else:
        unknown = [m for m in modes if m not in MODES]
        if unknown:
            raise ValueError(f"unknown modes {unknown}; valid: "
                             f"{sorted(MODES)}")
        unfit = [m for m in modes if not _mode_fits(m, world)]
        if unfit:
            raise ValueError(f"modes {unfit} do not fit {world} ranks (2 x k "
                             "modes need an even n >= 4)")
        selected = list(modes)
    results = []
    for name in selected:
        res = MODES[name](world, (weights or {}).get(name))
        if loud:
            print(f"mode={res['mode']} mesh={res['mesh']} "
                  f"loss={round(res['loss'], 4)} "
                  f"collectives={','.join(res['collectives'])} "
                  f"parity_delta={res['parity_delta']:.1e}", flush=True)
        results.append(res)
    return results


# -- the command line ---------------------------------------------------------
def _rank(rank: int, port: int, world: int, backend: str, device: str,
          modes) -> None:
    from pytorch_distributed_tpu_torch import distributed as pdist

    dev = torch.device(device if device != "cuda" or backend != "nccl"
                       else f"cuda:{rank}")
    pdist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                             rank=rank, world_size=world, device=dev)
    try:
        run_grid(world, modes)
    finally:
        pdist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nproc", type=int, default=4,
                   help="ranks to spawn (the grid's world)")
    p.add_argument("--device", default=None,
                   help="cpu, or the card (the default)")
    p.add_argument("--modes", nargs="*", default=None,
                   help=f"modes to run (default: all that fit): "
                        f"{', '.join(MODES)}")
    args = p.parse_args(argv)
    from pytorch_distributed_tpu_torch import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        backend = ("nccl" if torch.cuda.device_count() >= args.nproc
                   else "gloo")
    else:
        backend = "gloo"
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    print(f"dryrun: {args.nproc} ranks, {backend} on {device.type}",
          flush=True)
    torch.multiprocessing.start_processes(
        _rank, args=(port, args.nproc, backend, device.type, args.modes),
        nprocs=args.nproc, join=True, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
