"""A reshard of pipelined training state across pp sizes, on 4 gloo ranks.

``tests/_torch_port_pipeline.py``'s tiny GPT-2 (4 layers, the JAX
``GPT2Pipe``'s initial weights) trains 2 AdamW steps as ``GPT2Pipe``
under ``PipelineParallel`` at pp 4, one layer a rank. Its state
(``elastic.placed_state``: every rank names every layer, each held whole
by its stage's ranks) is moved by ``elastic.reshard_state`` onto
``state_shardings`` of a ``PipelineParallel`` on a ``(dp 2, pp 2)``
mesh, two layers a stage on two ranks, with their AdamW moments, and back
again. Held:

* each rank's moved layers equal the JAX package's ``reshard_state`` of
  the same values as the reference's stacked ``[n_layer, ...]`` tree
  (``P("pp")`` on dim 0, the tables replicated) between the same mesh
  shapes over 4 virtual CPU devices, bit for bit: layer ``i`` of a
  stacked leaf against the port's ``h.{i}``;
* moved back to pp 4, the state is the source's bit for bit;
* loaded into a ``GPT2Pipe`` trainer on the new mesh (``set_state_dict``),
  the state equals the checkpoint's resume at ``(2, 2)`` bit for bit, and
  the two take the same next steps;
* a layer that keeps a rank moves no byte there; each rank sends exactly
  its layers' bytes to each rank of the new stage that lacks them;
* three steps after the move give the losses of the JAX ``GPT2Pipe``
  trainer whose state the JAX ``reshard_state`` moved onto the ``(2, 2)``
  trainer's state shardings, at rtol 1e-5.

JAX is imported inside the tests only: the ranks re-import this module.
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_pipeline as pph
from tests import _torch_port_ranks as ranks

torch.set_num_threads(2)

BEFORE, AFTER = 2, 3
L = pph.TINY["n_layer"]


def _local(v):
    from pytorch_distributed_tpu_torch.redistribute import Placed

    if isinstance(v, Placed):
        v = v.block
    if v is None:
        return None
    return (v.to_local() if hasattr(v, "to_local") else v).clone()


def _live(trainer, state):
    from pytorch_distributed_tpu_torch.checkpoint import get_state_dict

    return {k: _local(v) for k, v in get_state_dict(trainer,
                                                     state).items()}


def reshard_body(rank, store_dir, flax_params):
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch.checkpoint import (
        CheckpointManager,
        get_state_dict,
        set_state_dict,
    )
    from pytorch_distributed_tpu_torch.elastic import (
        placed_state,
        reshard_state,
        resume_from_checkpoint,
        state_shardings,
    )
    from pytorch_distributed_tpu_torch.parallel import PipelineParallel
    from pytorch_distributed_tpu_torch.redistribute import executor

    batch = pph.lm_batch()
    trainer, state = pph._trainer(pph._mesh((1, 4)), flax_params,
                                  remat=pph.REMAT["pp4"])
    for _ in range(BEFORE):
        state, _ = trainer.step(state, batch)
    sd = placed_state(trainer, state)
    ckpt = f"{store_dir}/ckpt"
    with CheckpointManager(ckpt) as mgr:
        mgr.save(state.step, get_state_dict(trainer, state))
    shardings = state_shardings(sd, PipelineParallel(pph._mesh((2, 2)),
                                                     dp_axis="dp"))
    executor.reset_counts()
    moved = reshard_state(sd, shardings)
    out = {"src": {k: _local(v) for k, v in sd.items()},
           "src_ranks": {k: v.sharding.ranks for k, v in sd.items()
                         if hasattr(v, "sharding")},
           "dst_ranks": {k: s.ranks for k, s in shardings.items()},
           "moved": {k: _local(v) for k, v in moved.items()},
           "counts": dict(executor.counts)}
    resized, rstate = pph._trainer(pph._mesh((2, 2)), None,
                                   remat=pph.REMAT["dp2pp2"], seed=12)
    rstate = set_state_dict(resized, rstate, moved)
    resumed, qstate = pph._trainer(pph._mesh((2, 2)), None,
                                   remat=pph.REMAT["dp2pp2"], seed=13)
    qstate = resume_from_checkpoint(ckpt, resumed, qstate)
    out["layers"] = list(resized.model.layers)
    out["resized"] = _live(resized, rstate)
    out["resumed"] = _live(resumed, qstate)
    out["steps"] = (rstate.step, qstate.step)
    # and back to pp 4, before any step
    back = reshard_state(placed_state(resized, rstate), state_shardings(
        sd, PipelineParallel(pph._mesh((1, 4)), dp_axis="dp")))
    out["back"] = {k: _local(v) for k, v in back.items()}
    out["losses"] = []
    for _ in range(AFTER):
        rstate, m1 = resized.step(rstate, batch)
        qstate, m2 = resumed.step(qstate, batch)
        out["losses"].append((float(m1["loss"]), float(m2["loss"])))
    dist.barrier()
    torch.save(out, f"{store_dir}/rank{rank}.pt")


def jax_run():
    """The JAX GPT2Pipe trainer at pp 4: its initial parameters (numpy),
    and ``run()``, the losses of ``AFTER`` steps at (dp 2, pp 2) after
    ``BEFORE`` steps at pp 4 and the reference's ``reshard_state`` onto
    the (2, 2) trainer's state shardings."""
    import jax
    import optax

    from pytorch_distributed_tpu.elastic import reshard_state as jax_reshard
    from pytorch_distributed_tpu.mesh import init_device_mesh
    from pytorch_distributed_tpu.models import GPT2Config
    from pytorch_distributed_tpu.parallel import GPT2Pipe, PipelineParallel
    from pytorch_distributed_tpu.trainer import Trainer, lm_loss

    def trainer(shape, remat):
        dp = shape[0] > 1
        mesh = (init_device_mesh(shape, ("dp", "pp"),
                                 devices=jax.devices()[:4]) if dp
                else init_device_mesh((4,), ("pp",),
                                      devices=jax.devices()[:4]))
        model = GPT2Pipe(GPT2Config(**pph.TINY), mesh,
                         dp_axis="dp" if dp else None, n_microbatches=4,
                         remat=remat)
        return Trainer(model, optax.adamw(pph.LR), PipelineParallel(
            mesh, dp_axis="dp" if dp else None), loss_fn=lm_loss)

    batch = pph.lm_batch()
    src = trainer((1, 4), pph.REMAT["pp4"])
    state = src.init(jax.random.key(0), batch)

    def run():
        s = state
        for _ in range(BEFORE):
            s, _ = src.step(s, batch)
        dst = trainer((2, 2), pph.REMAT["dp2pp2"])
        like = dst.init(jax.random.key(1), batch)
        s = jax_reshard(s, jax.tree_util.tree_map(lambda x: x.sharding,
                                                  like))
        losses = []
        for _ in range(AFTER):
            s, m = dst.step(s, batch)
            losses.append(float(m["loss"]))
        return losses

    return jax.tree_util.tree_map(np.asarray, state.params), run


@pytest.fixture(scope="module")
def resharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_reshard")
    first, run = jax_run()
    ctx = ranks.start(reshard_body, tmp, first)
    want = run()
    ranks.finish(ctx, timeout=180)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(ranks.WORLD)], want


def _layer(key):
    """``(family, layer)`` of a stage key, e.g. ``("model/h.*.ln_1.weight",
    0)``, or None."""
    kind, _, rest = key.partition("/")
    parts = rest.split(".")
    if kind in ("model", "optim") and parts[0] == "h":
        return f"{kind}/h.*." + ".".join(parts[2:]), int(parts[1])
    return None


def test_every_rank_names_every_layer(resharded):
    got, _ = resharded
    for rank, r in enumerate(got):
        layers = {_layer(k)[1] for k in r["src"] if _layer(k)}
        assert layers == set(range(L))
        for k, v in r["src"].items():
            lay = _layer(k)
            if lay is None:
                assert v is not None, k
                continue
            assert r["src_ranks"][k] == (lay[1],)          # pp 4: rank i
            assert (v is not None) == (lay[1] == rank), k
            stage = lay[1] // 2
            assert r["dst_ranks"][k] == (stage, stage + 2)  # (dp, pp) order
            held = r["moved"][k] is not None
            assert held == (rank % 2 == stage), k
        assert r["layers"] == [2 * (rank % 2), 2 * (rank % 2) + 1]


def test_moved_layers_equal_jax_reshard_state(resharded):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from pytorch_distributed_tpu.elastic import reshard_state as jax_reshard

    got, _ = resharded
    devs = np.asarray(jax.devices()[:4])
    src_mesh = Mesh(devs, ("pp",))
    dst_mesh = Mesh(devs.reshape(2, 2), ("dp", "pp"))
    families = {}
    for k in got[0]["src"]:
        lay = _layer(k)
        if lay is not None:
            families.setdefault(lay[0], {})[lay[1]] = k
    state, targets = {}, {}
    for fam, keys in families.items():
        stacked = torch.stack([got[i]["src"][keys[i]] for i in range(L)])
        if not stacked.is_floating_point():
            continue
        state[fam] = jax.device_put(stacked.numpy(),
                                    NamedSharding(src_mesh, P("pp")))
        targets[fam] = NamedSharding(dst_mesh, P("pp"))
    for k, v in got[0]["src"].items():      # the tables: replicated
        if _layer(k) is None and v.is_floating_point():
            state[k] = jax.device_put(v.numpy(), NamedSharding(src_mesh, P()))
            targets[k] = NamedSharding(dst_mesh, P())
    out = jax_reshard(state, targets)
    assert len(families) == 12 * 4   # a layer's 12 params, 2 moments, step
    for name, arr in out.items():
        shards = {s.device.id: np.asarray(s.data)
                  for s in arr.addressable_shards}
        for rank, r in enumerate(got):
            shard = shards[devs.ravel()[rank].id]
            if name not in families:
                np.testing.assert_array_equal(r["moved"][name].numpy(), shard,
                                              err_msg=name)
                continue
            first = 2 * (rank % 2)
            for j in range(2):
                key = families[name][first + j]
                np.testing.assert_array_equal(r["moved"][key].numpy(),
                                              shard[j], err_msg=key)


def test_moved_back_is_the_source(resharded):
    got, _ = resharded
    for rank, r in enumerate(got):
        for k, v in r["src"].items():
            if v is None:
                assert r["back"][k] is None, k
            else:
                assert torch.equal(r["back"][k], v), k


def test_moved_state_equals_the_checkpoint_resume(resharded):
    got, _ = resharded
    for r in got:
        assert r["steps"] == (BEFORE, BEFORE)
        assert r["resized"].keys() == r["resumed"].keys()
        for k, t in r["resumed"].items():
            assert torch.equal(r["resized"][k], t), k
        for a, b in r["losses"]:
            assert a == b and np.isfinite(a)


def test_bytes_sent_are_the_layers_that_move(resharded):
    """Rank i holds layer i; each rank of its new stage that lacks it gets
    every entry of it (parameters, moments, Adam's step) from rank i. The
    tables stay where they are."""
    got, _ = resharded
    for rank, r in enumerate(got):
        want = 0
        for k, v in r["src"].items():
            if v is not None and _layer(k) is not None:
                lacking = [q for q in r["dst_ranks"][k] if q != rank]
                want += len(lacking) * v.numel() * v.element_size()
        assert r["counts"]["sent_bytes"] == want, (rank, r["counts"])
        assert want > 0


def test_steps_after_the_move_match_jax(resharded):
    """A rank reports its dp shard's loss (the last stage's, broadcast
    over pp); the JAX trainer the global batch's: the mean of the two."""
    got, want = resharded
    for stage in range(2):
        rows = [[a for a, _ in got[d * 2 + stage]["losses"]]
                for d in range(2)]
        np.testing.assert_allclose(np.mean(rows, axis=0), want, rtol=1e-5)
