"""A reshard of tensor-parallel training state across meshes, on 4 gloo
ranks.

``tests/_torch_port_tp.py``'s tiny GPT-2 (the JAX ``TensorParallel``
trainer's initial weights) trains 2 AdamW steps under ``TensorParallel``
at ``(dp 2, tp 2)`` and under TP x FSDP at ``(fsdp 2, tp 2)``; each state
(``get_state_dict``: every tp leaf ``Shard`` over tp, TP x FSDP's also
over fsdp on another dim, the fused ``c_attn`` whole) is saved, then moved
by ``elastic.reshard_state`` onto ``state_shardings`` of a
``TensorParallel`` on a ``(dp 1, tp 4)`` mesh. Held:

* the moved ``(dp 2, tp 2)`` state equals the JAX package's
  ``reshard_state`` of the same global arrays between the same mesh shapes
  over 4 virtual CPU devices, bit for bit, through the unsharded view
  (whole tensors: the reference's ``c_attn`` block is a contiguous chunk,
  not per-head rows);
* loaded into a trainer on the new mesh (``set_state_dict``), each moved
  state equals the checkpoint's resume at ``(1, 4)`` bit for bit;
* three steps after the move give the losses of the JAX ``TensorParallel``
  trainer whose state the JAX ``reshard_state`` moved the same way, at
  rtol 1e-5.

JAX is imported inside the tests only: the ranks re-import this module.
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_ranks as ranks
from tests import _torch_port_tp as tph

torch.set_num_threads(2)

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")

BEFORE, AFTER = 2, 3
SOURCES = ("dp2tp2", "fsdp2tp2")
DST = ((1, 4), ("dp", "tp"))


def _local(v):
    if v is None:
        return None
    return (v.to_local() if hasattr(v, "to_local") else v).clone()


def _dims(v):
    """``{mesh axis: tensor dim}`` of a DTensor's Shard placements."""
    if not hasattr(v, "placements"):
        return {}
    names = v.device_mesh.mesh_dim_names
    return {a: p.dim for a, p in zip(names, v.placements)
            if hasattr(p, "dim")}


def _live(trainer, state):
    from pytorch_distributed_tpu_torch.checkpoint import get_state_dict

    return {k: _local(v) for k, v in get_state_dict(trainer,
                                                     state).items()}


def reshard_body(rank, store_dir, state_dict):
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
    from pytorch_distributed_tpu_torch.parallel import (
        TensorParallel,
        gpt2_tp_plan,
    )
    from pytorch_distributed_tpu_torch.redistribute import executor

    batch = tph.lm_batch()

    def dst_strategy():
        return TensorParallel(init_device_mesh(*DST), gpt2_tp_plan())

    out = {}
    for tag in SOURCES:
        trainer, state = tph._tp_trainer(tph.make_strategy(tag, False),
                                         state_dict)
        for _ in range(BEFORE):
            state, _ = trainer.step(state, batch)
        sd = get_state_dict(trainer, state)
        ckpt = f"{store_dir}/ckpt_{tag}"
        with CheckpointManager(ckpt) as mgr:
            mgr.save(state.step, sd)
        shardings = state_shardings(sd, dst_strategy())
        executor.reset_counts()
        moved = reshard_state(sd, shardings)
        r = {"src": {k: _local(v) for k, v in sd.items()},
             "src_dims": {k: _dims(v) for k, v in sd.items()},
             "dst_specs": {k: s.spec for k, s in shardings.items()},
             "moved": {k: _local(v) for k, v in moved.items()},
             "counts": dict(executor.counts)}
        resized, rstate = tph._tp_trainer(dst_strategy(), None, seed=6)
        rstate = set_state_dict(resized, rstate, moved)
        resumed, qstate = tph._tp_trainer(dst_strategy(), None, seed=7)
        qstate = resume_from_checkpoint(ckpt, resumed, qstate)
        r["resized"] = _live(resized, rstate)
        r["resumed"] = _live(resumed, qstate)
        r["steps"] = (rstate.step, qstate.step)
        r["losses"] = []
        for _ in range(AFTER):
            rstate, m1 = resized.step(rstate, batch)
            qstate, m2 = resumed.step(qstate, batch)
            r["losses"].append((float(m1["loss"]), float(m2["loss"])))
        out[tag] = r
        del trainer, resized, resumed
    dist.barrier()
    torch.save(out, f"{store_dir}/rank{rank}.pt")


def jax_losses():
    """The JAX TensorParallel trainer at (dp 2, tp 2): ``BEFORE`` steps,
    its state moved by the reference's ``reshard_state`` onto the state
    shardings of the same trainer at (1, 4), then ``AFTER`` steps there;
    and the initial weights as the port's state dict."""
    import jax
    import optax

    from pytorch_distributed_tpu.elastic import reshard_state as jax_reshard
    from pytorch_distributed_tpu.mesh import init_device_mesh
    from pytorch_distributed_tpu.models import GPT2 as JaxGPT2
    from pytorch_distributed_tpu.models import GPT2Config as JaxCfg
    from pytorch_distributed_tpu.parallel.tensor_parallel import (
        TensorParallel as JaxTP,
        gpt2_tp_plan as jax_plan,
    )
    from pytorch_distributed_tpu.trainer import Trainer as JaxTrainer
    from pytorch_distributed_tpu.trainer import lm_loss as jax_lm_loss
    from pytorch_distributed_tpu_torch.models import gpt2_state_dict_from_flax

    def trainer(shape):
        mesh = init_device_mesh(shape, ("dp", "tp"),
                                devices=jax.devices()[:4])
        return JaxTrainer(JaxGPT2(JaxCfg(**tph.TINY)), optax.adamw(tph.LR),
                          JaxTP(mesh, jax_plan(), tp_axis="tp",
                                dp_axis="dp"), loss_fn=jax_lm_loss)

    src, dst = trainer((2, 2)), trainer(DST[0])
    batch = tph.lm_batch()
    state = src.init(jax.random.key(0), batch)
    first = gpt2_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, state.params))
    for _ in range(BEFORE):
        state, _ = src.step(state, batch)
    like = dst.init(jax.random.key(1), batch)
    state = jax_reshard(state, jax.tree_util.tree_map(lambda x: x.sharding,
                                                      like))
    losses = []
    for _ in range(AFTER):
        state, m = dst.step(state, batch)
        losses.append(float(m["loss"]))
    return first, losses


@pytest.fixture(scope="module")
def resharded(tmp_path_factory):
    from tests.test_torch_port_tensor_parallel import jax_tp_trainer

    tmp = tmp_path_factory.mktemp("tp_reshard")
    _, _, first = jax_tp_trainer()
    ctx = ranks.start(reshard_body, tmp, first)
    init, want = jax_losses()
    for name, t in first.items():
        assert torch.equal(init[name], t), name
    ranks.finish(ctx, timeout=180)
    got = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(ranks.WORLD)]
    return got, want


def _whole(blocks, mesh_shape, names, dims):
    """The whole tensor from the ranks' blocks on a 2-D mesh of
    ``mesh_shape`` (ranks row-major) cut ``{axis: dim}`` (an axis a dim;
    an axis not in ``dims`` replicates)."""
    (a, b), (outer, inner) = mesh_shape, names
    rows = []
    for i in range(a):
        row = blocks[i * b:(i + 1) * b]
        rows.append(torch.cat(row, dims[inner]) if inner in dims else row[0])
    return torch.cat(rows, dims[outer]) if outer in dims else rows[0]


def _src_mesh(tag):
    shape, names = tph.MESHES[tag]
    return shape, tuple(names)


def test_placements(resharded):
    got, _ = resharded
    for r in got:
        for tag in SOURCES:
            x = r[tag]
            # c_attn's weight, bias and moments whole; c_fc on tp
            for k in ("model/h.0.attn.c_attn.weight",
                      "optim/h.0.attn.c_attn.bias/exp_avg"):
                assert x["dst_specs"][k] == ((),) * x["moved"][k].dim(), k
                whole = list(x["src"][k].shape)     # TP x FSDP: an fsdp block
                for d in x["src_dims"][k].values():
                    whole[d] *= 2
                assert "tp" not in x["src_dims"][k]
                assert list(x["moved"][k].shape) == whole
            k = "model/h.0.mlp.c_fc.weight"
            tp_dim = next(d for d, a in enumerate(x["dst_specs"][k]) if a)
            assert x["dst_specs"][k][tp_dim] == ("tp",)
            assert x["src_dims"][k]["tp"] == tp_dim
            # tp 2 -> 4 on the tp dim; the fsdp dim whole again
            assert x["moved"][k].shape[tp_dim] * 2 == x["src"][k].shape[
                tp_dim]
            fsdp = x["src_dims"][k].get("fsdp")
            if fsdp is not None:
                assert fsdp != tp_dim
                assert x["moved"][k].shape[fsdp] == 2 * x["src"][k].shape[
                    fsdp]
            assert x["dst_specs"]["train/step"] == ()
        assert "fsdp" in r["fsdp2tp2"]["src_dims"]["model/h.0.mlp.c_fc.weight"]


def test_moved_state_equals_jax_reshard_state(resharded):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from pytorch_distributed_tpu.elastic import reshard_state as jax_reshard

    got, _ = resharded
    shape, names = _src_mesh("dp2tp2")
    devs = np.asarray(jax.devices()[:4])
    src_mesh = Mesh(devs.reshape(shape), names)
    dst_mesh = Mesh(devs.reshape(DST[0]), DST[1])
    r0 = got[0]["dp2tp2"]
    state, targets = {}, {}
    for k, dims in r0["src_dims"].items():
        whole = _whole([r["dp2tp2"]["src"][k] for r in got], shape, names,
                       dims)
        if not whole.is_floating_point():
            continue
        spec = [None] * whole.dim()
        for a, d in dims.items():
            spec[d] = a
        state[k] = jax.device_put(whole.numpy(),
                                  NamedSharding(src_mesh, P(*spec)))
        targets[k] = NamedSharding(dst_mesh, P(*[a[0] if a else None for a in
                                                 r0["dst_specs"][k]]))
    out = jax_reshard(state, targets)
    assert sum(1 for d in r0["src_dims"].values() if d) > 0
    for k in state:
        dst_dims = {a[0]: d for d, a in enumerate(r0["dst_specs"][k]) if a}
        moved = _whole([r["dp2tp2"]["moved"][k] for r in got], DST[0],
                       DST[1], dst_dims)
        np.testing.assert_array_equal(moved.numpy(), np.asarray(out[k]),
                                      err_msg=k)
        assert out[k].sharding == targets[k]
        # each rank's block is the JAX shard on its device
        shards = {s.device.id: np.asarray(s.data)
                  for s in out[k].addressable_shards}
        for rank, r in enumerate(got):
            np.testing.assert_array_equal(
                r["dp2tp2"]["moved"][k].numpy(),
                shards[devs.ravel()[rank].id], err_msg=k)


@pytest.mark.parametrize("tag", SOURCES)
def test_moved_state_equals_the_checkpoint_resume(resharded, tag):
    got, _ = resharded
    for r in got:
        x = r[tag]
        assert x["steps"] == (BEFORE, BEFORE)
        assert x["resized"].keys() == x["resumed"].keys()
        for k, t in x["resumed"].items():
            assert torch.equal(x["resized"][k], t), k
        for a, b in x["losses"]:
            assert a == b and np.isfinite(a)
    assert sum(r[tag]["counts"]["sent_bytes"] for r in got) > 0


def test_steps_after_the_move_match_jax(resharded):
    got, want = resharded
    for r in got:
        losses = [a for a, _ in r["dp2tp2"]["losses"]]
        np.testing.assert_allclose(losses, want, rtol=1e-5)
