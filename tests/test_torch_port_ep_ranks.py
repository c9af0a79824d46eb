"""The port's ``ExpertDataParallel`` against the JAX package's, on 4 gloo
ranks.

The ranks (``tests/_torch_port_ranks.py``, spawned once for the file; rank
bodies in ``tests/_torch_port_expert.py``) train ``tests/test_expert.py``'s
MoE GPT-2 (E=4, top-2, routing groups of 64 tokens) from the weights flax
drew, under ``ExpertDataParallel`` on the meshes ``(dp 2, ep 2)`` and
``(dp 1, ep 4)``, 3 AdamW steps on the reference test's batch; the JAX
``ExpertDataParallel`` trainer runs the same on the same mesh shapes over
4 of the 8 virtual CPU devices. Held:

* the losses (the mean of the dp shards') and ``moe_aux`` at rtol 1e-5,
  the grad norm at 1e-5 on step 1 and 1e-4 after (Adam's noise-driven
  elements);
* each rank holds ``E/ep`` experts of every stack, and nothing else is cut;
* every parameter outside the expert stacks is bit for bit the same on
  every ep rank after the steps, and the gathered parameters are the same
  on every rank;
* the collectives of a step: the dp gradient all-reduce, the norm's, and
  per MoE block the f/g pair over ep (two all-reduces forward: g and the
  aux statistics; three backward: the two f's and the statistics'), with
  their bytes;
* a checkpoint saved at (1, 4) after 2 steps, restored by a fresh trainer
  on the 4 ranks, takes step 3 bit for bit as the run that saved it; and
  one process loads it whole into a ``NoShard`` model (the unsharded
  model's keys and shapes);
* dropout: the ranks of one data shard draw the same masks, two data
  shards different ones, a step's masks the same when drawn again.

JAX is imported inside the tests only: the ranks re-import the helpers.
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_expert as eph
from tests import _torch_port_ranks as ranks

torch.set_num_threads(2)

RTOL = 1e-5
# the JAX trainer traces its init on one row (16 tokens), which a routing
# group of 64 does not divide: the init runs ungrouped (same parameters)
INIT = {**eph.TINY, "moe_group_size": None}


def _jax_params():
    import jax

    from pytorch_distributed_tpu.models import GPT2 as JaxGPT2
    from pytorch_distributed_tpu.models import GPT2Config as JaxGPT2Config

    model = JaxGPT2(JaxGPT2Config(**INIT))
    x, _ = eph.lm_batch()
    return model, model.init(jax.random.key(0), x)["params"]


def _jax_run(shape, params):
    import jax
    import optax

    from pytorch_distributed_tpu.mesh import init_device_mesh
    from pytorch_distributed_tpu.models import GPT2 as JaxGPT2
    from pytorch_distributed_tpu.models import GPT2Config as JaxGPT2Config
    from pytorch_distributed_tpu.parallel import ExpertDataParallel
    from pytorch_distributed_tpu.trainer import Trainer, lm_loss

    mesh = init_device_mesh(shape, ("dp", "ep"), devices=jax.devices()[:4])
    tr = Trainer(JaxGPT2(JaxGPT2Config(**INIT)),
                 optax.adamw(eph.LR, weight_decay=eph.WD),
                 ExpertDataParallel(mesh), loss_fn=lm_loss)
    state = tr.init(jax.random.key(0), eph.lm_batch())
    tr.model = JaxGPT2(JaxGPT2Config(**eph.TINY))    # the step is built lazily
    state = state.replace(params=jax.tree_util.tree_map(
        lambda p, s: jax.device_put(np.asarray(p), s.sharding), params,
        state.params))
    out = {}
    for _ in range(eph.STEPS):
        state, m = tr.step(state, eph.lm_batch())
        for k in ("loss", "moe_aux", "grad_norm"):
            out.setdefault(k, []).append(float(m[k]))
    return out


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    import jax

    from pytorch_distributed_tpu_torch.models import gpt2_state_dict_from_flax

    root = tmp_path_factory.mktemp("ep")
    _, params = _jax_params()
    params = jax.tree_util.tree_map(np.asarray, params)
    ctx = ranks.start(eph.train_body, root,
                      gpt2_state_dict_from_flax(params))
    want = {tag: _jax_run(shape, params) for tag, shape in eph.MESHES.items()}
    ranks.finish(ctx, timeout=240)
    got = {tag: [torch.load(root / f"{tag}.rank{r}.pt", weights_only=False)
                 for r in range(ranks.WORLD)] for tag in eph.MESHES}
    return root, got, want


@pytest.mark.parametrize("tag", sorted(eph.MESHES))
def test_losses_match_jax_expert_data_parallel(ep_runs, tag):
    _, got, want = ep_runs
    dp = eph.MESHES[tag][0]
    for key in ("loss", "moe_aux", "grad_norm"):
        per_rank = np.asarray([r["metrics"][key] for r in got[tag]])
        # the ranks of a dp row agree; the mean over the rows is global
        rows = per_rank.reshape(dp, -1, eph.STEPS)
        assert (rows == rows[:, :1]).all(), key
        mean = rows[:, 0].mean(0)
        if key == "grad_norm":
            # from step 2 on the norm reads parameters that Adam moved by
            # rounding noise where a gradient is near zero (see
            # test_torch_port_trainer.py's docstring): 1e-5 on step 1,
            # 1e-4 (the reference test's bound) after
            np.testing.assert_allclose(mean[0], want[tag][key][0],
                                       rtol=RTOL, atol=0)
            np.testing.assert_allclose(mean, want[tag][key], rtol=1e-4,
                                       atol=0)
            continue
        np.testing.assert_allclose(mean, want[tag][key], rtol=RTOL, atol=0,
                                   err_msg=key)


@pytest.mark.parametrize("tag", sorted(eph.MESHES))
def test_experts_a_rank_and_replicas_across_ep(ep_runs, tag):
    _, got, _ = ep_runs
    ep = eph.MESHES[tag][1]
    E, C = eph.TINY["moe_experts"], eph.TINY["n_embd"]
    for r in got[tag]:
        held = r["held"]
        for i in (1, 3):
            assert held[f"h.{i}.moe.experts_up"] == (E // ep, C, 4 * C)
            assert held[f"h.{i}.moe.experts_down"] == (E // ep, 4 * C, C)
            assert held[f"h.{i}.moe.router.weight"] == (E, C)
        assert held["h.0.mlp.c_fc.weight"] == (4 * C, C)
        assert r["replicas_equal"]
        for name, t in r["params"].items():
            assert torch.equal(t, got[tag][0]["params"][name]), name
    expert_bytes = 4 * 2 * (E // ep) * C * 4 * C * 2    # 2 blocks, fp32
    assert got[tag][0]["param_bytes"] == got[tag][1]["param_bytes"]
    assert got[tag][0]["data_shard"] == 0
    assert got[tag][-1]["data_shard"] == eph.MESHES[tag][0] - 1
    dense = sum(t.numel() * 4 for n, t in got[tag][0]["params"].items()
                if "experts" not in n)
    assert got[tag][0]["param_bytes"] == dense + expert_bytes


@pytest.mark.parametrize("tag", sorted(eph.MESHES))
def test_collectives_of_a_step(ep_runs, tag):
    """Per MoE block: forward g and the aux statistics' all-reduce,
    backward the two f's and the statistics' (at dp 1 there are no
    statistics to average); then the dp gradient all-reduce (one flat
    buffer of the held parameters, also over a dp group of one) and the
    norm's all-reduce over ep."""
    _, got, _ = ep_runs
    dp = eph.MESHES[tag][0]
    n_moe, C, k = 2, eph.TINY["n_embd"], eph.TINY["moe_top_k"]
    tokens = 8 * 16 // dp
    per_block = 3 + (2 if dp > 1 else 0)
    counts, wire = got[tag][0]["counts"], got[tag][0]["wire"]
    assert counts["all_reduce"] == n_moe * per_block + 2
    assert counts["all_gather"] == counts["reduce_scatter"] == 0
    n_params = sum(t.numel() for t in got[tag][0]["params"].values())
    experts = sum(t.numel() for n, t in got[tag][0]["params"].items()
                  if "experts" in n)
    held = n_params - experts + experts // eph.MESHES[tag][1]
    want = (n_moe * (2 * tokens * C + tokens * k) * 4 + 2 * 4
            + held * 4
            + (n_moe * 2 * 2 * 4 * 4 if dp > 1 else 0))
    assert wire["all_reduce.float32"] == want


def test_checkpoint_resume_bit_for_bit(ep_runs):
    _, got, _ = ep_runs
    for r in got[eph.CKPT_JOB]:
        assert r["resumed_step"] == eph.STEPS
        for key, series in r["resumed"].items():
            assert series == r["metrics"][key][eph.CKPT_STEP:], key
        for name, t in r["params"].items():
            assert torch.equal(r["resumed_params"][name], t), name


def test_checkpoint_loads_whole_into_one_process(ep_runs):
    """The EP checkpoint holds the unsharded model's keys and shapes: one
    process restores it into a ``NoShard`` trainer, whole."""
    from pytorch_distributed_tpu_torch.checkpoint import (
        CheckpointManager,
        get_state_dict,
        set_state_dict,
    )
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.parallel import NoShard
    from pytorch_distributed_tpu_torch.trainer import Trainer, lm_loss

    root, got, _ = ep_runs
    model = GPT2(GPT2Config(**eph.TINY), device="cpu", seed=9)
    tr = Trainer(model, torch.optim.AdamW(model.parameters(), lr=eph.LR),
                 NoShard("cpu"), loss_fn=lm_loss)
    state = tr.init()
    with CheckpointManager(str(root / "ckpt")) as mgr:
        assert mgr.all_steps() == [eph.CKPT_STEP]
        state = set_state_dict(tr, state, mgr.restore(get_state_dict(tr,
                                                                     state)))
    assert state.step == eph.CKPT_STEP
    # the whole experts: step 3 from here is the ranks' step 3
    state, m = tr.step(state, eph.lm_batch())
    np.testing.assert_allclose(float(m["loss"]),
                               got[eph.CKPT_JOB][0]["metrics"]["loss"][-1],
                               rtol=RTOL)
    for name, t in model.state_dict().items():
        np.testing.assert_allclose(
            t.numpy(), got[eph.CKPT_JOB][0]["params"][name].numpy(),
            rtol=0, atol=RTOL, err_msg=name)


def test_dropout_masks_follow_the_data_shard(tmp_path):
    ctx = ranks.start(eph.dropout_body, tmp_path)
    ranks.finish(ctx, timeout=120)
    out = [torch.load(tmp_path / f"dropout.rank{r}.pt", weights_only=False)
           for r in range(ranks.WORLD)]
    by_shard = {}
    for r in out:
        m0, m1, again = r["masks"]
        assert torch.equal(m0, again) and not torch.equal(m0, m1)
        assert 0.4 < m0.float().mean() < 0.6
        by_shard.setdefault(r["data_shard"], []).append(m0)
    assert sorted(by_shard) == [0, 1]
    for masks in by_shard.values():      # the ep ranks of a dp row agree
        assert all(torch.equal(masks[0], m) for m in masks)
    assert not torch.equal(by_shard[0][0], by_shard[1][0])
