"""The port's tensor parallelism of the MoE GPT-2 (TP x MoE) against the
JAX package's, on 4 gloo ranks.

The ranks (``tests/_torch_port_ranks.py``, spawned once for the file; rank
bodies in ``tests/_torch_port_tp_moe.py``) train a tiny MoE GPT-2 (width
64, 2 layers, 4 heads, E=4, top-2, routing groups of 64 tokens) from the
weights flax drew, under ``TensorParallel`` at ``(dp 2, tp 2)`` and
``(fsdp 2, tp 2)``, with the expert stacks left out of the plan (whole on
every tp rank) and with ``ExpertParallel()`` in it (cut on E over tp),
sequence parallelism off and on, and at ``(dp 1, tp 4)`` with SP: 2 AdamW
steps on one batch. The JAX ``TensorParallel`` trainer runs the same with
``ExpertParallel`` in its plan on a ``(dp 2, tp 2)`` mesh over 4 of the 8
virtual CPU devices, and ``jax.grad`` of its loss at each step's
parameters gives the reference's gradients. Held:

* the losses (the mean of the dp shards'), ``moe_aux`` and the grad norm
  at rtol 1e-5;
* the whole gradients the optimizer stepped on of the router, both expert
  stacks of the MoE block and ``wte``, at each step, within 1e-5 of each
  tensor's largest element;
* each rank holds the plan's blocks: the stacks ``(E, C, 4C)`` or ``(E /
  tp, C, 4C)``, their ff dim cut over fsdp under TP x FSDP, the router
  whole; the MoE layer's context is the plan's;
* with SP the MoE's collectives are the sequence region's (all-gathers and
  reduce-scatters, no all-reduce of an activation);
* a checkpoint of the ``(dp 2, tp 2)`` run with ``ExpertParallel`` and SP
  (the stacks ``Shard(0)`` over tp) loads whole into one ``NoShard``
  process at tp 1.

JAX is imported inside the tests only: the ranks re-import the helpers.
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_ranks as ranks
from tests import _torch_port_tp_moe as tmh

torch.set_num_threads(2)

RTOL = 1e-5
# the JAX trainer traces its init on one row (16 tokens), which a routing
# group of 64 does not divide: the init runs ungrouped (same parameters)
INIT = {**tmh.TINY, "moe_group_size": None}


def _jax_trainer():
    """The JAX TP trainer at step 0, and its parameters as the port's
    state dict."""
    import jax
    import optax

    from pytorch_distributed_tpu.mesh import init_device_mesh
    from pytorch_distributed_tpu.models import GPT2 as JaxGPT2
    from pytorch_distributed_tpu.models import GPT2Config as JaxCfg
    from pytorch_distributed_tpu.parallel.expert import (
        ExpertParallel as JaxEP,
    )
    from pytorch_distributed_tpu.parallel.tensor_parallel import (
        TensorParallel as JaxTP,
        gpt2_tp_plan as jax_plan,
    )
    from pytorch_distributed_tpu.trainer import Trainer as JaxTrainer
    from pytorch_distributed_tpu.trainer import lm_loss as jax_lm_loss
    from pytorch_distributed_tpu_torch.models import gpt2_state_dict_from_flax

    mesh = init_device_mesh((2, 2), ("dp", "tp"), devices=jax.devices()[:4])
    strategy = JaxTP(mesh, {r"moe/experts_": JaxEP(), **jax_plan()},
                     tp_axis="tp", dp_axis="dp")
    tr = JaxTrainer(JaxGPT2(JaxCfg(**INIT)),
                    optax.adamw(tmh.LR, weight_decay=tmh.WD), strategy,
                    loss_fn=jax_lm_loss)
    state = tr.init(jax.random.key(0), tmh.lm_batch())
    tr.model = JaxGPT2(JaxCfg(**tmh.TINY))    # the step is built lazily
    shards = state.params["h_1"]["moe"]["experts_up"].addressable_shards
    assert {s.data.shape for s in shards} == {(2, 64, 256)}
    return tr, state, gpt2_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, state.params))


def _jax_steps(tr, state):
    """Per step the JAX trainer's loss, ``moe_aux`` and grad norm, and
    ``jax.grad``'s gradients of ``GRADS`` at the step's parameters (torch
    layout)."""
    import jax

    from pytorch_distributed_tpu.trainer import lm_loss as jax_lm_loss
    from pytorch_distributed_tpu_torch.models import gpt2_state_dict_from_flax

    batch, model = tmh.lm_batch(), tr.model

    @jax.jit
    def grads(params):
        return jax.grad(lambda p: jax_lm_loss(model, {"params": p}, batch,
                                              True)[0])(params)

    out = {"metrics": {}, "grads": {n: [] for n in tmh.GRADS}}
    for _ in range(tmh.STEPS):
        g = gpt2_state_dict_from_flax(jax.tree_util.tree_map(
            np.asarray, grads(state.params)))
        for n in tmh.GRADS:
            out["grads"][n].append(g[n])
        state, m = tr.step(state, batch)
        for k in ("loss", "moe_aux", "grad_norm"):
            out["metrics"].setdefault(k, []).append(float(m[k]))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_moe")
    tr, state, sd = _jax_trainer()
    ctx = ranks.start(tmh.train_body, tmp, tmh.JOBS, sd)
    want = _jax_steps(tr, state)
    ranks.finish(ctx, timeout=240)
    got = {tag: [torch.load(f"{tmp}/{tag}.rank{r}.pt", weights_only=False)
                 for r in range(ranks.WORLD)] for tag, *_ in tmh.JOBS}
    return tmp, got, want


@pytest.mark.parametrize("tag", [tag for tag, *_ in tmh.JOBS])
def test_losses_aux_and_norms_match_jax(runs, tag):
    _, got, want = runs
    for key in ("loss", "moe_aux", "grad_norm"):
        mean = np.mean([r["metrics"][key] for r in got[tag]], axis=0)
        np.testing.assert_allclose(mean, want["metrics"][key], rtol=RTOL,
                                   atol=0, err_msg=key)
        for r in got[tag]:
            if key != "loss":      # the global statistic on every rank
                np.testing.assert_allclose(r["metrics"][key], mean,
                                           rtol=RTOL, atol=0, err_msg=key)


@pytest.mark.parametrize("tag", [tag for tag, *_ in tmh.JOBS])
def test_router_stack_and_table_gradients_match_jax(runs, tag):
    _, got, want = runs
    for name in tmh.GRADS:
        for step in range(tmh.STEPS):
            w = want["grads"][name][step]
            scale = float(w.abs().max())
            for r in got[tag]:
                torch.testing.assert_close(
                    r["grads"][name][step], w, rtol=0, atol=RTOL * scale,
                    msg=f"{name} step {step}")


@pytest.mark.parametrize("tag,kind,experts,sp", tmh.JOBS)
def test_each_rank_holds_the_plans_blocks(runs, tag, kind, experts, sp):
    _, got, _ = runs
    C, E = tmh.TINY["n_embd"], tmh.TINY["moe_experts"]
    tp = tmh.MESHES[kind][0][1]
    e = E // tp if experts == "ep" else E
    ff = 4 * C // (2 if kind == "fsdp2tp2" else 1)
    for r in got[tag]:
        held = r["held"]
        assert held["h.1.moe.experts_up"] == (e, C, ff)
        assert held["h.1.moe.experts_down"] == (e, ff, C)
        assert held["h.1.moe.router.weight"][0] == E
        assert held["h.0.mlp.c_fc.weight"][0] == 4 * C // tp
        ctx = {"whole": "NoneType", "ep": ("SequenceEPContext" if sp
                                           else "EPContext")}[experts]
        assert r["ep"] == [ctx]
        # the gathered parameters are the same on every rank
        for name, t in r["params"].items():
            assert torch.equal(t, got[tag][0]["params"][name]), name


@pytest.mark.parametrize("experts", ["whole", "ep"])
def test_sequence_parallel_moe_reduce_scatters(runs, experts):
    """SP (dp 2, tp 2): the dense step's collectives (``_torch_port_tp``'s
    count: 4 per layer each way, the tables, the dp mean, the norm and the
    partial gradients' sum) plus the MoE block's: the gather of the
    sequence in, and the reduce-scatter of the partial combine out (EP) or
    nothing (whole stacks: each rank keeps its rows), and the aux
    statistics' all-reduce over dp each way; without SP the MoE adds
    all-reduces (the statistics', and EP's f on the tokens and the gates
    and g)."""
    _, got, _ = runs
    on = got[f"dp2tp2_{experts}_sp1"][0]["counts"]
    off = got[f"dp2tp2_{experts}_sp0"][0]["counts"]
    L, n_dense = tmh.TINY["n_layer"], 1
    ep = experts == "ep"
    # a pair of f and g: the attention's in every block, the MLP's in a
    # dense one; the MoE's entry (and EP's exit), the tables' 4 gathers
    # (SP: with the sequence's split and join), the statistics' 2
    pairs = L + n_dense
    assert on == {"all_reduce": 3 + 2, "reduce_scatter": 2 * pairs + 1 + ep,
                  "all_gather": 2 * pairs + 4 + 1 + ep,
                  "broadcast": 0}, on
    assert off == {"all_reduce": 2 * pairs + 2 + 2 + 3 * ep,
                   "reduce_scatter": 0, "all_gather": 2, "broadcast": 0}, off


def test_tp_cut_checkpoint_loads_at_tp_1(runs):
    """The ``(dp 2, tp 2)`` EP + SP checkpoint (the stacks saved as
    ``Shard(0)`` over tp under the unsharded model's keys) restored into a
    ``NoShard`` trainer in this process: the ranks' gathered parameters,
    and the next step's loss."""
    from pytorch_distributed_tpu_torch.checkpoint import (
        CheckpointManager,
        get_state_dict,
        set_state_dict,
    )
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.parallel import NoShard
    from pytorch_distributed_tpu_torch.trainer import Trainer, lm_loss

    tmp, got, _ = runs
    model = GPT2(GPT2Config(**tmh.TINY), device="cpu", seed=9)
    tr = Trainer(model, torch.optim.AdamW(model.parameters(), lr=tmh.LR,
                                          weight_decay=tmh.WD, eps=1e-8),
                 NoShard("cpu"), loss_fn=lm_loss)
    state = tr.init()
    with CheckpointManager(str(tmp / "ckpt")) as mgr:
        assert mgr.all_steps() == [tmh.STEPS]
        state = set_state_dict(tr, state, mgr.restore(get_state_dict(tr,
                                                                     state)))
    assert state.step == tmh.STEPS
    ref = got[tmh.CKPT_JOB][0]["params"]
    for name, t in model.state_dict().items():
        assert torch.equal(t, ref[name]), name
    exp = tr.optimizer.state[model.h[1].moe.experts_up]["exp_avg"]
    assert exp.shape == (4, 64, 256) and exp.abs().max() > 0
    _, m = tr.step(state, tmh.lm_batch())
    assert np.isfinite(float(m["loss"]))
