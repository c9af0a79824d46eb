"""Checkpoints of pipelined training state and dropout through the
pipeline, on 4 gloo ranks (rank bodies ``ckpt_body`` and ``dropout_body``
in ``tests/_torch_port_pipeline.py``).

* A ``PipelineParallel`` trainer's state is saved under the unsharded
  model's keys: each stage's ``h.{i}`` and its AdamW moments by its own
  rank, the replicated tables and the train state once. A fresh trainer
  (other weights) restored from it at pp 4 takes the remaining steps bit
  for bit as the run that saved it; a (dp 2, pp 2) trainer loads the same
  checkpoint through DCP (each stage reads the layers it holds now, which
  two pp-4 ranks wrote) and its next loss is the pp-4 run's at rtol 1e-5.
* ``Trainer.run`` on the gloo pipeline runs the eager bodies and gives
  the eager steps' losses; two accumulated halves give the whole batch's
  loss (rtol 1e-6) and grad norm (rtol 1e-5).
* Dropout, held by properties (the masks follow the reference's rule,
  never its bits): a step's masks are drawn again the same for the same
  seed, step and data shard; the next step's differ; the stages, the
  microbatches and the data shards draw different masks; eval is
  deterministic and differs from train; the trainer trains.
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_pipeline as pph
from tests import _torch_port_ranks as ranks

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ckpt_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp_ckpt")
    ctx = ranks.start(pph.ckpt_body, root)
    ranks.finish(ctx, timeout=240)
    return root, [torch.load(root / f"ckpt.rank{r}.pt", weights_only=False)
                  for r in range(ranks.WORLD)]


def test_checkpoint_keys_are_the_unsharded_models(ckpt_runs):
    _, got = ckpt_runs
    for rank, r in enumerate(got):
        layers = {int(k.split("/")[1].split(".")[1]) for k in r["keys"]
                  if k.startswith("model/h.")}
        assert layers == {rank}                      # 4 layers, pp 4
        assert {"model/wte", "model/wpe", "model/ln_f.weight",
                "optim/wte/exp_avg", f"optim/h.{rank}.mlp.c_fc.weight/"
                "exp_avg_sq", "train/step"} <= set(r["keys"])


def test_resume_bit_for_bit(ckpt_runs):
    _, got = ckpt_runs
    for r in got:
        assert r["restored_step"] == pph.CKPT_STEP
        for key, series in r["resumed"].items():
            assert series == r["metrics"][key][pph.CKPT_STEP:], key
        for name, t in r["params"].items():
            assert torch.equal(r["resumed_params"][name], t), name
        for name, t in r["exp_avg"].items():
            assert torch.equal(r["resumed_exp_avg"][name], t), name


def test_loads_at_pp2_through_dcp(ckpt_runs):
    """The (dp 2, pp 2) trainer: stage s holds layers [2s, 2s + 2), which
    the pp-4 ranks 2s and 2s + 1 saved; its next loss (the mean of its dp
    rows') is the pp-4 run's third step's."""
    from pytorch_distributed_tpu_torch.checkpoint import CheckpointManager

    root, got = ckpt_runs
    with CheckpointManager(str(root / "ckpt")) as mgr:
        assert mgr.all_steps() == [pph.CKPT_STEP]
    for rank, r in enumerate(got):
        stage = rank % 2
        assert r["pp2_layers"] == [2 * stage, 2 * stage + 1]
    rows = [got[d * 2 + 1]["pp2_next"]["loss"][0] for d in range(2)]
    want = got[0]["metrics"]["loss"][pph.CKPT_STEP]
    np.testing.assert_allclose(np.mean(rows), want, rtol=1e-5)


def test_runner_on_gloo_runs_the_eager_bodies(ckpt_runs):
    """``Trainer.run`` on a gloo pipeline: the runner does not capture
    (``Trainer.graph_capturable`` is False), and its losses are the eager
    steps' bit for bit."""
    _, got = ckpt_runs
    for r in got:
        assert r["graph_capturable"] is False
        np.testing.assert_array_equal(
            np.asarray(r["run_losses"], np.float32),
            np.asarray(r["metrics"]["loss"], np.float32))


def test_accumulation_through_the_pipeline(ckpt_runs):
    """Two accumulated halves of the batch, each through the whole
    pipeline (4 microbatches of one row): the first step's loss and grad
    norm are the whole batch's."""
    _, got = ckpt_runs
    for r in got:
        np.testing.assert_allclose(r["accum"]["loss"][0],
                                   r["metrics"]["loss"][0], rtol=1e-6)
        np.testing.assert_allclose(r["accum"]["grad_norm"][0],
                                   r["metrics"]["grad_norm"][0], rtol=1e-5)


@pytest.fixture(scope="module")
def dropout_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp_dropout")
    ctx = ranks.start(pph.dropout_body, root)
    ranks.finish(ctx, timeout=180)
    return [torch.load(root / f"dropout.rank{r}.pt", weights_only=False)
            for r in range(ranks.WORLD)]


def test_dropout_masks_reproduce_and_differ(dropout_runs):
    """(dp 2, pp 2), 2 layers a stage, 4 microbatches: stage 0 draws the
    embedding's mask, then 4 masks a microbatch (2 sites x 2 layers);
    stage 1 the 16 masks of its layers."""
    by = {}
    for r in dropout_runs:
        first, again, other = r["first"], r["again"], r["other"]
        assert len(first) == (17 if r["stage"] == 0 else 16)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        assert not any(torch.equal(a, b) for a, b in zip(first, other))
        masks = first[1:] if r["stage"] == 0 else first
        per_mb = [masks[4 * m:4 * m + 4] for m in range(4)]
        for a in range(4):      # microbatches and sites draw differently
            for b in range(a + 1, 4):
                assert not torch.equal(per_mb[a][0], per_mb[b][0])
        assert not torch.equal(per_mb[0][0], per_mb[0][1])
        for m in masks:
            assert 0.7 < m.float().mean() < 0.9             # rate 0.2
        by[(r["stage"], r["data_shard"])] = masks[0]
    assert sorted(by) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert not torch.equal(by[(0, 0)], by[(1, 0)])          # stages
    assert not torch.equal(by[(0, 0)], by[(0, 1)])          # data shards


def test_dropout_eval_deterministic_and_training(dropout_runs):
    """Eval logits are the same twice and differ from train's;
    ``Trainer.eval_step`` gives every stage of a dp row its row's loss,
    the same twice; the trainer's loss falls."""
    for r in dropout_runs:
        twin = dropout_runs[r["data_shard"] * 2]
        assert r["eval_step"] == twin["eval_step"]
        assert r["eval_step"][0] == r["eval_step"][1]
    for r in dropout_runs:
        ev1, ev2 = r["eval"]
        if r["stage"] != 1:
            continue
        assert torch.equal(ev1, ev2) and torch.isfinite(ev1).all()
        assert torch.equal(r["y_train"], r["y_again"])
        assert not torch.allclose(r["y_train"], ev1)
        losses = r["losses"]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_dropout_recomputation_reuses_the_masks(dropout_runs):
    """The first step with remat on and off, from the same seed: the
    recomputation of each stage application reuses the masks drawn before
    it, so the loss and the gradient norm are the same (redrawn masks
    would give another gradient)."""
    for r in dropout_runs:
        once = r["no_remat"]
        np.testing.assert_allclose(once["loss"][0], r["losses"][0],
                                   rtol=1e-6)
        np.testing.assert_allclose(once["grad_norm"][0],
                                   r["grad_norm"][0], rtol=1e-6)
