"""The port's ``DataParallel`` ResNet training on 4 gloo ranks against the
JAX ``Trainer`` with ``DataParallel`` on 8 virtual devices.

ResNet-18 (CIFAR stem, 10 classes, 16 filters in the first stage where
the published model has 64), global batch 16 (4 rows a rank),
``SGD(0.05, momentum=0.9)`` against ``optax.sgd(0.05, momentum=0.9)``,
``classification_loss``. flax builds the weights, every BatchNorm scale,
bias and running statistic is drawn at random, and only rank 0 of the port
is given them (``Trainer.init`` broadcasts parameters and BN buffers). The
JAX step is one global-view program, so its BatchNorm takes the statistics
of the whole global batch; the port's all-reduces them over the dp group.

Both models compute in fp64 with fp32 parameters (flax under
``jax.enable_x64``; the weights are flax's fp32 init): in fp32, with
random BN state, ResNet-18's step-1 gradients are 17% (flax; of a
tensor's largest element) and 0.45% (the port) away from the fp64 ones
(``tests/_torch_port_resnet_precision.py``), so an fp32 comparison would
measure rounding. The loss is taken in fp32 on both sides (the loss
functions cast the logits).

* 3 steps at ``grad_accum_steps=1`` and 3 at ``2``: at 2, microbatch ``i``
  is global rows ``[8 i, 8 i + 8)`` in both, each rank holding 2 rows of
  each. The mean of the ranks' losses agrees with the JAX loss within
  1e-6 relative at every step (measured: 1.1e-7), and the parameters and
  BN buffers after the last step within 1e-5 of each tensor's largest
  element (3e-7), on every rank; the ranks end with equal parameters.
* One fp16 step with an infinite loss scale (every scaled gradient
  overflows): both skip it; parameters and momentum stay as they were,
  the BN buffers advance to JAX's new ``batch_stats`` (1e-5), the loss
  agrees (1e-6).

JAX is imported inside the tests only: the ranks re-import this module.
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_ranks as ranks

torch.set_num_threads(2)

N = ranks.WORLD
B, LR, MOMENTUM, STEPS = 16, 0.05, 0.9, 3
WIDTH = 16
INF_SCALE = float("inf")
LOSS_TOL = 1e-6
STATE_TOL = 1e-5


def _port_trainer(rank, mesh, state_dict, **kw):
    from pytorch_distributed_tpu_torch.models import resnet18
    from pytorch_distributed_tpu_torch.parallel import DataParallel
    from pytorch_distributed_tpu_torch.trainer import (
        Trainer,
        classification_loss,
    )

    model = resnet18(10, cifar_stem=True, num_filters=WIDTH,
                     dtype=torch.float64, device="cpu", seed=rank)
    if rank == 0:
        model.load_state_dict(state_dict)
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM)
    trainer = Trainer(model, opt, DataParallel(mesh, "dp"),
                      loss_fn=classification_loss, **kw)
    return trainer, trainer.init()


def _snapshot(trainer):
    model, opt = trainer.model, trainer.optimizer
    return {"state": {k: v.detach().clone()
                      for k, v in model.state_dict().items()},
            "momentum": {n: opt.state[p]["momentum_buffer"].clone()
                         for n, p in model.named_parameters()}}


def _rank(rank, store_dir, state_dict, batch):
    from pytorch_distributed_tpu_torch.amp import GradScaler
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh

    mesh = init_device_mesh((N,), ("dp",))
    out = {}
    for accum in (1, 2):
        trainer, state = _port_trainer(rank, mesh, state_dict,
                                       grad_accum_steps=accum)
        losses = []
        for _ in range(STEPS):
            state, m = trainer.step(state, batch)
            losses.append(float(m["loss"]))
        out[accum] = {"losses": losses, **_snapshot(trainer)}
    trainer, state = _port_trainer(rank, mesh, state_dict, policy="fp16",
                                   scaler=GradScaler(init_scale=INF_SCALE))
    before = _snapshot(trainer)
    state, m = trainer.step(state, batch)
    out["skip"] = {"before": before, "loss": float(m["loss"]),
                   "all_finite": bool(m["all_finite"]), **_snapshot(trainer)}
    torch.save(out, f"{store_dir}/rank{rank}.pt")


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's rank results and the JAX runs on the same data."""
    import jax
    import jax.numpy as jnp
    import optax

    from pytorch_distributed_tpu.amp import GradScaler as JaxGradScaler
    from pytorch_distributed_tpu.mesh import init_device_mesh
    from pytorch_distributed_tpu.models import resnet18 as jax_resnet18
    from pytorch_distributed_tpu.parallel import DataParallel as JaxDP
    from pytorch_distributed_tpu.trainer import Trainer as JaxTrainer
    from pytorch_distributed_tpu.trainer import (
        classification_loss as jax_classification_loss,
    )
    from pytorch_distributed_tpu_torch.models import (
        resnet_state_dict_from_flax,
    )
    from tests.test_torch_port_resnet import _randomize_bn

    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, B).astype(np.int32))
    mesh = init_device_mesh((8,), ("dp",))

    def jax_trainer(**kw):
        model = jax_resnet18(num_classes=10, cifar_stem=True,
                             num_filters=WIDTH, dtype=jnp.float64)
        return JaxTrainer(model, optax.sgd(LR, momentum=MOMENTUM),
                          JaxDP(mesh), loss_fn=jax_classification_loss, **kw)

    def jax_state(trainer, params, stats):
        """The trainer's state with ``params`` and, as fp64 (the dtype the
        fp64 statistics give them after a step), ``stats``."""
        state = trainer.init(jax.random.key(0), batch)

        def put(new, old):
            return jax.device_put(new, old.sharding)

        stats = jax.tree_util.tree_map(lambda a: a.astype(np.float64), stats)
        return state.replace(
            params=jax.tree_util.tree_map(put, params, state.params),
            model_state={"batch_stats": jax.tree_util.tree_map(
                put, stats, state.model_state["batch_stats"])})

    init = jax_resnet18(num_classes=10, cifar_stem=True,
                        num_filters=WIDTH).init(jax.random.key(0), batch[0])
    params, stats = _randomize_bn(
        jax.tree_util.tree_map(np.asarray, init["params"]),
        jax.tree_util.tree_map(np.asarray, init["batch_stats"]), rng,
        np.float32)
    store = tmp_path_factory.mktemp("resnet_dp")
    ctx = ranks.start(_rank, store,
                      resnet_state_dict_from_flax(params, stats), batch)
    def run(trainer, steps):
        state = jax_state(trainer, params, stats)
        losses = []
        for _ in range(steps):
            state, m = trainer.step(state, batch)
            losses.append(float(m["loss"]))
        state_dict = resnet_state_dict_from_flax(*jax.tree_util.tree_map(
            np.asarray, (state.params, state.model_state["batch_stats"])))
        return state, m, {"losses": losses, "state": state_dict}

    try:
        with jax.enable_x64(True):
            want = {accum: run(jax_trainer(grad_accum_steps=accum), STEPS)[2]
                    for accum in (1, 2)}
            state, m, want["skip"] = run(jax_trainer(
                policy="fp16", scaler=JaxGradScaler(init_scale=INF_SCALE)), 1)
            want["skip"].update(
                all_finite=bool(m["all_finite"]),
                trace=resnet_state_dict_from_flax(jax.tree_util.tree_map(
                    np.asarray, state.opt_state[0].trace)))
    finally:
        ranks.finish(ctx)
    got = [torch.load(store / f"rank{r}.pt", weights_only=False)
           for r in range(N)]
    return got, want


@pytest.mark.parametrize("accum", [1, 2])
def test_dp_steps_match_jax(runs, accum):
    got, want = runs
    mean_losses = np.mean([g[accum]["losses"] for g in got], axis=0)
    np.testing.assert_allclose(mean_losses, want[accum]["losses"],
                               rtol=LOSS_TOL, atol=0)
    for g in got:
        for name, w in want[accum]["state"].items():
            assert _rel_err(g[accum]["state"][name], w) <= STATE_TOL, name
        for name, t in g[accum]["state"].items():
            assert torch.equal(t, got[0][accum]["state"][name]), name


def test_skipped_fp16_step_keeps_params_and_momentum(runs):
    got, want = runs
    assert not want["skip"]["all_finite"]
    np.testing.assert_allclose(np.mean([g["skip"]["loss"] for g in got]),
                               want["skip"]["losses"][0], rtol=LOSS_TOL)
    for name, w in want["skip"]["trace"].items():
        assert not w.any(), name                 # optax's trace kept at 0
    for g in got:
        s = g["skip"]
        assert not s["all_finite"]
        for name, t in s["state"].items():
            old = s["before"]["state"][name]
            if name.endswith(("running_mean", "running_var")):
                assert not torch.equal(t, old), name       # advanced
                assert _rel_err(t, want["skip"]["state"][name]) <= STATE_TOL
            else:
                assert torch.equal(t, old), name           # kept
                assert _rel_err(t, want["skip"]["state"][name]) == 0.0
        for name, buf in s["momentum"].items():
            assert not buf.any(), name


class _Mesh:
    """The part of a ``DeviceMesh`` that ``DataParallel`` reads, for one
    rank of a ``dp`` axis of ``n``, without a process group."""

    axis_names = ("dp",)
    device = torch.device("cpu")

    def __init__(self, n, rank):
        self.n, self.rank = n, rank

    def size(self, axis):
        return self.n

    def get_local_rank(self, axis):
        return self.rank

    def get_group(self, axis):
        return None


@pytest.mark.parametrize("accum", [1, 2, 4])
def test_place_batch_gives_each_rank_its_share_of_every_microbatch(accum):
    """Global rows ``[i B / accum, (i + 1) B / accum)`` are microbatch
    ``i``; rank ``r`` of ``n`` holds its ``r``-th equal share of each, in
    microbatch order. A ``LocalBatch`` is placed as it is."""
    from pytorch_distributed_tpu_torch.data import LocalBatch
    from pytorch_distributed_tpu_torch.parallel import DataParallel

    rows = np.arange(B)
    share = B // (N * accum)
    for rank in range(N):
        dp = DataParallel(_Mesh(N, rank))
        (got,) = dp.place_batch((rows,), accum)
        want = np.concatenate([
            rows[i * B // accum + rank * share:][:share]
            for i in range(accum)])
        np.testing.assert_array_equal(got.numpy(), want)
        (local,) = dp.place_batch(LocalBatch((torch.tensor(rows),)), accum)
        np.testing.assert_array_equal(local.numpy(), rows)
