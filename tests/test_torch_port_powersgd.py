"""The port's PowerSGD hook (``parallel/powersgd.py``) against torch's own
PowerSGD arithmetic and the JAX package's hook.

* The plan and ``wire_elements`` in the reference's layout: equal to the
  JAX hook's for GPT-2 and ResNet-18 at test size (the multiset of (n, m,
  compressed) per gradient, and the counts), and for GPT-2 125M and
  ResNet-50 at their published shapes: (521,890, 124,439,808) and
  (23,508,422, 25,557,032). A torch layout would give ResNet-50 219,102.
* One round on one rank against torch's ``powerSGD_hook`` recipe (its own
  ``_orthogonalize``; QR column signs aligned), and the error-feedback
  invariant ``M_hat + e = M + e_0``.
* On 4 gloo ranks, ResNet-18 (CIFAR stem, 8 filters, per-rank BN,
  ``SGD(0.05, 0.9)``, global batch 16) under ``PowerSGD(rank=2,
  start_iter=1)`` for 3 steps, the JAX ``Trainer``'s Q carried in (Q is
  drawn from another generator in each package): the mean of the ranks'
  losses within 1e-5 of JAX's, the state within 1e-4 of each tensor's
  largest element, Q within 1e-4; the error buffers are per rank (they
  differ between ranks); each compressed step puts (n + m) r fp32
  elements of P and Q on the wire plus the uncompressed gradients.
* The warm-up is the allreduce hook bit for bit; the runner across
  ``start_iter`` (2 of 5 steps) equals sequential ``Trainer.step`` bit
  for bit with two programs; without ``warm_start`` Q is redrawn each step
  and nothing is kept.

JAX is imported inside the tests only.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests import _torch_port_comm as rb
from tests import _torch_port_ranks as ranks

torch.set_num_threads(2)

WS = rb.WS
B, WIDTH, LR, MOMENTUM, STEPS = 16, 8, 0.05, 0.9, 3
PSGD = dict(rank=2, start_iter=1, min_compression_rate=2.0)


def _flax_to_torch_index(params, model):
    """flax leaf index (``tree_flatten`` order) -> the torch parameter's
    index in ``model.parameters()``."""
    import jax

    from pytorch_distributed_tpu_torch.models import (
        resnet_state_dict_from_flax,
    )

    leaves, treedef = jax.tree_util.tree_flatten(params)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i, np.float32)
                  for i, x in enumerate(leaves)])
    sd = resnet_state_dict_from_flax(tagged)
    names = [n for n, _ in model.named_parameters()]
    return {int(sd[n].reshape(-1)[0]): j for j, n in enumerate(names)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import optax

    from pytorch_distributed_tpu.mesh import init_device_mesh
    from pytorch_distributed_tpu.models import resnet18
    from pytorch_distributed_tpu.parallel import DataParallel
    from pytorch_distributed_tpu.parallel import PowerSGD as JaxPowerSGD
    from pytorch_distributed_tpu.trainer import Trainer, classification_loss
    from pytorch_distributed_tpu_torch.models import (
        resnet18 as port_resnet18,
    )
    from pytorch_distributed_tpu_torch.models import (
        resnet_state_dict_from_flax,
    )

    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, B).astype(np.int32))
    flax_model = resnet18(num_classes=10, cifar_stem=True, num_filters=WIDTH)
    init = jax.tree_util.tree_map(
        np.asarray, flax_model.init(jax.random.key(0), batch[0]))
    mesh = init_device_mesh((WS,), ("dp",), devices=jax.devices()[:WS])
    trainer = Trainer(flax_model, optax.sgd(LR, momentum=MOMENTUM),
                      DataParallel(mesh), loss_fn=classification_loss,
                      comm_hook=JaxPowerSGD(**PSGD))
    state = trainer.init(jax.random.key(0), batch)
    index = _flax_to_torch_index(init["params"], port_resnet18(
        10, cifar_stem=True, num_filters=WIDTH, device="cpu"))
    q = {index[int(k)]: np.asarray(v["q"])
         for k, v in state.comm_state.items()}
    store = tmp_path_factory.mktemp("powersgd")
    ctx = ranks.start(rb.powersgd_rank, store, resnet_state_dict_from_flax(
        init["params"], init["batch_stats"]), batch, q, WIDTH, LR, MOMENTUM,
        PSGD)
    try:
        state = state.replace(
            params=jax.tree_util.tree_map(
                lambda new, old: jax.device_put(new, old.sharding),
                init["params"], state.params),
            model_state={"batch_stats": jax.tree_util.tree_map(
                lambda new, old: jax.device_put(new, old.sharding),
                init["batch_stats"], state.model_state["batch_stats"])})
        losses = []
        for _ in range(STEPS):
            state, m = trainer.step(state, batch)
            losses.append(float(m["loss"]))
        want = {
            "losses": losses,
            "state": resnet_state_dict_from_flax(*jax.tree_util.tree_map(
                np.asarray, (state.params,
                             state.model_state["batch_stats"]))),
            "q": {index[int(k)]: np.asarray(v["q"])
                  for k, v in state.comm_state.items()}}
    finally:
        ranks.finish(ctx)
    return rb.load(store, "powersgd"), want


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_powersgd_trainer_matches_jax_with_carried_q(runs):
    got, want = runs
    mean = np.mean([g["carried"]["losses"] for g in got], axis=0)
    np.testing.assert_allclose(mean, want["losses"], rtol=1e-5, atol=1e-5)
    for g in got:
        for name, w in want["state"].items():
            assert _rel_err(g["carried"]["state"][name], w) <= 1e-4, name
        for idx, w in want["q"].items():
            assert _rel_err(g["carried"]["comm_state"][str(idx)]["q"],
                            w) <= 1e-4, idx


def test_error_buffers_are_per_rank(runs):
    got, _ = runs
    keys = list(got[0]["carried"]["comm_state"])
    assert keys
    for k in keys:
        e = [g["carried"]["comm_state"][k]["e"] for g in got]
        q = [g["carried"]["comm_state"][k]["q"] for g in got]
        assert not torch.equal(e[0], e[1])        # each rank's own residual
        assert all(torch.equal(q[0], x) for x in q)   # Q agreed


def test_wire_is_the_low_rank_factors(runs):
    from pytorch_distributed_tpu_torch.models import resnet18
    from pytorch_distributed_tpu_torch.parallel import PowerSGD

    got, _ = runs
    model = resnet18(10, cifar_stem=True, num_filters=WIDTH, device="cpu")
    compressed, dense = PowerSGD(**PSGD).wire_elements(model)
    buffers = sum(b.numel() for b in model.buffers())
    for g in got:
        warm, compressed_step = g["carried"]["counts"][0], g["carried"][
            "counts"][1]
        assert warm[1]["all_reduce.float32"] == (dense + buffers) * 4
        # P's, Q's, the uncompressed gradients, the BN statistics
        assert compressed_step[0]["all_reduce"] == 4
        assert compressed_step[1]["all_reduce.float32"] == (
            compressed + buffers) * 4


def test_warmup_is_the_allreduce_hook(runs):
    got, _ = runs
    for g in got:
        assert g["warmup"]["losses"] == g["allreduce"]["losses"]
        for name, t in g["allreduce"]["state"].items():
            assert torch.equal(g["warmup"]["state"][name], t), name


def test_runner_across_start_iter_equals_sequential_steps(runs):
    got, _ = runs
    for g in got:
        assert g["runner"]["programs"] == [False, True]
        assert g["runner"]["losses"] == g["sequential"]["losses"]
        assert g["runner"]["step"] == g["sequential"]["step"] == 5
        for name, t in g["sequential"]["state"].items():
            assert torch.equal(g["runner"]["state"][name], t), name
        for k, entry in g["sequential"]["comm_state"].items():
            for key, t in entry.items():
                assert torch.equal(g["runner"]["comm_state"][k][key], t)


def test_cold_start_redraws_q_and_keeps_none(runs):
    from pytorch_distributed_tpu_torch.parallel import PowerSGD

    got, _ = runs
    hook = PowerSGD(rank=2, warm_start=False)
    plan = hook._plan((32, 16))
    assert not torch.equal(hook._fresh_q(0, 0, plan, "cpu"),
                           hook._fresh_q(0, 1, plan, "cpu"))
    assert torch.equal(hook._fresh_q(0, 1, plan, "cpu"),
                       hook._fresh_q(0, 1, plan, "cpu"))
    for g in got:
        assert np.all(np.isfinite(g["cold"]["losses"]))
        for entry in g["cold"]["comm_state"].values():
            assert "q" not in entry and "e" in entry


# -- layout and plan -----------------------------------------------------------
def _jax_plan(hook, params):
    import jax

    return sorted((p.compress, p.n, p.m) for p in (
        hook._plan(tuple(x.shape)) for x in jax.tree_util.tree_leaves(params)))


def _port_plan(hook, model):
    return sorted((p.compress, p.n, p.m)
                  for p in (hook._plan(s) for s in hook._shapes(model)))


@pytest.mark.parametrize("model", ["gpt2", "resnet18"])
def test_plan_and_wire_elements_match_jax(model):
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_tpu import models as jax_models
    from pytorch_distributed_tpu.parallel import PowerSGD as JaxPowerSGD
    from pytorch_distributed_tpu_torch import models as port_models
    from pytorch_distributed_tpu_torch.parallel import PowerSGD

    if model == "gpt2":
        cfg = dict(vocab_size=256, n_positions=32, n_embd=64, n_layer=2,
                   n_head=2)
        flax_model = jax_models.GPT2(jax_models.GPT2Config(**cfg))
        x = jnp.zeros((1, 8), jnp.int32)
        port = port_models.GPT2(port_models.GPT2Config(**cfg), device="cpu")
    else:
        flax_model = jax_models.resnet18(num_classes=10, cifar_stem=True,
                                         num_filters=8)
        x = jnp.zeros((1, 32, 32, 3))
        port = port_models.resnet18(10, cifar_stem=True, num_filters=8,
                                    device="cpu")
    params = jax.eval_shape(flax_model.init, jax.random.key(0), x)["params"]
    for rank, rate in ((1, 2.0), (2, 2.0), (4, 1.1)):
        kw = dict(rank=rank, min_compression_rate=rate)
        assert PowerSGD(**kw).wire_elements(port) == JaxPowerSGD(
            **kw).wire_elements(params)
        assert _port_plan(PowerSGD(**kw), port) == _jax_plan(
            JaxPowerSGD(**kw), params)


def test_published_models_wire_elements():
    """GPT-2 125M and ResNet-50 at their published shapes, in the
    reference's layout (the JAX hook's counts on ``eval_shape``d
    parameters)."""
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_tpu import models as jax_models
    from pytorch_distributed_tpu.parallel import PowerSGD as JaxPowerSGD
    from pytorch_distributed_tpu_torch import models as port_models
    from pytorch_distributed_tpu_torch.parallel import PowerSGD

    gpt2 = jax.eval_shape(jax_models.gpt2_125m().init, jax.random.key(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    r50 = jax.eval_shape(jax_models.resnet50(num_classes=1000).init,
                         jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    hook = PowerSGD(rank=2)
    assert JaxPowerSGD(rank=2).wire_elements(gpt2) == (521_890, 124_439_808)
    assert hook.wire_elements(port_models.gpt2_125m(device="cpu")) == (
        521_890, 124_439_808)
    assert JaxPowerSGD(rank=2).wire_elements(r50["params"]) == (
        23_508_422, 25_557_032)
    port_r50 = port_models.resnet50(1000, device="cpu")
    assert hook.wire_elements(port_r50) == (23_508_422, 25_557_032)
    # torch's own layout (OIHW reshaped [O, I*H*W]) would compress far more
    shapes = [p.shape for p in port_r50.parameters()]
    assert hook.wire_elements(shapes)[0] == 219_102


# -- one rank: torch's own PowerSGD arithmetic ---------------------------------
@pytest.fixture
def one_rank():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _torch_reference_step(m, q, e, eps=0.0):
    """torch's ``powerSGD_hook`` round on one rank, with its own
    ``_orthogonalize``: M += e; P = M Q; orthogonalize; Q = M^T P;
    M_hat = P Q^T."""
    from torch.distributed.algorithms.ddp_comm_hooks.powerSGD_hook import (
        _orthogonalize,
    )

    m = m + e
    p = (m @ q).unsqueeze(0)
    _orthogonalize(p, epsilon=eps)
    p = p.squeeze(0)
    q_new = m.t() @ p
    m_hat = p @ q_new.t()
    return m_hat, q_new, m - m_hat


@pytest.mark.parametrize("n,m,r", [(16, 12, 2), (32, 8, 1), (24, 24, 4),
                                   (40, 30, 8), (64, 48, 32)])
def test_single_rank_matches_torch(one_rank, n, m, r):
    from pytorch_distributed_tpu_torch.parallel import PowerSGD

    g = torch.Generator().manual_seed(0)
    grad = torch.randn(n, m, generator=g)
    q0 = torch.randn(m, r, generator=g)
    e0 = torch.randn(n, m, generator=g) * 0.1
    want_g, want_q, want_e = _torch_reference_step(grad, q0, e0)
    hook = PowerSGD(rank=r, start_iter=0, min_compression_rate=0.0)
    state = {"0": {"q": q0.clone(), "e": e0.clone()}}
    state, (out,) = hook.apply(state, [grad], one_rank, step=5)
    torch.testing.assert_close(out, want_g, rtol=2e-4, atol=2e-4)
    signs = torch.sign((state["0"]["q"] * want_q).sum(0, keepdim=True))
    torch.testing.assert_close(state["0"]["q"] * signs, want_q, rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(state["0"]["e"], want_e, rtol=2e-4, atol=2e-4)
    # error feedback keeps the signal: M_hat + e == M + e_0
    torch.testing.assert_close(out + state["0"]["e"], grad + e0, rtol=1e-4,
                               atol=1e-5)


def test_conv_and_linear_compress_in_the_reference_layout(one_rank):
    """A conv weight's gradient goes through the compressor as HWIO
    reshaped [H, W*I*O], a Linear's as [in, out], and comes back in the
    torch layout."""
    from pytorch_distributed_tpu_torch.parallel import PowerSGD

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(4, 6, 3, bias=False)
            self.fc = torch.nn.Linear(20, 30)

    net = Net()
    hook = PowerSGD(rank=2, start_iter=0, min_compression_rate=0.5)
    state = hook.init(net)
    assert state["0"]["e"].shape == (3, 3 * 4 * 6)      # HWIO [3, 72]
    assert state["1"]["e"].shape == (20, 30)            # [in, out]
    grads = [torch.randn(p.shape) for p in net.parameters()]
    _, out = hook.apply(state, grads, one_rank, step=0)
    assert [o.shape for o in out] == [g.shape for g in grads]
    torch.testing.assert_close(out[2], grads[2])        # the bias: mean
    hwio = grads[0].permute(2, 3, 1, 0).reshape(3, -1)
    back = (out[0].permute(2, 3, 1, 0).reshape(3, -1)
            + state["0"]["e"])
    torch.testing.assert_close(back, hwio, rtol=1e-4, atol=1e-5)
