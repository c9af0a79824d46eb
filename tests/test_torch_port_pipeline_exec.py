"""The port's pipelined executor (``pipeline_exec``) on the CPU.

Mirrors ``tests/test_pipeline_exec.py``. On the CPU the runner runs its
step body eagerly at every ``submit``: ``Trainer.step`` over the static
input buffers, the metric-ring push and the loss-scaler write-back, after
a warm-up at ``start`` whose changes it puts back. So its per-step metrics,
final parameters, model buffers and optimizer state equal sequential
``Trainer.step`` calls bit for bit (a tiny GPT-2 under AdamW, a tiny
ResNet-18 under SGD with BatchNorm buffers, and GPT-2 with a loss scaler
whose scale moves during the run). Against the JAX ``AsyncRunner`` on the
same flax-drawn weights and batches (dense attention, fp32), the loss and
grad-norm histories agree at rtol 1e-5: the two frameworks sum in
another order (the bound of ``tests/test_torch_port_trainer.py``). A
restart keeps the built step only while every state tensor stays at its
address.
"""

import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_distributed_tpu.models.gpt2 import GPT2 as JaxGPT2
from pytorch_distributed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from pytorch_distributed_tpu.parallel import NoShard as JaxNoShard
from pytorch_distributed_tpu.pipeline_exec import AsyncRunner as JaxRunner
from pytorch_distributed_tpu.pipeline_exec import MetricRing as JaxRing
from pytorch_distributed_tpu.trainer import Trainer as JaxTrainer
from pytorch_distributed_tpu.trainer import lm_loss as jax_lm_loss
from pytorch_distributed_tpu_torch.amp import GradScaler, GradScalerState
from pytorch_distributed_tpu_torch.models import (
    GPT2,
    GPT2Config,
    gpt2_state_dict_from_flax,
    resnet18,
)
from pytorch_distributed_tpu_torch.parallel import NoShard
from pytorch_distributed_tpu_torch.pipeline_exec import (
    AsyncRunner,
    MetricHistory,
    MetricRing,
)
from pytorch_distributed_tpu_torch.trainer import (
    Trainer,
    classification_loss,
    lm_loss,
)

torch.set_num_threads(2)

TINY = dict(vocab_size=97, n_positions=32, n_embd=48, n_layer=2, n_head=4)
B, T, LR, WD = 4, 32, 1e-3, 0.01
N_STEPS = 7
JAX_TOL = dict(rtol=1e-5, atol=0)


def _lm_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, TINY["vocab_size"], (B, T + 1)).astype(np.int32)
        out.append((tok[:, :-1], tok[:, 1:]))
    return out


def _image_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((8, 16, 16, 3)).astype(np.float32),
             rng.integers(0, 10, 8).astype(np.int32)) for _ in range(n)]


def _gpt2(**kw):
    model = GPT2(GPT2Config(**TINY), device="cpu", seed=3)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD,
                            eps=1e-8)
    tr = Trainer(model, opt, NoShard("cpu"), loss_fn=lm_loss, clip_norm=1.0,
                 **kw)
    return tr, tr.init()


def _resnet():
    model = resnet18(10, cifar_stem=True, num_filters=8, device="cpu",
                     seed=4)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    tr = Trainer(model, opt, NoShard("cpu"), loss_fn=classification_loss)
    return tr, tr.init()


def _scaled():
    # growth every 2 finite steps: the scale moves during the run, so the
    # runner must write it back for the next step to read
    return _gpt2(scaler=GradScaler(init_scale=2.0**8, growth_interval=2))


CASES = {"gpt2_adamw": (_gpt2, _lm_batches),
         "resnet_sgd_bn": (_resnet, _image_batches),
         "gpt2_loss_scaler": (_scaled, _lm_batches)}


def _everything(trainer, state):
    """Every tensor a step changes, by name."""
    model, opt = trainer.model, trainer.optimizer
    out = {f"model.{k}": v for k, v in model.state_dict().items()}
    names = {p: n for n, p in model.named_parameters()}
    for p, st in opt.state.items():
        for k, v in st.items():
            out[f"opt.{names[p]}.{k}"] = v
    if state.scaler is not None:
        out["scale"] = state.scaler.scale
        out["growth_tracker"] = state.scaler.growth_tracker
    return {k: v.detach().clone() for k, v in out.items()}


def _sequential(make, batches):
    trainer, state = make()
    series = {}
    for batch in batches:
        state, m = trainer.step(state, batch)
        for k, v in m.items():
            series.setdefault(k, []).append(np.float32(v))
    return state, {k: np.array(v) for k, v in series.items()}, \
        _everything(trainer, state)


# -- the ring -----------------------------------------------------------------
@pytest.mark.parametrize("size,n_push", [(3, 5), (4, 4), (1, 3), (6, 2)])
def test_ring_matches_jax_ring(size, n_push):
    """Push/wrap and ``stacked`` row order against the JAX ring, with the
    same pushes (a bool is stored as 0/1)."""
    rng = np.random.default_rng(size * 10 + n_push)
    names = ["loss", "acc", "all_finite"]
    jring = JaxRing.create(names, size)
    ring = MetricRing.create(names, size, "cpu")
    for _ in range(n_push):
        vals = rng.standard_normal(2).astype(np.float32)
        flag = bool(rng.integers(0, 2))
        jring = jring.push({"loss": jnp.float32(vals[0]),
                            "acc": jnp.float32(vals[1]),
                            "all_finite": jnp.bool_(flag)})
        ring.push({"loss": torch.tensor(vals[0]), "acc": torch.tensor(vals[1]),
                   "all_finite": torch.tensor(flag)})
    assert ring.names == tuple(jring.names) == ("acc", "all_finite", "loss")
    assert int(ring.idx) == int(jring.idx) == n_push
    snap = ring.stacked()
    np.testing.assert_array_equal(snap.numpy(), np.asarray(jring.stacked()))
    assert snap.data_ptr() != ring.buf.data_ptr()


def test_ring_validates():
    with pytest.raises(ValueError):
        MetricRing.create(["loss"], 0)
    with pytest.raises(ValueError):
        MetricRing.create([], 4)


# -- pipelined == sequential ---------------------------------------------------
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("depth,drain_every", [(1, 7), (2, 3), (3, 4)])
def test_runner_bit_exact_with_sequential_steps(case, depth, drain_every):
    """Metrics, parameters, buffers, optimizer and scaler state equal
    sequential ``Trainer.step`` calls bit for bit, with a ``drain_every``
    that divides the step count and ones that leave a tail."""
    make, data = CASES[case]
    batches = data(N_STEPS, seed=1)
    seq_state, seq_series, seq_all = _sequential(make, batches)
    trainer, state = make()
    runner = AsyncRunner(trainer, depth=depth, drain_every=drain_every)
    runner.start(state, batches[0])
    for batch in batches:
        runner.submit(batch)
    assert runner.dispatch_count == N_STEPS
    assert len(runner._drains) == N_STEPS // drain_every
    state, hist = runner.finish()
    assert hist.n_steps == N_STEPS and state.step == seq_state.step
    # the runner's span rows (observability.spans) beside the step's own
    spans = {k for k in hist.keys() if k.startswith("span_ms.")}
    assert {"span_ms.forward", "span_ms.update"} <= spans
    assert set(hist.keys()) - spans == set(seq_series)
    for k, want in seq_series.items():
        np.testing.assert_array_equal(hist[k], want, err_msg=k)
    got = _everything(trainer, state)
    assert set(got) == set(seq_all)
    for k, want in seq_all.items():
        assert torch.equal(got[k], want), k
    if case == "gpt2_loss_scaler":
        assert len(set(hist["loss_scale"].tolist())) > 1


def test_trainer_run_facade_and_restart():
    """``Trainer.run`` drives the runner: the same history as sequential
    steps; a second run on the returned state continues the same
    trajectory, keeping the built step, which a new learning rate
    rebuilds."""
    batches = _lm_batches(6, seed=2)
    _, seq, _ = _sequential(_gpt2, batches)
    trainer, state = _gpt2()
    state, h1 = trainer.run(state, batches[:4], depth=2, drain_every=3)
    runner = AsyncRunner(trainer, depth=2, drain_every=3)
    state, h2 = runner.run(state, batches[4:])
    program = runner._program
    assert program is not None
    np.testing.assert_array_equal(
        np.concatenate([h1["loss"], h2["loss"]]), seq["loss"])
    assert h1.first("loss") == seq["loss"][0]
    assert h2.last("loss") == seq["loss"][-1]
    assert state.step == 6
    state, _ = runner.run(state, batches[:1])
    assert runner._program is program   # same shapes and state: no rebuild
    trainer.optimizer.param_groups[0]["lr"] = LR / 2
    runner.run(state, batches[:1])
    assert runner._program is not program   # the step holds the old lr


@pytest.mark.parametrize("move", ["none", "optimizer_state", "parameter",
                                  "scaler"])
def test_moved_state_rebuilds_the_step(move):
    """The built step reads and writes the state tensors at their
    addresses: a restart keeps it while every tensor stays where it was,
    and rebuilds it once one moved (an optimizer checkpoint loaded, a
    parameter given new storage, a new loss-scaler state); the history
    still equals sequential steps."""
    batches = _lm_batches(4, seed=5)
    _, seq, want = _sequential(_scaled, batches)
    trainer, state = _scaled()
    runner = AsyncRunner(trainer, depth=2, drain_every=2)
    state, h1 = runner.run(state, batches[:2])
    program = runner._program
    if move == "optimizer_state":
        opt = trainer.optimizer
        opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    elif move == "parameter":
        p = next(trainer.model.parameters())
        p.data = p.data.clone()
    elif move == "scaler":
        state = state.replace(scaler=GradScalerState(
            state.scaler.scale.clone(), state.scaler.growth_tracker.clone()))
    state, h2 = runner.run(state, batches[2:])
    assert (runner._program is program) == (move == "none")
    np.testing.assert_array_equal(
        np.concatenate([h1["loss"], h2["loss"]]), seq["loss"])
    got = _everything(trainer, state)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_snapshot_restores_the_tensors_the_optimizer_steps_on():
    """Under ZeRO1 the optimizer steps on blocks of the parameters that
    are not ``model.parameters()`` (``sharded_update.ShardedParams``): the
    runner's snapshot holds them beside their state, so its warm-up is
    undone for them too (the runner under ZeRO1 on 4 ranks is in
    ``tests/test_torch_port_zero1_ranks.py``)."""
    from pytorch_distributed_tpu_torch.pipeline_exec.runner import (
        _snapshot,
        _step_tensors,
    )

    model = GPT2(GPT2Config(**TINY), device="cpu", seed=3)
    block = torch.zeros(5)
    opt = torch.optim.AdamW([*model.parameters(), block], lr=LR)
    trainer = Trainer(model, opt, NoShard("cpu"), loss_fn=lm_loss)
    state = trainer.init()
    assert any(t is block for t in _step_tensors(trainer, state))
    restore = _snapshot(trainer, state)
    with torch.no_grad():
        block.add_(1.0)
        opt.state[block]["exp_avg"].add_(1.0)
    restore()
    assert not block.any() and not opt.state[block]["exp_avg"].any()


def test_empty_stream():
    trainer, state = _gpt2()
    out_state, hist = trainer.run(state, [])
    assert out_state is state
    assert hist.n_steps == 0


# -- against the JAX runner ----------------------------------------------------
def test_history_matches_jax_runner(mesh8):
    """The port's runner against the JAX ``AsyncRunner`` from the same
    flax-drawn weights on the same batches: loss and grad-norm histories
    at rtol 1e-5 (dense attention, AdamW, clip 1.0)."""
    jmodel = JaxGPT2(JaxGPT2Config(**TINY))
    jtr = JaxTrainer(jmodel, optax.adamw(LR, weight_decay=WD),
                     JaxNoShard(mesh8), loss_fn=jax_lm_loss, clip_norm=1.0)
    batches = _lm_batches(5, seed=3)
    jstate = jtr.init(jax.random.key(0), batches[0])
    model = GPT2(GPT2Config(**TINY), device="cpu")
    model.load_state_dict(gpt2_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.params)))
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD,
                            eps=1e-8)
    tr = Trainer(model, opt, NoShard("cpu"), loss_fn=lm_loss, clip_norm=1.0)
    _, want = JaxRunner(jtr, depth=2, drain_every=2).run(jstate, batches)
    _, got = AsyncRunner(tr, depth=2, drain_every=2).run(tr.init(), batches)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], **JAX_TOL, err_msg=k)


# -- validation ------------------------------------------------------------
def test_depth_and_drain_validate():
    trainer, _ = _gpt2()
    with pytest.raises(ValueError, match="depth"):
        AsyncRunner(trainer, depth=0)
    with pytest.raises(ValueError, match="drain_every"):
        AsyncRunner(trainer, drain_every=0)


def test_submit_before_start_raises():
    runner = AsyncRunner(_gpt2()[0])
    with pytest.raises(RuntimeError, match="start"):
        runner.submit(_lm_batches(1)[0])
    with pytest.raises(RuntimeError, match="start"):
        runner.finish()


class _VectorMetricTrainer(Trainer):
    def step(self, state, batch):
        state, metrics = super().step(state, batch)
        return state, {**metrics, "per_example": metrics["loss"].expand(3)}


def test_non_scalar_metric_rejected_and_state_kept():
    """A metric that is not a 0-d tensor is refused at ``start``, and the
    warm-up step that found it leaves every tensor as it was."""
    base, _ = _gpt2()
    trainer = _VectorMetricTrainer(base.model, base.optimizer,
                                   NoShard("cpu"), loss_fn=lm_loss)
    state = trainer.init()
    before = _everything(trainer, state)
    with pytest.raises(ValueError, match="0-d"):
        AsyncRunner(trainer).start(state, _lm_batches(1)[0])
    after = _everything(trainer, state)
    assert all(torch.equal(after[k], v) for k, v in before.items())


def test_submit_rejects_other_shapes():
    trainer, state = _gpt2()
    runner = AsyncRunner(trainer).start(state, _lm_batches(1)[0])
    with pytest.raises(ValueError, match="shapes"):
        runner.submit(tuple(x[:2] for x in _lm_batches(1)[0]))


def test_metric_history_accessors():
    h = MetricHistory({"loss": np.array([3.0, 2.0, 1.0], np.float32)})
    assert "loss" in h and "acc" not in h
    assert list(h.keys()) == ["loss"]
    assert h.n_steps == 3
    assert h.first() == 3.0
    assert h.last() == 1.0


# -- the audit surface (the reference's executable_count, step_artifacts) --
def test_executable_count_one_over_same_shape_and_grows_on_a_new_shape():
    trainer, state = _gpt2()
    runner = AsyncRunner(trainer, depth=2, drain_every=4)
    assert runner.executable_count == 0
    batches = _lm_batches(4)
    runner.start(state, batches[0])
    for batch in batches:
        runner.submit(batch)
    assert runner.dispatch_count == 4
    assert runner.executable_count == 1
    state, _ = runner.finish()
    runner.start(state, batches[0])      # the same shapes: kept
    runner.submit(batches[0])
    assert runner.executable_count == 1
    state, _ = runner.finish()
    half = tuple(x[:2] for x in batches[1])
    runner.start(state, half)            # another batch shape: rebuilt
    runner.submit(half)
    assert runner.executable_count == 2
    runner.finish()


@pytest.mark.parametrize("via", ["runner", "trainer"])
def test_step_artifacts_leave_the_state_as_it_was(via):
    """``step_artifacts`` returns the step's Program and the collectives
    recorded when it was built, and runs no step on the state: every
    state tensor keeps its values and its address."""
    from pytorch_distributed_tpu_torch._graphs import Program
    from pytorch_distributed_tpu_torch.pipeline_exec.runner import (
        _named_step_tensors,
    )

    trainer, state = _scaled()
    batch = _lm_batches(1)[0]
    before = _everything(trainer, state)
    ptrs = [(p, t.data_ptr()) for p, t in _named_step_tensors(trainer, state)]
    if via == "runner":
        runner = AsyncRunner(trainer).start(state, batch)
        program, inventory = runner.step_artifacts(batch)
        assert runner.dispatch_count == 0
    else:
        program, inventory = trainer.step_artifacts(state, batch)
    assert isinstance(program, Program) and not program.captured
    assert inventory == []               # NoShard issues no collective
    after = _everything(trainer, state)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert [(p, t.data_ptr())
            for p, t in _named_step_tensors(trainer, state)] == ptrs
    assert {p.split(".")[0] for p, _ in ptrs} == {"param", "opt", "scaler"}
    # the body is the step: calling it steps the state once, in place
    program()
    stepped = _everything(trainer, state)
    assert any(not torch.equal(stepped[k], v) for k, v in before.items()
               if k.startswith("model."))
    assert [t.data_ptr() for _, t in _named_step_tensors(trainer, state)] \
        == [ptr for _, ptr in ptrs]
