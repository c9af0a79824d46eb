"""The port's selective recomputation and dropout (A.9), on the CPU.

``remat_policy`` names a ``jax.checkpoint_policies`` policy that takes no
argument; the port maps each onto a selective checkpoint policy over aten
ops (``models.gpt2.REMAT_POLICIES``). Held here, on a tiny GPT-2 (dense,
and with an MoE block) in fp32:

* every policy's losses and gradients are bit for bit those of remat off
  (a recomputation reruns the same ops on the same inputs), with dropout
  on too (a block's masks are drawn before it runs and passed in);
* the bytes the forward leaves alive for the backward are ordered
  ``nothing <= dots_with_no_batch_dims <= dots <= everything``, all below
  remat off's or equal to it. They are counted by a dispatch mode that
  keeps a weak reference to every storage an op writes and sums those
  still alive after the forward: ``saved_tensors_hooks`` cannot see inside
  a non-reentrant checkpoint (its own hooks are the innermost), nor the
  outputs a selective policy caches;
* an unknown name (a policy factory that takes arguments) raises and
  lists the supported names; a policy without ``remat=True`` raises.

Dropout is held by its properties, not mask for mask against
``jax.random`` (another generator; ROADMAP C):

* off (rate 0), or in eval mode at any rate, the forward equals the JAX
  package's deterministic forward at rtol 1e-5;
* the keep share is within 5 sigma of ``1 - rate`` and a kept value is
  ``x / (1 - rate)`` in ``x``'s dtype, a dropped one 0;
* the same (seed, step) gives the same masks, another step or seed other
  ones; a resume from a checkpoint draws the masks of the run it resumes
  (losses bit for bit); another data shard's masks are other ones
  (``tests/test_torch_port_ep_ranks.py``, on ranks);
* the pipelined runner's steps equal the eager loop's bit for bit.
"""

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
from pytorch_distributed_tpu_torch.models.gpt2 import REMAT_POLICIES, _dropout
from pytorch_distributed_tpu_torch.parallel import NoShard
from pytorch_distributed_tpu_torch.trainer import Trainer, lm_loss

torch.set_num_threads(2)

TINY = dict(vocab_size=97, n_positions=32, n_embd=48, n_layer=2, n_head=4)
MOE = dict(moe_experts=4, moe_top_k=2)
B, T = 4, 32
ORDER = ("nothing_saveable", "dots_with_no_batch_dims_saveable",
         "dots_saveable", "everything_saveable")


def _batch(seed=0):
    tok = np.random.default_rng(seed).integers(0, 97, (B, T + 1))
    return torch.tensor(tok[:, :-1]), torch.tensor(tok[:, 1:])


def _loss_and_grads(policy, moe, dropout=0.0):
    cfg = GPT2Config(**TINY, **(MOE if moe else {}), dropout=dropout,
                     remat=policy is not None,
                     remat_policy=None if policy in (None, "full") else policy)
    model = GPT2(cfg, device="cpu", seed=3)
    model.train(True)
    loss, metrics = lm_loss(model, _batch(), True)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("policy", ["full"] + sorted(REMAT_POLICIES))
def test_policy_is_bit_for_bit_remat_off(policy, moe):
    want_loss, want = _loss_and_grads(None, moe)
    loss, grads = _loss_and_grads(policy, moe)
    assert torch.equal(loss, want_loss)
    for name, g in grads.items():
        assert torch.equal(g, want[name]), name


@pytest.mark.parametrize("policy", ["full", "dots_saveable"])
def test_policy_with_dropout_is_bit_for_bit_remat_off(policy):
    want_loss, want = _loss_and_grads(None, True, dropout=0.1)
    loss, grads = _loss_and_grads(policy, True, dropout=0.1)
    assert torch.equal(loss, want_loss)
    for name, g in grads.items():
        assert torch.equal(g, want[name]), name


class _LiveBytes(TorchDispatchMode):
    """Weak references to every storage an op writes."""

    def __init__(self):
        super().__init__()
        self.refs = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                ref = StorageWeakRef(st)
                old = self.refs.get(ref.cdata)   # a freed one's place reused
                if old is None or old[0].expired():
                    self.refs[ref.cdata] = (ref, st.nbytes())
        return out

    def alive(self) -> int:
        return sum(n for ref, n in self.refs.values() if not ref.expired())


def _held_bytes(policy, moe):
    cfg = GPT2Config(**TINY, **(MOE if moe else {}),
                     remat=policy is not None, remat_policy=policy)
    model = GPT2(cfg, device="cpu", seed=3)
    batch = _batch()
    mode = _LiveBytes()
    with mode:
        loss, _ = lm_loss(model, batch, True)
    held = mode.alive()
    loss.backward()
    return held


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_held_bytes_are_ordered(moe):
    held = [_held_bytes(p, moe) for p in ORDER]
    off = _held_bytes(None, moe)
    assert held == sorted(held), dict(zip(ORDER, held))
    assert held[0] < held[1] < held[2], dict(zip(ORDER, held))
    assert held[-1] <= off
    assert _held_bytes(None, moe) == off


@pytest.mark.parametrize("name", ["save_only_these_names",
                                  "offload_dot_with_no_batch_dims", "dots"])
def test_unknown_policy_raises_with_the_names(name):
    with pytest.raises(ValueError, match="everything_saveable"):
        GPT2(GPT2Config(**TINY, remat=True, remat_policy=name), device="cpu")
    with pytest.raises(ValueError, match="remat=False"):
        GPT2(GPT2Config(**TINY, remat_policy="dots_saveable"), device="cpu")


# -- dropout --------------------------------------------------------------
@pytest.mark.parametrize("rate,train", [(0.0, True), (0.1, False),
                                        (0.5, False)])
def test_off_or_eval_equals_jax_deterministic_forward(rate, train):
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_tpu.models.gpt2 import GPT2 as JaxGPT2
    from pytorch_distributed_tpu.models.gpt2 import GPT2Config as JaxConfig
    from pytorch_distributed_tpu_torch.models import gpt2_state_dict_from_flax

    x = _batch(4)[0]
    jm = JaxGPT2(JaxConfig(**TINY, **MOE, dropout=rate))
    params = jm.init(jax.random.key(0), jnp.asarray(x.numpy()))
    want, want_aux = jm.apply(params, jnp.asarray(x.numpy()),
                              deterministic=True)
    model = GPT2(GPT2Config(**TINY, **MOE, dropout=rate), device="cpu")
    model.load_state_dict(gpt2_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params["params"])))
    model.train(train)
    with torch.no_grad():
        got, aux = model(x)
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * scale)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_share_and_scaling(rate, dtype):
    model = GPT2(GPT2Config(**TINY, dropout=rate), device="cpu")
    model.train(True)
    shape = (8, 32, 48)
    keep = model._mask_drawer(shape)()
    n = keep.numel()
    share = keep.float().mean().item()
    assert abs(share - (1 - rate)) < 5 * np.sqrt(rate * (1 - rate) / n)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1)).to(
        dtype)
    y = _dropout(x, keep, rate)
    assert y.dtype == dtype
    assert torch.equal(y[keep], x[keep] / (1 - rate))
    assert (y[~keep] == 0).all()
    model.train(False)
    assert model._mask_drawer(shape)() is None


def _trainer(seed=0, rate=0.1, **kw):
    model = GPT2(GPT2Config(**TINY, dropout=rate), device="cpu", seed=2)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    return Trainer(model, opt, NoShard("cpu"), loss_fn=lm_loss, seed=seed,
                   **kw)


def test_masks_are_a_function_of_seed_and_step():
    def first_mask(tr, step):
        tr.seed_dropout(step)
        tr.model.train(True)
        return tr.model._mask_drawer((4, 32, 48))()

    a, b = _trainer(), _trainer()
    a.init(), b.init()
    assert torch.equal(first_mask(a, 3), first_mask(b, 3))
    assert not torch.equal(first_mask(a, 3), first_mask(a, 4))
    other = _trainer(seed=1)
    other.init()
    assert not torch.equal(first_mask(a, 3), first_mask(other, 3))


def _steps(tr, state, batches):
    losses = []
    for batch in batches:
        state, m = tr.step(state, batch)
        losses.append(m["loss"])
    return state, torch.stack(losses)


def test_resume_draws_the_same_masks():
    from pytorch_distributed_tpu_torch.checkpoint import (
        get_state_dict,
        set_state_dict,
    )

    batches = [_batch(s) for s in range(4)]
    tr = _trainer()
    state, first = _steps(tr, tr.init(), batches[:2])
    saved = {k: v.clone() for k, v in get_state_dict(tr, state).items()}
    _, want = _steps(tr, state, batches[2:])
    fresh = _trainer()
    fstate = set_state_dict(fresh, fresh.init(), saved)
    assert fstate.step == 2
    _, got = _steps(fresh, fstate, batches[2:])
    assert torch.equal(got, want)
    # dropout really acts: the same batch at another step, another loss
    assert not torch.equal(first[:1], _steps(_trainer(), state.replace(
        step=5), batches[:1])[1])


def test_runner_equals_the_eager_loop_with_dropout():
    batches = [_batch(s) for s in range(5)]
    eager = _trainer(grad_accum_steps=2)
    _, want = _steps(eager, eager.init(), batches)
    piped = _trainer(grad_accum_steps=2)
    state, hist = piped.run(piped.init(), batches)
    assert state.step == 5
    np.testing.assert_array_equal(hist["loss"], want.numpy())
    for p, q in zip(piped.model.parameters(), eager.model.parameters()):
        assert torch.equal(p, q)
