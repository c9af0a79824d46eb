"""The port's context-parallel and data-parallel training on 4 gloo ranks.

* The slice as a whole: a tiny GPT-2 (2 layers, 32 wide, 4 heads, T=32,
  vocab 64) with ring flash attention (``make_ring_attention``) under
  ``CPStrategy``, 3 AdamW steps on 4 ranks, against the JAX ``Trainer``
  with ``CPStrategy`` on a 4-device ``cp`` mesh (the recipe of
  ``tests/test_context_parallel.py``; Pallas in interpret mode). The JAX
  weights are copied through ``models.convert``. Losses agree within 1e-5
  relative, step-1 gradients within 1e-4 of each tensor's largest element
  plus 1e-7 (fp32, sums in another order), and every rank ends with the
  same parameters.
* ``DataParallel`` with the batch split over 4 ranks against ``NoShard``
  on the whole batch, only rank 0 given the weights (``Trainer.init``
  broadcasts them): the mean of the ranks' losses, the averaged
  gradients and the parameters after 2 clipped AdamW steps are those of
  the whole batch.

JAX is imported inside the tests only: the ranks re-import this module.
"""

import numpy as np
import torch

from tests import _torch_port_ranks as ranks

torch.set_num_threads(2)

N = ranks.WORLD
TINY = dict(vocab_size=64, n_positions=32, n_embd=32, n_layer=2, n_head=4)
LR, WD = 1e-3, 1e-4   # optax.adamw's default weight decay
STEPS = 3


def _batches(n, B, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, TINY["vocab_size"], (B, 33)).astype(np.int32)
        out.append((tok[:, :-1], tok[:, 1:]))
    return out


def _assert_grads_close(got, want):
    """Each tensor within 1e-4 of its largest element plus 1e-7."""
    for name, w in want.items():
        w = np.asarray(w)
        err = np.abs(np.asarray(got[name]) - w).max()
        assert err <= 1e-4 * np.abs(w).max() + 1e-7, (name, err)


def _port_trainer(rank, strategy, state_dict, attn_impl=None,
                  clip_norm=None):
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.trainer import Trainer, lm_loss

    # a seed per rank; ranks given no state keep theirs until init()
    # broadcasts the first rank's parameters
    model = GPT2(GPT2Config(attn_impl=attn_impl, **TINY), device="cpu",
                 seed=rank)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD,
                            eps=1e-8)
    trainer = Trainer(model, opt, strategy, loss_fn=lm_loss,
                      clip_norm=clip_norm)
    return trainer, trainer.init()


def _steps(trainer, state, batches):
    """Per-step (loss, grad_norm), the step-1 gradients and the final
    parameters."""
    trace, grads = [], None
    for batch in batches:
        state, m = trainer.step(state, batch)
        trace.append((float(m["loss"]), float(m["grad_norm"])))
        if grads is None:
            grads = {n: p.grad.detach().clone()
                     for n, p in trainer.model.named_parameters()}
    params = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    return {"trace": trace, "grads": grads, "params": params}


# -- rank bodies (run in the spawned processes) ----------------------------
def _cp_rank(rank, store_dir, state_dict, batches):
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.parallel import (
        CPStrategy,
        make_ring_attention,
    )

    mesh = init_device_mesh((N,), ("cp",))
    trainer, state = _port_trainer(
        rank, CPStrategy(mesh), state_dict,
        make_ring_attention(mesh, "cp", causal=True))
    torch.save(_steps(trainer, state, batches), f"{store_dir}/rank{rank}.pt")


def _dp_rank(rank, store_dir, state_dict, batches):
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.parallel import DataParallel

    mesh = init_device_mesh((N,), ("dp",))
    strategy = DataParallel(mesh, "dp")
    assert strategy.data_shard_count == N
    trainer, state = _port_trainer(rank, strategy,
                                   state_dict if rank == 0 else None,
                                   clip_norm=1.0)
    torch.save(_steps(trainer, state, batches), f"{store_dir}/rank{rank}.pt")


def _load(store_dir):
    return [torch.load(store_dir / f"rank{r}.pt", weights_only=False)
            for r in range(N)]


def _assert_same_params_everywhere(results):
    for r, res in enumerate(results):
        for name, p in res["params"].items():
            assert torch.equal(p, results[0]["params"][name]), (r, name)


# -- tests -----------------------------------------------------------------
def test_gpt2_cp_trainer_matches_jax(tmp_path):
    import jax
    import optax

    from pytorch_distributed_tpu.mesh import init_device_mesh
    from pytorch_distributed_tpu.models import GPT2 as JaxGPT2
    from pytorch_distributed_tpu.models import GPT2Config as JaxGPT2Config
    from pytorch_distributed_tpu.parallel import DataParallel as JaxDP
    from pytorch_distributed_tpu.parallel.context_parallel import (
        make_ring_attention,
    )
    from pytorch_distributed_tpu.trainer import Trainer as JaxTrainer
    from pytorch_distributed_tpu.trainer import lm_loss as jax_lm_loss
    from pytorch_distributed_tpu_torch.models import gpt2_state_dict_from_flax

    class JaxCPStrategy(JaxDP):
        def __init__(self, mesh):
            super().__init__(mesh, "cp")
            self.batch_axes = None  # replicate the batch; cp splits T

    mesh = init_device_mesh((N,), ("cp",), devices=jax.devices()[:N])
    cfg = JaxGPT2Config(attn_impl=make_ring_attention(mesh, "cp", causal=True),
                        **TINY)
    trainer = JaxTrainer(JaxGPT2(cfg), optax.adamw(LR), JaxCPStrategy(mesh),
                         loss_fn=jax_lm_loss)
    batches = _batches(STEPS, 4, seed=0)
    state = trainer.init(jax.random.key(0), batches[0])
    params = jax.tree_util.tree_map(np.asarray, state.params)
    ctx = ranks.start(_cp_rank, tmp_path, gpt2_state_dict_from_flax(params),
                      batches)

    def loss_of(p):
        return jax_lm_loss(trainer.model, {"params": p}, batches[0], True)[0]

    want_grads = gpt2_state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss_of)(state.params)))
    want = []
    for batch in batches:
        state, m = trainer.step(state, batch)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    ranks.finish(ctx)
    results = _load(tmp_path)
    for res in results:
        np.testing.assert_allclose([t[0] for t in res["trace"]],
                                   [t[0] for t in want], rtol=1e-5, atol=0)
        np.testing.assert_allclose([t[1] for t in res["trace"]],
                                   [t[1] for t in want], rtol=1e-5, atol=0)
        _assert_grads_close({n: g.numpy() for n, g in res["grads"].items()},
                            {n: t.numpy() for n, t in want_grads.items()})
    _assert_same_params_everywhere(results)


def test_data_parallel_matches_noshard_on_the_whole_batch(tmp_path):
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.parallel import NoShard

    state_dict = GPT2(GPT2Config(**TINY), device="cpu", seed=3).state_dict()
    batches = _batches(2, 8, seed=1)          # 2 examples per rank
    ctx = ranks.start(_dp_rank, tmp_path, state_dict, batches)
    trainer, state = _port_trainer(0, NoShard("cpu"), state_dict,
                                   clip_norm=1.0)
    want = _steps(trainer, state, batches)
    ranks.finish(ctx)
    results = _load(tmp_path)
    for step, (loss, norm) in enumerate(want["trace"]):
        mean_loss = np.mean([res["trace"][step][0] for res in results])
        np.testing.assert_allclose(mean_loss, loss, rtol=1e-5)
        for res in results:
            np.testing.assert_allclose(res["trace"][step][1], norm, rtol=1e-5)
    for res in results:
        _assert_grads_close(res["grads"], want["grads"])
    _assert_same_params_everywhere(results)
    C = TINY["n_embd"]
    for name, p in results[0]["params"].items():
        p, w = p.clone(), want["params"][name].clone()
        if name.endswith("attn.c_attn.bias"):
            # the key bias: its gradient is rounding noise (a constant added
            # to every key leaves the softmax unchanged), which Adam scales
            # up to a share of lr in a direction the noise picks
            assert (p[C:2 * C] - w[C:2 * C]).abs().max() <= 2 * len(batches) * LR
            p[C:2 * C] = w[C:2 * C]
        torch.testing.assert_close(p, w, rtol=1e-4, atol=1e-5, msg=name)
