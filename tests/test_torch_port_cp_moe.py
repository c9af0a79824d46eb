"""The port's context parallelism of the MoE GPT-2 (CP x MoE) against the
JAX package's, on 4 gloo ranks.

A tiny MoE GPT-2 (2 layers, 64 wide, 4 heads, vocab 64; block 1 routed
over E=4 experts, top-2, one routing group of the whole batch) with ring
flash attention over cp 4 under ``CPStrategy``, 3 AdamW steps on B=4,
T=32, from the weights flax drew, against the JAX ``Trainer`` with the
JAX recipe's ``CPStrategy`` on a 4-device ``cp`` mesh (Pallas in
interpret mode): the plain ring, and the zigzag ring (the attention
reorders q, k and v with ``zigzag_reorder`` and restores its output, on
both sides). CP's interface is global: every cp rank runs the MoE on the
whole batch, so its routes are the reference's global ones. Held: the
losses, ``moe_aux`` and grad norms at rtol 1e-5 on every rank, the step-1
gradients within 1e-4 of each tensor's largest element plus 1e-7 (fp32,
sums in another order), the same parameters on every rank after, and the
ring's hops counted as point-to-point sends.

JAX is imported inside the tests only: the ranks re-import this module.
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_ranks as ranks

torch.set_num_threads(2)

N = ranks.WORLD
TINY = dict(vocab_size=64, n_positions=32, n_embd=64, n_layer=2, n_head=4,
            moe_experts=4, moe_top_k=2)
LR, WD = 1e-3, 1e-4
STEPS = 3
RINGS = ("plain", "zigzag")


def _batches(n, B=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, TINY["vocab_size"], (B, 33)).astype(np.int32)
        out.append((tok[:, :-1], tok[:, 1:]))
    return out


def _port_attn(mesh, ring):
    from pytorch_distributed_tpu_torch.parallel import (
        make_ring_attention,
        zigzag_reorder,
        zigzag_restore,
    )

    attn = make_ring_attention(mesh, "cp", causal=True,
                               zigzag=ring == "zigzag")
    if ring == "plain":
        return attn

    def zigzag(q, k, v, causal=True):
        q, k, v = (zigzag_reorder(x, N) for x in (q, k, v))
        return zigzag_restore(attn(q, k, v, causal=causal), N)

    return zigzag


def _cp_rank(rank, store_dir, state_dict, batches):
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.parallel import CPStrategy, comm
    from pytorch_distributed_tpu_torch.trainer import Trainer, lm_loss

    mesh = init_device_mesh((N,), ("cp",))
    out = {}
    for ring in RINGS:
        model = GPT2(GPT2Config(attn_impl=_port_attn(mesh, ring), **TINY),
                     device="cpu", seed=rank)
        model.load_state_dict(state_dict)
        opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD,
                                eps=1e-8)
        trainer = Trainer(model, opt, CPStrategy(mesh), loss_fn=lm_loss)
        state = trainer.init()
        trace, grads = [], None
        for i, batch in enumerate(batches):
            comm.reset_counts()
            state, m = trainer.step(state, batch)
            trace.append([float(m[k]) for k in ("loss", "moe_aux",
                                                "grad_norm")])
            if i == 0:
                grads = {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}
        out[ring] = {"trace": trace, "grads": grads, "counts":
                     dict(comm.counts),
                     "params": {n: p.detach().clone()
                                for n, p in model.named_parameters()}}
    torch.save(out, f"{store_dir}/rank{rank}.pt")


def _jax_run(ring, batches, params=None):
    """The JAX CPStrategy trainer's per-step (loss, moe_aux, grad_norm),
    step-1 gradients (the port's layout) and initial parameters."""
    import jax
    import optax

    from pytorch_distributed_tpu.mesh import init_device_mesh
    from pytorch_distributed_tpu.models import GPT2 as JaxGPT2
    from pytorch_distributed_tpu.models import GPT2Config as JaxGPT2Config
    from pytorch_distributed_tpu.parallel import DataParallel as JaxDP
    from pytorch_distributed_tpu.parallel.context_parallel import (
        make_ring_attention,
        zigzag_reorder,
        zigzag_restore,
    )
    from pytorch_distributed_tpu.trainer import Trainer as JaxTrainer
    from pytorch_distributed_tpu.trainer import lm_loss as jax_lm_loss
    from pytorch_distributed_tpu_torch.models import gpt2_state_dict_from_flax

    class JaxCPStrategy(JaxDP):
        def __init__(self, mesh):
            super().__init__(mesh, "cp")
            self.batch_axes = None  # replicate the batch; cp splits T

    mesh = init_device_mesh((N,), ("cp",), devices=jax.devices()[:N])
    attn = make_ring_attention(mesh, "cp", causal=True,
                               zigzag=ring == "zigzag")
    if ring == "zigzag":
        ring_attn = attn

        def attn(q, k, v, causal=True):
            q, k, v = (zigzag_reorder(x, N) for x in (q, k, v))
            return zigzag_restore(ring_attn(q, k, v, causal=causal), N)

    trainer = JaxTrainer(JaxGPT2(JaxGPT2Config(attn_impl=attn, **TINY)),
                         optax.adamw(LR, weight_decay=WD),
                         JaxCPStrategy(mesh), loss_fn=jax_lm_loss)
    state = trainer.init(jax.random.key(0), batches[0])
    if params is not None:
        state = state.replace(params=jax.tree_util.tree_map(
            lambda p, s: jax.device_put(p, s.sharding), params,
            state.params))
    first = jax.tree_util.tree_map(np.asarray, state.params)

    def loss_of(p):
        return jax_lm_loss(trainer.model, {"params": p}, batches[0], True)[0]

    grads = gpt2_state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss_of)(state.params)))
    trace = []
    for batch in batches:
        state, m = trainer.step(state, batch)
        trace.append([float(m[k]) for k in ("loss", "moe_aux", "grad_norm")])
    return trace, grads, first


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from pytorch_distributed_tpu_torch.models import gpt2_state_dict_from_flax

    tmp = tmp_path_factory.mktemp("cp_moe")
    batches = _batches(STEPS)
    want = {"plain": _jax_run("plain", batches)}
    params = want["plain"][2]
    ctx = ranks.start(_cp_rank, tmp, gpt2_state_dict_from_flax(params),
                      batches)
    want["zigzag"] = _jax_run("zigzag", batches, params)
    ranks.finish(ctx, timeout=180)
    got = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(N)]
    return got, want


@pytest.mark.parametrize("ring", RINGS)
def test_losses_aux_and_norms_match_jax(runs, ring):
    got, want = runs
    for res in got:
        np.testing.assert_allclose(res[ring]["trace"], want[ring][0],
                                   rtol=1e-5, atol=0)


@pytest.mark.parametrize("ring", RINGS)
def test_step1_gradients_match_jax(runs, ring):
    got, want = runs
    for res in got:
        for name, w in want[ring][1].items():
            w = w.numpy()
            err = np.abs(res[ring]["grads"][name].numpy() - w).max()
            assert err <= 1e-4 * np.abs(w).max() + 1e-7, (name, err)


@pytest.mark.parametrize("ring", RINGS)
def test_same_parameters_everywhere_and_the_hops(runs, ring):
    got, _ = runs
    for res in got:
        for name, p in res[ring]["params"].items():
            assert torch.equal(p, got[0][ring]["params"][name]), name
        # per layer and step, K and V each a send a hop: the forward's
        # N - 1 hops, the backward's N - 1, and dK and dV's N (home after N)
        L = TINY["n_layer"]
        assert res[ring]["counts"]["send"] == L * 2 * (3 * N - 2)
        assert res[ring]["counts"]["recv"] == L * 2 * (3 * N - 2)


def test_zigzag_and_plain_rings_agree(runs):
    got, _ = runs
    np.testing.assert_allclose(got[0]["zigzag"]["trace"],
                               got[0]["plain"]["trace"], rtol=1e-5, atol=0)
