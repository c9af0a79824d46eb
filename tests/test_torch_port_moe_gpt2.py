"""The port's mixture-of-experts GPT-2 against the JAX package's, on the CPU.

A tiny MoE GPT-2 (2 layers, 48 wide, 4 heads, vocab 97, T=32; block 1 is
routed over E=4 experts, top-2) is built by flax and its weights copied
into the port. The JAX side runs the Pallas flash kernels in interpret
mode, the port the plain versions of its flash kernels.

* the forward: ``(logits, weighted aux)`` and ``return_hidden``'s
  ``(hidden, aux)`` at rtol 1e-5 of the largest value;
* 3 ``Trainer`` steps under ``NoShard`` and under one-rank FSDP, with the
  dense and the chunked loss, from flax's weights and optax's AdamW state
  after one JAX step (carried across): losses, ``moe_aux`` and grad norms
  at rtol 1e-5;
* the eval loss leaves the aux term out and reports it;
* the entry point with ``--moe-experts`` on the CPU, and its ``SystemExit``
  messages (the JAX script's);
* the serving engine's refusals of an MoE model, and ``TensorParallel``'s
  cut of one (the expert stacks whole, or on their expert dim over tp).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_distributed_tpu.models.gpt2 import GPT2 as JaxGPT2
from pytorch_distributed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from pytorch_distributed_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
)
from pytorch_distributed_tpu.parallel import NoShard as JaxNoShard
from pytorch_distributed_tpu.trainer import Trainer as JaxTrainer
from pytorch_distributed_tpu.trainer import lm_loss as jax_lm_loss
from pytorch_distributed_tpu.trainer import (
    make_chunked_lm_loss as jax_make_chunked_lm_loss,
)
from pytorch_distributed_tpu_torch.examples.train_gpt2 import main as train_main
from pytorch_distributed_tpu_torch.models import (
    GPT2,
    GPT2Config,
    gpt2_flax_from_state_dict,
    gpt2_state_dict_from_flax,
    load_adamw_state_from_optax,
)
from pytorch_distributed_tpu_torch.ops.flash_attention import flash_attention
from pytorch_distributed_tpu_torch.parallel import NoShard
from pytorch_distributed_tpu_torch.trainer import (
    Trainer,
    lm_loss,
    make_chunked_lm_loss,
)

torch.set_num_threads(2)

TINY = dict(vocab_size=97, n_positions=32, n_embd=48, n_layer=2, n_head=4,
            moe_experts=4, moe_top_k=2)
B, T, LR, WD = 4, 32, 1e-3, 0.01
RTOL = 1e-5


def _jax_attn(q, k, v, causal=True):
    return jax_flash(q, k, v, causal=causal, block_q=16, block_k=16,
                     interpret=True)


def _port_attn(q, k, v, causal=True):
    return flash_attention(q, k, v, causal=causal, block_q=16, block_k=16)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, TINY["vocab_size"], (B, T + 1)).astype(np.int32)
        out.append((tok[:, :-1], tok[:, 1:]))
    return out


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_model(params):
    model = GPT2(GPT2Config(attn_impl=_port_attn, **TINY), device="cpu")
    model.load_state_dict(gpt2_state_dict_from_flax(_np(params)))
    return model


@pytest.fixture(scope="module")
def jax_init():
    from pytorch_distributed_tpu.mesh import init_device_mesh

    mesh = init_device_mesh((8,), ("dp",))
    model = JaxGPT2(JaxGPT2Config(attn_impl=_jax_attn, **TINY))
    params = model.init(jax.random.key(0), jnp.asarray(_batches(1)[0][0]))
    return mesh, model, params


def test_model_tree_and_converter_round_trip(jax_init):
    _, _, params = jax_init
    model = _port_model(params["params"])
    assert hasattr(model.h[1], "moe") and not hasattr(model.h[1], "mlp")
    assert hasattr(model.h[0], "mlp") and not hasattr(model.h[0], "moe")
    assert model.h[1].moe.experts_up.shape == (4, 48, 192)
    back = gpt2_flax_from_state_dict(model.state_dict())
    flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            params["params"])[0]:
        np.testing.assert_array_equal(flat[path], np.asarray(leaf))
    assert len(flat) == len(jax.tree_util.tree_leaves(params["params"]))


def test_forward_and_hidden_match_jax(jax_init):
    _, jmodel, params = jax_init
    x = _batches(1, seed=3)[0][0]
    jlogits, jaux = jmodel.apply(params, jnp.asarray(x))
    jhidden, jaux_h = jmodel.apply(params, jnp.asarray(x), return_hidden=True)
    model = _port_model(params["params"])
    with torch.no_grad():
        logits, aux = model(torch.tensor(x))
        hidden, aux_h = model(torch.tensor(x), return_hidden=True)
    _close(logits.numpy(), jlogits)
    _close(hidden.numpy(), jhidden)
    _close(aux.item(), float(jaux))
    _close(aux_h.item(), float(jaux_h))
    assert logits.dtype == torch.float32 and aux.dtype == torch.float32


LOSSES = {"dense": (jax_lm_loss, lm_loss),
          "chunked": (jax_make_chunked_lm_loss(4), make_chunked_lm_loss(4))}
METRICS = ("loss", "moe_aux", "grad_norm")


@pytest.fixture(scope="module", params=sorted(LOSSES))
def carried(request, jax_init):
    """One JAX step, then 3 more: the JAX state after the first (params
    and AdamW state, carried into the port) and the per-step (loss,
    moe_aux, grad_norm) of the 3."""
    mesh, jmodel, params = jax_init
    jloss, ploss = LOSSES[request.param]
    jtr = JaxTrainer(jmodel, optax.adamw(LR, weight_decay=WD),
                     JaxNoShard(mesh), loss_fn=jloss, clip_norm=1.0)
    jstate = jtr.init(jax.random.key(0), _batches(1)[0])
    jstate = jstate.replace(params=jax.tree_util.tree_map(
        jnp.copy, params["params"]))   # the step donates its state
    jstate, _ = jtr.step(jstate, _batches(1, seed=8)[0])
    start = jax.tree_util.tree_map(np.asarray, jstate)
    want = []
    for batch in _batches(3, seed=1):
        jstate, m = jtr.step(jstate, batch)
        want.append([float(m[k]) for k in METRICS])
    return start, ploss, np.asarray(want)


def _port_steps(start, ploss, strategy):
    model = _port_model(start.params)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD,
                            eps=1e-8)
    tr = Trainer(model, opt, strategy, loss_fn=ploss, clip_norm=1.0)
    state = tr.init()
    adam = start.opt_state[0]
    load_adamw_state_from_optax(opt, model, adam.count, adam.mu, adam.nu,
                                tr.layout)
    got = []
    for batch in _batches(3, seed=1):
        state, m = tr.step(state, batch)
        got.append([float(m[k]) for k in METRICS])
    return np.asarray(got)


def test_three_steps_noshard_match_jax_trainer(carried):
    start, ploss, want = carried
    got = _port_steps(start, ploss, NoShard("cpu"))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert (got[:, 1] > 0).all()


def test_three_steps_one_rank_fsdp_match_jax_trainer(carried, tmp_path):
    from pytorch_distributed_tpu_torch import distributed as pdist
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.parallel import (
        FullyShardedDataParallel,
    )

    start, ploss, want = carried
    pdist.init_process_group(init_method=f"file://{tmp_path}/store", rank=0,
                             world_size=1, device="cpu")
    try:
        got = _port_steps(start, ploss, FullyShardedDataParallel(
            init_device_mesh((1,), ("fsdp",)), min_shard_size=8))
    finally:
        pdist.destroy_process_group()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_eval_loss_leaves_the_aux_term_out(jax_init):
    mesh, jmodel, params = jax_init
    jtr = JaxTrainer(jmodel, optax.adamw(LR), JaxNoShard(mesh),
                     loss_fn=jax_lm_loss)
    jstate = jtr.init(jax.random.key(0), _batches(1)[0])
    jstate = jstate.replace(params=jax.tree_util.tree_map(
        jnp.copy, params["params"]))   # the step donates its state
    batch = _batches(1, seed=5)[0]
    want = jtr.eval_step(jstate, batch)
    model = _port_model(params["params"])
    tr = Trainer(model, torch.optim.AdamW(model.parameters(), lr=LR),
                 NoShard("cpu"), loss_fn=lm_loss)
    got = tr.eval_step(tr.init(), batch)
    assert set(got) == {"loss", "perplexity", "moe_aux"} == set(want)
    for k in got:
        _close(float(got[k]), float(want[k]))
    # training adds the weighted aux term to the cross-entropy
    loss, metrics = lm_loss(model, tuple(torch.tensor(b) for b in batch),
                            True)
    assert float(loss) == pytest.approx(float(want["loss"])
                                        + float(metrics["moe_aux"]),
                                        rel=1e-6)


COMMON = ["--device", "cpu", "--layers", "2", "--embd", "48", "--heads", "4",
          "--seq-len", "32", "--vocab", "97", "--global-batch", "4",
          "--dataset-size", "8", "--log-every", "100"]


def test_entry_point_trains_moe_on_cpu():
    out = train_main(COMMON + ["--steps", "6", "--lr", "3e-3",
                               "--moe-experts", "4", "--moe-top-k", "2"])
    assert out["strategy"] == "FullyShardedDataParallel"
    assert len(out["losses"]) == len(out["moe_aux"]) == 6
    assert all(np.isfinite(out["losses"])) and min(out["moe_aux"]) > 0
    model = GPT2(GPT2Config(**{**TINY, "moe_top_k": 2}), device="cpu")
    assert out["n_params"] == sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("flags,message", [
    (["--moe-experts", "2", "--moe-top-k", "3"],
     "--moe-top-k 3 > --moe-experts 2"),
    (["--ep", "2"], r"--ep needs --moe-experts > 0 \(dense model\)"),
    (["--moe-experts", "4", "--ep", "2"], "--ep must divide the process "
                                          "count"),
])
def test_entry_point_moe_flag_rules(flags, message):
    with pytest.raises(SystemExit, match=message):
        train_main(COMMON + ["--steps", "1"] + flags)


def test_entry_point_rules_on_a_world_of_four():
    """The rules that need a world (``_check_moe`` reads the process
    count): experts must split over ep, dp must be 1 or world/ep."""
    from argparse import Namespace

    from pytorch_distributed_tpu_torch.examples.train_gpt2 import _check_moe

    def args(**kw):
        return Namespace(**{**dict(moe_experts=4, moe_top_k=2, ep=2, dp=1),
                            **kw})

    assert _check_moe(args(), 4) is True
    assert _check_moe(args(dp=2), 4) is True
    assert _check_moe(args(ep=1), 4) is False
    with pytest.raises(SystemExit, match="--moe-experts 6 must divide by "
                                         "--ep 4"):
        _check_moe(args(moe_experts=6, ep=4), 4)
    with pytest.raises(SystemExit, match="--dp 4 conflicts with the MoE "
                                         "mesh"):
        _check_moe(args(dp=4), 4)


def test_engine_and_tensor_parallel_refuse_moe():
    from pytorch_distributed_tpu_torch.parallel import (
        ColwiseParallel,
        ExpertParallel,
        TensorParallel,
        gpt2_tp_plan,
    )
    from pytorch_distributed_tpu_torch.parallel.expert import (
        EPContext,
        SequenceEPContext,
    )
    from pytorch_distributed_tpu_torch.serving import InferenceEngine
    from tests._torch_port_tp import StubMesh

    moe = GPT2(GPT2Config(**TINY), device="cpu")
    with pytest.raises(ValueError, match="serving supports dense GPT-2 only"):
        InferenceEngine(moe, device="cpu", n_slots=2)
    dense = GPT2(GPT2Config(**{**TINY, "moe_experts": 0}), device="cpu")
    with pytest.raises(ValueError, match="draft model must be dense"):
        InferenceEngine(dense, device="cpu", n_slots=2, spec_k=2,
                        draft_model=moe, draft_params=moe.state_dict())
    with pytest.raises(ValueError, match="dense GPT-2 only"):
        moe(torch.zeros(1, 4, dtype=torch.long), kv_cache=object())
    # TP x MoE (A.14b) is ported: TensorParallel cuts the MoE model as its
    # plan says, the expert stacks whole or on their expert dim
    E, C = TINY["moe_experts"], TINY["n_embd"]
    for plan, sp, e, ctx in (
            (gpt2_tp_plan(), False, E, None),
            ({r"moe\.experts_": ExpertParallel(), **gpt2_tp_plan()}, False,
             E // 2, EPContext),
            ({r"moe\.experts_": ExpertParallel(), **gpt2_tp_plan()}, True,
             E // 2, SequenceEPContext)):
        model = GPT2(GPT2Config(**TINY), device="cpu")
        tp = TensorParallel(StubMesh((1, 2), ("dp", "tp")), plan,
                            sequence_parallel=sp)
        cut = tp.parallelize(model)
        moe_layer = model.h[1].moe
        assert tuple(moe_layer.experts_up.shape) == (e, C, 4 * C)
        assert tuple(moe_layer.experts_down.shape) == (e, 4 * C, C)
        assert tuple(moe_layer.router.weight.shape) == (E, C)
        assert ("h.1.moe.experts_up" in cut) == (e < E)
        assert tuple(model.h[1].attn.c_attn.weight.shape) == (3 * C // 2, C)
        assert (type(moe_layer.ep) if ctx else moe_layer.ep) is ctx
    with pytest.raises(ValueError, match="router runs whole"):
        TensorParallel(StubMesh((1, 2), ("dp", "tp")),
                       {r"moe\.router": ColwiseParallel(),
                        **gpt2_tp_plan()}).parallelize(
            GPT2(GPT2Config(**TINY), device="cpu"))
