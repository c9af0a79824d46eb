"""The port's training slice against the JAX package's, on the CPU.

A tiny GPT-2 (2 layers, 48 wide, 4 heads, vocab 97, T=32, B=4) is built by
flax and its weights copied into the port (the two init RNGs differ). The
JAX ``Trainer`` runs it with the Pallas flash kernels in interpret mode,
``optax.adamw(1e-3, weight_decay=0.01)`` under ``NoShard``; the port's
``Trainer`` runs the plain versions of its flash kernels with
``torch.optim.AdamW(1e-3, weight_decay=0.01, eps=1e-8)``. Losses and grad
norms agree at rtol 1e-5 and the trained parameters at 1e-5 (fp32; sums are
taken in another order).

Adam's step is ill-conditioned where a gradient is near zero: it divides
by ``sqrt(v) + 1e-8``, so a gradient of 1e-9 that is rounding noise moves
the parameter by a sizable share of the learning rate in a direction the
noise picks, differently in each framework. The key part of each
``c_attn`` bias is such a case for every element (adding a constant to
every key of a row leaves its softmax unchanged, so that gradient is zero
in exact arithmetic), and a few other elements are by chance. So the 1e-5
comparison covers every element whose gradient stayed above 1e-6 at every
step; the others (held to be under 1% of all, plus the key biases) must
agree within the most Adam can move them, 2 x steps x lr.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_distributed_tpu.data import DistributedSampler as JaxSampler
from pytorch_distributed_tpu.data import SyntheticLMDataset as JaxLMDataset
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
from pytorch_distributed_tpu_torch.amp import GradScaler, get_policy
from pytorch_distributed_tpu_torch.data import (
    DistributedSampler,
    SyntheticLMDataset,
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

TINY = dict(vocab_size=97, n_positions=32, n_embd=48, n_layer=2, n_head=4)
B, T, LR, WD = 4, 32, 1e-3, 0.01
TRACE_TOL = dict(rtol=1e-5, atol=0)
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_attn(q, k, v, causal=True):
    return jax_flash(q, k, v, causal=causal, block_q=16, block_k=16,
                     interpret=True)


def _port_attn(q, k, v, causal=True):
    return flash_attention(q, k, v, causal=causal, block_q=16, block_k=16)


def _batches(n, seed=0, mask=None):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, TINY["vocab_size"], (B, T + 1)).astype(np.int32)
        batch = (tok[:, :-1], tok[:, 1:])
        out.append(batch if mask is None else batch + (mask,))
    return out


def _jax_trainer(mesh, loss_fn=jax_lm_loss, **kw):
    model = JaxGPT2(JaxGPT2Config(attn_impl=_jax_attn, **TINY))
    tr = JaxTrainer(model, optax.adamw(LR, weight_decay=WD), JaxNoShard(mesh),
                    loss_fn=loss_fn, clip_norm=1.0, **kw)
    state = tr.init(jax.random.key(0), _batches(1)[0][:2])
    return tr, state


def _port_trainer(jax_params, loss_fn=lm_loss, attn=_port_attn, **kw):
    model = GPT2(GPT2Config(attn_impl=attn, **TINY), device="cpu")
    model.load_state_dict(gpt2_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jax_params)))
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD,
                            eps=1e-8)
    tr = Trainer(model, opt, NoShard("cpu"), loss_fn=loss_fn, clip_norm=1.0,
                 **kw)
    return tr, tr.init()


NOISE_FLOOR = 1e-6


def _run(trainer, state, batches):
    """Steps, the (loss, grad_norm) trace and, for the port, which grad
    elements fell below the noise floor at some step."""
    trace = []
    small = {}
    for batch in batches:
        state, m = trainer.step(state, batch)
        trace.append((float(m["loss"]), float(m["grad_norm"])))
        if isinstance(trainer, Trainer):
            for n, p in trainer.model.named_parameters():
                tiny = (p.grad.abs() < NOISE_FLOOR).float()
                small[n] = torch.maximum(small.get(n, tiny), tiny)
    return state, np.asarray(trace), small


def _assert_params(jax_params, model, small, steps):
    """Final params at 1e-5 where Adam is well-conditioned (see the module
    docstring), within 2 x steps x lr elsewhere."""
    got = gpt2_flax_from_state_dict(model.state_dict())
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_small = dict(jax.tree_util.tree_flatten_with_path(
        gpt2_flax_from_state_dict(small))[0])
    C = TINY["n_embd"]
    n_small = n_all = 0
    for path, w in jax.tree_util.tree_flatten_with_path(jax_params)[0]:
        g, w = flat_got[path], np.asarray(w)
        ill = flat_small[path] > 0.5
        name = jax.tree_util.keystr(path)
        np.testing.assert_allclose(g[~ill], w[~ill], **PARAM_TOL, err_msg=name)
        assert np.abs(g[ill] - w[ill]).max(initial=0) <= 2 * steps * LR, name
        if name.endswith("['c_attn']['bias']"):
            assert ill[C:2 * C].all(), name  # the key bias
            ill[C:2 * C] = False
        n_small += int(ill.sum())
        n_all += ill.size
    assert n_small <= 1e-2 * n_all, (n_small, n_all)


@pytest.fixture(scope="module")
def three_steps():
    from pytorch_distributed_tpu.mesh import init_device_mesh

    mesh = init_device_mesh((8,), ("dp",))
    jtr, jstate = _jax_trainer(mesh)
    ttr, tstate = _port_trainer(jstate.params)
    batches = _batches(3, seed=1)
    jstate, jtrace, _ = _run(jtr, jstate, batches)
    tstate, ttrace, small = _run(ttr, tstate, batches)
    return mesh, jstate, jtrace, ttr, tstate, ttrace, small


def test_three_steps_match_jax_trainer(three_steps):
    """The whole slice: loss and grad-norm traces and the final params."""
    _, jstate, jtrace, ttr, tstate, ttrace, small = three_steps
    np.testing.assert_allclose(ttrace, jtrace, **TRACE_TOL)
    assert tstate.step == int(jstate.step) == 3
    _assert_params(jstate.params, ttr.model, small, 3)


def test_adamw_state_carries_from_optax(three_steps):
    """One step from JAX's trained params and converted optax state matches
    JAX's own next step."""
    mesh, jstate, _, _, _, _, small = three_steps
    jstate = jax.tree_util.tree_map(jnp.copy, jstate)  # the step donates it
    jtr, _ = _jax_trainer(mesh)
    adam = jstate.opt_state[0]
    ttr, tstate = _port_trainer(jstate.params)
    load_adamw_state_from_optax(
        ttr.optimizer, ttr.model, np.asarray(adam.count),
        jax.tree_util.tree_map(np.asarray, adam.mu),
        jax.tree_util.tree_map(np.asarray, adam.nu))
    batch = _batches(1, seed=9)
    jstate, jtrace, _ = _run(jtr, jstate, batch)
    _, ttrace, small_now = _run(ttr, tstate, batch)
    np.testing.assert_allclose(ttrace, jtrace, **TRACE_TOL)
    _assert_params(jstate.params, ttr.model,
                   {n: torch.maximum(small[n], small_now[n]) for n in small}, 4)
    st = ttr.optimizer.state[ttr.model.wte]
    assert float(st["step"]) == int(jstate.opt_state[0].count) == 4


def test_chunked_loss_and_masked_batch_match_jax(mesh8):
    """The vocab-chunked CE (4 chunks) on a batch with a per-token mask
    (an uneven tail), and the dense loss on a per-example mask."""
    rng = np.random.default_rng(4)
    tok_mask = (rng.random((B, T)) < 0.7).astype(np.float32)
    ex_mask = np.array([1, 1, 0, 1], np.float32)
    for jax_loss, port_loss, mask in (
            (jax_make_chunked_lm_loss(4), make_chunked_lm_loss(4), tok_mask),
            (jax_lm_loss, lm_loss, ex_mask)):
        jtr, jstate = _jax_trainer(mesh8, loss_fn=jax_loss)
        ttr, tstate = _port_trainer(jstate.params, loss_fn=port_loss)
        batches = _batches(2, seed=5, mask=mask)
        jstate, jtrace, _ = _run(jtr, jstate, batches)
        _, ttrace, small = _run(ttr, tstate, batches)
        np.testing.assert_allclose(ttrace, jtrace, **TRACE_TOL)
        _assert_params(jstate.params, ttr.model, small, 2)


def _fresh_port(seed=0, **cfg):
    model = GPT2(GPT2Config(attn_impl=_port_attn, **{**TINY, **cfg}),
                 device="cpu", seed=seed)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD,
                            eps=1e-8)
    return model, opt


def test_grad_accumulation_equals_one_full_batch():
    """accum=2 takes the mean of two half-batch grads: the same step as one
    full batch (the LM loss is a per-token mean over equal halves)."""
    batch = _batches(1, seed=6)[0]
    runs = []
    for accum in (1, 2):
        model, opt = _fresh_port()
        tr = Trainer(model, opt, NoShard("cpu"), loss_fn=lm_loss,
                     grad_accum_steps=accum, clip_norm=1.0)
        _, m = tr.step(tr.init(), batch)
        runs.append((m, {k: v.detach().clone()
                         for k, v in model.state_dict().items()}))
    (m1, p1), (m2, p2) = runs
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=1e-6, atol=0)
    torch.testing.assert_close(m2["grad_norm"], m1["grad_norm"], rtol=1e-5,
                               atol=0)
    for k in p1:
        torch.testing.assert_close(p2[k], p1[k], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        tr.step(tr.init(), tuple(x[:3] for x in batch))


def test_remat_recomputes_the_same_gradients():
    batch = tuple(torch.from_numpy(x) for x in _batches(1, seed=7)[0])
    grads = []
    for remat in (False, True):
        model, _ = _fresh_port(remat=remat)
        loss, _ = lm_loss(model, batch, True)
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=0, atol=0)


def test_fp16_scaler_skips_an_inf_step():
    """An overflowing loss scale: the step keeps params and AdamW state,
    the scale halves and the growth counter resets; the next (finite) step
    moves the params. Nothing in the step reads the flag back."""
    model, opt = _fresh_port()
    scaler = GradScaler(init_scale=2.0**127)
    tr = Trainer(model, opt, NoShard("cpu"), loss_fn=lm_loss, policy="fp16",
                 scaler=scaler, clip_norm=1.0)
    state = tr.init()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _batches(1, seed=8)[0]
    state, m = tr.step(state, batch)
    assert not bool(m["all_finite"])
    assert float(m["loss_scale"]) == 2.0**127
    assert float(state.scaler.scale) == 2.0**126
    assert int(state.scaler.growth_tracker) == 0
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    st = opt.state[model.wte]
    assert float(st["step"]) == 0 and not st["exp_avg"].any()

    state = state.replace(scaler=scaler.init().__class__(
        scale=torch.tensor(2.0**10), growth_tracker=state.scaler.growth_tracker))
    state, m = tr.step(state, batch)
    assert bool(m["all_finite"]) and int(state.scaler.growth_tracker) == 1
    assert float(opt.state[model.wte]["step"]) == 1
    assert not torch.equal(model.wte, before["wte"])


def test_grad_scaler_matches_torch_constants_and_state_machine():
    ts = torch.amp.GradScaler("cpu", enabled=True)
    ours = GradScaler()
    assert (ours.init_scale, ours.growth_factor, ours.backoff_factor,
            ours.growth_interval) == (ts._init_scale, ts._growth_factor,
                                      ts._backoff_factor, ts._growth_interval)
    sc = GradScaler(init_scale=4.0, growth_interval=2)
    st = sc.init()
    yes, no = torch.tensor(True), torch.tensor(False)
    for flag, want in ((yes, 4.0), (yes, 8.0), (no, 4.0), (yes, 4.0),
                       (yes, 8.0)):
        st = sc.update(st, flag)
        assert float(st.scale) == want
    grads, finite = sc.unscale([torch.ones(2), torch.tensor([1.0, np.inf])], st)
    assert not bool(finite) and float(grads[0][0]) == 1.0 / 8.0
    assert get_policy("fp16").needs_loss_scaling
    assert not get_policy("bf16").needs_loss_scaling
    assert get_policy("bf16").cast_to_compute(
        (torch.zeros(2), torch.zeros(2, dtype=torch.int32))
    )[0].dtype == torch.bfloat16


def test_config_and_trainer_options_not_ported_raise():
    with pytest.raises(ValueError, match="remat=False"):
        GPT2(GPT2Config(remat_policy="dots_saveable", **TINY), device="cpu")
    # A.9's selective remat and dropout and A.14's MoE blocks are ported:
    # each builds and takes a training step
    for kw in (dict(remat=True, remat_policy="dots_saveable"),
               dict(dropout=0.1), dict(moe_experts=4, moe_top_k=2)):
        m = GPT2(GPT2Config(**{**TINY, **kw}), device="cpu")
        o = torch.optim.AdamW(m.parameters(), lr=LR)
        t = Trainer(m, o, NoShard("cpu"), loss_fn=lm_loss)
        _, metrics = t.step(t.init(), _batches(1)[0])
        assert np.isfinite(float(metrics["loss"]))
        assert ("moe_aux" in metrics) == ("moe_experts" in kw)
    model, opt = _fresh_port()
    # gradient hooks are ported; as in the reference, DataParallel only
    with pytest.raises(ValueError, match="dp_axis"):
        Trainer(model, opt, NoShard("cpu"), comm_hook="bf16_compress")
    tr = Trainer(model, opt, NoShard("cpu"), loss_fn=lm_loss)
    # Trainer.run is ported (pipeline_exec.AsyncRunner): it runs now
    state, hist = tr.run(tr.init(), _batches(1))
    assert state.step == 1 and hist.n_steps == 1
    metrics = tr.eval_step(tr.init(), _batches(1)[0])
    assert set(metrics) == {"loss", "perplexity"}


def test_entry_point_trains_on_cpu(tmp_path):
    common = ["--device", "cpu", "--layers", "2", "--embd", "48", "--heads",
              "4", "--seq-len", "32", "--vocab", "97", "--global-batch", "4",
              "--dataset-size", "8", "--log-every", "100"]
    out = train_main(common + ["--steps", "6"])
    assert len(out["losses"]) == len(out["step_s"]) == 6
    assert out["tokens_per_step"] == 4 * 32 and out["attn"] == "flash"
    assert all(np.isfinite(out["losses"]))
    out = train_main(common + ["--steps", "2", "--chunked-loss", "4",
                               "--remat", "--attn", "dense"])
    assert len(out["losses"]) == 2
    # the entry point runs FSDP on a one-rank group: everything whole
    assert out["strategy"] == "FullyShardedDataParallel"
    assert out["world"] == 1 and out["mesh"] == {"dp": 1, "fsdp": 1}
    # --dp is ported (tests/test_torch_port_train_gpt2_ranks.py); it must
    # divide the process count, as in the JAX script
    with pytest.raises(SystemExit, match="--dp must divide"):
        train_main(common + ["--dp", "2"])
    # --moe-experts is ported: an MoE model trains, reporting moe_aux
    out = train_main(common + ["--steps", "2", "--moe-experts", "4"])
    assert len(out["losses"]) == len(out["moe_aux"]) == 2
    assert all(np.isfinite(out["losses"] + out["moe_aux"]))
    # --data-bin (ported): the windows of a token file; a repeating corpus
    # is learnt, and an id past --vocab is refused
    from pytorch_distributed_tpu_torch.data import write_token_bin

    corpus = tmp_path / "corpus.bin"
    write_token_bin(str(corpus), np.tile(np.arange(24), 40))
    out = train_main(common + ["--steps", "8", "--lr", "3e-3", "--data-bin",
                               str(corpus)])
    assert out["data"] == str(corpus)
    assert out["losses"][-1] < out["losses"][0] - 0.5
    with pytest.raises(ValueError, match="vocab_size"):
        train_main(common[:-2] + ["--vocab", "16", "--steps", "1",
                                  "--data-bin", str(corpus)])


@pytest.mark.parametrize("strategy", ["fsdp", "zero1", "zero1_state",
                                      "hybrid"])
def test_sharded_route_on_one_rank_equals_noshard(tmp_path, strategy):
    """On a one-rank group the rule keeps every parameter whole
    (``trivial_axis``), and the sharded route of the step (the update
    layout's all-reduces, the norm and finite flag reduced over the group,
    the optimizer on the layout's tensors) gives NoShard's steps bit for
    bit, through a skipped fp16 step: the CPU side of the card's
    ``fsdp_train`` check."""
    from pytorch_distributed_tpu_torch import distributed as pdist
    from pytorch_distributed_tpu_torch.mesh import (
        init_device_mesh,
        init_hybrid_mesh,
    )
    from pytorch_distributed_tpu_torch.models import full_state_dict
    from pytorch_distributed_tpu_torch.parallel import (
        FullyShardedDataParallel,
        HybridShard,
        ZeRO1,
    )

    def run(make):
        model = GPT2(GPT2Config(**TINY), device="cpu", seed=2)
        opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD,
                                eps=1e-8)
        tr = Trainer(model, opt, make(), loss_fn=lm_loss, clip_norm=1.0,
                     scaler=GradScaler(init_scale=2.0**126))  # overflows
        state, trace = tr.init(), []
        for batch in _batches(3, seed=4):
            state, m = tr.step(state, batch)
            trace.append([float(m[k]) for k in ("loss", "grad_norm",
                                                "all_finite", "loss_scale")])
        return trace, full_state_dict(model), tr

    want, want_params, _ = run(lambda: NoShard("cpu"))
    assert want[0][2] == 0.0 and want[-1][2] == 1.0     # a skipped step
    pdist.init_process_group(init_method=f"file://{tmp_path}/store", rank=0,
                             world_size=1, device="cpu")
    try:
        makers = {
            "fsdp": lambda: FullyShardedDataParallel(
                init_device_mesh((1,), ("fsdp",)), min_shard_size=8),
            "zero1": lambda: ZeRO1(init_device_mesh((1,), ("dp",)),
                                   min_shard_size=8),
            "zero1_state": lambda: ZeRO1(init_device_mesh((1,), ("dp",)),
                                         min_shard_size=8,
                                         sharded_update=False),
            "hybrid": lambda: HybridShard(
                init_hybrid_mesh((1,), (1,), ("dcn", "fsdp")),
                min_shard_size=8),
        }
        got, got_params, tr = run(makers[strategy])
    finally:
        pdist.destroy_process_group()
    assert tr.layout is not None and not any(
        leaf.sharded for leaf in tr.layout.leaves)
    np.testing.assert_array_equal(got, want)    # NaN norms where skipped
    for name, p in want_params.items():
        assert torch.equal(got_params[name], p), name


def test_data_copies_match_the_jax_package():
    ours, theirs = SyntheticLMDataset(16, seq_len=8, seed=3), \
        JaxLMDataset(16, seq_len=8, seed=3)
    for i in (0, 5, 15):
        for a, b in zip(ours[i], theirs[i]):
            np.testing.assert_array_equal(a, b)
    for rank in (0, 1, 2):
        s1 = DistributedSampler(ours, 3, rank, seed=2)
        s2 = JaxSampler(theirs, 3, rank, seed=2)
        s1.set_epoch(1)
        s2.set_epoch(1)
        assert list(s1) == list(s2)
