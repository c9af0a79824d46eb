"""The port's GPipe across ranks and its pipelined GPT-2 trainer against
the JAX package's, on 4 gloo ranks.

The ranks (``tests/_torch_port_ranks.py``; rank bodies in
``tests/_torch_port_pipeline.py``, which import no JAX) run:

* ``gpipe_spmd`` at pp 4 on ``tests/test_pipeline.py``'s stacked tanh
  layers: the last stage's outputs against the JAX runner's
  ``stacked_out[-1]`` (rtol and atol 1e-5, the reference test's), the
  gradient of ``sum(out ** 2)`` through the ranks against ``jax.grad`` of
  the JAX runner (rtol 1e-4, atol 1e-5); the other stages return zeros;
  the links carry 4 activations and 4 gradients a link;
* ``GPT2Pipe`` under ``PipelineParallel`` in the ``Trainer`` at pp 4 and
  at (dp 2, pp 2), from the weights the JAX ``GPT2Pipe`` drew (converted
  from its stacked ``blocks`` tree), 4 AdamW steps against the JAX
  ``GPT2Pipe`` trainer on the same mesh shapes over 4 virtual CPU devices:
  the losses (the mean of the dp shards') at rtol 1e-5 (fp32), the grad
  norm at 1e-5 on step 1 and 1e-4 after (Adam's rounding-driven elements,
  as the EP and TP tests hold it); after them the replicated tables are
  bit for bit the same on every rank and a stage's layers on its dp
  replicas;
* the collectives of a step and the links' bytes against the design's;
* ``make_chunked_lm_loss(4)`` through ``return_hidden`` at pp 4 (the
  port's twin of ``tests/test_chunked_xent.py``'s pipelined test), against
  the JAX trainer's losses.

The refusals (MoE and ``n_layer`` not divisible, word for word the
reference's; the batch not divisible by the microbatches; the pp axis
not in the mesh) run in this process on a stand-in mesh, and the
Trainer's refusal of a model that is not a pipeline stage on the ranks.
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_pipeline as pph
from tests import _torch_port_ranks as ranks

torch.set_num_threads(2)

RTOL = 1e-5


def _jax_gpipe():
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_tpu.mesh import init_device_mesh
    from pytorch_distributed_tpu.parallel import gpipe_spmd

    ws, fwd, grad = (jnp.asarray(a) for a in pph.gpipe_inputs())
    mesh = init_device_mesh((4,), ("pp",), devices=jax.devices()[:4])

    def stage_fn(local_ws, x):
        def body(h, w):
            return jnp.tanh(h @ w), None

        return jax.lax.scan(body, x, local_ws)[0]

    run = gpipe_spmd(stage_fn, mesh, axis="pp")
    out = np.asarray(run(ws, fwd)[-1])
    g = np.asarray(jax.grad(lambda w: jnp.sum(run(w, grad)[-1] ** 2))(ws))
    return out, g


def _jax_pipe(shape, remat, cfg_kw, batch, loss_name="lm"):
    """The JAX GPT2Pipe trainer, initialised: its (numpy) parameters, and
    ``steps()``, which runs ``STEPS`` steps and returns their losses and
    grad norms."""
    import jax
    import optax

    from pytorch_distributed_tpu.mesh import init_device_mesh
    from pytorch_distributed_tpu.models import GPT2Config
    from pytorch_distributed_tpu.parallel import GPT2Pipe, PipelineParallel
    from pytorch_distributed_tpu.trainer import (
        Trainer,
        lm_loss,
        make_chunked_lm_loss,
    )

    dp = shape[0] > 1
    mesh = (init_device_mesh(shape, ("dp", "pp"), devices=jax.devices()[:4])
            if dp else init_device_mesh((4,), ("pp",),
                                        devices=jax.devices()[:4]))
    model = GPT2Pipe(GPT2Config(**cfg_kw), mesh,
                     dp_axis="dp" if dp else None, n_microbatches=4,
                     remat=remat)
    tr = Trainer(model, optax.adamw(pph.LR),
                 PipelineParallel(mesh, dp_axis="dp" if dp else None),
                 loss_fn=(lm_loss if loss_name == "lm"
                          else make_chunked_lm_loss(4)))
    state = tr.init(jax.random.key(0), batch)

    def steps():
        s, out = state, {}
        for _ in range(pph.STEPS):
            s, m = tr.step(s, batch)
            for k in ("loss", "grad_norm"):
                out.setdefault(k, []).append(float(m[k]))
        return out

    return jax.tree_util.tree_map(np.asarray, state.params), steps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    gctx = ranks.start(pph.gpipe_body, root)
    want = {"gpipe": _jax_gpipe()}
    ranks.finish(gctx, timeout=120)
    params, steps = {}, {}
    for tag, shape in pph.MESHES.items():
        params[tag], steps[tag] = _jax_pipe(shape, pph.REMAT[tag], pph.TINY,
                                            pph.lm_batch())
    params["chunked"], steps["chunked"] = _jax_pipe(
        (1, 4), False, pph.CHUNKED, pph.chunked_batch(), "chunked")
    # one init for both meshes: the JAX GPT2Pipe draws the same weights
    for a, b in zip(*(jax_leaves(params[t]) for t in pph.MESHES)):
        np.testing.assert_array_equal(a, b)
    ctx = ranks.start(pph.train_body, root, params["pp4"], params["chunked"])
    want.update({tag: run() for tag, run in steps.items()})
    ranks.finish(ctx, timeout=240)
    got = {"gpipe": [torch.load(root / f"gpipe.rank{r}.pt",
                                weights_only=False)
                     for r in range(ranks.WORLD)],
           "train": [torch.load(root / f"train.rank{r}.pt",
                                weights_only=False)
                     for r in range(ranks.WORLD)]}
    return got, want


def jax_leaves(tree):
    import jax

    return jax.tree_util.tree_leaves(tree)


def test_gpipe_forward_and_gradient_match_jax(runs):
    got, want = runs
    out, g = want["gpipe"]
    ranks_out = got["gpipe"]
    np.testing.assert_allclose(ranks_out[-1]["out"].numpy(), out, rtol=1e-5,
                               atol=1e-5)
    for r in ranks_out[:-1]:
        assert r["zeros"] and not r["out"].any()
    grads = np.concatenate([r["grad"].numpy() for r in ranks_out])
    np.testing.assert_allclose(grads, g, rtol=1e-4, atol=1e-5)
    act = 2 * 8 * 4                 # [2, 8] fp32
    for s, r in enumerate(ranks_out):
        sends = (4 if s < 3 else 0) + (4 if s > 0 else 0)
        assert r["links"]["sends"] == r["links"]["recvs"] == sends
        assert r["links"]["sent_bytes"] == sends * act
        assert r["links"]["host_staged_bytes"] == 0   # CPU tensors


def test_gpipe_with_rng_ticks(runs):
    """``with_rng``: the recomputation under remat draws what the forward
    drew (the same output and gradient as remat off), the same ``rng``
    draws the same, another ``rng`` and every stage other ones, and a
    runner built ``with_rng`` refuses a call without ``rng``."""
    got, _ = runs
    ranks_out = [r["rng"] for r in got["gpipe"]]
    for s, r in enumerate(ranks_out):
        torch.testing.assert_close(r[True]["grad"], r[False]["grad"],
                                   rtol=1e-6, atol=0)
        assert not torch.equal(r[True]["grad"], got["gpipe"][s]["grad"])
        assert "with_rng" in r["no_rng"]
    last = ranks_out[-1]
    assert torch.equal(last[True]["out"], last[False]["out"])
    assert torch.equal(last["again"], last[False]["out"])
    assert not torch.allclose(last["other"], last["again"])
    # a tick's words: (rng, stage, dp shard, microbatch)
    from pytorch_distributed_tpu_torch.parallel.pipeline import (
        _tick_generator,
    )

    draws = {w: torch.rand(16, generator=_tick_generator("cpu", 5, *w))
             for w in [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)]}
    assert len({tuple(d.tolist()) for d in draws.values()}) == 4


@pytest.mark.parametrize("tag", sorted(pph.MESHES))
def test_trainer_matches_jax_gpt2pipe(runs, tag):
    got, want = runs
    dp, pp = pph.MESHES[tag]
    rs = [r[tag] for r in got["train"]]
    for key in ("loss", "grad_norm"):
        per_rank = np.asarray([r["metrics"][key] for r in rs])
        rows = per_rank.reshape(dp, pp, pph.STEPS)
        # every stage of a dp row reports its row's value
        assert (rows == rows[:, :1]).all(), key
        mean = rows[:, 0].mean(0)
        if key == "grad_norm":
            np.testing.assert_allclose(mean[0], want[tag][key][0], rtol=RTOL)
            np.testing.assert_allclose(mean, want[tag][key], rtol=1e-4)
        else:
            np.testing.assert_allclose(mean, want[tag][key], rtol=RTOL)
    # after the steps: the replicated tables bit for bit the same on every
    # rank, a stage's layers the same on its dp replicas
    for rank, r in enumerate(rs):
        for name, t in r["params"].items():
            twin = rs[0 if not name.startswith("h.") else rank % pp]
            assert torch.equal(t, twin["params"][name]), name


@pytest.mark.parametrize("tag", sorted(pph.MESHES))
def test_stage_holds_its_layers_and_the_tables(runs, tag):
    got, _ = runs
    dp, pp = pph.MESHES[tag]
    L, C, V = pph.TINY["n_layer"], pph.TINY["n_embd"], pph.TINY["vocab_size"]
    per = L // pp
    block = 12 * C * C + 13 * C       # c_attn, c_proj, c_fc, c_proj, 2 LN
    tables = V * C + pph.TINY["n_positions"] * C + 2 * C
    for rank, r in enumerate(got["train"]):
        s = r[tag]["stage"]
        assert s == rank % pp and r[tag]["data_shard"] == rank // pp
        assert r[tag]["layers"] == list(range(s * per, (s + 1) * per))
        layers = {int(k.split(".")[1]) for k in r[tag]["held"]
                  if k.startswith("h.")}
        assert layers == set(r[tag]["layers"])
        assert {"wte", "wpe", "ln_f.weight"} <= set(r[tag]["held"])
        assert r[tag]["param_bytes"] == 4 * (per * block + tables)


@pytest.mark.parametrize("tag", sorted(pph.MESHES))
def test_collectives_and_links_of_a_step(runs, tag):
    """A step: the replicated gradients' all-reduce over (dp, pp), the
    stage gradients' over dp; the norm's over pp; the loss and
    perplexity broadcast from the last stage. Each link carries the 4
    microbatches' activations forward and their gradients back: [B/dp/4,
    T, C] fp32."""
    got, _ = runs
    dp, pp = pph.MESHES[tag]
    act = (8 // dp // 4) * 16 * pph.TINY["n_embd"] * 4
    for r in got["train"]:
        c, links = r[tag]["counts"], r[tag]["links"]
        assert c["all_reduce"] == 3     # the dp group is issued at dp 1 too
        assert c["broadcast"] == 1
        assert c["all_gather"] == c["reduce_scatter"] == 0
        s = r[tag]["stage"]
        sends = (4 if s < pp - 1 else 0) + (4 if s > 0 else 0)
        assert links["sends"] == links["recvs"] == sends
        assert links["sent_bytes"] == links["recv_bytes"] == sends * act


def test_chunked_loss_through_return_hidden(runs):
    got, want = runs
    losses = [r["chunked"]["loss"] for r in got["train"]]
    assert all(x == losses[0] for x in losses)
    np.testing.assert_allclose(losses[0], want["chunked"]["loss"], rtol=RTOL)
    assert losses[0][-1] < losses[0][0]


class _Mesh:
    """A stand-in mesh of ``n`` pipeline stages on the CPU (this rank the
    first): what ``GPT2Pipe`` and ``PipelineParallel`` read before they
    make a group."""

    device = torch.device("cpu")

    def __init__(self, n=4, axis_names=("pp",)):
        self.n, self.axis_names = n, axis_names

    def size(self, axis):
        return self.n

    def get_local_rank(self, axis):
        return 0


def test_refusals():
    """The batch not divisible by the microbatches (the reference's
    message), the pp axis not in the mesh, and a model that is not a
    pipeline stage under ``PipelineParallel`` (on the ranks)."""
    from pytorch_distributed_tpu_torch.models import GPT2Config
    from pytorch_distributed_tpu_torch.parallel import (
        GPT2Pipe,
        PipelineParallel,
    )

    model = GPT2Pipe(GPT2Config(**pph.TINY), _Mesh(1), n_microbatches=4)
    with pytest.raises(ValueError, match="batch 6 not divisible by "
                                         "n_microbatches 4"):
        model(torch.zeros(6, 8, dtype=torch.long))
    with pytest.raises(ValueError, match="axis 'pp' not in mesh"):
        PipelineParallel(_Mesh(axis_names=("dp",)))


def test_trainer_refuses_a_model_that_is_not_a_stage(runs):
    got, _ = runs
    for r in got["train"]:
        assert "PipelineParallel needs this rank's stage" in r["refusal"]
        assert r["refusal"].endswith("got None of None")


@pytest.mark.parametrize("kw", [{"n_layer": 3}, {"moe_experts": 4}],
                         ids=["not_divisible", "moe"])
def test_refusals_match_reference_messages(kw):
    """``n_layer % pp`` and MoE, on a 4-stage mesh stand-in: the
    reference's exception and message word for word."""
    import jax

    from pytorch_distributed_tpu.mesh import init_device_mesh as jax_mesh
    from pytorch_distributed_tpu.models import GPT2Config as JaxConfig
    from pytorch_distributed_tpu.parallel import GPT2Pipe as JaxPipe
    from pytorch_distributed_tpu_torch.models import GPT2Config
    from pytorch_distributed_tpu_torch.parallel import GPT2Pipe

    cfg = {**pph.TINY, **kw}
    with pytest.raises((ValueError, NotImplementedError)) as want:
        JaxPipe(JaxConfig(**cfg),
                jax_mesh((4,), ("pp",), devices=jax.devices()[:4]))
    with pytest.raises(want.type) as got:
        GPT2Pipe(GPT2Config(**cfg), _Mesh())
    assert str(got.value) == str(want.value)


def test_convert_carries_gpt2pipe_weights_and_adamw_state():
    """The JAX GPT2Pipe's tree (blocks stacked ``[L, ...]``) into a stage
    (its own layers only) and a whole pipeline, back into the stacked
    tree bit for bit, and optax AdamW state of that tree into a stage's
    optimizer."""
    import jax
    import optax

    from pytorch_distributed_tpu.mesh import init_device_mesh as jax_mesh
    from pytorch_distributed_tpu.models import GPT2Config as JaxConfig
    from pytorch_distributed_tpu.parallel import GPT2Pipe as JaxPipe
    from pytorch_distributed_tpu_torch.models import (
        GPT2Config,
        gpt2_flax_from_state_dict,
        gpt2_state_dict_from_flax,
        load_adamw_state_from_optax,
    )
    from pytorch_distributed_tpu_torch.parallel import GPT2Pipe

    tokens = pph.lm_batch()[0]
    jmodel = JaxPipe(JaxConfig(**pph.TINY),
                     jax_mesh((4,), ("pp",), devices=jax.devices()[:4]))
    params = jmodel.init(jax.random.key(0), tokens)["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)

    stage = GPT2Pipe(GPT2Config(**pph.TINY), _Mesh(4))     # layer 0
    stage.load_state_dict(gpt2_state_dict_from_flax(tree,
                                                    layers=stage.layers))
    whole = GPT2Pipe(GPT2Config(**pph.TINY), _Mesh(1))
    whole.load_state_dict(gpt2_state_dict_from_flax(tree))
    back = gpt2_flax_from_state_dict(whole.state_dict(), stacked=True)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert flat_back.keys() == flat_want.keys()
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_back[k], v)

    opt = optax.adamw(pph.LR)
    grads = jax.tree_util.tree_map(lambda a: 0.5 * a + 0.1, params)
    _, st = opt.update(grads, opt.init(params), params)
    adam = st[0]
    torch_opt = torch.optim.AdamW(stage.parameters(), lr=pph.LR)
    load_adamw_state_from_optax(
        torch_opt, stage, adam.count,
        jax.tree_util.tree_map(np.asarray, adam.mu),
        jax.tree_util.tree_map(np.asarray, adam.nu))
    st_w = torch_opt.state[stage.h["0"].attn.c_attn.weight]
    mu_k = np.asarray(adam.mu["blocks"]["attn"]["c_attn"]["kernel"][0])
    nu_b = np.asarray(adam.nu["blocks"]["mlp"]["c_fc"]["bias"][0])
    np.testing.assert_array_equal(st_w["exp_avg"].numpy(), mu_k.T)
    np.testing.assert_array_equal(
        torch_opt.state[stage.h["0"].mlp.c_fc.bias]["exp_avg_sq"].numpy(),
        nu_b)
    assert float(st_w["step"]) == 1.0
    assert len(torch_opt.state) == len(list(stage.parameters()))

