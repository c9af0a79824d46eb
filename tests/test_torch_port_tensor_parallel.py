"""The port's tensor parallelism against the JAX package's, on the CPU.

Mirrors ``tests/test_tensor_parallel.py``: the styles on torch shapes, the
GPT-2 plan, TP x FSDP (``min_shard_size=8``) and unmatched parameters;
the bytes a rank holds equal those of the reference's ``make_state_specs``
on the same tiny GPT-2 (vocab 64, width 32, 2 layers, 4 heads) and mesh
shape. Placements need no ranks: the strategy is built on a stand-in mesh
that answers sizes and coordinates.

Training runs on 4 gloo ranks (``tests/_torch_port_ranks.py``, spawned
once for the file; rank bodies in ``tests/_torch_port_tp.py``) at ``(dp
1, tp 4)`` (one head a rank), ``(dp 2, tp 2)`` and ``(fsdp 2, tp 2)``,
each with sequence parallelism off and on: 4 AdamW steps on the
reference test's batch from the weights flax drew, against the JAX
``TensorParallel`` trainer on its ``(2, 4)`` mesh over 8 virtual CPU
devices. The mean of the ranks' losses and each rank's grad norm are held
to rtol 1e-5 (the reference test's bound). The gathered parameters, equal
on every rank, are held with the limits of the port's sharding oracle
(``tests/_torch_port_sharding.check_against``): rtol 1e-4 plus 1e-5 where
Adam's step is well-conditioned, and the most Adam can move an element,
``2 x steps x lr``, where it is not (an element whose reduced gradient
fell below 1e-6 at some step, and every element of the attention's key
bias, whose gradient is rounding noise: softmax ignores a constant added
to every key's score); such elements are under 1% of all besides the key
biases (the positions past the batch's 16 get no gradient and are held
to the tight limit). The port's own NoShard, against the JAX NoShard
after these 4 steps, differs by up to 3.7e-5 of a tensor's largest
value, so a bound of 1e-5 of it would fail without TP. Sequence
parallelism gives the same losses (rtol 1e-5) with the all-reduces of
the tp region replaced by reduce-scatters and all-gathers, counted per
step. On one rank, TP (SP off and on) is NoShard bit for bit.

JAX is imported inside the tests only: the ranks re-import the helpers.
"""

import math

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch.parallel import (
    ColwiseParallel,
    Replicated,
    RowwiseParallel,
    SequenceParallel,
    TensorParallel,
    gpt2_tp_plan,
)
from pytorch_distributed_tpu_torch.parallel.tensor_parallel import (
    TPShard,
    tp_block,
    tp_full_tensor,
)
from tests import _torch_port_ranks as ranks
from tests import _torch_port_tp as tph
from tests._torch_port_tp import StubMesh

torch.set_num_threads(2)

JOBS = [(f"{kind}_sp{int(sp)}", kind, sp)
        for kind in ("tp4", "dp2tp2", "fsdp2tp2") for sp in (False, True)]


def torch_shapes():
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config

    model = GPT2(GPT2Config(**tph.TINY), device="cpu")
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


class TestStyles:
    def test_colwise(self):
        s = ColwiseParallel()
        assert s.shard_dim("h.0.mlp.c_fc.weight", (128, 32)) == 0  # [out, in]
        assert s.shard_dim("h.0.mlp.c_fc.bias", (128,)) == 0
        assert s.shard_dim("wte", (64, 32)) == 1   # a table's features
        assert ColwiseParallel(chunks=3).chunks == 3

    def test_rowwise(self):
        s = RowwiseParallel()
        assert s.shard_dim("h.0.mlp.c_proj.weight", (32, 128)) == 1
        assert s.shard_dim("h.0.mlp.c_proj.bias", (32,)) is None
        assert s.shard_dim("wte", (64, 32)) == 0   # a table's rows

    def test_sp_and_replicated(self):
        assert SequenceParallel().shard_dim("ln_f.weight", (32,)) is None
        assert Replicated().shard_dim("w.weight", (8, 8)) is None

    def test_per_head_block_round_trips(self):
        """c_attn's block is each rank's rows of q, k and v."""
        whole = torch.arange(12 * 2.0).reshape(12, 2)   # q, k, v of 4 rows
        spec = TPShard(0, None, 1, 2, (12, 2), chunks=3)
        block = tp_block(whole, spec)
        assert torch.equal(block[:, 0], torch.tensor([4., 6, 12, 14, 20, 22]))
        with pytest.MonkeyPatch.context() as mp:
            # a 2-rank gather from blocks 0 and 1
            blocks = [tp_block(whole, TPShard(0, None, r, 2, (12, 2), 3))
                      for r in range(2)]
            mp.setattr("pytorch_distributed_tpu_torch.parallel.tensor_"
                       "parallel.gather",
                       lambda t, d, g, n: torch.cat(blocks, d))
            assert torch.equal(tp_full_tensor(block, spec), whole)


def jax_specs(mesh_shape, names, **kw):
    """The reference's ``make_state_specs`` params on the tiny GPT-2."""
    import jax
    import jax.numpy as jnp
    import optax

    from pytorch_distributed_tpu.mesh import init_device_mesh
    from pytorch_distributed_tpu.models import GPT2 as JaxGPT2
    from pytorch_distributed_tpu.models import GPT2Config as JaxCfg
    from pytorch_distributed_tpu.parallel import TrainState, make_state_specs
    from pytorch_distributed_tpu.parallel.tensor_parallel import (
        TensorParallel as JaxTP,
        gpt2_tp_plan as jax_plan,
    )

    mesh = init_device_mesh(mesh_shape, names)
    strategy = JaxTP(mesh, jax_plan(), **kw)
    model = JaxGPT2(JaxCfg(**tph.TINY))
    tx = optax.sgd(0.1)

    def init_fn(rng):
        p = model.init(rng, jnp.zeros((1, 8), jnp.int32))["params"]
        return TrainState(step=jnp.int32(0), params=p, model_state={},
                          opt_state=tx.init(p), scaler=None)

    shapes = jax.eval_shape(init_fn, jax.random.key(0))
    specs = make_state_specs(shapes, strategy).params
    flat = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        flat["/".join(p.key for p in path)] = spec
    leaves = jax.tree_util.tree_flatten_with_path(shapes.params)[0]
    sizes = {"/".join(p.key for p in path): math.prod(leaf.shape)
             for path, leaf in leaves}
    held = {}
    for key, spec in flat.items():
        n = 1
        for entry in spec:
            for axis in ((entry,) if isinstance(entry, str) else entry or ()):
                n *= mesh.shape[axis]
        held[key] = sizes[key] // n
    return flat, held


def port_key(flax_key):
    """A flax path (``h_0/attn/c_attn/kernel``) as the port's name."""
    from pytorch_distributed_tpu_torch.models.convert import _pairs

    for path, name, _ in _pairs(tph.TINY["n_layer"]):
        if "/".join(path) == flax_key:
            return name
    raise KeyError(flax_key)


class TestPlacements:
    def test_gpt2_plan(self):
        s = TensorParallel(StubMesh((2, 4), ("dp", "tp")), gpt2_tp_plan())
        shapes = torch_shapes()
        place = {n: s.placement(n, sh) for n, sh in shapes.items()}
        assert place["h.0.attn.c_attn.weight"] == {"tp": 0}    # colwise
        assert place["h.0.attn.c_attn.bias"] == {"tp": 0}
        assert place["h.0.attn.c_proj.weight"] == {"tp": 1}    # rowwise
        assert place["h.0.attn.c_proj.bias"] == {}
        assert place["h.0.mlp.c_fc.weight"] == {"tp": 0}
        assert place["h.0.mlp.c_proj.weight"] == {"tp": 1}
        assert place["h.0.ln_1.weight"] == {}                  # replicated
        assert place["wte"] == {"tp": 1} == place["wpe"]       # features
        assert s.style_for("h.1.attn.c_attn.weight").chunks == 3
        assert s.batch_axes == "dp"
        assert s.collective_signature()["tp"] == "all_reduce"

    def test_tp_fsdp_composition(self):
        s = TensorParallel(StubMesh((2, 4), ("fsdp", "tp")), gpt2_tp_plan(),
                           dp_axis=None, fsdp_axis="fsdp", min_shard_size=8)
        shapes = torch_shapes()
        # colwise [3C, C]: tp on the outputs (dim 0), fsdp the other
        assert s.placement("h.0.attn.c_attn.weight",
                           shapes["h.0.attn.c_attn.weight"]) == {"tp": 0,
                                                                 "fsdp": 1}
        # rowwise [C, C]: tp on the inputs (dim 1), fsdp on the outputs
        assert s.placement("h.0.attn.c_proj.weight",
                           shapes["h.0.attn.c_proj.weight"]) == {"tp": 1,
                                                                 "fsdp": 0}
        assert s.param_axis == s.update_axis == "fsdp"
        assert s.collective_signature()["param_gather"] == "per_param"

    def test_unmatched_falls_back(self):
        s = TensorParallel(StubMesh((8,), ("tp",)), {}, dp_axis=None)
        assert s.placement("h.0.attn.c_attn.weight", (96, 32)) == {}

    @pytest.mark.parametrize("case", ["dp_tp", "fsdp_tp"])
    def test_bytes_held_equal_the_references(self, case):
        if case == "dp_tp":
            mesh, kw = ((2, 4), ("dp", "tp")), dict(tp_axis="tp",
                                                    dp_axis="dp")
        else:
            mesh, kw = ((2, 4), ("fsdp", "tp")), dict(
                tp_axis="tp", dp_axis=None, fsdp_axis="fsdp",
                min_shard_size=8)
        specs, want = jax_specs(*mesh, **kw)
        s = TensorParallel(StubMesh(*mesh), gpt2_tp_plan(), **kw)
        shapes = torch_shapes()
        for key, n in want.items():
            name = port_key(key)
            assert math.prod(s.held_shape(name, shapes[name])) == n, (
                key, specs[key], s.placement(name, shapes[name]))


# -- training on 4 gloo ranks ------------------------------------------------
def jax_tp_trainer():
    """The JAX TensorParallel trainer on the (2, 4) mesh, its state at
    step 0, and its params as the port's state dict."""
    import jax
    import optax

    from pytorch_distributed_tpu.mesh import init_device_mesh
    from pytorch_distributed_tpu.models import GPT2 as JaxGPT2
    from pytorch_distributed_tpu.models import GPT2Config as JaxCfg
    from pytorch_distributed_tpu.parallel.tensor_parallel import (
        TensorParallel as JaxTP,
        gpt2_tp_plan as jax_plan,
    )
    from pytorch_distributed_tpu.trainer import Trainer as JaxTrainer
    from pytorch_distributed_tpu.trainer import lm_loss as jax_lm_loss
    from pytorch_distributed_tpu_torch.models import gpt2_state_dict_from_flax

    mesh = init_device_mesh((2, 4), ("dp", "tp"))
    trainer = JaxTrainer(JaxGPT2(JaxCfg(**tph.TINY)), optax.adamw(tph.LR),
                         JaxTP(mesh, jax_plan(), tp_axis="tp", dp_axis="dp"),
                         loss_fn=jax_lm_loss)
    state = trainer.init(jax.random.key(0), tph.lm_batch())
    first = gpt2_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, state.params))
    return trainer, state, first


def jax_tp_steps(trainer, state):
    """Per-step (loss, grad_norm) of ``STEPS`` steps, the last params."""
    import jax

    from pytorch_distributed_tpu_torch.models import gpt2_state_dict_from_flax

    trace = []
    for _ in range(tph.STEPS):
        state, m = trainer.step(state, tph.lm_batch())
        trace.append((float(m["loss"]), float(m["grad_norm"])))
    return trace, gpt2_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, state.params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    trainer, state, first = jax_tp_trainer()
    ctx = ranks.start(tph.train_body, tmp, JOBS, first)
    trace, last = jax_tp_steps(trainer, state)
    ranks.finish(ctx, timeout=240)
    got = {tag: [torch.load(f"{tmp}/{tag}.rank{r}.pt", weights_only=False)
                 for r in range(ranks.WORLD)] for tag, _, _ in JOBS}
    return got, trace, last


@pytest.mark.parametrize("tag", [tag for tag, _, _ in JOBS])
def test_losses_and_norms_match_jax(runs, tag):
    got, trace, _ = runs
    for step, (loss, norm) in enumerate(trace):
        mean = np.mean([r["metrics"]["loss"][step] for r in got[tag]])
        np.testing.assert_allclose(mean, loss, rtol=1e-5)
        for r in got[tag]:
            np.testing.assert_allclose(r["metrics"]["grad_norm"][step], norm,
                                       rtol=1e-5)


@pytest.mark.parametrize("tag", [tag for tag, _, _ in JOBS])
def test_gathered_params_match_jax(runs, tag):
    got, _, last = runs
    C = tph.TINY["n_embd"]
    bound = 2 * tph.STEPS * tph.LR
    n_small = n_all = 0
    first = got[tag][0]
    for r in got[tag]:
        for name, p in r["params"].items():
            assert torch.equal(p, first["params"][name]), name
    for name, p in first["params"].items():
        w, ill = last[name], first["small"][name].clone()
        if name == "wpe":
            # positions past the batch's T get no gradient: AdamW only
            # decays them, on both sides alike (held to the tight limit)
            ill[tph.lm_batch()[0].shape[1]:] = False
        if name.endswith("attn.c_attn.bias"):
            ill[C:2 * C] = True
        assert float((p - w).abs().where(ill, 0).max()) <= bound, name
        torch.testing.assert_close(p[~ill], w[~ill], rtol=1e-4, atol=1e-5,
                                   msg=name)
        if name.endswith("attn.c_attn.bias"):
            ill[C:2 * C] = False
        n_small += int(ill.sum())
        n_all += ill.numel()
    assert n_small <= 1e-2 * n_all, (n_small, n_all)


@pytest.mark.parametrize("kind", ["tp4", "dp2tp2", "fsdp2tp2"])
def test_sequence_parallel_same_losses_other_collectives(runs, kind):
    got, _, _ = runs
    off, on = got[f"{kind}_sp0"][0], got[f"{kind}_sp1"][0]
    np.testing.assert_allclose(on["metrics"]["loss"], off["metrics"]["loss"],
                               rtol=1e-5)
    c_off, c_on = off["counts"], on["counts"]
    assert c_on["reduce_scatter"] > c_off["reduce_scatter"]
    assert c_on["all_gather"] > c_off["all_gather"]
    assert c_on["all_reduce"] < c_off["all_reduce"]
    if kind != "fsdp2tp2":
        # a step: per layer 2 f + 2 g all-reduces (SP: 4 all-gathers and 4
        # reduce-scatters), the tables' 2 gathers (SP: + the sequence's
        # split and join), the dp mean and the norm (SP: + the partial
        # gradients' sum over tp)
        L = tph.TINY["n_layer"]
        assert c_off == {"all_reduce": 4 * L + 2, "reduce_scatter": 0,
                         "all_gather": 2, "broadcast": 0}
        assert c_on == {"all_reduce": 3, "reduce_scatter": 4 * L,
                        "all_gather": 4 * L + 4, "broadcast": 0}


@pytest.mark.parametrize("tag", [tag for tag, _, _ in JOBS])
def test_each_rank_holds_the_plans_blocks(runs, tag):
    got, _, _ = runs
    kind = tag.rsplit("_", 1)[0]
    shape, names = tph.MESHES[kind]
    kw = (dict(dp_axis=None, fsdp_axis="fsdp", min_shard_size=8)
          if kind == "fsdp2tp2" else {})
    s = TensorParallel(StubMesh(shape, names), gpt2_tp_plan(), **kw)
    shapes = torch_shapes()
    want = {n: s.held_shape(n, sh) for n, sh in shapes.items()}
    for r in got[tag]:
        assert r["held"] == want
        assert r["param_bytes"] == 4 * sum(math.prod(v) for v in want.values())


def test_one_rank_is_noshard_bit_for_bit(tmp_path):
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config

    sd = GPT2(GPT2Config(**tph.TINY), device="cpu", seed=3).state_dict()
    ctx = ranks.start(tph.tp1_body, tmp_path, sd, world=1)
    ranks.finish(ctx)
    out = torch.load(tmp_path / "tp1.pt", weights_only=False)
    want = out["noshard"]
    for tag in ("tp1_sp0", "tp1_sp1"):
        assert out[tag]["metrics"] == want["metrics"], tag
        for name, p in want["params"].items():
            assert torch.equal(out[tag]["params"][name], p), (tag, name)
