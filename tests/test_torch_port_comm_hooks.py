"""The port's gradient communication hooks (``parallel/comm_hooks.py``),
``Trainer(comm_hook=...)`` and ``data.pad_batch`` against the JAX package.

On 4 gloo ranks, against the JAX hooks in ``shard_map`` over 4 CPU devices
on the same per-rank gradients (an fp32 [13, 5], an fp32 [3], a bf16
[1000] and an int32 [4]):

* each hook's synced gradients: the allreduce hook within 1e-6; bf16 and
  fp16 compression within their dtype's rounding (the port sums the
  16-bit values in 16 bits on gloo, XLA's CPU all-reduce promotes them),
  every output in its input's dtype, and the bytes on the wire those of
  16-bit buffers; the bucketed reduce-scatter and the ring within 1e-6
  (fp32) and the bf16 limit (the bf16 bucket), with the reference's bucket
  and hop counts (at a 1e-4 MB cap: three buckets; 2 (n - 1) hops each);
* ``Trainer`` on ResNet-18 (CIFAR stem, 8 filters, ``SGD(0.05, 0.9)``,
  global batch 16, 4 rows a rank) with the allreduce hook for 3 steps from
  copied flax weights: with ``bn_axis_name="dp"`` (the global batch's BN)
  and without (each rank's own rows; running statistics averaged over the
  ranks), the mean of the ranks' losses within 1e-5 of the JAX
  ``Trainer``'s and the state within 1e-4 of each tensor's largest
  element; the bf16 and fp16 hooks within 5e-2 of the fp32 hook but not
  equal to it, with 16-bit gradient buffers on the wire.

In the test process: a hook under FSDP or ZeRO1 and an unknown hook name
are refused, and ``pad_batch``'s twins of ``tests/test_comm_hooks_uneven.py``
``TestUnevenInputs`` / ``TestMaskedGradients``. JAX is imported inside the
tests only.
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_comm as rb
from tests import _torch_port_ranks as ranks

torch.set_num_threads(2)

WS = rb.WS
CAP_MB = 1e-4        # ~105 bytes: every gradient a bucket of its own
B, WIDTH, LR, MOMENTUM, STEPS = 16, 8, 0.05, 0.9, 3
TRAINER_JOBS = (
    dict(tag="allreduce_dp", hook="allreduce", bn_axis_name="dp"),
    dict(tag="allreduce", hook="allreduce", bn_axis_name=None),
    dict(tag="bf16", hook="bf16_compress", bn_axis_name=None),
    dict(tag="fp16", hook="fp16_compress", bn_axis_name=None),
)


def _grads():
    """Per rank: fp32 [13, 5], fp32 [3], [1000] (bf16 values, held as
    fp32 here; ``BF16_LEAF`` is cast on both sides) and int32 [4]."""
    rng = np.random.default_rng(7)
    return [[rng.standard_normal((13, 5)).astype(np.float32),
             rng.standard_normal(3).astype(np.float32),
             np.asarray(torch.tensor(rng.standard_normal(1000)).to(
                 torch.bfloat16).float()),
             np.full(4, r, np.int32)] for r in range(WS)]


def _jax_hooks(grads):
    """Each reference hook's synced gradients per rank, and its lowered
    program's reduce-scatter and collective-permute counts."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from pytorch_distributed_tpu._compat import shard_map
    from pytorch_distributed_tpu.mesh import init_device_mesh
    from pytorch_distributed_tpu.parallel import comm_hooks

    mesh = init_device_mesh((WS,), ("dp",), devices=jax.devices()[:WS])
    stacked = [jnp.asarray(np.stack([g[i] for g in grads]))
               for i in range(len(grads[0]))]
    stacked[rb.BF16_LEAF] = stacked[rb.BF16_LEAF].astype(jnp.bfloat16)
    hooks = {
        "allreduce": comm_hooks.allreduce_hook,
        "bf16_compress": comm_hooks.bf16_compress,
        "fp16_compress": comm_hooks.fp16_compress,
        "reduce_scatter": comm_hooks.reduce_scatter_hook,
        "ring_allreduce": comm_hooks.ring_allreduce_hook,
        "reduce_scatter_small": comm_hooks.make_bucketed_rs_hook(CAP_MB),
        "ring_allreduce_small": comm_hooks.make_ring_allreduce_hook(CAP_MB),
    }
    out = {}
    for name, hook in hooks.items():
        fn = shard_map(lambda g, h=hook: [x[None] for x in
                                          h([x[0] for x in g], "dp")],
                       mesh=mesh.jax_mesh, in_specs=(P("dp"),),
                       out_specs=P("dp"), check_vma=False)
        lowered = jax.jit(fn).lower(stacked)
        text = lowered.as_text()
        out[name] = {
            "synced": [np.asarray(x) for x in lowered.compile()(stacked)],
            "reduce_scatter": text.count("stablehlo.reduce_scatter"),
            "permutes": text.count("stablehlo.collective_permute"),
        }
    return out


def _jax_trainers(params, stats, batch):
    """The JAX ``Trainer`` with the allreduce hook, with and without
    ``bn_axis_name``, from ``params`` and ``stats`` (the compressed hooks
    are held against the JAX hooks above and the port's fp32 run)."""
    import jax
    import optax

    from pytorch_distributed_tpu.mesh import init_device_mesh
    from pytorch_distributed_tpu.models import resnet18
    from pytorch_distributed_tpu.parallel import DataParallel
    from pytorch_distributed_tpu.trainer import Trainer, classification_loss
    from pytorch_distributed_tpu_torch.models import (
        resnet_state_dict_from_flax,
    )

    mesh = init_device_mesh((WS,), ("dp",), devices=jax.devices()[:WS])
    out = {}
    for job in TRAINER_JOBS:
        if job["hook"] != "allreduce":
            continue
        trainer = Trainer(
            resnet18(num_classes=10, cifar_stem=True, num_filters=WIDTH,
                     bn_axis_name=job["bn_axis_name"]),
            optax.sgd(LR, momentum=MOMENTUM), DataParallel(mesh),
            loss_fn=classification_loss, comm_hook=job["hook"])
        state = trainer.init(jax.random.key(0), batch)
        state = state.replace(
            params=jax.tree_util.tree_map(
                lambda new, old: jax.device_put(new, old.sharding), params,
                state.params),
            model_state={"batch_stats": jax.tree_util.tree_map(
                lambda new, old: jax.device_put(new, old.sharding), stats,
                state.model_state["batch_stats"])})
        losses = []
        for _ in range(STEPS):
            state, m = trainer.step(state, batch)
            losses.append(float(m["loss"]))
        out[job["tag"]] = {
            "losses": losses,
            "state": resnet_state_dict_from_flax(*jax.tree_util.tree_map(
                np.asarray, (state.params,
                             state.model_state["batch_stats"])))}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from pytorch_distributed_tpu.models import resnet18
    from pytorch_distributed_tpu_torch.models import (
        resnet_state_dict_from_flax,
    )

    grads = _grads()
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, B).astype(np.int32))
    init = jax.tree_util.tree_map(np.asarray, resnet18(
        num_classes=10, cifar_stem=True, num_filters=WIDTH).init(
            jax.random.key(0), batch[0]))
    state_dict = resnet_state_dict_from_flax(init["params"],
                                             init["batch_stats"])
    store = tmp_path_factory.mktemp("hooks")
    ctx = ranks.start(rb.hooks_and_trainer_rank, store, grads, CAP_MB,
                      list(TRAINER_JOBS), state_dict, batch, STEPS, WIDTH,
                      LR, MOMENTUM)
    try:
        want_hooks = _jax_hooks(grads)
        want_trainers = _jax_trainers(init["params"], init["batch_stats"],
                                      batch)
    finally:
        ranks.finish(ctx)
    return (rb.load(store, "hooks"), want_hooks, rb.load(store, "trainer"),
            want_trainers)


def _f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      np.asarray(t, np.float32), np.float32)


# bf16 leaves: one bf16 ulp at |x| < 2 (the mean of four N(0, 1) values)
TOL = {"allreduce": (1e-6, 1e-6), "bf16_compress": (1e-2, 1.6e-2),
       "fp16_compress": (1e-3, 2e-3), "reduce_scatter": (1e-6, 1e-6),
       "ring_allreduce": (1e-6, 1e-6), "reduce_scatter_small": (1e-6, 1e-6),
       "ring_allreduce_small": (1e-6, 1e-6)}


@pytest.mark.parametrize("hook", sorted(TOL))
def test_hook_synced_grads_match_jax(runs, hook):
    got, want = runs[0], runs[1]
    rtol, atol = TOL[hook]
    for r in range(WS):
        for i, (g, w) in enumerate(zip(got[r][hook]["synced"],
                                       want[hook]["synced"])):
            bf16_leaf = i == rb.BF16_LEAF
            tol = (dict(rtol=1e-2, atol=1.6e-2) if bf16_leaf
                   else dict(rtol=rtol, atol=atol))
            np.testing.assert_allclose(_f32(g), _f32(w[r]), **tol)
        # each in its input's dtype; the int32 leaf's mean in fp32, as
        # lax.pmean gives it
        assert got[r][hook]["dtypes"] == [torch.float32, torch.float32,
                                          torch.bfloat16, torch.float32]
        assert [w.dtype.name for w in want[hook]["synced"]] == [
            "float32", "float32", "bfloat16", "float32"]
        for g, g0 in zip(got[r][hook]["synced"], got[0][hook]["synced"]):
            assert torch.equal(g, g0)              # the ranks agree


@pytest.mark.parametrize("hook,dtype", [("bf16_compress", "bfloat16"),
                                        ("fp16_compress", "float16")])
def test_compression_puts_16_bits_on_the_wire(runs, hook, dtype):
    got = runs[0]
    for r in range(WS):
        wire = got[r][hook]["wire_bytes"]
        # the fp32 leaves and the bf16 leaf, each dtype's buffer cast to
        # the wire dtype, as the reference casts every floating leaf
        assert wire == {f"all_reduce.{dtype}": (65 + 3 + 1000) * 2,
                        "all_reduce.int32": 16}
        assert got[r]["allreduce"]["wire_bytes"]["all_reduce.float32"] == (
            (65 + 3) * 4)


@pytest.mark.parametrize("hook,buckets", [("reduce_scatter", 2),
                                          ("reduce_scatter_small", 3)])
def test_reduce_scatter_buckets_match_reference(runs, hook, buckets):
    got, want = runs[0], runs[1]
    assert want[hook]["reduce_scatter"] == buckets
    for r in range(WS):
        counts = got[r][hook]["counts"]
        assert counts["reduce_scatter"] == counts["all_gather"] == buckets
        assert counts["all_reduce"] == 1          # the int leaf's mean


@pytest.mark.parametrize("hook,buckets", [("ring_allreduce", 2),
                                          ("ring_allreduce_small", 3)])
def test_ring_hops_match_reference(runs, hook, buckets):
    got, want = runs[0], runs[1]
    hops = buckets * 2 * (WS - 1)
    assert want[hook]["permutes"] == hops
    for r in range(WS):
        counts = got[r][hook]["counts"]
        assert counts["send"] == counts["recv"] == hops


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("tag", ["allreduce_dp", "allreduce"])
def test_hooked_trainer_matches_jax(runs, tag):
    got, want = runs[2], runs[3]
    mean = np.mean([g[tag]["losses"] for g in got], axis=0)
    np.testing.assert_allclose(mean, want[tag]["losses"], rtol=1e-5,
                               atol=1e-5)
    for g in got:
        for name, w in want[tag]["state"].items():
            assert _rel_err(g[tag]["state"][name], w) <= 1e-4, name
        for name, t in g[tag]["state"].items():    # the ranks agree
            assert torch.equal(t, got[0][tag]["state"][name]), name


def test_per_rank_bn_differs_from_global_bn(runs):
    got = runs[2]
    assert got[0]["allreduce"]["losses"][1:] != got[0]["allreduce_dp"][
        "losses"][1:]


@pytest.mark.parametrize("tag", ["bf16", "fp16"])
def test_compressed_hooks_track_fp32(runs, tag):
    got = runs[2]
    full = np.mean([g["allreduce"]["losses"] for g in got], axis=0)
    comp = np.mean([g[tag]["losses"] for g in got], axis=0)
    np.testing.assert_allclose(comp, full, rtol=5e-2, atol=5e-2)
    assert list(comp) != list(full)       # the compression happened
    counts, wire = got[0][tag]["counts"][0]
    dtype = "bfloat16" if tag == "bf16" else "float16"
    assert set(wire) == {f"all_reduce.{dtype}", "all_reduce.float32"}
    # the gradients in 16 bits, the BN running statistics in fp32
    assert wire["all_reduce.float32"] < wire[f"all_reduce.{dtype}"] / 10


# -- in the test process ------------------------------------------------------
class _Mesh:
    """The part of a ``DeviceMesh`` the strategies read, one rank of 4."""

    axis_names = ("dp", "fsdp")
    device = torch.device("cpu")

    def size(self, axis):
        return 4

    def get_local_rank(self, axis):
        return 0

    def get_group(self, axis):
        return None


def test_hook_refused_outside_data_parallel():
    from pytorch_distributed_tpu_torch.models import resnet18
    from pytorch_distributed_tpu_torch.parallel import (
        DataParallel,
        FullyShardedDataParallel,
        ZeRO1,
        get_comm_hook,
    )
    from pytorch_distributed_tpu_torch.trainer import Trainer

    model = resnet18(10, cifar_stem=True, num_filters=8, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    for strategy in (FullyShardedDataParallel(_Mesh()), ZeRO1(_Mesh())):
        with pytest.raises(ValueError, match="dp_axis"):
            Trainer(model, opt, strategy, comm_hook="allreduce")
    with pytest.raises(ValueError, match="unknown comm hook"):
        Trainer(model, opt, DataParallel(_Mesh()), comm_hook="gzip")
    with pytest.raises(ValueError, match="unknown comm hook"):
        get_comm_hook("gzip")


def test_pad_batch_shapes_and_mask():
    from pytorch_distributed_tpu.data import pad_batch as jax_pad_batch
    from pytorch_distributed_tpu_torch.data import pad_batch

    x = np.ones((5, 4), np.float32)
    y = np.arange(5, dtype=np.int32)
    px, py, mask = pad_batch((x, y), 8)
    assert px.shape == (8, 4) and py.shape == (8,)
    np.testing.assert_array_equal(mask, [1, 1, 1, 1, 1, 0, 0, 0])
    for a, b in zip((px, py, mask), jax_pad_batch((x, y), 8)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pad_batch((x[:0], y[:0]), 3),
                    jax_pad_batch((x[:0], y[:0]), 3)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pad_batch((x, y), 4)


def test_masked_loss_equals_unpadded_loss():
    """The padded and masked batch gives the loss of the real rows (eval
    mode, so BN does not see the batch), in the port and in JAX."""
    import jax

    from pytorch_distributed_tpu.models import resnet18 as jax_resnet18
    from pytorch_distributed_tpu.trainer import (
        classification_loss as jax_loss,
    )
    from pytorch_distributed_tpu_torch.data import pad_batch
    from pytorch_distributed_tpu_torch.models import (
        resnet18,
        resnet_state_dict_from_flax,
    )
    from pytorch_distributed_tpu_torch.trainer import classification_loss

    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    flax_model = jax_resnet18(num_classes=10, cifar_stem=True, num_filters=8)
    variables = flax_model.init(jax.random.key(0), x)
    model = resnet18(10, cifar_stem=True, num_filters=8, device="cpu")
    model.load_state_dict(resnet_state_dict_from_flax(
        *jax.tree_util.tree_map(np.asarray, (variables["params"],
                                             variables["batch_stats"]))))
    model.train(False)
    padded = pad_batch((x[:6], y[:6]), 8)
    with torch.no_grad():
        ref, _ = classification_loss(model, tuple(map(torch.tensor,
                                                      (x[:6], y[:6]))), False)
        got, _ = classification_loss(model, tuple(map(torch.tensor, padded)),
                                     False)
    want, _ = jax_loss(flax_model, variables, padded, False, None)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_uneven_dataset_end_to_end():
    """21 examples in batches of 8: the last batch padded and masked, the
    run finishes with finite, falling loss."""
    from pytorch_distributed_tpu_torch.data import pad_batch
    from pytorch_distributed_tpu_torch.models import resnet18
    from pytorch_distributed_tpu_torch.parallel import NoShard
    from pytorch_distributed_tpu_torch.trainer import (
        Trainer,
        classification_loss,
    )

    rng = np.random.default_rng(0)
    x = rng.standard_normal((21, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 21).astype(np.int32)
    model = resnet18(10, cifar_stem=True, num_filters=8, device="cpu")
    trainer = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.05,
                                             momentum=0.9),
                      NoShard("cpu"), loss_fn=classification_loss)
    state = trainer.init()
    losses = []
    for _ in range(2):
        for i in range(0, 21, 8):
            state, m = trainer.step(state, pad_batch((x[i:i + 8],
                                                      y[i:i + 8]), 8))
            losses.append(float(m["loss"]))
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_padding_contributes_nothing_to_grads():
    """GPT-2 (no BN): the gradients of the padded, masked batch equal those
    of the real rows, as the JAX test holds for the reference."""
    from pytorch_distributed_tpu_torch.data import pad_batch
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.trainer import lm_loss

    cfg = GPT2Config(vocab_size=32, n_positions=8, n_embd=16, n_layer=1,
                     n_head=2)
    model = GPT2(cfg, device="cpu")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 32, (6, 8)).astype(np.int64)
    tgt = np.roll(tok, -1, 1)

    def grads(batch):
        model.zero_grad()
        loss, _ = lm_loss(model, tuple(map(torch.tensor, batch)), True)
        loss.backward()
        return [p.grad.clone() for p in model.parameters()]

    for a, b in zip(grads((tok, tgt)), grads(pad_batch((tok, tgt), 8))):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.fixture
def one_rank_group():
    from datetime import timedelta

    from pytorch_distributed_tpu_torch import distributed as pdist

    pdist.init_process_group(store=pdist.HashStore(), rank=0, world_size=1,
                             device="cpu", timeout=timedelta(seconds=60))
    try:
        yield
    finally:
        pdist.destroy_process_group()


def test_callable_and_stateful_hooks_accepted(one_rank_group):
    """``Trainer(comm_hook=...)`` takes a callable ``hook(grads, group)``
    (called once a step with every gradient) and a ``PowerSGD``, whose
    state ``init`` puts in ``TrainState.comm_state``; at one rank the
    callable that means through the allreduce hook gives its losses."""
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.models import resnet18
    from pytorch_distributed_tpu_torch.parallel import (
        DataParallel,
        PowerSGD,
        allreduce_hook,
    )
    from pytorch_distributed_tpu_torch.trainer import (
        Trainer,
        classification_loss,
    )

    mesh = init_device_mesh((1,), ("dp",))
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, 4).astype(np.int32))
    calls = []

    def hook(grads, group):
        calls.append(len(grads))
        return allreduce_hook(grads, group)

    def run(comm_hook):
        model = resnet18(10, cifar_stem=True, num_filters=8, device="cpu")
        trainer = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1),
                          DataParallel(mesh), loss_fn=classification_loss,
                          comm_hook=comm_hook)
        state = trainer.init()
        losses = []
        for _ in range(2):
            state, m = trainer.step(state, batch)
            losses.append(float(m["loss"]))
        return losses, state, trainer

    named, _, _ = run("allreduce")
    mine, state, trainer = run(hook)
    assert mine == named and state.comm_state is None
    assert calls == [len(trainer._params)] * 2
    _, state, trainer = run(PowerSGD(rank=2, start_iter=1))
    assert state.comm_state and state.step == 2
    assert all(set(e) == {"q", "e"} for e in state.comm_state.values())
