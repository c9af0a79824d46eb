"""The port's ZeRO1 against its DataParallel on 4 gloo ranks (the oracle of
``tests/test_sharded_update.py``: the sharded update is a change of
layout, not of arithmetic).

The MLP of that file, ``SGD(0.1, momentum=0.9)``, global batch 32 (8 rows
a rank), 5 steps from the same weights, ``min_shard_size=8``:

* ``ZeRO1(sharded_update=False)`` (DP's one flat all-reduce, each rank
  stepping its block of the whole gradients) equals DP bit for bit: losses,
  grad norms, parameters and momentum, in fp32 and in fp16 with the loss
  scaler through skipped steps;
* ``ZeRO1`` (the reduce-scatter) does not, by rounding: gloo adds the four
  ranks in an order that depends on where an element sits in the buffer it
  reduces, and DP reduces one flat buffer of every gradient where ZeRO1
  reduce-scatters each leaf (``test_gloo_sums_depend_on_the_buffer``
  shows it; ROADMAP C). One step from the same weights, the momentum (the
  reduced gradient) and the parameters agree within one ulp of each
  tensor's largest value (an element near zero, where the four ranks
  cancel, can be hundreds of its own ulps off); over 5 steps the
  differences compound, to 1.6 such ulps measured, and are held to 2, the
  losses to rtol 1e-6 and the grad norms (summed per shard, then across
  ranks) to rtol 1e-6;
* the momentum is held as 1/4 blocks and the parameters stay whole;
* one step's collectives (``parallel.comm.counts``) are those
  ``collective_signature`` promises: DP all-reduces and gathers nothing,
  ZeRO1 reduce-scatters and gathers once per sharded leaf, FSDP gathers
  per parameter where it is used (again in the backward for the weights
  autograd saves) and reduce-scatters each gradient once;
* ``AsyncRunner`` under ZeRO1 and under FSDP (GPT-2 with AdamW, the MLP
  with SGD) equals sequential ``Trainer.step`` bit for bit: its warm-up
  changes the ZeRO1 blocks and their state, which are not
  ``model.parameters()``, and puts them back.

The ranks run once for the module (``runs``); each test reads their
results.
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_ranks as ranks
from tests import _torch_port_sharding as sh

torch.set_num_threads(2)

N = ranks.WORLD
STEPS = 5
# fp16 policy with the MLP computing in fp16: a scale of 2**22 overflows
# the fp16 gradients at steps 1 and 2 (skipped, the scale halves), then
# the steps are taken
FP16 = dict(policy="fp16", dtype=torch.float16,
            scaler=dict(init_scale=2.0**22, growth_interval=2))


def _jobs(state_dict):
    batches = [sh.mlp_batch(seed=i) for i in range(STEPS)]
    base = dict(model="mlp", state_dict=state_dict, batches=batches)
    jobs = []
    for strategy in ("dp", "zero1", "zero1_state"):
        jobs.append(dict(base, tag=f"{strategy}_fp32", strategy=strategy))
        jobs.append(dict(base, tag=f"{strategy}_fp16", strategy=strategy,
                         **FP16))
    return jobs


def _gloo_order(rank, store_dir):
    import torch.distributed as dist

    g = torch.Generator().manual_seed(rank)
    parts = [torch.randn(n, generator=g) for n in (4096, 256, 64)]
    flat = torch.cat(parts)
    dist.all_reduce(flat)
    diffs = 0
    pos = 0
    for p in parts:
        out = torch.empty(p.numel() // N)
        dist.reduce_scatter_tensor(out, p.clone())
        diffs += int((out != flat[pos:pos + p.numel()].view(N, -1)[rank])
                     .sum())
        pos += p.numel()
    torch.save(diffs, f"{store_dir}/order.rank{rank}.pt")


def _runner_jobs(gpt2_sd, mlp_sd):
    lm = sh.lm_batches(4, 8, seed=3)
    mlp = [sh.mlp_batch(seed=i) for i in range(4)]
    jobs = []
    for strategy in ("zero1", "fsdp"):
        for runner in (False, True):
            jobs.append(dict(tag=f"gpt2_{strategy}_{runner}", model="gpt2",
                             strategy=strategy, state_dict=gpt2_sd,
                             batches=lm, runner=runner))
            jobs.append(dict(tag=f"mlp_{strategy}_{runner}", model="mlp",
                             strategy=strategy, state_dict=mlp_sd,
                             batches=mlp, runner=runner))
    return jobs


def _body(rank, store_dir, jobs):
    _gloo_order(rank, store_dir)
    sh.rank_body(rank, store_dir, jobs)


def _gpt2_state_dict():
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config

    return GPT2(GPT2Config(**sh.GPT2_TINY), device="cpu", seed=5).state_dict()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero1")
    state_dict = sh.MLP(seed=1).state_dict()
    jobs = (_jobs(state_dict)
            + _runner_jobs(_gpt2_state_dict(), state_dict)
            + [dict(tag=f"{s}_one_step", strategy=s, model="mlp",
                    state_dict=state_dict, batches=[sh.mlp_batch(seed=0)])
               for s in ("dp", "zero1")]
            + [dict(tag="fsdp_bf16", strategy="fsdp", model="mlp",
                    state_dict=state_dict, dtype=torch.bfloat16,
                    policy="bf16", batches=[sh.mlp_batch(seed=0)] * 2)])
    ranks.finish(ranks.start(_body, tmp, jobs))
    out = {job["tag"]: sh.load(tmp, job["tag"], N) for job in jobs}
    out["order_diffs"] = [torch.load(tmp / f"order.rank{r}.pt")
                          for r in range(N)]
    return out


def _assert_equal_runs(a, b):
    for k in ("loss", "grad_norm", "all_finite"):
        np.testing.assert_array_equal(a["metrics"][k], b["metrics"][k], k)
    for name, p in a["params"].items():
        assert torch.equal(p, b["params"][name]), name
    for name, st in a["opt"].items():
        for k, v in st.items():
            assert torch.equal(v, b["opt"][name][k]), (name, k)


def _assert_close_at_scale(a, b, ulps):
    """Each tensor within ``ulps`` ulps of its largest value."""
    for name, x in a.items():
        y = b[name]
        top = np.float32(y.abs().max())
        err = float((x - y).abs().max())
        assert err <= ulps * np.spacing(top), (name, err, np.spacing(top))


def test_gloo_sums_depend_on_the_buffer(runs):
    # all-reducing one flat buffer and reduce-scattering its pieces give
    # other sums in some elements
    assert sum(runs["order_diffs"]) > 0, runs["order_diffs"]


@pytest.mark.parametrize("prec", ["fp32", "fp16"])
def test_zero1_state_only_equals_dp_bit_for_bit(runs, prec):
    for r in range(N):
        _assert_equal_runs(runs[f"zero1_state_{prec}"][r],
                           runs[f"dp_{prec}"][r])
    if prec == "fp16":
        finite = runs["dp_fp16"][0]["metrics"]["all_finite"]
        assert not all(finite) and any(finite), finite


def test_zero1_step_within_one_ulp_of_dp(runs):
    for r in range(N):
        z, dp = runs["zero1_one_step"][r], runs["dp_one_step"][r]
        assert z["metrics"]["loss"] == dp["metrics"]["loss"]
        _assert_close_at_scale(z["params"], dp["params"], 1)
        _assert_close_at_scale(
            {n: st["momentum_buffer"] for n, st in z["opt"].items()},
            {n: st["momentum_buffer"] for n, st in dp["opt"].items()}, 1)


@pytest.mark.parametrize("prec", ["fp32", "fp16"])
def test_zero1_steps_within_two_ulps_of_dp(runs, prec):
    for r in range(N):
        z, dp = runs[f"zero1_{prec}"][r], runs[f"dp_{prec}"][r]
        np.testing.assert_array_equal(z["metrics"]["all_finite"],
                                      dp["metrics"]["all_finite"])
        np.testing.assert_array_equal(z["metrics"].get("loss_scale"),
                                      dp["metrics"].get("loss_scale"))
        np.testing.assert_allclose(z["metrics"]["loss"],
                                   dp["metrics"]["loss"], rtol=1e-6)
        np.testing.assert_allclose(z["metrics"]["grad_norm"],
                                   dp["metrics"]["grad_norm"], rtol=1e-6)
        _assert_close_at_scale(z["params"], dp["params"], 2)
        _assert_close_at_scale(
            {n: st["momentum_buffer"] for n, st in z["opt"].items()},
            {n: st["momentum_buffer"] for n, st in dp["opt"].items()}, 2)


@pytest.mark.parametrize("strategy", ["zero1", "zero1_state"])
def test_optimizer_state_held_as_quarter_blocks(runs, strategy):
    z = runs[f"{strategy}_fp32"][0]
    assert z["held"]["params"]["Dense_1.weight"] == (64, 64)   # whole
    mom = {st["momentum_buffer"] for st in z["held"]["opt"].values()}
    # [64, 64] and [64] along dim 0, the head's [10, 64] along dim 1; its
    # bias [10] does not divide by 4
    assert mom == {(16, 64), (16,), (10, 16), (10,)}, mom
    assert z["n_leaves_sharded"] == 5
    dp_bytes = runs["dp_fp32"][0]["held"]["opt_bytes"]
    assert z["held"]["opt_bytes"] < dp_bytes / 3.5


# one step of the MLP: its 5 sharded leaves, 1 whole one (the head's bias)
SIGNATURES = {
    # one flat all-reduce, no gather
    "dp": {"all_reduce": 1, "reduce_scatter": 0, "all_gather": 0},
    # a reduce-scatter and a gather per sharded leaf; the whole leaves'
    # all-reduce and the norm's
    "zero1": {"all_reduce": 2, "reduce_scatter": 5, "all_gather": 5},
    # DP's all-reduce, a gather per sharded leaf
    "zero1_state": {"all_reduce": 1, "reduce_scatter": 0, "all_gather": 5},
    # a gather per sharded parameter in the forward, and one in the
    # backward for each weight autograd saved (Dense_1 and Dense_2: the
    # first layer's input needs no gradient); a reduce-scatter per
    # sharded gradient
    "fsdp": {"all_reduce": 2, "reduce_scatter": 5, "all_gather": 7},
    # the same in bf16: autograd saves the weights' bf16 casts, and the
    # backward gathers again instead of keeping them
    "fsdp_bf16": {"all_reduce": 2, "reduce_scatter": 5, "all_gather": 7},
}


@pytest.mark.parametrize("strategy", sorted(SIGNATURES))
def test_collectives_of_one_step(runs, strategy):
    tag = {"fsdp": "mlp_fsdp_False", "fsdp_bf16": "fsdp_bf16"}.get(
        strategy, f"{strategy}_fp32")
    counts = runs[tag][0]["counts"]
    assert counts == {**SIGNATURES[strategy], "broadcast": 0}, counts


@pytest.mark.parametrize("model", ["gpt2", "mlp"])
@pytest.mark.parametrize("strategy", ["zero1", "fsdp"])
def test_runner_equals_sequential_steps(runs, model, strategy):
    seq = runs[f"{model}_{strategy}_False"]
    piped = runs[f"{model}_{strategy}_True"]
    for r in range(N):
        _assert_equal_runs(piped[r], seq[r])
