"""The port's FSDP and HybridShard against the JAX ones: a small GPT-2 on
4 gloo ranks against the JAX ``Trainer`` on 4 virtual CPU devices.

GPT-2 with 2 layers, width 64, 2 heads, vocab 256, T=32, global batch 8
(2 rows a rank), AdamW (lr 1e-3, optax's weight decay 1e-4),
``min_shard_size=8``, 3 steps from the weights flax drew (copied with
``models.convert``): ``FullyShardedDataParallel`` on ``("fsdp",)``, and
``HybridShard`` on the JAX ``init_hybrid_mesh((2,), (2,), ("dcn",
"fsdp"), stub_slices=True)`` against the port's ``init_hybrid_mesh`` of
the same shape, each against the same JAX strategy; FSDP with
``dp_axis`` on ``(dp=2, fsdp=2)`` against the JAX ``NoShard`` on the
whole batch (``tests/test_parallel.py``'s 2-D check). ZeRO1 is in
``tests/test_torch_port_sharding_jax_zero1.py``, clipping in
``tests/test_torch_port_sharding_jax_mlp.py``.

The limits are those of the port's DataParallel oracle
(``tests/test_torch_port_cp_trainer.py``): the mean of the ranks' losses
and each rank's grad norm within rtol 1e-5 of JAX's (rtol 1e-4 against
NoShard, as the 2-D check), the gathered parameters within rtol 1e-4 plus
1e-5, every rank holding the same ones. Where Adam's step is
ill-conditioned (see ``tests/test_torch_port_trainer.py``: an element
whose reduced gradient fell below 1e-6 at some step, and every element of
the attention's key bias, whose gradient is rounding noise), the
parameter is held to the most Adam can move it, ``2 x steps x lr``; such
elements are under 1% of all besides the key biases
(``_torch_port_sharding.check_against``).

The optax state carries into the shards: FSDP loads the JAX NoShard
run's params and AdamW state after its first step (each rank taking its
blocks, ``load_adamw_state_from_optax(..., layout=...)``) and takes its
next two steps.

JAX is imported inside the tests only: the ranks re-import this module.
"""

import pytest
import torch

from tests import _torch_port_sharding as sh

torch.set_num_threads(2)

KINDS = ("fsdp", "hybrid")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sh.gpt2_against_jax(tmp_path_factory.mktemp("gpt2"), KINDS,
                               carry=("fsdp",), fsdp_dp=True)


@pytest.mark.parametrize("kind", KINDS)
def test_strategy_matches_jax(runs, kind):
    got, want = runs
    _, trace, last, _ = want[kind]
    sh.check_against(got[kind], trace, last, rtol=1e-5)


def test_fsdp_over_dp_and_fsdp_matches_noshard(runs):
    got, want = runs
    _, trace, last, _ = want["noshard"]
    sh.check_against(got["fsdp_dp"], trace, last, rtol=1e-4)


def test_optax_state_carries_into_the_shards(runs):
    got, want = runs
    _, trace, last, _ = want["noshard"]
    sh.check_against(got["fsdp_carry"], trace, last, rtol=1e-5, start=1)


@pytest.mark.parametrize("kind", ["fsdp", "hybrid", "fsdp_dp"])
def test_fsdp_holds_quarter_or_half_shards(runs, kind):
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config

    got, _ = runs
    held = got[kind][0]["held"]
    fsdp = 4 if kind == "fsdp" else 2
    # wte [256, 64] shards along dim 0; the LayerNorm scales ([64]) too;
    # every tensor of this GPT-2 divides by 4
    assert held["params"]["wte"] == (256 // fsdp, 64)
    assert held["params"]["h.0.ln_1.weight"] == (64 // fsdp,)
    whole = GPT2(GPT2Config(**sh.GPT2_TINY), device="cpu")
    assert held["param_bytes"] * fsdp == 4 * sum(
        p.numel() for p in whole.parameters())
    # AdamW's two moments on the shards, and a 4-byte step count each
    n_tensors = len(held["params"])
    assert held["opt_bytes"] == 2 * held["param_bytes"] + 4 * n_tensors
