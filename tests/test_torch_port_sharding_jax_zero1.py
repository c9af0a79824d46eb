"""The port's ZeRO1 against the JAX one: a small GPT-2 on 4 gloo ranks
against the JAX ``Trainer`` on 4 virtual CPU devices, with and without
``sharded_update``.

The model, batches, optimizer, steps and limits are those of
``tests/test_torch_port_sharding_jax_gpt2.py`` (``ZeRO1(mesh,
min_shard_size=8)`` on ``("dp",)``); the optax AdamW state after the JAX
NoShard run's first step carries into ZeRO1's blocks. The parameters stay
whole on every rank, the AdamW moments are held in 1/4 blocks.

JAX is imported inside the tests only: the ranks re-import this module.
"""

import pytest
import torch

from tests import _torch_port_sharding as sh

torch.set_num_threads(2)

KINDS = ("zero1", "zero1_state")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sh.gpt2_against_jax(tmp_path_factory.mktemp("gpt2"), KINDS,
                               carry=("zero1",))


@pytest.mark.parametrize("kind", KINDS)
def test_strategy_matches_jax(runs, kind):
    got, want = runs
    _, trace, last, _ = want[kind]
    sh.check_against(got[kind], trace, last, rtol=1e-5)


def test_optax_state_carries_into_the_blocks(runs):
    got, want = runs
    _, trace, last, _ = want["noshard"]
    sh.check_against(got["zero1_carry"], trace, last, rtol=1e-5, start=1)


@pytest.mark.parametrize("kind", KINDS)
def test_parameters_whole_state_in_quarters(runs, kind):
    got, _ = runs
    held = got[kind][0]["held"]
    assert held["params"]["wte"] == (256, 64)
    # AdamW's two moments on quarter blocks, and a 4-byte step count each
    n_tensors = len(held["params"])
    assert held["opt_bytes"] == 2 * held["param_bytes"] // 4 + 4 * n_tensors
    shapes = {st["exp_avg"] for st in held["opt"].values()}
    assert (64, 64) in shapes                    # wte's block, along dim 0
