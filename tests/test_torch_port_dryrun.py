"""The port's dry-run grid (``pytorch_distributed_tpu_torch.dryrun``), the
twin of ``tests/test_dryrun.py``.

Four gloo ranks (``tests/_torch_port_ranks.py``, spawned once for the
file) run ``run_grid(4)``: every mode's shard-shape, collective and
one-rank parity checks, from the parameters the reference's own trainer
draws for that mode. Meanwhile the JAX package's ``MODES[m](4)`` runs on 4
of the 8 virtual CPU devices, as its own tests run it; its exact step
loss (the mode's result rounds it) and its trainer's initial parameters
are read through the reference's ``_finite_loss`` and ``Trainer.init``.
Held: each mode's loss within 1e-5 of the JAX mode's, the same on every
rank, the port's parity within the reference's 1e-3, and the modes the
reference's six.

JAX is imported inside the tests only: the ranks re-import this module.
"""

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch.dryrun import MODES, _mode_fits, run_grid
from tests import _torch_port_ranks as ranks

torch.set_num_threads(2)

WORLD = 4
RTOL = 1e-5


def grid_body(rank, store_dir, weights):
    results = run_grid(WORLD, weights=weights, verbose=False)
    torch.save(results, f"{store_dir}/grid.rank{rank}.pt")


def _jax_weights():
    """Each mode's initial parameters as the port's state dict: the
    reference's one-device twin trainer's init, which draws what the
    mode's parallel trainer draws (``test_ranks_start_from_the_reference_
    parameters`` holds them equal)."""
    import jax
    import optax

    from pytorch_distributed_tpu import dryrun as jdry
    from pytorch_distributed_tpu.models import GPT2, GPT2Config
    from pytorch_distributed_tpu.parallel import (
        GPT2Pipe,
        NoShard,
        PipelineParallel,
    )
    from pytorch_distributed_tpu.trainer import Trainer, lm_loss
    from pytorch_distributed_tpu_torch.models import gpt2_state_dict_from_flax

    base = dict(vocab_size=256, n_positions=64, n_embd=64, n_layer=2,
                n_head=4)
    cases = {
        "fsdp": (GPT2Config(**base), 8, 32),
        "hsdp": (GPT2Config(**base), 8, 32),
        "tp_sp": (GPT2Config(**{**base, "n_positions": 16}), 4, 16),
        "pp": (GPT2Config(**base), 4, 32),
        "cp": (GPT2Config(**{**base, "n_positions": 32}), 2, 32),
        "ep": (GPT2Config(**base, moe_experts=2, moe_top_k=2, moe_every=2),
               8, 16),
    }
    out = {}
    for mode, (cfg, B, T) in cases.items():
        if mode == "pp":
            m1 = jdry._mesh1("dp", "pp")
            tr = Trainer(GPT2Pipe(cfg, m1, dp_axis="dp", n_microbatches=2,
                                  remat=False), optax.adamw(1e-3),
                         PipelineParallel(m1, dp_axis="dp"), loss_fn=lm_loss)
        else:
            tr = Trainer(GPT2(cfg), optax.adamw(1e-3),
                         NoShard(jdry._mesh1()), loss_fn=lm_loss)
        state = tr.init(jax.random.key(0), jdry._lm_batch(256, B=B, T=T))
        out[mode] = gpt2_state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, state.params))
    return out


def _jax_modes():
    """``MODES[m](4)`` of the reference for every mode: its result, its
    exact loss and its parallel trainer's initial parameters."""
    import jax

    from pytorch_distributed_tpu import dryrun as jdry
    from pytorch_distributed_tpu import trainer as jtrainer
    from pytorch_distributed_tpu_torch.models import gpt2_state_dict_from_flax

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        seen = {}
        init, finite = jtrainer.Trainer.init, jdry._finite_loss

        def recording_init(self, *a, **k):
            state = init(self, *a, **k)
            seen.setdefault("params", jax.tree_util.tree_map(np.asarray,
                                                             state.params))
            return state

        def recording_loss(metrics):
            seen["loss"] = finite(metrics)
            return seen["loss"]

        mp.setattr(jtrainer.Trainer, "init", recording_init)
        mp.setattr(jdry, "_finite_loss", recording_loss)
        for mode in jdry.MODES:
            seen.clear()
            (res,) = jdry.run_grid(WORLD, modes=(mode,))
            out[mode] = (res, seen["loss"],
                         gpt2_state_dict_from_flax(seen["params"]))
    return out


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grid")
    weights = _jax_weights()
    ctx = ranks.start(grid_body, tmp, weights)
    want = _jax_modes()
    ranks.finish(ctx, timeout=240)
    got = [torch.load(tmp / f"grid.rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    return weights, got, want


def test_ranks_start_from_the_reference_parameters(grid):
    weights, _, want = grid
    for mode, (_, _, first) in want.items():
        assert weights[mode].keys() == first.keys(), mode
        for name, t in first.items():
            assert torch.equal(weights[mode][name], t), (mode, name)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_grid_mode(grid, mode):
    _, got, want = grid
    res_j, loss_j, _ = want[mode]
    results = [{r["mode"]: r for r in rank}[mode] for rank in got]
    res = results[0]
    assert res["mesh"] == res_j["mesh"]
    assert res["collectives"], res
    assert all(r["loss"] == res["loss"] for r in results)
    assert res["parity_delta"] < 1e-3
    np.testing.assert_allclose(res["loss"], loss_j, rtol=RTOL, atol=0)


def test_grid_covers_all_claimed_families():
    from pytorch_distributed_tpu.dryrun import MODES as JAX_MODES

    assert set(MODES) == set(JAX_MODES) == {"fsdp", "hsdp", "tp_sp", "pp",
                                            "cp", "ep"}


def test_mode_factorizations_and_validation():
    assert [m for m in MODES if _mode_fits(m, 2)] == ["fsdp", "cp"]
    assert all(_mode_fits(m, 4) for m in MODES)
    assert not _mode_fits("ep", 6 - 1)
    with pytest.raises(ValueError, match="every rank of a group"):
        run_grid(WORLD)
