"""The port's model averaging (``parallel/averagers.py``) on 4 gloo ranks
against the JAX package's averagers run in threads over its own group
(``tests/test_process_group.py``'s ``run_ranks``), on the same values.

* ``PeriodicModelAverager(period=2, warmup_steps=1)``: steps 1 (warm-up)
  and 2 (the period's offset) keep each rank's own parameters, step 3
  averages and step 4 keeps the average, as the reference's history;
* ``average_parameters``: one all-reduce per dtype (an fp32 and an fp64
  tensor: two), the means equal to the reference's, and a module's
  parameters averaged in place;
* ``EMAAverager`` equal to the JAX EMA, and its decay validated.

JAX is imported inside the tests only.
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_comm as rb
from tests import _torch_port_ranks as ranks

torch.set_num_threads(2)

WS = rb.WS


def _reference(rank, pg):
    import jax

    from pytorch_distributed_tpu.parallel import (
        PeriodicModelAverager,
        average_parameters,
    )

    avg = PeriodicModelAverager(pg, period=2, warmup_steps=1)
    params = {"w": np.full(3, float(rank)), "b": np.float32(rank)}
    hist = []
    for _ in range(4):
        params = jax.tree_util.tree_map(np.asarray, avg.average(params))
        hist.append(params["w"].copy())
    mixed = average_parameters(
        {"a": np.full((2, 2), float(rank), np.float32),
         "b": np.arange(3, dtype=np.float64) + rank}, pg)
    return hist, mixed


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tests.test_process_group import run_ranks

    store = tmp_path_factory.mktemp("averagers")
    ctx = ranks.start(rb.averager_rank, store)
    try:
        want = run_ranks(WS, _reference)
    finally:
        ranks.finish(ctx)
    return rb.load(store, "averager"), want


def test_periodic_averager_matches_reference(runs):
    got, want = runs
    mean_w = np.full(3, np.mean(range(WS)))
    for rank in range(WS):
        hist, ref_hist = got[rank]["hist"], want[rank][0]
        for step, (h, w) in enumerate(zip(hist, ref_hist)):
            np.testing.assert_array_equal(h.numpy(), w)
        np.testing.assert_array_equal(hist[0].numpy(), np.full(3, rank))
        np.testing.assert_array_equal(hist[2].numpy(), mean_w)
        np.testing.assert_array_equal(hist[3].numpy(), mean_w)


def test_average_parameters_one_wire_op_per_dtype(runs):
    got, want = runs
    for rank in range(WS):
        assert got[rank]["calls"] == 2
        for key in ("a", "b"):
            out = got[rank]["mixed"][key]
            np.testing.assert_array_equal(out.numpy(), want[rank][1][key])
            assert out.dtype == (torch.float32 if key == "a"
                                 else torch.float64)


def test_average_parameters_of_a_module_in_place(runs):
    got, _ = runs
    for rank in range(WS):
        for p in got[rank]["module"]:
            np.testing.assert_array_equal(p.numpy(),
                                          np.full(p.shape, 1.5, np.float32))


def test_period_validated():
    from pytorch_distributed_tpu_torch.parallel import PeriodicModelAverager

    with pytest.raises(ValueError, match="period"):
        PeriodicModelAverager(None, period=0)


def test_ema_averager_matches_reference():
    import jax.numpy as jnp

    from pytorch_distributed_tpu.parallel import EMAAverager as JaxEMA
    from pytorch_distributed_tpu_torch.parallel import EMAAverager

    rng = np.random.default_rng(0)
    values = [rng.standard_normal(5).astype(np.float32) for _ in range(4)]
    ema, ref = EMAAverager(decay=0.9), JaxEMA(decay=0.9)
    shadow = ema.init({"w": torch.tensor(values[0])})
    ref_shadow = ref.init({"w": jnp.asarray(values[0])})
    for v in values[1:]:
        shadow = ema.update(shadow, {"w": torch.tensor(v)})
        ref_shadow = ref.update(ref_shadow, {"w": jnp.asarray(v)})
    np.testing.assert_allclose(shadow["w"].numpy(),
                               np.asarray(ref_shadow["w"]), rtol=1e-6)
    half = EMAAverager(decay=0.5)
    s = half.update(half.init({"w": torch.ones(2)}), {"w": torch.zeros(2)})
    np.testing.assert_array_equal(s["w"].numpy(), [0.5, 0.5])
    for bad in (0.0, 1.0, 1.5):
        with pytest.raises(ValueError):
            EMAAverager(decay=bad)
