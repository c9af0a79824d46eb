"""The port's sharded strategies against the JAX ones on the test MLP of
``tests/test_sharded_update.py`` (Dense 64, relu, Dense 64, relu, Dense 10
over 8x8x1 images), ``SGD(0.1, momentum=0.9)``, global batch 32 (8 rows a
rank), ``min_shard_size=8``, 3 steps from the weights flax drew: the port
on 4 gloo ranks against the JAX ``Trainer`` on 4 virtual CPU devices under
the same strategy (``FullyShardedDataParallel``, ``ZeRO1`` with and
without ``sharded_update``, ``HybridShard`` on ``(dcn=2, fsdp=2)``), and
FSDP with a clip norm of 1.0.

Limits as the port's DataParallel oracle
(``tests/test_torch_port_cp_trainer.py``): the mean of the ranks' losses
and each rank's grad norm within rtol 1e-5 (1e-4 with clipping, as
``tests/test_parallel.py``), the gathered parameters and momentum within
rtol 1e-4 plus 1e-5, every rank holding the same parameters. The momentum
is held in 1/4 blocks (1/2 under HybridShard), and under FSDP the
parameters too.

JAX is imported inside the tests only: the ranks re-import this module.
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_ranks as ranks
from tests import _torch_port_sharding as sh

torch.set_num_threads(2)

N = ranks.WORLD
STEPS = 3
KINDS = ("fsdp", "zero1", "zero1_state", "hybrid")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mlp")
    batches = [sh.mlp_batch(seed=i) for i in range(STEPS)]
    first, *_ = sh.jax_run("noshard", "mlp", batches[:1])
    base = dict(model="mlp", state_dict=first, batches=batches)
    jobs = [dict(base, tag=k, strategy=k) for k in KINDS]
    jobs.append(dict(base, tag="fsdp_clip", strategy="fsdp", clip=1.0))
    ctx = ranks.start(sh.rank_body, tmp, jobs)
    want = {k: sh.jax_run(k, "mlp", batches) for k in KINDS}
    want["fsdp_clip"] = sh.jax_run("fsdp", "mlp", batches, clip=1.0)
    ranks.finish(ctx)
    got = {job["tag"]: sh.load(tmp, job["tag"], N) for job in jobs}
    return got, want


def _check(results, trace, last, rtol):
    for step, (loss, norm) in enumerate(trace):
        mean = np.mean([res["metrics"]["loss"][step] for res in results])
        np.testing.assert_allclose(mean, loss, rtol=rtol)
        for res in results:
            np.testing.assert_allclose(res["metrics"]["grad_norm"][step],
                                       norm, rtol=rtol)
    for res in results:
        for name, p in res["params"].items():
            assert torch.equal(p, results[0]["params"][name]), name
    for name, p in results[0]["params"].items():
        torch.testing.assert_close(p, last[name], rtol=1e-4, atol=1e-5,
                                   msg=name)


@pytest.mark.parametrize("kind", KINDS + ("fsdp_clip",))
def test_strategy_matches_jax(runs, kind):
    got, want = runs
    _, trace, last, _ = want[kind]
    _check(got[kind], trace, last,
           rtol=1e-4 if kind == "fsdp_clip" else 1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_state_held_in_blocks(runs, kind):
    got, _ = runs
    held = got[kind][0]["held"]
    n = 2 if kind == "hybrid" else 4
    mom = {st["momentum_buffer"] for st in held["opt"].values()}
    # the head's bias [10] divides by 2, not by 4
    head_bias = (10 // n,) if 10 % n == 0 else (10,)
    assert mom == {(64 // n, 64), (64 // n,), (10, 64 // n), head_bias}, mom
    if kind in ("fsdp", "hybrid"):
        assert held["params"]["Dense_1.weight"] == (64 // n, 64)
        assert held["params"]["Dense_2.weight"] == (10, 64 // n)
    else:
        assert held["params"]["Dense_1.weight"] == (64, 64)

