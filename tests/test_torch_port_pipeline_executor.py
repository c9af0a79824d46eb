"""The port's ``EagerPipelineExecutor`` under every schedule, on gloo
ranks, against ``tests/test_pipeline.py``'s references.

The ranks (``tests/_torch_port_ranks.py``, spawned once for the file; rank
body ``executor_body`` in ``tests/_torch_port_pipeline.py``) run each of
the reference tests' cases on the subgroup of its first ``world`` ranks:
the heterogeneous 8 -> 16 -> 4 -> 2 -> 1 stages under gpipe, 1f1b and zb;
interleaved and interleaved_zb at (world, chunks, microbatches) (2, 2,
4), (2, 3, 4), (4, 2, 8); zbv at (2, 4), (3, 6); looped_bfs at (2, 2, 4),
(3, 2, 6), (2, 3, 4); dualpipev at (2, 4), (2, 6), (4, 8); and the twice-
on-one-group case. The JAX side is the reference tests' own: ``jax.grad``
of the whole chain, the mean over the microbatches. Held at the reference
tests' bounds: the loss at rtol 1e-5 on the rank of the last virtual stage,
each virtual stage's gradient at rtol 1e-4 and atol 1e-5 on the rank that
hosts it.
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_pipeline as pph
from tests import _torch_port_ranks as ranks

torch.set_num_threads(2)


def _jax_reference(case):
    import jax
    import jax.numpy as jnp

    cid, _, world, n_chunks, n_micro, seed = case
    ws, mbs, tgts = pph.chain_case(cid.split("-")[0], world, n_chunks,
                                   n_micro, seed)
    ws = [jnp.asarray(w) for w in ws]

    def full_loss(all_w):
        total = 0.0
        for m in range(n_micro):
            h = jnp.asarray(mbs[m])
            for w in all_w:
                h = jnp.tanh(h @ w)
            total = total + jnp.mean((h - jnp.asarray(tgts[m])) ** 2)
        return total / n_micro

    return float(full_loss(ws)), [np.asarray(g) for g in
                                  jax.grad(full_loss)(ws)]


@pytest.fixture(scope="module")
def executor_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("executor")
    ctx = ranks.start(pph.executor_body, root)
    want = {case[0]: _jax_reference(case) for case in pph.EXECUTOR_CASES}
    ranks.finish(ctx, timeout=240)
    got = [torch.load(root / f"executor.rank{r}.pt", weights_only=False)
           for r in range(ranks.WORLD)]
    return got, want


@pytest.mark.parametrize("case", pph.EXECUTOR_CASES, ids=lambda c: c[0])
def test_loss_and_grads_match_jax(executor_runs, case):
    got, want = executor_runs
    cid, schedule, world, n_chunks, _, _ = case
    ref_loss, ref_grads = want[cid]
    last = world * n_chunks - 1
    for rank in range(world):
        r = got[rank][cid]
        assert r["stages"] == pph.placement(schedule, world, n_chunks, rank)
        if last in r["stages"]:
            np.testing.assert_allclose(float(r["loss"]), ref_loss,
                                       rtol=1e-5)
        else:
            assert r["loss"] is None
        for v, g in zip(r["stages"], r["grads"]):
            np.testing.assert_allclose(g.numpy(), ref_grads[v], rtol=1e-4,
                                       atol=1e-5)


def test_runs_twice_same_pg(executor_runs):
    got, _ = executor_runs
    assert [float(x) for x in got[1]["twice"]] == [1.0, 1.0]
    assert got[0]["twice"] == [None, None]


class _PG:
    rank = 0
    world_size = 2


def test_constraints():
    """The reference's refusals, before any message."""
    from pytorch_distributed_tpu_torch.parallel import EagerPipelineExecutor

    with pytest.raises(ValueError, match="interleaved"):
        EagerPipelineExecutor(lambda w, x: x, [torch.zeros(1)] * 2, _PG(),
                              schedule="zb", n_chunks=2)
    with pytest.raises(ValueError, match="n_chunks"):
        EagerPipelineExecutor(lambda w, x: x, torch.zeros(1), _PG(),
                              schedule="interleaved_zb", n_chunks=1)
    with pytest.raises(ValueError, match="n_chunks=2"):
        EagerPipelineExecutor(lambda w, x: x, [torch.zeros(1)] * 3, _PG(),
                              loss_fn=lambda y, t: 0.0,
                              schedule="dualpipev", n_chunks=3)
    with pytest.raises(ValueError, match="need 2 chunk param trees"):
        EagerPipelineExecutor(lambda w, x: x, [torch.zeros(1)] * 3, _PG(),
                              schedule="interleaved", n_chunks=2)
    with pytest.raises(ValueError, match="last stage needs a loss_fn"):
        EagerPipelineExecutor(lambda w, x: x, [torch.zeros(1)] * 2, _PG(),
                              schedule="zbv", n_chunks=2)
    ex = EagerPipelineExecutor(lambda w, x: x, torch.zeros(1), _PG())
    with pytest.raises(ValueError, match="must pass microbatches"):
        ex.run(targets=[torch.zeros(1)])
    with pytest.raises(ValueError, match="tag stride"):
        ex.run(microbatches=[torch.zeros(1)] * 4096)
