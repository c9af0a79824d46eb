"""The port's eager process-group API (``distributed/process_group.py``,
``batch_ops.py`` and the module API of ``distributed/__init__.py``) on 4
gloo ranks, against the JAX package's ``ProcessGroup`` run in threads over
its own store (``tests/test_process_group.py``'s ``run_ranks``) on the
same inputs.

* ``TestCollectives``' cases: every collective's result equal to the
  reference's (the port's tensors, the reference's numpy arrays);
* the desync wrapper: equal ops pass, object collectives of unequal
  payloads pass, a shape mismatch raises on every rank before the
  collective runs;
* ``batch_isend_irecv`` in a ring, the coalescing manager's one wire op
  per dtype, the module-level collectives, ``new_group``, and
  ``shrink_group`` with rank 1 dead: the survivors' new group sums
  0 + 2 + 3;
* one ``collective`` event (op, bytes, ``duration_ms``) per collective.

In the test process (no ranks): the fake group's identity semantics
against the reference's ``FakeBackend``, the module lifecycle over the
fake backend, the registry, ``TORCH_DISTRIBUTED_DEBUG=DETAIL``, and
``P2POp``'s validation. JAX is imported inside the tests only.
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_comm as rb
from tests import _torch_port_ranks as ranks

torch.set_num_threads(2)

WS = rb.WS
CASES = ("all_reduce_sum", "all_reduce_ops", "broadcast", "all_gather",
         "reduce_to_dst", "scatter", "reduce_scatter", "all_to_all",
         "send_recv", "barrier_and_async", "object_collectives")


def _reference_cases(rank, pg):
    """The same cases on the reference's group (numpy in and out)."""
    from pytorch_distributed_tpu.distributed import ReduceOp

    out = {}
    out["all_reduce_sum"] = pg.all_reduce(np.full(3, float(rank + 1))).result()
    x = np.array([float(rank + 1)])
    out["all_reduce_ops"] = {
        name: float(pg.all_reduce(x, op).result()[0])
        for name, op in (("max", ReduceOp.MAX), ("min", ReduceOp.MIN),
                         ("avg", ReduceOp.AVG), ("prod", ReduceOp.PRODUCT))}
    out["broadcast"] = pg.broadcast(np.full(2, float(rank)), src=2).result()
    out["all_gather"] = pg.all_gather(np.array([rank, rank * 10])).result()
    out["reduce_to_dst"] = pg.reduce(np.array([1.0]), dst=1).result()
    arrs = [np.array([10.0 * r]) for r in range(WS)] if rank == 0 else None
    out["scatter"] = pg.scatter(arrs, src=0).result()
    out["reduce_scatter"] = pg.reduce_scatter(np.arange(8.0)).result()
    out["all_to_all"] = pg.all_to_all(
        [np.array([rank * 10 + c]) for c in range(WS)]).result()
    if rank == 0:
        pg.send(np.array([42.0]), dst=3)
        out["send_recv"] = None
    else:
        out["send_recv"] = pg.recv(src=0) if rank == 3 else None
    w = pg.barrier(async_op=True)
    w.wait()
    out["barrier_and_async"] = w.is_success() and w.is_completed()
    out["object_collectives"] = (
        pg.all_gather_object({"rank": rank, "data": [rank] * 2}),
        pg.broadcast_object("hello" if rank == 0 else None, src=0))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tests.test_process_group import run_ranks

    store = tmp_path_factory.mktemp("pg")
    ctx = ranks.start(rb.pg_rank, store)
    try:
        want = run_ranks(WS, _reference_cases)
    finally:
        ranks.finish(ctx)
    return rb.load(store, "pg"), want


def _same(got, want):
    """A port result (tensors, nested) equals a reference one (arrays)."""
    if want is None or got is None:
        assert got is None and want is None, (got, want)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), want)
    else:
        assert got == want, (got, want)


@pytest.mark.parametrize("case", CASES)
def test_collectives_match_reference(runs, case):
    got, want = runs
    for r in range(WS):
        _same(got[r]["cases"][case], want[r][case])


def test_wrapper_passes_matching_ops_and_objects(runs):
    got, _ = runs
    for out in got:
        np.testing.assert_array_equal(out["wrapper_match"], np.full(3, 4.0))
        objs, bc = out["wrapper_objects"]
        assert [len(o) for o in objs] == [1, 101, 201, 301]
        assert bc == {"big": "B" * 500}


def test_wrapper_detects_shape_mismatch(runs):
    got, _ = runs
    for out in got:
        msg = out["wrapper_mismatch"]
        assert msg is not None and "desync" in msg, msg
        assert "(5,)" in msg and "(3,)" in msg


def test_batch_isend_irecv_ring(runs):
    got, _ = runs
    for rank, out in enumerate(got):
        np.testing.assert_array_equal(out["ring"],
                                      np.full(3, float((rank - 1) % WS)))


def test_coalescing_manager_one_wire_op_per_dtype(runs):
    got, _ = runs
    s = sum(range(WS))
    for out in got:
        n_calls, ra, rb_, rc = out["coalescing"]
        assert n_calls == 2      # float64 (a, b) and float32 (c)
        np.testing.assert_array_equal(ra, np.full((2, 2), float(s)))
        np.testing.assert_array_equal(rb_, np.arange(3.0) * WS + s)
        assert rc.dtype == torch.float32
        np.testing.assert_array_equal(rc, np.full(4, float(s)))


def test_module_api_and_subgroup(runs):
    got, _ = runs
    for rank, out in enumerate(got):
        np.testing.assert_array_equal(out["module_all_reduce"], [4.0, 4.0])
        assert out["rank_size"] == (rank, WS)
        if rank < 2:
            sub_rank, size, total = out["subgroup"]
            assert (sub_rank, size) == (rank, 2)
            np.testing.assert_array_equal(total, [1.0, 1.0])
        else:
            assert out["subgroup"] is None


def test_shrink_group_survivors_recover(runs):
    got, _ = runs
    survivors = [0, 2, 3]
    for rank in survivors:
        new_rank, size, total = got[rank]["shrink"]
        assert (new_rank, size) == (survivors.index(rank), 3)
        assert total == 5.0                  # 0 + 2 + 3
        assert "cannot shrink itself" in got[rank]["shrink_self"]
    assert "shrink" not in got[1]


def test_events_recorded_per_collective(runs):
    got, _ = runs
    evs = got[0]["events"]
    ops = {e["op"] for e in evs}
    assert {"all_reduce", "barrier", "all_gather", "broadcast"} <= ops
    ar = [e for e in evs if e["op"] == "all_reduce"]
    assert all("duration_ms" in e and e["world_size"] in (WS, 2, 3)
               for e in ar)
    assert any(e["nbytes"] == 3 * 4 for e in ar)      # the fp32 [3] sum


# -- in the test process ------------------------------------------------------
def test_fake_backend_identity_semantics():
    from pytorch_distributed_tpu.distributed import FakeBackend as JaxFake
    from pytorch_distributed_tpu.distributed import HashStore as JaxHash
    from pytorch_distributed_tpu.distributed import (
        ProcessGroup as JaxProcessGroup,
    )
    from pytorch_distributed_tpu_torch.distributed import (
        FakeBackend,
        ProcessGroup,
    )

    want = JaxProcessGroup(JaxFake(JaxHash(), rank=2, world_size=8))
    pg = ProcessGroup(FakeBackend(rank=2, world_size=8))
    x = np.arange(8.0)
    np.testing.assert_array_equal(
        pg.all_reduce(torch.tensor(x)).result(), want.all_reduce(x).result())
    assert len(pg.all_gather(torch.tensor(x)).result()) == len(
        want.all_gather(x).result()) == 8
    np.testing.assert_array_equal(pg.reduce_scatter(torch.tensor(x)).result(),
                                  want.reduce_scatter(x).result())
    assert pg.reduce(torch.tensor(x), dst=0).result() is None
    pg.barrier().result()
    assert pg.rank == 2 and pg.world_size == 8
    with pytest.raises(RuntimeError, match="cannot recv"):
        pg.recv(torch.empty(1), src=0)


def test_init_lifecycle_fake():
    from pytorch_distributed_tpu_torch import distributed as pdist

    pg = pdist.init_process_group("fake", store=pdist.HashStore(), rank=0,
                                  world_size=4)
    try:
        assert pdist.is_initialized() and pdist.get_default_group() is pg
        assert pdist.get_rank() == 0 and pdist.get_world_size() == 4
        np.testing.assert_array_equal(pdist.all_reduce(torch.ones(2)),
                                      np.ones(2))
        sub = pdist.new_group([0, 1])          # inherits the fake backend
        assert sub is not None and sub.world_size == 2
        assert isinstance(sub.backend, pdist.FakeBackend)
        assert pdist.new_group([1, 2], backend="fake") is None
        with pytest.raises(RuntimeError):
            pdist.init_process_group("fake", store=pdist.HashStore(), rank=0,
                                     world_size=1)
        shrunk = pdist.shrink_group([3])
        assert (shrunk.rank, shrunk.world_size) == (0, 3)
    finally:
        pdist.destroy_process_group()
    assert not pdist.is_initialized()


def test_plugin_registry_and_unknown_backend():
    from pytorch_distributed_tpu_torch import distributed as pdist

    calls = []

    def creator(store, rank, ws, timeout):
        calls.append((rank, ws))
        return pdist.FakeBackend(store, rank, ws)

    pdist.register_backend("port_testplugin", creator)
    pdist.init_process_group("port_testplugin", store=pdist.HashStore(),
                             rank=1, world_size=3)
    try:
        assert calls == [(1, 3)] and pdist.get_rank() == 1
    finally:
        pdist.destroy_process_group()
    for name in ("fake", "xla", "gloo"):
        with pytest.raises(ValueError, match="already registered"):
            pdist.register_backend(name, creator)
    with pytest.raises(ValueError, match="unknown backend"):
        pdist.init_process_group("gzip", store=pdist.HashStore(), rank=0,
                                 world_size=1)


def test_debug_detail_uses_wrapper(monkeypatch):
    from pytorch_distributed_tpu_torch import distributed as pdist

    monkeypatch.setenv("TORCH_DISTRIBUTED_DEBUG", "DETAIL")
    pdist.init_process_group("fake", store=pdist.HashStore(), rank=0,
                             world_size=1)
    try:
        assert isinstance(pdist.get_default_group(),
                          pdist.ProcessGroupWrapper)
        pdist.all_reduce(torch.ones(2))      # checks through the store
    finally:
        pdist.destroy_process_group()


def test_p2pop_validation():
    from pytorch_distributed_tpu_torch.distributed import P2POp

    with pytest.raises(ValueError, match="isend|irecv"):
        P2POp("send", torch.ones(1), 0)
    with pytest.raises(ValueError, match="needs a tensor"):
        P2POp("isend", None, 0)
