"""The port's ``observability`` package against the JAX package's, on the
CPU.

Every case of ``tests/test_observability.py`` runs on the JAX module and
on the port's counterpart side by side wherever both see the same input:
the flight recorder's record, complete and dump, the ring's wrap and ids,
the watchdog's dump, ``fr_trace`` of the same entries (and each
package's ``fr_trace`` of the other's dump), ``debug_level`` over the same
raw values (``TPU_DISTRIBUTED_DEBUG`` there, ``TORCH_DISTRIBUTED_DEBUG``
here), ``nan_check``'s raise and pass set, ``IterationLogger``'s sampling,
events, metrics and the logging decorators. Then the port's own:

* a ``ProcessGroup`` on two spawned gloo ranks records ``all_reduce`` and
  ``barrier`` as completed with their bytes, inside ``pg::<op>[<group>]``
  profiler regions that ``trace_op_breakdown`` finds; an ``all_reduce``
  that one rank joins late stalls under the watchdog: its dump exists,
  ``stalled()`` is true and ``fr_trace`` of the dump names it as the hang
  suspect, and it then completes;
* ``annotate`` regions found by ``trace_op_breakdown``;
* ``StepProfiler``'s start after the warm-up, stop after ``n_steps``, and
  close on a raising step;
* ``memory_breakdown``'s exact ``argument_size``, its outputs and their
  aliases.
"""

import json
import time

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch import observability as tobs
from tests import _torch_port_ranks as ranks

torch.set_num_threads(2)

PKGS = ("jax", "torch")


def _obs(pkg):
    if pkg == "jax":
        from pytorch_distributed_tpu import observability as jobs

        return jobs
    return tobs


def test_all_is_the_references():
    assert sorted(tobs.__all__) == sorted(_obs("jax").__all__)
    for name in tobs.__all__:
        assert getattr(tobs, name) is not None


# -- the flight recorder ------------------------------------------------------
@pytest.mark.parametrize("pkg", PKGS)
def test_record_complete_dump(pkg):
    fr = _obs(pkg).FlightRecorder(capacity=16)
    i1 = fr.record("all_reduce", "default", 1024)
    i2 = fr.record("broadcast", "default", 64)
    fr.complete(i1, ok=True)
    fr.complete(i2, ok=False)
    entries = fr.dump()
    assert len(entries) == 2
    by_op = {e["op"]: e for e in entries}
    assert by_op["all_reduce"]["status"] == "completed"
    assert by_op["all_reduce"]["bytes"] == 1024
    assert by_op["broadcast"]["status"] == "failed"
    assert by_op["all_reduce"]["t_done"] >= by_op["all_reduce"]["t_sched"]
    assert set(entries[0]) == {"id", "op", "group", "bytes", "status",
                               "t_sched", "t_done"}
    fr.close()


def test_ring_wraps_with_the_same_ids():
    got = {}
    for pkg in PKGS:
        fr = _obs(pkg).FlightRecorder(capacity=4)
        for i in range(10):
            fr.complete(fr.record(f"op{i}", "g", i))
        got[pkg] = [(e["id"], e["op"], e["bytes"], e["status"])
                    for e in fr.dump()]
        fr.close()
    assert got["torch"] == got["jax"]
    assert [i for i, *_ in got["torch"]] == [6, 7, 8, 9]


@pytest.mark.parametrize("pkg", PKGS)
def test_oldest_inflight_and_watchdog(pkg, tmp_path):
    fr = _obs(pkg).FlightRecorder(capacity=8)
    assert fr.oldest_inflight_age() is None
    fr.record("hung_all_gather", "default", 4096)  # never completed
    time.sleep(0.05)
    assert fr.oldest_inflight_age() >= 0.05
    dump = str(tmp_path / "fr_dump.json")
    fr.start_watchdog(timeout_s=0.2, dump_path=dump, poll_interval_s=0.05)
    assert not fr.stalled()
    time.sleep(0.6)
    assert fr.stalled()
    payload = json.load(open(dump))
    assert payload["entries"][0]["op"] == "hung_all_gather"
    fr.stop_watchdog()
    fr.close()


def _trace_entries(pkg):
    fr = _obs(pkg).FlightRecorder(capacity=32)
    for _ in range(3):
        fr.complete(fr.record("all_reduce", "default", 10))
    fr.record("barrier", "default", 0)  # hang suspect
    entries = fr.dump()
    fr.close()
    return entries


@pytest.mark.parametrize("pkg", PKGS)
def test_fr_trace_analyzer(pkg):
    report = _obs(pkg).fr_trace(_trace_entries(pkg))
    assert report["by_op"] == {"all_reduce": 3, "barrier": 1}
    assert report["hang_suspect"]["op"] == "barrier"
    assert report["latency_avg_s"] is not None


def test_fr_trace_of_the_same_entries_and_of_each_others_dumps(tmp_path):
    entries = _trace_entries("torch")
    assert tobs.fr_trace(entries) == _obs("jax").fr_trace(entries)
    for writer, reader in (("torch", "jax"), ("jax", "torch")):
        fr = _obs(writer).FlightRecorder(capacity=8)
        fr.complete(fr.record("all_reduce", "g", 8))
        fr.record("all_gather", "g", 16)
        path = str(tmp_path / f"{writer}.json")
        fr.dump_to_file(path)
        report = _obs(reader).fr_trace(path)
        assert report == _obs(writer).fr_trace(path)
        assert report["hang_suspect"]["op"] == "all_gather"
        assert report["by_op"] == {"all_reduce": 1, "all_gather": 1}
        fr.close()


def test_capacity_from_torch_fr_buffer_size(monkeypatch):
    monkeypatch.setenv("TORCH_FR_BUFFER_SIZE", "3")
    fr = tobs.FlightRecorder()
    assert fr.capacity == 3
    for i in range(5):
        fr.record(f"op{i}")
    assert [e["id"] for e in fr.dump()] == [2, 3, 4]
    fr.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_pg_records_collectives(pkg):
    """The reference's case on its fake group, and the port's on its
    own: the process-global recorder holds both collectives, completed."""
    if pkg == "jax":
        from pytorch_distributed_tpu.distributed import (
            FakeBackend,
            HashStore,
            ProcessGroup,
        )

        data = np.ones(8)
    else:
        from pytorch_distributed_tpu_torch.distributed import (
            FakeBackend,
            HashStore,
            ProcessGroup,
        )

        data = torch.ones(8, dtype=torch.float64)
    fr = _obs(pkg).get_flight_recorder()
    before = len(fr.dump())
    pg = ProcessGroup(FakeBackend(HashStore(), 0, 2), "frtest")
    pg.all_reduce(data).result()
    pg.barrier().result()
    entries = [e for e in fr.dump() if e["group"] == "frtest"]
    assert {e["op"] for e in entries} >= {"all_reduce", "barrier"}
    assert all(e["status"] == "completed" for e in entries)
    assert len(fr.dump()) >= before + 2
    if pkg == "torch":      # the reference's fake group records 0 bytes
        assert {e["bytes"] for e in entries
                if e["op"] == "all_reduce"} == {64}


# -- logging utils ------------------------------------------------------------
@pytest.mark.parametrize("pkg", PKGS)
def test_events_and_metrics(pkg):
    o = _obs(pkg)
    ev = o.record_event("rendezvous_complete", source="agent", nodes=4)
    assert ev.metadata == {"nodes": 4}
    assert json.loads(ev.serialize())["name"] == "rendezvous_complete"
    o.put_metric("agent.restarts")
    o.put_metric("agent.restarts", 2)
    assert o.get_metrics()["agent.restarts"] >= 3


@pytest.mark.parametrize("pkg", PKGS)
def test_event_handlers(pkg):
    from importlib import import_module

    lu = import_module(f"{_obs(pkg).__name__}.logging_utils")
    seen = []

    def bad(ev):
        raise RuntimeError("a handler that fails is logged, not raised")

    lu.add_event_handler(seen.append)
    lu.add_event_handler(bad)
    try:
        ev = lu.record_event("handled", x=1)
    finally:
        lu._event_handlers.remove(seen.append)
        lu._event_handlers.remove(bad)
    assert seen == [ev]


NAN_CASES = [
    ("clean", lambda m: {"w": m.ones(3)}, None),
    ("nan", lambda m: {"w": m.array([1.0, np.nan])}, "grads[w]"),
    ("inf", lambda m: {"a": m.ones(2), "b": [m.ones(1), m.array([np.inf])]},
     "grads[b/[1]]"),
    ("ints", lambda m: {"i": m.array([1, 2])}, None),
    ("bare", lambda m: m.array([np.nan]), "grads[]"),
]


class _NP:
    ones = staticmethod(np.ones)
    array = staticmethod(np.array)


class _Torch:
    @staticmethod
    def ones(n):
        return torch.ones(n)

    @staticmethod
    def array(x):
        return torch.tensor(x)


@pytest.mark.parametrize("case", [c[0] for c in NAN_CASES])
def test_nan_check_raises_and_passes_alike(case):
    make, want = next((m, w) for c, m, w in NAN_CASES if c == case)
    results = []
    for check, mod in ((_obs("jax").nan_check, _NP),
                       (tobs.nan_check, _NP), (tobs.nan_check, _Torch)):
        try:
            check(make(mod), name="grads")
            results.append(None)
        except FloatingPointError as e:
            results.append(str(e))
    want_msg = None if want is None else f"non-finite values in {want}"
    assert results == [want_msg] * 3


@pytest.mark.parametrize("pkg", PKGS)
def test_iteration_logger(pkg):
    il = _obs(pkg).IterationLogger(sample_rate=2)
    for _ in range(4):
        il.start_iteration()
        il.end_iteration(loss=1.0)
    s = il.summary()
    assert s["iterations"] == 4
    assert s["avg_step_time_s"] >= 0
    assert [x["iteration"] for x in il.samples] == [2, 4]


@pytest.mark.parametrize("raw", [None, "detail", "DETAIL", "info", "Off",
                                 "bogus", ""])
def test_debug_level(monkeypatch, raw):
    for var in ("TPU_DISTRIBUTED_DEBUG", "TORCH_DISTRIBUTED_DEBUG"):
        if raw is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, raw)
    want = _obs("jax").debug_level()
    got = tobs.debug_level()
    assert got.value == want.value
    assert isinstance(got, tobs.DebugLevel)


@pytest.mark.parametrize("pkg", PKGS)
def test_logging_decorators(pkg, monkeypatch, caplog):
    import logging

    o = _obs(pkg)
    var = ("TPU_DISTRIBUTED_DEBUG" if pkg == "jax"
           else "TORCH_DISTRIBUTED_DEBUG")

    @o.exception_logger
    def failing(x, y=1):
        raise ValueError("boom")

    @o.time_logger
    def timed(x):
        return x + 1

    with caplog.at_level(logging.INFO):
        with pytest.raises(ValueError, match="boom"):
            failing(1, y=2)
        assert "failing failed (args=1, kwargs=['y'])" in caplog.text
        monkeypatch.setenv(var, "OFF")
        assert timed(1) == 2
        assert "timed took" not in caplog.text
        monkeypatch.setenv(var, "INFO")
        assert timed(1) == 2
        assert "timed took" in caplog.text


# -- the profiler -------------------------------------------------------------
def test_memory_breakdown():
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_tpu.observability.profiler import (
        memory_breakdown as jax_memory,
    )

    compiled = jax.jit(lambda x: jnp.dot(x, x).sum()).lower(
        jnp.ones((64, 64))).compile()
    want = jax_memory(compiled)
    x = torch.ones(64, 64)
    mb = tobs.memory_breakdown(lambda t: (t @ t).sum(), x)
    assert mb["argument_size"] == want["argument_size"] == 64 * 64 * 4
    assert mb["output_size"] == 4 and mb["alias_size"] == 0
    assert mb["temp_size"] >= 64 * 64 * 4       # the product
    # nested arguments, and outputs that are views of an argument
    y = torch.zeros(10, dtype=torch.float64)
    mb = tobs.memory_breakdown(lambda d: (d["a"][0][:2], d["b"] * 2),
                               {"a": [x], "b": y})
    assert mb["argument_size"] == 64 * 64 * 4 + 80
    assert mb["output_size"] == 2 * 64 * 4 + 80
    assert mb["alias_size"] == 2 * 64 * 4


def test_annotate_regions_in_the_breakdown(tmp_path):
    x = torch.randn(128, 128)
    with tobs.profile_trace(str(tmp_path)):
        for _ in range(3):
            with tobs.annotate("region_a"):
                x = torch.tanh(x @ x)
        with tobs.annotate("region_b"):
            x = x + 1
    bd = tobs.trace_op_breakdown(str(tmp_path))
    assert bd["calls"]["region_a"] == 3 and bd["calls"]["region_b"] == 1
    assert "aten::matmul" not in bd["calls"]    # inside a region
    assert set(bd) >= {"total_ms", "by_type_ms", "top_ops_ms"}
    assert bd["total_ms"] >= bd["by_type_ms"]["region_a"] > 0


def test_step_profiler_start_stop_and_close_on_raise(tmp_path):
    from torch.profiler import record_function

    sp = tobs.StepProfiler(str(tmp_path / "a"), n_steps=3, warmup=2)
    for i in range(7):
        with sp.step():
            with record_function(f"step{i}"):
                torch.randn(32, 32).sum()
    s = sp.summary()
    assert s["steps_captured"] == 3
    assert sorted(s["calls"]) == ["step2", "step3", "step4"]

    sp = tobs.StepProfiler(str(tmp_path / "b"), n_steps=5, warmup=1)
    with pytest.raises(RuntimeError, match="bad step"):
        for i in range(4):
            with sp.step():
                with record_function(f"step{i}"):
                    torch.ones(4).sum()
                if i == 2:
                    raise RuntimeError("bad step")
    s = sp.summary()
    assert s["steps_captured"] == 1            # step1; step2 raised
    assert sorted(s["calls"]) == ["step1", "step2"]
    # a later step starts no second trace
    with sp.step():
        pass
    assert sp.summary() == s


@pytest.mark.parametrize("pkg", PKGS)
def test_step_profiler_summary(pkg, tmp_path):
    """The reference's case: a summary with ``steps_captured`` (or, where
    the trace has nothing to read, its explicit error)."""
    sp = _obs(pkg).StepProfiler(str(tmp_path), n_steps=3, warmup=1)
    if pkg == "jax":
        import jax
        import jax.numpy as jnp

        f = jax.jit(lambda x: jnp.tanh(x @ x))
        x = jnp.ones((128, 128))
    else:
        def f(t):
            return torch.tanh(t @ t)

        x = torch.ones(128, 128)
    for _ in range(4):
        with sp.step():
            x = f(x)
    s = sp.summary()
    assert s is not None
    assert "steps_captured" in s or "error" in s
    if pkg == "torch":
        assert s["steps_captured"] == 3 and s["total_ms"] > 0


# -- a process group on gloo ranks --------------------------------------------
STALL_S = 1.0


def pg_body(rank, store_dir):
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch import distributed as pdist
    from pytorch_distributed_tpu_torch import observability as obs

    pg = pdist.get_default_group()
    fr = obs.get_flight_recorder()
    with obs.profile_trace(f"{store_dir}/trace{rank}"):
        out = pg.all_reduce(torch.full((8,), float(rank + 1))).result()
        pg.barrier().result()
    result = {"sum": out.tolist(), "group": pg.group_name,
              "entries": [e for e in fr.dump()
                          if e["group"] == pg.group_name],
              "breakdown": obs.trace_op_breakdown(f"{store_dir}/trace{rank}"),
              "inflight_before": fr.oldest_inflight_age()}
    # a stalled all_reduce: rank 0 waits under the watchdog until rank 1
    # joins STALL_S later
    dump = f"{store_dir}/stall{rank}.json"
    if rank == 0:
        fr.start_watchdog(timeout_s=0.3, dump_path=dump,
                          poll_interval_s=0.05)
        t0 = time.perf_counter()
        late = pg.all_reduce(torch.ones(4)).result()
        result["stall_s"] = time.perf_counter() - t0
        result["stalled"] = fr.stalled()
        fr.stop_watchdog()
        result["dump"] = obs.fr_trace(dump)
        result["late"] = late.tolist()
        result["after"] = fr.dump()[-1]
    else:
        time.sleep(STALL_S)
        pg.all_reduce(torch.ones(4)).result()
    dist.barrier()
    torch.save(result, f"{store_dir}/pg{rank}.pt")


@pytest.fixture(scope="module")
def pg_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs_pg")
    ctx = ranks.start(pg_body, tmp, world=2)
    ranks.finish(ctx, timeout=120)
    return [torch.load(tmp / f"pg{r}.pt", weights_only=False)
            for r in range(2)]


def test_gloo_group_records_its_collectives(pg_ranks):
    for r in pg_ranks:
        assert r["sum"] == [3.0] * 8
        ops = [(e["op"], e["bytes"], e["status"]) for e in r["entries"]]
        assert ops[:2] == [("all_reduce", 32, "completed"),
                           ("barrier", 0, "completed")]
        assert r["inflight_before"] is None


def test_collectives_are_profiler_regions(pg_ranks):
    for r in pg_ranks:
        calls = r["breakdown"]["calls"]
        name = r["group"]
        assert calls[f"pg::all_reduce[{name}]"] == 1
        assert calls[f"pg::barrier[{name}]"] == 1


def test_stalled_all_reduce_is_the_hang_suspect(pg_ranks):
    r = pg_ranks[0]
    assert r["stalled"] and r["stall_s"] >= STALL_S * 0.5
    suspect = r["dump"]["hang_suspect"]
    assert suspect["op"] == "all_reduce" and suspect["bytes"] == 16
    assert suspect["group"] == r["group"]
    assert [e["op"] for e in r["dump"]["inflight"]] == ["all_reduce"]
    # and then it completed
    assert r["late"] == [2.0] * 4
    assert r["after"]["id"] == suspect["id"]
    assert r["after"]["status"] == "completed"
