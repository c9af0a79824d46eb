"""The port's elastic launcher (``pytorch_distributed_tpu_torch.elastic``)
against the contract of ``tests/test_elastic.py``: a standalone launch and
its environment, restart after a failure, the error file once retries
run out, two agents forming one world, a scale-up re-rendezvous, the
command line, the rendezvous protocol (late joiners, shutdown, the join
deadline), the health endpoint, and a rendezvous over a FileStore.

Where the reference waits with sleeps, these wait on files or store keys:
a worker that must still be running when a second agent joins writes a
file first, and the second agent joins when it sees it."""

import json
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from tests import _torch_port_elastic as el

from pytorch_distributed_tpu_torch.distributed.store import (
    FileStore,
    HashStore,
    PrefixStore,
    StoreTimeoutError,
    TCPStore,
)
from pytorch_distributed_tpu_torch.elastic import (
    ChildFailedError,
    DynamicRendezvous,
    HealthCheckServer,
    LaunchConfig,
    LocalElasticAgent,
    WorkerSpec,
    elastic_launch,
)
from pytorch_distributed_tpu_torch.elastic.rendezvous import (
    RendezvousClosedError,
)
from pytorch_distributed_tpu_torch.elastic.run import (
    config_from_args,
    get_args_parser,
)
from pytorch_distributed_tpu_torch.elastic.run import main as run_main


def write_script(tmp_path, body: str) -> str:
    p = tmp_path / "worker.py"
    p.write_text(textwrap.dedent(body))
    return str(p)


def wait_for(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)


OK_SCRIPT = """
    import json, os, sys
    out = os.environ["TEST_OUT_DIR"]
    rank = os.environ["RANK"]
    keys = ["RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE",
            "GROUP_RANK", "MASTER_ADDR", "MASTER_PORT", "TPURUN_RUN_ID",
            "TPURUN_RESTART_COUNT", "TPURUN_MAX_RESTARTS"]
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump({k: os.environ[k] for k in keys}, f)
"""


def records(out):
    return {int(json.loads(p.read_text())["RANK"]): json.loads(p.read_text())
            for p in out.glob("rank*.json")}


def run_agents(targets, timeout=90):
    errors = []

    def wrap(fn, *args):
        try:
            fn(*args)
        except Exception as e:          # reported by the assert below
            errors.append(e)

    ts = [threading.Thread(target=wrap, args=t) for t in targets]
    [t.start() for t in ts]
    [t.join(timeout=timeout) for t in ts]
    assert not any(t.is_alive() for t in ts), "an agent did not finish"
    assert not errors, errors


def test_standalone_two_workers_env_contract(tmp_path):
    script = write_script(tmp_path, OK_SCRIPT)
    out = tmp_path / "out"
    out.mkdir()
    cfg = LaunchConfig(nproc_per_node=2, log_dir=str(tmp_path / "logs"),
                       extra_env={"TEST_OUT_DIR": str(out)})
    elastic_launch(cfg, [sys.executable, script])
    recs = records(out)
    assert sorted(recs) == [0, 1]
    for rank, r in recs.items():
        assert r["WORLD_SIZE"] == "2" and r["LOCAL_WORLD_SIZE"] == "2"
        assert r["GROUP_RANK"] == "0" and r["LOCAL_RANK"] == str(rank)
        assert r["TPURUN_RESTART_COUNT"] == "0"
        assert r["MASTER_ADDR"] == "127.0.0.1" and r["MASTER_PORT"].isdigit()


def test_restart_then_succeed(tmp_path):
    script = write_script(tmp_path, """
        import os, sys
        out = os.environ["TEST_OUT_DIR"]
        n = int(os.environ["TPURUN_RESTART_COUNT"])
        with open(f"{out}/attempt{n}_rank{os.environ['RANK']}", "w"):
            pass
        if n == 0:
            sys.exit(13)  # the first round fails
        """)
    out = tmp_path / "out"
    out.mkdir()
    cfg = LaunchConfig(nproc_per_node=2, max_restarts=2,
                       log_dir=str(tmp_path / "logs"),
                       extra_env={"TEST_OUT_DIR": str(out)})
    elastic_launch(cfg, [sys.executable, script])
    names = {p.name for p in out.iterdir()}
    assert {"attempt1_rank0", "attempt1_rank1"} <= names
    assert "attempt0_rank0" in names or "attempt0_rank1" in names


def test_retries_exhausted_error_file(tmp_path):
    script = write_script(tmp_path, """
        from pytorch_distributed_tpu_torch.elastic import record

        @record
        def main():
            raise ValueError("boom from worker")

        main()
        """)
    cfg = LaunchConfig(nproc_per_node=2, max_restarts=1,
                       log_dir=str(tmp_path / "logs"),
                       extra_env=el.worker_env())
    with pytest.raises(ChildFailedError) as ei:
        elastic_launch(cfg, [sys.executable, script])
    assert "boom from worker" in str(ei.value)
    assert len(ei.value.failures) >= 1
    payload = json.loads(Path(ei.value.failures[0].error_file).read_text())
    assert "ValueError" in payload["message"] and "traceback" in payload


def test_two_agents_form_one_world(tmp_path):
    script = write_script(tmp_path, OK_SCRIPT)
    out = tmp_path / "out"
    out.mkdir()
    master = TCPStore("127.0.0.1", 0, is_master=True)

    def agent(node_rank):
        store = master if node_rank == 0 else TCPStore("127.0.0.1",
                                                        master.port)
        rdzv = DynamicRendezvous(PrefixStore("run:multi", store), "multi",
                                 min_nodes=2, max_nodes=2)
        spec = WorkerSpec(cmd=[sys.executable, script], nproc_per_node=2,
                          run_id="multi",
                          log_dir=str(tmp_path / f"logs{node_rank}"),
                          extra_env={"TEST_OUT_DIR": str(out)})
        LocalElasticAgent(spec, rdzv).run()

    run_agents([(agent, 0), (agent, 1)])
    recs = records(out)
    assert sorted(recs) == [0, 1, 2, 3]            # 2 nodes x 2 workers
    assert all(r["WORLD_SIZE"] == "4" for r in recs.values())
    assert {r["GROUP_RANK"] for r in recs.values()} == {"0", "1"}
    master.close()


def test_scale_up_triggers_re_rendezvous(tmp_path):
    """Agent 0 starts alone (min 1); agent 1 joins once agent 0's worker
    runs; agent 0 restarts its group into a 2-node round, and that costs
    no retry (max_restarts 0)."""
    script = write_script(tmp_path, """
        import json, os, time
        out = os.environ["TEST_OUT_DIR"]
        ws = int(os.environ["WORLD_SIZE"])
        if ws == 1:
            open(f"{out}/alone_running", "w").close()
            time.sleep(60)  # until the scale-up stops this group
        with open(f"{out}/final_rank{os.environ['RANK']}.json", "w") as f:
            json.dump({"ws": ws,
                       "restarts": os.environ["TPURUN_RESTART_COUNT"]}, f)
        """)
    out = tmp_path / "out"
    out.mkdir()
    master = TCPStore("127.0.0.1", 0, is_master=True)

    def agent(node):
        if node == 1:
            wait_for(lambda: (out / "alone_running").exists())
        store = master if node == 0 else TCPStore("127.0.0.1", master.port)
        rdzv = DynamicRendezvous(PrefixStore("run:scale", store), "scale",
                                 min_nodes=1, max_nodes=2,
                                 last_call_timeout=0.3)
        spec = WorkerSpec(cmd=[sys.executable, script], nproc_per_node=1,
                          run_id="scale", max_restarts=0,
                          log_dir=str(tmp_path / f"logs{node}"),
                          extra_env={"TEST_OUT_DIR": str(out)})
        LocalElasticAgent(spec, rdzv).run()

    run_agents([(agent, 0), (agent, 1)])
    recs = [json.loads(p.read_text()) for p in out.glob("final_rank*.json")]
    assert len(recs) == 2 and all(r["ws"] == 2 for r in recs)
    assert all(r["restarts"] == "0" for r in recs)
    master.close()


def test_cli_standalone(tmp_path, monkeypatch):
    script = write_script(tmp_path, OK_SCRIPT)
    out = tmp_path / "out"
    out.mkdir()
    monkeypatch.setenv("TEST_OUT_DIR", str(out))
    assert run_main(["--standalone", "--nproc-per-node", "2",
                     "--log-dir", str(tmp_path / "logs"), script]) == 0
    assert len(list(out.glob("rank*.json"))) == 2


def test_cli_no_script():
    assert run_main(["--standalone"]) == 2


def test_cli_nnodes_range_parsing():
    args = get_args_parser().parse_args(
        ["--nnodes", "2:4", "--nproc-per-node", "8", "x.py"])
    cfg = config_from_args(args)
    assert (cfg.min_nodes, cfg.max_nodes, cfg.nproc_per_node) == (2, 4, 8)
    args = get_args_parser().parse_args(
        ["--standalone", "--nnodes", "2:4", "--watchdog-dir", "w",
         "--healthcheck-port", "0", "-m", "pkg.mod", "--device", "cpu"])
    cfg = config_from_args(args)
    assert (cfg.min_nodes, cfg.max_nodes, cfg.rdzv_endpoint) == (1, 1, "")
    assert (cfg.watchdog_dir, cfg.healthcheck_port) == ("w", 0)
    # as torchrun: -m takes the first positional as the module, and the
    # module's own flags pass through
    assert args.module and args.script_and_args == ["pkg.mod", "--device",
                                                    "cpu"]


def _rdzv(store, max_nodes=2, **kw):
    kw.setdefault("last_call_timeout", 0.1)
    kw.setdefault("join_timeout", 10.0)
    return DynamicRendezvous(store, "proto", 1, max_nodes, **kw)


def test_late_joiner_falls_into_next_round():
    store = HashStore()
    a = _rdzv(store, max_nodes=1)
    assert a.next_rendezvous() == (0, 0, 1)
    out = {}
    b = _rdzv(store, max_nodes=2)
    t = threading.Thread(target=lambda: out.update(res=b.next_rendezvous()))
    t.start()
    wait_for(lambda: store.add("rdzv/proto/0/waiting", 0) >= 1)
    assert t.is_alive()                 # waiting for the next round
    a.advance_round()
    t.join(10)
    assert not t.is_alive()
    rnd, rank, _ = out["res"]
    assert rnd == 1 and rank == 0
    a.stop_heartbeat()
    b.stop_heartbeat()


def test_shutdown_closes_run_for_joiners_and_waiters():
    store = HashStore()
    a = _rdzv(store, max_nodes=1)
    a.next_rendezvous()
    b = _rdzv(store, max_nodes=1)
    errs = []

    def waiter():
        try:
            b.next_rendezvous()
        except RendezvousClosedError as e:
            errs.append(e)

    t = threading.Thread(target=waiter)
    t.start()
    wait_for(lambda: store.add("rdzv/proto/0/waiting", 0) >= 1)
    a.shutdown()
    t.join(10)
    assert not t.is_alive() and len(errs) == 1
    with pytest.raises(RendezvousClosedError):    # a fresh joiner fails
        _rdzv(store, max_nodes=4).next_rendezvous()


def test_wait_honors_overall_deadline():
    store = HashStore()
    a = _rdzv(store, max_nodes=1)
    a.next_rendezvous()
    a.stop_heartbeat()
    b = _rdzv(store, max_nodes=1, join_timeout=0.5)
    t0 = time.monotonic()
    with pytest.raises(StoreTimeoutError):
        b.next_rendezvous()
    assert time.monotonic() - t0 < 5.0           # about the join timeout


def test_health_endpoint_liveness_and_staleness():
    srv = HealthCheckServer(lambda: {"state": "HEALTHY"}, stale_after=0.5,
                            host="127.0.0.1").start()
    url = f"http://127.0.0.1:{srv.port}/health"
    try:
        with urllib.request.urlopen(url) as r:
            assert r.status == 200
            body = json.loads(r.read())
        assert body["healthy"] is True and body["state"] == "HEALTHY"

        def stale():
            try:
                urllib.request.urlopen(url)
                return False
            except urllib.error.HTTPError as e:
                assert e.code == 503
                return json.loads(e.read())["healthy"] is False

        wait_for(stale, timeout=10)
        srv.heartbeat()
        with urllib.request.urlopen(url) as r:
            assert r.status == 200
        with srv.blocking_phase("rendezvous"):  # stale, but in a phase
            time.sleep(0.6)
            with urllib.request.urlopen(url) as r:
                assert r.status == 200
                assert json.loads(r.read())["blocking_phase"] == "rendezvous"
        wait_for(stale, timeout=10)
    finally:
        srv.stop()
    with pytest.raises(OSError):
        urllib.request.urlopen(url, timeout=1)


def test_agent_serves_health_during_run(tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    script = write_script(tmp_path, """
        import os, time
        out = os.environ["TEST_OUT_DIR"]
        while not os.path.exists(f"{out}/release"):
            time.sleep(0.02)
        """)
    master = TCPStore("127.0.0.1", 0, 1, is_master=True)
    spec = WorkerSpec(cmd=[sys.executable, script], nproc_per_node=1,
                      run_id="health_t", log_dir=str(tmp_path / "logs"),
                      healthcheck_port=0,
                      extra_env={"TEST_OUT_DIR": str(out)})
    agent = LocalElasticAgent(spec, DynamicRendezvous(master, "health_t",
                                                      1, 1))
    t = threading.Thread(target=agent.run)
    t.start()
    try:
        wait_for(lambda: agent.health_server._httpd is not None)
        url = f"http://127.0.0.1:{agent.health_server.port}/health"

        def serving_one_worker():
            with urllib.request.urlopen(url) as r:
                body = json.loads(r.read())
            assert r.status == 200 and body["healthy"] is True
            assert body["run_id"] == "health_t"
            return body["workers"] == 1

        wait_for(serving_one_worker)
    finally:
        (out / "release").touch()
        t.join(30)
        master.close()
    assert not t.is_alive()
    with pytest.raises(OSError):           # stopped with the agent
        urllib.request.urlopen(url, timeout=1)


def test_dynamic_rendezvous_over_file_store(tmp_path):
    """Two agents rendezvous over one FileStore directory (no network
    coordinator) and complete a 2-node run."""
    script = write_script(tmp_path, """
        import json, os
        out = os.environ["TEST_OUT_DIR"]
        with open(f"{out}/g{os.environ['GROUP_RANK']}", "w") as f:
            json.dump({"world": os.environ["WORLD_SIZE"]}, f)
        """)
    out = tmp_path / "out"
    out.mkdir()

    def agent(node):
        rdzv = DynamicRendezvous(FileStore(str(tmp_path / "rdzv.store")),
                                 "file_rdzv", 2, 2)
        spec = WorkerSpec(cmd=[sys.executable, script], nproc_per_node=1,
                          run_id="file_rdzv",
                          log_dir=str(tmp_path / f"logs{node}"),
                          extra_env={"TEST_OUT_DIR": str(out)})
        LocalElasticAgent(spec, rdzv).run()

    run_agents([(agent, 0), (agent, 1)])
    assert sorted(p.name for p in out.glob("g*")) == ["g0", "g1"]
    assert json.loads((out / "g0").read_text())["world"] == "2"
