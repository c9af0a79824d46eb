"""The port's watchdog timers (``pytorch_distributed_tpu_torch.elastic.
timer``) against ``tests/test_watchdog.py``: arm, expire and release,
nested scopes, the disabled timer, and a worker hung in its "step" that the
agent reaps within a monitor tick of its deadline before restarting the
group."""

import json
import sys
import textwrap
import time
from datetime import timedelta

from tests import _torch_port_elastic as el

from pytorch_distributed_tpu_torch.distributed.store import TCPStore
from pytorch_distributed_tpu_torch.elastic import (
    DynamicRendezvous,
    LocalElasticAgent,
    TimerReaper,
    WorkerSpec,
    WorkerTimer,
)

# the first incarnation hangs "in a step" with a 1 s watchdog armed; the
# restart completes
WORKER = textwrap.dedent("""
    import json, os, sys, time
    from pytorch_distributed_tpu_torch.elastic.timer import WorkerTimer

    out_path = sys.argv[1]
    restart = int(os.environ["TPURUN_RESTART_COUNT"])
    timer = WorkerTimer.from_env()
    assert timer.dir, "the agent did not pass TPURUN_WATCHDOG_DIR"
    with timer.expires(after=1.0):
        if restart == 0:
            time.sleep(120)  # a hung step: the watchdog must reap it
    with open(out_path, "w") as f:
        f.write(json.dumps({"restart": restart}))
""")


def test_arm_expire_release(tmp_path):
    t = WorkerTimer(str(tmp_path), pid=1234)
    reaper = TimerReaper(str(tmp_path))
    with t.expires(after=30):
        assert reaper.expired_pids() == []
        assert reaper.expired_pids(now=time.time() + 60) == [1234]
    assert reaper.expired_pids(now=time.time() + 60) == []   # released


def test_nested_scopes_publish_earliest(tmp_path):
    t = WorkerTimer(str(tmp_path), pid=7)
    reaper = TimerReaper(str(tmp_path))
    with t.expires(after=100):
        with t.expires(after=1):
            assert reaper.expired_pids(now=time.time() + 5) == [7]
        assert reaper.expired_pids(now=time.time() + 5) == []


def test_disabled_is_noop():
    t = WorkerTimer(None)
    with t.expires(after=0.001):
        pass                             # nothing to reap, nothing to crash


def test_hung_worker_reaped_and_group_restarts(tmp_path):
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER)
    out_path = tmp_path / "done.json"
    store = TCPStore("127.0.0.1", 0, 1, is_master=True,
                     timeout=timedelta(seconds=60))
    spec = WorkerSpec(
        cmd=[sys.executable, str(worker_py), str(out_path)],
        nproc_per_node=1, max_restarts=1, run_id="wd",
        log_dir=str(tmp_path / "logs"),
        watchdog_dir=str(tmp_path / "watchdog"), extra_env=el.worker_env())
    t0 = time.time()
    LocalElasticAgent(spec, DynamicRendezvous(store, "wd", 1, 1)).run()
    elapsed = time.time() - t0
    store.close()
    assert json.loads(out_path.read_text())["restart"] == 1
    # reaped far below any store or rendezvous timeout
    assert elapsed < 30, elapsed
