"""The port's ResNet entry point and bench twin, on the CPU at a tiny size.

* ``examples.train_resnet_ddp.main`` trains ResNet-18 on synthetic CIFAR-10
  for 2 steps in one process (``NoShard``), with 0 and 2 loader workers,
  and, under the ``torchrun`` environment (``env://``), on 2 gloo ranks
  with ``DataParallel`` and gradient accumulation; the losses are finite.
* The flags that are not ported raise ``NotImplementedError`` naming their
  ROADMAP items.
* ``bench.main(["--device", "cpu"])`` prints one JSON line with the root
  ``bench.py``'s keys and the smoke metric name.
"""

import json
import math
import socket

import pytest
import torch
import torch.multiprocessing as mp

from pytorch_distributed_tpu_torch import bench
from pytorch_distributed_tpu_torch.examples import train_resnet_ddp
from tests import _torch_port_ranks as ranks

torch.set_num_threads(2)

TINY = ["--device", "cpu", "--model", "resnet18", "--dataset", "cifar10",
        "--global-batch", "8", "--steps-per-epoch", "2", "--dataset-size",
        "32", "--log-every", "1"]


def _check_run(out, world=1):
    assert len(out["losses"]) == 2 and len(out["step_s"]) == 2
    assert all(math.isfinite(x) for x in out["losses"])
    assert out["device"] == "cpu" and out["dtype"] == "float32"
    assert out["world"] == world


@pytest.mark.parametrize("workers", [0, 2])
def test_entry_point_trains_on_the_cpu(workers):
    # spawned workers: a test process may hold threads, which fork breaks
    _check_run(train_resnet_ddp.main(
        TINY + ["--num-workers", str(workers), "--mp-context", "spawn"]))


def _launched_rank(rank, port, store):
    import os

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    out = train_resnet_ddp.main(TINY + ["--grad-accum", "2"])
    torch.save(out, f"{store}/rank{rank}.pt")


def test_entry_point_under_torchrun_env_runs_data_parallel(tmp_path):
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.start_processes(_launched_rank, args=(port, str(tmp_path)),
                             nprocs=2, join=False, start_method="spawn")
    ranks.finish(ctx, timeout=120)
    for rank in range(2):
        _check_run(torch.load(tmp_path / f"rank{rank}.pt"), world=2)


@pytest.mark.parametrize("flag,item", [
    (["--comm-hook", "allreduce"], "A.14"),
    (["--data-dir", "images"], "A.8"),
])
def test_flags_not_ported_raise(flag, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        train_resnet_ddp.main(TINY + flag)


def test_bench_twin_prints_the_smoke_line(capsys):
    bench.main(["--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)
    assert out["metric"] == "resnet50_smoke_bs8_64px_images_per_sec"
    keys = {"metric", "value", "unit", "vs_baseline", "platform",
            "device_kind", "timed_steps", "step_ms_p50", "step_ms_p90",
            "images_per_sec_blocking", "achieved_tflops", "mfu", "mfu_xla",
            "dispatch_ms_per_program", "step_budget", "loss_first",
            "loss_last"}
    assert keys <= set(out)
    assert out["platform"] == "cpu" and out["mfu"] is None
    assert out["value"] > 0 and out["loss_last"] < out["loss_first"]
    if "anomaly" not in out:   # the bench keeps NoShard: no sharded update
        budget = out["step_budget"]
        assert budget["strategy"] == "NoShard"
        assert budget["sharded_update"] is False
        assert budget["programs_per_step"] == 1.0
