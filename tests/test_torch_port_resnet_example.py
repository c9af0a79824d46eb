"""The port's ResNet entry point and bench twin, on the CPU at a tiny size.

* ``examples.train_resnet_ddp.main`` trains ResNet-18 on synthetic CIFAR-10
  for 2 steps in one process (``NoShard``), with 0 and 2 loader workers,
  and, under the ``torchrun`` environment (``env://``), on 2 gloo ranks
  with ``DataParallel`` and gradient accumulation; the losses are finite.
* ``--data-dir`` (ROADMAP A.8, ported) trains on a JPEG ImageFolder
  tree written by ``data.write_image_folder``, with its class count.
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
    (["--data-dir", "images"], "A.8"),
])
def test_flags_not_ported_raise(flag, item, tmp_path):
    """The flag that raised until its ROADMAP item (A.8) was ported now
    trains: on a 3-class tree of 8 JPEGs a class, with 2 workers."""
    from pytorch_distributed_tpu_torch.data import write_image_folder

    root = tmp_path / flag[1]
    write_image_folder(str(root), n_classes=3, per_class=8, size=(40, 36))
    out = train_resnet_ddp.main(TINY + [flag[0], str(root), "--num-workers",
                                        "2", "--mp-context", "spawn"])
    _check_run(out)
    assert out["data"] == str(root)


_HOOKLESS = {}


@pytest.mark.parametrize("hook", ["allreduce", "bf16_compress",
                                  "fp16_compress", "reduce_scatter",
                                  "ring_allreduce"])
def test_comm_hook_flag_trains_under_data_parallel(hook):
    """``--comm-hook`` runs DataParallel on a one-rank group of the entry
    point's own: the full-precision hooks give the hookless (NoShard)
    losses bit for bit (a mean over one rank is exact, per-rank BN is the
    global batch's), the 16-bit ones differ and stay within 5e-2."""
    if not _HOOKLESS:
        _HOOKLESS.update(train_resnet_ddp.main(TINY))
    out = train_resnet_ddp.main(TINY + ["--comm-hook", hook])
    _check_run(out)
    assert out["comm_hook"] == hook and out["world"] == 1
    if hook.endswith("_compress"):
        assert out["losses"] != _HOOKLESS["losses"]
        assert max(abs(a - b) for a, b in zip(out["losses"],
                                              _HOOKLESS["losses"])) <= 5e-2
    else:
        assert out["losses"] == _HOOKLESS["losses"]


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
