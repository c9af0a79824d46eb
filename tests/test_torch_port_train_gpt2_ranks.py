"""The FSDP twin of ``examples/train_gpt2_fsdp.py`` on 4 gloo ranks.

``examples/train_gpt2.py --device cpu`` at a small size (2 layers, 64
wide, 4 heads, vocab 97, T=32, global batch 8, 3 AdamW steps) gives on
every rank the losses of the one-process run (the mean over the ranks of
their shards' losses; fp32, sums in another order: rtol 1e-5):

* under the ``torchrun`` environment (``env://``: ``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) with ``--dp 2``: the
  mesh ``(dp=2, fsdp=2)``, the batch split 4 ways;
* in a process group its caller made, with ``--dp 1``: ``fsdp=4``.
"""

import socket

import numpy as np
import torch
import torch.multiprocessing as mp

from pytorch_distributed_tpu_torch.examples import train_gpt2
from tests import _torch_port_ranks as ranks

torch.set_num_threads(2)

N = ranks.WORLD
ARGS = ["--device", "cpu", "--layers", "2", "--embd", "64", "--heads", "4",
        "--seq-len", "32", "--vocab", "97", "--global-batch", "8",
        "--dataset-size", "32", "--steps", "3", "--log-every", "100"]


def _launched_rank(rank, port, store):
    import os

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(N), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    torch.save(train_gpt2.main(ARGS + ["--dp", "2"]), f"{store}/rank{rank}.pt")


def _grouped_rank(rank, store):
    torch.save(train_gpt2.main(ARGS), f"{store}/rank{rank}.pt")


def _check(tmp_path, mesh, want):
    for rank in range(N):
        out = torch.load(tmp_path / f"rank{rank}.pt", weights_only=False)
        assert out["world"] == N and out["mesh"] == mesh, out
        assert out["strategy"] == "FullyShardedDataParallel"
        np.testing.assert_allclose(out["losses"], want["losses"], rtol=1e-5)


def test_dp2_under_torchrun_env_matches_one_process(tmp_path):
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.start_processes(_launched_rank, args=(port, str(tmp_path)),
                             nprocs=N, join=False, start_method="spawn")
    want = train_gpt2.main(ARGS)
    assert want["world"] == 1 and len(want["losses"]) == 3
    ranks.finish(ctx, timeout=120)
    _check(tmp_path, {"dp": 2, "fsdp": 2}, want)


def test_fsdp4_in_the_callers_group_matches_one_process(tmp_path):
    ctx = ranks.start(_grouped_rank, tmp_path)
    want = train_gpt2.main(ARGS)
    ranks.finish(ctx)
    _check(tmp_path, {"dp": 1, "fsdp": 4}, want)
