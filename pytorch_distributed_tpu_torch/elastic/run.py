"""The launcher's command line (torch ``distributed/run.py``, torchrun).

Port of ``pytorch_distributed_tpu/elastic/run.py`` (``tpurun``), run as a
module::

    python -m pytorch_distributed_tpu_torch.elastic.run \
        --standalone --nproc-per-node 1 \
        -m pytorch_distributed_tpu_torch.examples.train_resnet_ddp \
        --model resnet50 --dataset imagenet --ckpt-dir ckpt
    python -m pytorch_distributed_tpu_torch.elastic.run --nnodes 2 \
        --node-rank 0 --rdzv-endpoint host0:29400 train.py

Elastic: ``--nnodes MIN:MAX`` enables scale events: agents re-rendezvous
when nodes join or die, restarting the worker group with new RANK /
WORLD_SIZE. Resuming from a checkpoint is the script's job, signalled by
TPURUN_RESTART_COUNT (the port's training entry points do it with
``--ckpt-dir``).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List, Optional

from pytorch_distributed_tpu_torch.elastic.launcher import LaunchConfig, elastic_launch

__all__ = ["get_args_parser", "main"]


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpurun",
        description="Elastic launcher of the PyTorch/CUDA port",
    )
    p.add_argument("--nproc-per-node", "--nproc_per_node", type=int, default=1)
    p.add_argument(
        "--nnodes", type=str, default="1",
        help="N or MIN:MAX (elastic membership range)",
    )
    p.add_argument("--node-rank", "--node_rank", type=int, default=0)
    p.add_argument(
        "--rdzv-endpoint", "--rdzv_endpoint", type=str, default="",
        help="host:port of the rendezvous store (node 0 hosts it)",
    )
    p.add_argument("--rdzv-id", "--rdzv_id", type=str, default="")
    p.add_argument("--max-restarts", "--max_restarts", type=int, default=3)
    p.add_argument(
        "--monitor-interval", "--monitor_interval", type=float, default=0.1
    )
    p.add_argument(
        "--standalone", action="store_true",
        help="single-node: host an ephemeral rendezvous store locally",
    )
    p.add_argument("--log-dir", "--log_dir", type=str,
                   default=os.path.join(tempfile.gettempdir(), "tpurun"))
    p.add_argument(
        "--watchdog-dir", "--watchdog_dir", type=str, default=None,
        help="enable worker watchdog timers (elastic/timer.py): workers "
             "arm deadlines via TPURUN_WATCHDOG_DIR, the agent kills "
             "overrunning workers and restarts the group",
    )
    p.add_argument(
        "--healthcheck-port", "--healthcheck_port", type=int,
        default=None,
        help="serve an agent liveness HTTP endpoint on this port "
             "(0 = pick a free one; torch launcher health-check-server "
             "role) — GET /health returns 200 while the agent "
             "supervises, 503 if its loop wedges",
    )
    p.add_argument(
        "-m", "--module", action="store_true",
        help="run the script as a python module (python -m): the first "
             "positional argument is the module's name, as in torchrun",
    )
    p.add_argument("script_and_args", nargs=argparse.REMAINDER)
    return p


def config_from_args(args) -> LaunchConfig:
    if ":" in args.nnodes:
        lo, hi = args.nnodes.split(":")
        min_nodes, max_nodes = int(lo), int(hi)
    else:
        min_nodes = max_nodes = int(args.nnodes)
    if args.standalone:
        min_nodes = max_nodes = 1
        args.rdzv_endpoint = ""
    return LaunchConfig(
        nproc_per_node=args.nproc_per_node,
        min_nodes=min_nodes,
        max_nodes=max_nodes,
        node_rank=args.node_rank,
        rdzv_endpoint=args.rdzv_endpoint,
        run_id=args.rdzv_id,
        max_restarts=args.max_restarts,
        monitor_interval=args.monitor_interval,
        log_dir=args.log_dir,
        watchdog_dir=args.watchdog_dir,
        healthcheck_port=args.healthcheck_port,
    )


def main(argv: Optional[List[str]] = None) -> int:
    args = get_args_parser().parse_args(argv)
    rest = list(args.script_and_args)
    if rest and rest[0] == "--":
        rest = rest[1:]
    if not rest:
        print("tpurun: no training script given", file=sys.stderr)
        return 2
    cmd = [sys.executable, *(["-m"] if args.module else []), *rest]
    try:
        elastic_launch(config_from_args(args), cmd)
    except Exception as e:
        print(f"tpurun: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
