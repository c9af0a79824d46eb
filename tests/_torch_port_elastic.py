"""Shared pieces of the port's checkpoint and elastic tests: the rank body
of the reshard-on-load test, the training worker that the elastic agent
restarts, and helpers to run a launcher. Imports no JAX: every rank and
worker imports this module afresh.
"""

import json
import os
import shutil
import signal
import sys
import threading
import time
from pathlib import Path

import torch

REPO = str(Path(__file__).resolve().parents[1])
TESTS = str(Path(__file__).resolve().parent)


def worker_env(**extra) -> dict:
    """Environment of a worker process: the repo and the tests importable,
    two CPU threads, no card."""
    env = {
        "PYTHONPATH": os.pathsep.join(
            [REPO, TESTS, os.environ.get("PYTHONPATH", "")]),
        "OMP_NUM_THREADS": "2",
        "CUDA_VISIBLE_DEVICES": "",
    }
    env.update(extra)
    return env


def mlp_job(seed=0):
    from _torch_port_sharding import MLP

    return {"model": "mlp",
            "state_dict": {k: v.clone() for k, v in
                           MLP(seed=seed).state_dict().items()}}


def reshard_rank_body(rank, store_dir, ckpt_root):
    """Train the MLP 2 steps under FSDP and under ZeRO1 (4 ranks, blocks of
    every weight), save each at step 2 through a CheckpointManager (FSDP's
    async), and write the whole state rank 0 gathered beside it."""
    from _torch_port_sharding import build, make_strategy, mlp_batch

    from pytorch_distributed_tpu_torch.checkpoint import (
        CheckpointManager,
        get_state_dict,
    )
    from pytorch_distributed_tpu_torch.models import (
        full_optimizer_state,
        full_state_dict,
    )

    torch.set_num_threads(1)
    for kind, async_save in (("fsdp", True), ("zero1", False)):
        trainer, state = build(mlp_job(), make_strategy(kind))
        for i in range(2):
            state, _ = trainer.step(state, mlp_batch(seed=i))
        held = {n: tuple(p.shape) for n, p in trainer.model.named_parameters()}
        with CheckpointManager(f"{ckpt_root}/{kind}",
                               async_save=async_save) as mgr:
            mgr.save(state.step, get_state_dict(trainer, state))
        full = (full_state_dict(trainer.model),
                full_optimizer_state(trainer.optimizer, trainer.model,
                                     trainer.layout))
        if rank == 0:
            torch.save({"params": full[0], "opt": full[1], "held": held,
                        "sharded": [leaf.name for leaf in
                                    trainer.layout.leaves if leaf.sharded]},
                       f"{ckpt_root}/{kind}.whole.pt")


# The training worker of the resume tests: tests/test_elastic_resume.py's
# worker in the port (ResNet-18 CIFAR stem, SGD(0.05, 0.9), batch 8 at
# 32 px), with its weights, SGD momentum and batch copied from a file. It
# saves every step and, in its first incarnation, dies hard after
# committing step ``crash_at``; it appends every step it took to
# ``log_path``.
RESUME_WORKER = """
import json, os, sys
import torch
torch.set_num_threads(2)
import numpy as np
from pytorch_distributed_tpu_torch.checkpoint import (CheckpointManager,
                                                      get_state_dict)
from pytorch_distributed_tpu_torch.elastic import resume_from_checkpoint
from pytorch_distributed_tpu_torch.models import (load_sgd_state_from_optax,
                                                  resnet18)
from pytorch_distributed_tpu_torch.parallel import NoShard
from pytorch_distributed_tpu_torch.trainer import Trainer, classification_loss

ckpt_dir, log_path, weights, crash_at = sys.argv[1:5]
restart = int(os.environ.get("TPURUN_RESTART_COUNT", "0"))
w = torch.load(weights, weights_only=False)
model = resnet18(10, cifar_stem=True, device="cpu", seed=0)
model.load_state_dict(w["state_dict"])
trainer = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.05,
                                         momentum=0.9),
                  NoShard("cpu"), loss_fn=classification_loss)
state = trainer.init()
load_sgd_state_from_optax(trainer.optimizer, model, w["trace"])
x, y = w["x"], w["y"]
restored = resume_from_checkpoint(ckpt_dir, trainer, state)
if restored is not None:
    state = restored
ckpt = CheckpointManager(ckpt_dir, max_to_keep=2)
while state.step < 6:
    state, m = trainer.step(state, (x, y))
    with open(log_path, "a") as f:
        f.write(json.dumps({"step": state.step, "loss": float(m["loss"]),
                            "restart": restart}) + "\\n")
    ckpt.save(state.step, get_state_dict(trainer, state))
    if restart == 0 and state.step == int(crash_at):
        os._exit(7)
ckpt.close()
"""


def read_jsonl(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def committed(ckpt_dir, step) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, str(step), ".metadata"))


def launch(log_dir, run_id, module_args, nproc, kill_after=None):
    """Run ``python -m <module_args>`` as ``nproc`` workers under the
    port's agent (max 1 restart). With ``kill_after=(ckpt_dir, step,
    copy_dir)``: once checkpoint ``step`` is committed, stop every worker
    (SIGSTOP), copy the newest committed checkpoint into ``copy_dir``, and
    SIGKILL worker 0 (the others continue, fail, and are stopped by the
    agent). Returns ``(restart_count, step killed after or None,
    {round: [each rank's last JSON line]})``."""
    from pytorch_distributed_tpu_torch.distributed.store import TCPStore
    from pytorch_distributed_tpu_torch.elastic import (
        DynamicRendezvous,
        LocalElasticAgent,
        WorkerSpec,
    )

    store = TCPStore("127.0.0.1", 0, is_master=True)
    spec = WorkerSpec(cmd=[sys.executable, "-m", *module_args],
                      nproc_per_node=nproc, run_id=run_id, max_restarts=1,
                      log_dir=str(log_dir), extra_env=worker_env())
    agent = LocalElasticAgent(spec, DynamicRendezvous(store, run_id, 1, 1))
    errors = []

    def run():
        try:
            agent.run()
        except Exception as e:           # reported below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    killed_at = None
    if kill_after is not None:
        ckpt_dir, step, copy_dir = kill_after
        deadline = time.monotonic() + 120
        while not committed(ckpt_dir, step):
            assert t.is_alive() and time.monotonic() < deadline, errors
            time.sleep(0.005)
        workers = list(agent.workers)
        for w in workers:
            os.kill(w.proc.pid, signal.SIGSTOP)
        killed_at = max(int(n) for n in os.listdir(ckpt_dir)
                        if n.isdigit() and committed(ckpt_dir, n))
        shutil.copytree(os.path.join(ckpt_dir, str(killed_at)),
                        os.path.join(copy_dir, str(killed_at)))
        os.kill(workers[0].proc.pid, signal.SIGKILL)
        for w in workers[1:]:
            os.kill(w.proc.pid, signal.SIGCONT)
    t.join(timeout=240)
    store.close()
    assert not t.is_alive() and not errors, errors
    rounds = {}
    for rnd in sorted(Path(log_dir, run_id).iterdir()):
        logs = sorted(rnd.glob("worker_*.log"),
                      key=lambda p: int(p.stem.split("_")[1]))
        rounds[int(rnd.name.removeprefix("round"))] = [
            _last_json(p.read_text()) for p in logs]
    return agent.restart_count, killed_at, rounds


def _last_json(text):
    for line in reversed(text.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    return None
