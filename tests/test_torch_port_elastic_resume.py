"""Elastic restart with checkpoint resume, against ``tests/
test_elastic_resume.py`` and against the JAX package's own numbers.

A ResNet-18 training worker (CIFAR stem, SGD(0.05, momentum 0.9), one
fixed batch of 8 at 32 px, fp32) saves every step and dies hard after
committing step 3 in its first incarnation; the port's agent restarts it,
and the new process resumes from the newest checkpoint for steps 4-6:

* steps 4-6 of the resumed port run equal those of an uninterrupted port
  run bit for bit (the restore puts back every parameter, BatchNorm
  buffer and momentum buffer exactly);
* the same worker in the JAX package (``tests/test_elastic_resume.py``'s
  worker: a ``Trainer`` over ``DataParallel`` on one device, orbax's
  ``CheckpointManager`` and ``elastic.resume_from_checkpoint``), crashed
  after step 3 and resumed in a fresh trainer, gives steps 1-6 within
  ``LOSS_RTOL`` of the port's. Its weights are flax's init, copied into
  the port with ``models.convert`` (``resnet_state_dict_from_flax``,
  ``load_sgd_state_from_optax``). The JAX side runs in this process (no
  worker process imports JAX); the port's workers run meanwhile.

LOSS_RTOL is the port's fp32 ResNet limit against flax
(``tests/test_torch_port_resnet.py``: logits within 1e-5), on the loss,
relative.
"""

import os
import subprocess
import sys
import threading
from datetime import timedelta

import numpy as np

from tests import _torch_port_elastic as el

from pytorch_distributed_tpu_torch.distributed.store import TCPStore
from pytorch_distributed_tpu_torch.elastic import (
    DynamicRendezvous,
    LocalElasticAgent,
    WorkerSpec,
)

LOSS_RTOL = 1e-5
CRASH_AT, STEPS = 3, 6


def _jax_init_and_batch():
    """The reference worker's inputs: flax's init from ``key(0)`` and its
    batch; returns them and the trainer factory."""
    import jax
    import optax

    import pytorch_distributed_tpu as ptd
    from pytorch_distributed_tpu.models import resnet18
    from pytorch_distributed_tpu.parallel import DataParallel
    from pytorch_distributed_tpu.trainer import Trainer, classification_loss

    def make():
        mesh = ptd.init_device_mesh((1,), ("dp",), devices=jax.devices()[:1])
        return Trainer(resnet18(num_classes=10, cifar_stem=True),
                       optax.sgd(0.05, momentum=0.9), DataParallel(mesh),
                       loss_fn=classification_loss)

    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    return make, x, y


def _jax_resumed_losses(ckpt_dir):
    """The reference worker's two incarnations in this process: steps 1-3
    saved every step, a fresh trainer resumed from the newest checkpoint
    for steps 4-6."""
    import jax

    from pytorch_distributed_tpu.checkpoint import CheckpointManager
    from pytorch_distributed_tpu.elastic import resume_from_checkpoint

    make, x, y = _jax_init_and_batch()
    losses = {}
    for incarnation in range(2):
        trainer = make()
        state = trainer.init(jax.random.key(0), (x, y))
        restored = resume_from_checkpoint(
            ckpt_dir, state, shardings=trainer.state_shardings, max_to_keep=2)
        if restored is not None:
            state = restored
        assert (restored is None) == (incarnation == 0)
        ckpt = CheckpointManager(ckpt_dir, max_to_keep=2)
        stop = CRASH_AT if incarnation == 0 else STEPS
        while int(state.step) < stop:
            state, m = trainer.step(state, (x, y))
            losses[int(state.step)] = float(m["loss"])
            ckpt.save(int(state.step), state)
            ckpt.wait_until_finished()
        ckpt.close()
    return losses


def _write_weights(path):
    """flax's init (parameters, BatchNorm statistics, optax's momentum
    trace) and the batch, for the port's worker."""
    import jax
    import torch

    from pytorch_distributed_tpu_torch.models.convert import (
        resnet_state_dict_from_flax,
    )

    make, x, y = _jax_init_and_batch()
    state = make().init(jax.random.key(0), (x, y))
    host = jax.tree_util.tree_map(np.asarray, (
        state.params, state.model_state["batch_stats"],
        state.opt_state[0].trace))
    torch.save({"state_dict": resnet_state_dict_from_flax(host[0], host[1]),
                "trace": host[2], "x": torch.tensor(x),
                "y": torch.tensor(y.astype(np.int64))}, path)


def _port_runs(tmp_path, weights, out):
    """The resumed run under the agent, and an uninterrupted one."""
    worker = tmp_path / "worker.py"
    worker.write_text(el.RESUME_WORKER)
    store = TCPStore("127.0.0.1", 0, 1, is_master=True,
                     timeout=timedelta(seconds=60))
    spec = WorkerSpec(
        cmd=[sys.executable, str(worker), str(tmp_path / "ckpt"),
             str(tmp_path / "resumed.jsonl"), str(weights), str(CRASH_AT)],
        nproc_per_node=1, max_restarts=2, run_id="resume",
        log_dir=str(tmp_path / "logs"), extra_env=el.worker_env())
    agent = LocalElasticAgent(spec, DynamicRendezvous(store, "resume", 1, 1))
    agent.run()
    store.close()
    out["restarts"] = agent.restart_count
    subprocess.run([sys.executable, str(worker), str(tmp_path / "whole"),
                    str(tmp_path / "whole.jsonl"), str(weights), "-1"],
                   env={**os.environ, **el.worker_env()}, check=True,
                   timeout=120)


def test_worker_death_resumes_the_loss_curve(tmp_path):
    weights = tmp_path / "weights.pt"
    _write_weights(weights)
    out, errors = {}, []

    def port():
        try:
            _port_runs(tmp_path, weights, out)
        except Exception as e:           # reported by the assert below
            errors.append(e)

    t = threading.Thread(target=port)
    t.start()
    want = _jax_resumed_losses(str(tmp_path / "jax_ckpt"))
    t.join(timeout=150)
    assert not t.is_alive() and not errors, errors

    steps = el.read_jsonl(tmp_path / "resumed.jsonl")
    first = [s for s in steps if s["restart"] == 0]
    again = [s for s in steps if s["restart"] == 1]
    assert out["restarts"] == 1
    assert [s["step"] for s in first] == [1, 2, 3]
    assert [s["step"] for s in again] == [4, 5, 6]   # continued, not from 0
    whole = {s["step"]: s["loss"] for s in el.read_jsonl(
        tmp_path / "whole.jsonl")}
    assert [s["loss"] for s in steps] == [whole[i] for i in range(1, 7)]
    got = np.array([whole[i] for i in range(1, 7)])
    np.testing.assert_allclose(got, [want[i] for i in range(1, 7)],
                               rtol=LOSS_RTOL, atol=0)
    assert got[-1] < got[0]
