"""Checkpoints of a PowerSGD trainer's communication state in the port
(``TrainState.comm_state`` through ``checkpoint/state_dict.py``).

On 4 gloo ranks (rank body ``tests/_torch_port_comm.py::
powersgd_ckpt_rank``), ResNet-18 (CIFAR stem, 8 filters, ``SGD(0.05,
0.9)``, global batch 16) under ``PowerSGD(rank=2, start_iter=1)`` with the
JAX ``Trainer``'s Q carried in (as ``tests/test_torch_port_powersgd.py``
does: each package draws Q from its own generator) takes 3 steps straight
through, and 2 steps, a ``CheckpointManager`` save, a restore into a fresh
trainer built from other weights with its own Q, and 1 more. The resumed
run equals the straight one bit for bit: losses, the model's state, each
leaf's Q and each rank's own error buffer (the buffers differ between
ranks, so a checkpoint that kept one rank's would fail here). The restore
keeps the comm state's tensors in place, and a restore into a live
``AsyncRunner`` replays its programs on the restored buffers: the steps
after it equal the steps after the save. The error buffers are saved as
one tensor over dp. The straight run is ``tests/test_torch_port_powersgd.
py``'s carried run, which that file holds against the JAX trainer's
losses (its compile is not repeated here).
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_comm as rb
from tests import _torch_port_ranks as ranks
from tests.test_torch_port_powersgd import (
    LR,
    MOMENTUM,
    PSGD,
    WIDTH,
    B,
    _flax_to_torch_index,
)

torch.set_num_threads(2)

STEPS, AT = 3, 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from pytorch_distributed_tpu.models import resnet18
    from pytorch_distributed_tpu.parallel import PowerSGD as JaxPowerSGD
    from pytorch_distributed_tpu_torch.models import (
        resnet18 as port_resnet18,
    )
    from pytorch_distributed_tpu_torch.models import (
        resnet_state_dict_from_flax,
    )

    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, B).astype(np.int32))
    flax_model = resnet18(num_classes=10, cifar_stem=True, num_filters=WIDTH)
    init = jax.tree_util.tree_map(
        np.asarray, flax_model.init(jax.random.key(0), batch[0]))
    # the JAX hook's state as its Trainer.init makes it
    comm_state = JaxPowerSGD(**PSGD).init(init["params"], rb.WS)
    index = _flax_to_torch_index(init["params"], port_resnet18(
        10, cifar_stem=True, num_filters=WIDTH, device="cpu"))
    q = {index[int(k)]: np.asarray(v["q"]) for k, v in comm_state.items()}
    store = tmp_path_factory.mktemp("psgd_ckpt")
    ctx = ranks.start(rb.powersgd_ckpt_rank, store, resnet_state_dict_from_flax(
        init["params"], init["batch_stats"]), batch, q, WIDTH, LR, MOMENTUM,
        PSGD, STEPS, AT)
    ranks.finish(ctx, timeout=240)
    return store, rb.load(store, "psgd_ckpt"), q


def assert_same(a, b):
    assert a["losses"] == b["losses"]
    assert a["step"] == b["step"]
    for name, t in b["state"].items():
        assert torch.equal(a["state"][name], t), name
    assert a["comm_state"].keys() == b["comm_state"].keys()
    for k, entry in b["comm_state"].items():
        for key, t in entry.items():
            assert torch.equal(a["comm_state"][k][key], t), (k, key)


def test_resume_is_bit_for_bit(runs):
    _, got, _ = runs
    for g in got:
        assert g["resumed"]["in_place"]
        assert g["resumed"]["restored"]["step"] == AT
        assert_same(g["resumed"], g["straight"])


def test_each_ranks_error_buffer_comes_back(runs):
    _, got, _ = runs
    keys = list(got[0]["straight"]["comm_state"])
    assert keys
    for k in keys:
        restored = [g["resumed"]["restored"]["comm_state"][k]["e"]
                    for g in got]
        assert not torch.equal(restored[0], restored[1])   # per rank
        assert restored[0].abs().max() > 0
        qs = [g["resumed"]["restored"]["comm_state"][k]["q"] for g in got]
        assert all(torch.equal(qs[0], q) for q in qs)


def test_runner_restore_replays_on_the_restored_buffers(runs):
    _, got, _ = runs
    for g in got:
        r = g["runner"]
        assert r["same_programs"]
        assert_same(r["again"], r["first"])
        assert r["losses_before"] + r["first"]["losses"] == \
            g["straight"]["losses"]


def test_saved_as_one_tensor_over_dp(runs):
    """Each leaf's error buffers are saved as one ``[dp * n, m]`` tensor
    (every rank's block), Q once as ``[m, r]``; the straight run started
    from the JAX Q."""
    import torch.distributed.checkpoint as dcp

    store, got, q = runs
    meta = dcp.FileSystemReader(str(store / "psgd_ckpt" / str(AT))
                                ).read_metadata().state_dict_metadata
    first = got[0]["resumed"]["restored"]["comm_state"]
    assert {int(k) for k in first} == set(q)
    for k, entry in first.items():
        n, m = entry["e"].shape
        assert tuple(meta[f"train/comm/{k}/e"].size) == (rb.WS * n, m)
        assert tuple(meta[f"train/comm/{k}/q"].size) == tuple(
            entry["q"].shape) == q[int(k)].shape
