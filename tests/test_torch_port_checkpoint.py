"""The port's checkpoints (``pytorch_distributed_tpu_torch.checkpoint``)
against the contract of ``tests/test_checkpoint.py``: FQN state dicts
(``model/...``, ``optim/...``, ``train/...``) and a missing key, a save/load
round trip, reshard-on-load (FSDP and ZeRO1 on 4 gloo ranks into one
NoShard process), async save, the manager's keep-last-k and resume of the
newest step, an empty directory; plus what the port adds: a restore keeps
every state tensor where it was (so a runner keeps its captured step), and
a save torn between its write and its commit is never returned."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tests import _torch_port_elastic as el
from tests import _torch_port_ranks as ranks
from tests._torch_port_sharding import (
    GPT2_TINY,
    build,
    lm_batches,
    make_strategy,
    mlp_batch,
)

from pytorch_distributed_tpu_torch.amp import GradScaler
from pytorch_distributed_tpu_torch.checkpoint import (
    CheckpointManager,
    async_save_checkpoint,
    get_state_dict,
    load_checkpoint,
    load_params,
    save_checkpoint,
    set_state_dict,
)
from pytorch_distributed_tpu_torch.elastic import reshard_state
from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
from pytorch_distributed_tpu_torch.parallel import NoShard
from pytorch_distributed_tpu_torch.pipeline_exec import AsyncRunner
from pytorch_distributed_tpu_torch.pipeline_exec.runner import _step_tensors
from pytorch_distributed_tpu_torch.trainer import Trainer, lm_loss

torch.set_num_threads(2)


def mlp(seed=0):
    return build(el.mlp_job(seed), make_strategy("noshard"))


def gpt2_scaled(seed=0):
    """GPT-2 tiny, AdamW and a loss scaler (fp32 compute): every kind of
    state the trainer keeps."""
    model = GPT2(GPT2Config(**GPT2_TINY), device="cpu", seed=seed)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    trainer = Trainer(model, opt, NoShard("cpu"), loss_fn=lm_loss,
                      scaler=GradScaler(init_scale=2.0 ** 8))
    return trainer, trainer.init()


def everything(trainer, state):
    return {k: (v.detach().clone() if isinstance(v, torch.Tensor) else v)
            for k, v in get_state_dict(trainer, state).items()}


def assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def test_fqn_round_trip():
    trainer, state = mlp()
    state, _ = trainer.step(state, mlp_batch())
    sd = get_state_dict(trainer, state)
    assert "model/Dense_0.weight" in sd
    assert "optim/Dense_0.weight/momentum_buffer" in sd
    assert int(sd["train/step"]) == 1
    other, other_state = mlp(seed=1)
    got = set_state_dict(other, other_state, sd)
    assert got.step == 1
    assert_same(everything(other, got), everything(trainer, state))


def test_missing_key_raises():
    trainer, state = mlp()
    sd = get_state_dict(trainer, state)
    sd.pop("model/Dense_0.weight")
    with pytest.raises(KeyError):
        set_state_dict(trainer, state, sd)


def test_save_load_round_trip_keeps_every_tensor_in_place(tmp_path):
    """Save after a step; take another; load: every value (parameters,
    AdamW's moments and step counts, the scaler) is the saved one again,
    and no state tensor moved."""
    trainer, state = gpt2_scaled()
    batches = lm_batches(2, 4, seed=0)
    state, _ = trainer.step(state, batches[0])
    save_checkpoint(str(tmp_path / "ck"), get_state_dict(trainer, state))
    want = everything(trainer, state)
    state2, _ = trainer.step(state, batches[1])
    assert state2.step == 2
    ptrs = [t.data_ptr() for t in _step_tensors(trainer, state2)]
    sd = load_checkpoint(str(tmp_path / "ck"),
                         get_state_dict(trainer, state2))
    got_state = set_state_dict(trainer, state2, sd)
    assert got_state.step == 1
    assert [t.data_ptr() for t in _step_tensors(trainer, got_state)] == ptrs
    assert_same(everything(trainer, got_state), want)
    assert not os.path.exists(tmp_path / ".tmp-ck")


def test_restore_keeps_the_runners_captured_step(tmp_path):
    """A restore in place into a live runner: the runner keeps its built
    step, and the steps after the restore equal those after the save."""
    trainer, state = gpt2_scaled()
    batches = lm_batches(4, 4, seed=1)
    runner = AsyncRunner(trainer, depth=2, drain_every=2)
    state, _ = runner.run(state, batches[:2])
    program = runner._program
    with CheckpointManager(str(tmp_path / "ck")) as mgr:
        mgr.save(state.step, get_state_dict(trainer, state))
        state, h_first = runner.run(state, batches[2:])
        state = set_state_dict(trainer, state,
                               mgr.restore(get_state_dict(trainer, state)))
    assert state.step == 2
    state, h_again = runner.run(state, batches[2:])
    assert runner._program is program
    np.testing.assert_array_equal(h_again["loss"], h_first["loss"])


@pytest.fixture(scope="module")
def sharded_checkpoints(tmp_path_factory):
    """FSDP and ZeRO1 checkpoints written by 4 gloo ranks."""
    root = tmp_path_factory.mktemp("reshard")
    ctx = ranks.start(el.reshard_rank_body, root, str(root))
    ranks.finish(ctx, timeout=120)
    return root


@pytest.mark.parametrize("kind", ["fsdp", "zero1"])
def test_reshard_on_load_to_one_rank(sharded_checkpoints, kind):
    """Saved by 4 ranks as blocks (FSDP: the parameters and their AdamW
    state; ZeRO1: the optimizer state), restored whole into one NoShard
    process; then training goes on from step 2."""
    root = sharded_checkpoints
    whole = torch.load(root / f"{kind}.whole.pt", weights_only=False)
    assert whole["sharded"]                   # blocks were really saved
    if kind == "fsdp":
        assert whole["held"]["Dense_1.weight"] == (16, 64)
    trainer, state = mlp(seed=3)
    with CheckpointManager(str(root / kind)) as mgr:
        assert mgr.all_steps() == [2]
        sd = mgr.restore(get_state_dict(trainer, state))
    state = set_state_dict(trainer, state, sd)
    assert state.step == 2
    for name, t in trainer.model.state_dict().items():
        torch.testing.assert_close(t, whole["params"][name], rtol=0, atol=0)
    params = dict(trainer.model.named_parameters())
    for name, st in whole["opt"].items():
        for key, v in st.items():
            torch.testing.assert_close(
                trainer.optimizer.state[params[name]][key], v, rtol=0,
                atol=0)
    state, m = trainer.step(state, mlp_batch(seed=2))
    assert state.step == 3 and np.isfinite(float(m["loss"]))


def test_load_params_reads_the_model_only(sharded_checkpoints):
    root = sharded_checkpoints
    whole = torch.load(root / "fsdp.whole.pt", weights_only=False)
    trainer, _ = mlp(seed=4)
    assert load_params(str(root / "fsdp"), trainer.model) == 2
    for name, t in trainer.model.state_dict().items():
        torch.testing.assert_close(t, whole["params"][name], rtol=0, atol=0)
    assert not any(trainer.optimizer.state[p].get("momentum_buffer", torch.
                                                  zeros(1)).abs().sum()
                   for p in trainer.model.parameters())


def test_async_save(tmp_path):
    trainer, state = gpt2_scaled()
    state, _ = trainer.step(state, lm_batches(1, 4, seed=2)[0])
    want = everything(trainer, state)
    pending = async_save_checkpoint(str(tmp_path / "ck"),
                                    get_state_dict(trainer, state))
    pending.wait_until_finished()
    pending.wait_until_finished()             # idempotent
    fresh, fresh_state = gpt2_scaled(seed=1)
    got = set_state_dict(fresh, fresh_state, load_checkpoint(
        str(tmp_path / "ck"), get_state_dict(fresh, fresh_state)))
    assert_same(everything(fresh, got), want)


@pytest.mark.parametrize("async_save", [False, True])
def test_manager_keep_last_k_and_latest(tmp_path, async_save):
    trainer, state = mlp()
    d = str(tmp_path / "ckpts")
    with CheckpointManager(d, max_to_keep=2, async_save=async_save) as mgr:
        for i in range(4):
            state, _ = trainer.step(state, mlp_batch(seed=i))
            assert mgr.save(state.step, get_state_dict(trainer, state))
        assert not mgr.save(state.step, get_state_dict(trainer, state))
        mgr.wait_until_finished()
        assert mgr.latest_step() == 4
        assert mgr.all_steps() == [3, 4]     # keep-last-2 dropped 1 and 2
        want = everything(trainer, state)
    # a fresh manager (a restart) resumes the newest
    other, other_state = mlp(seed=1)
    with CheckpointManager(d) as mgr2:
        assert mgr2.latest_step() == 4
        got = set_state_dict(other, other_state,
                             mgr2.restore(get_state_dict(other, other_state)))
        assert got.step == 4
        assert_same(everything(other, got), want)
        older = set_state_dict(other, got, mgr2.restore(
            get_state_dict(other, got), step=3))
        assert older.step == 3


def test_restore_empty_raises(tmp_path):
    trainer, state = mlp()
    with CheckpointManager(str(tmp_path / "none")) as mgr:
        assert mgr.latest_step() is None and mgr.all_steps() == []
        with pytest.raises(FileNotFoundError):
            mgr.restore(get_state_dict(trainer, state))


TORN = textwrap.dedent("""
    import os, sys
    import torch
    from pytorch_distributed_tpu_torch.checkpoint import (CheckpointManager,
                                                          get_state_dict, saver)
    from tests import _torch_port_elastic as el
    from tests._torch_port_sharding import build, make_strategy, mlp_batch

    trainer, state = build(el.mlp_job(), make_strategy("noshard"))
    mgr = CheckpointManager(sys.argv[1])
    state, _ = trainer.step(state, mlp_batch())
    mgr.save(state.step, get_state_dict(trainer, state))

    def killed(path):                 # dies between the write and the commit
        os._exit(9)

    saver._commit = killed
    state, _ = trainer.step(state, mlp_batch(seed=1))
    mgr.save(state.step, get_state_dict(trainer, state))
""")


def test_torn_save_is_never_returned(tmp_path):
    d = tmp_path / "ck"
    proc = subprocess.run([sys.executable, "-c", TORN, str(d)],
                          env={**os.environ, **el.worker_env()},
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 9, proc.stderr
    assert (d / ".tmp-2" / ".metadata").exists()   # written, not committed
    trainer, state = mlp(seed=1)
    with CheckpointManager(str(d)) as mgr:
        assert mgr.latest_step() == 1 and mgr.all_steps() == [1]
        got = set_state_dict(trainer, state,
                             mgr.restore(get_state_dict(trainer, state)))
        assert got.step == 1
        # the next save of that step clears the torn one and commits
        state2, _ = trainer.step(got, mlp_batch(seed=1))
        assert mgr.save(state2.step, get_state_dict(trainer, state2))
        assert mgr.all_steps() == [1, 2]
    assert not (d / ".tmp-2").exists()


def test_reshard_state_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="A.16"):
        reshard_state(None, None)
