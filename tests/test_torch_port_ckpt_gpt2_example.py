"""``examples/train_gpt2.py --ckpt-dir`` under the port's elastic agent:
GPT-2 (2 layers, 64 wide) under FullyShardedDataParallel on two gloo
ranks (every weight held as two blocks), saving every 2 of 6 steps. Once
step 2 is committed every worker is stopped, the newest committed
checkpoint is copied aside, and rank 0 is killed; the agent restarts the
group, which resumes from that step. The JAX script re-enters its data at
the first epoch's first batch on a resume, and so does the port, so the
resumed losses are held against a fresh launch resumed from the copied
checkpoint: equal, bit for bit, with the steps numbered on."""

from tests import _torch_port_elastic as el

ARGS = ["pytorch_distributed_tpu_torch.examples.train_gpt2", "--device",
        "cpu", "--layers", "2", "--embd", "64", "--heads", "4", "--seq-len",
        "32", "--vocab", "97", "--global-batch", "4", "--dataset-size", "8",
        "--steps", "6", "--ckpt-every", "2", "--log-every", "100"]


def test_killed_fsdp_worker_resumes(tmp_path):
    restarts, k, rounds = el.launch(
        tmp_path / "logs", "killed",
        ARGS + ["--ckpt-dir", str(tmp_path / "k")], 2,
        kill_after=(str(tmp_path / "k"), 2, str(tmp_path / "copy")))
    assert restarts == 1 and k in (2, 4)
    _, _, again = el.launch(tmp_path / "logs", "again",
                            ARGS + ["--ckpt-dir", str(tmp_path / "copy")], 2)
    for rank in range(2):
        got, want = rounds[1][rank], again[0][rank]
        assert got["strategy"] == "FullyShardedDataParallel"
        assert got["mesh"] == {"dp": 1, "fsdp": 2}
        assert got["resumed_from"] == want["resumed_from"] == k
        assert got["first_step"] == k + 1
        assert len(got["losses"]) == 6 - k
        assert got["losses"] == want["losses"]
    assert el.committed(tmp_path / "k", 6)
