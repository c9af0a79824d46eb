"""``examples/train_resnet_ddp.py --ckpt-dir`` under the port's elastic
agent (BASELINE config #5 on CPU gloo ranks): two ranks of DataParallel
ResNet-18 train 3 epochs of 2 steps, saving every 2 steps; once step 2 is
committed every worker is stopped and rank 0 killed; the agent restarts
the group, which resumes from the newest committed step at that step's
epoch, re-entered at its first batch. With ``--steps-per-epoch`` equal to
``--ckpt-every`` the resume lands on an epoch boundary and sees the
uninterrupted run's batches: its losses equal that run's, bit for bit,
on both ranks."""

from tests import _torch_port_elastic as el

ARGS = ["pytorch_distributed_tpu_torch.examples.train_resnet_ddp",
        "--device", "cpu", "--model", "resnet18", "--dataset", "cifar10",
        "--global-batch", "8", "--steps-per-epoch", "2", "--epochs", "3",
        "--dataset-size", "32", "--ckpt-every", "2", "--log-every", "1",
        "--prefetch", "0"]


def test_killed_worker_resumes_the_uninterrupted_curve(tmp_path):
    _, _, whole = el.launch(tmp_path / "logs", "whole",
                            ARGS + ["--ckpt-dir", str(tmp_path / "w")], 2)
    restarts, k, rounds = el.launch(
        tmp_path / "logs", "killed", ARGS + ["--ckpt-dir",
                                             str(tmp_path / "k")], 2,
        kill_after=(str(tmp_path / "k"), 2, str(tmp_path / "copy")))
    assert restarts == 1 and k in (2, 4)
    assert [r["first_step"] for r in whole[0]] == [1, 1]
    for rank in range(2):
        want = whole[0][rank]["losses"]
        got = rounds[1][rank]
        assert got["resumed_from"] == k and got["first_step"] == k + 1
        assert got["world"] == 2
        assert got["losses"] == want[k:], (rank, got["losses"], want)
    # the end of the run is saved too
    assert el.committed(tmp_path / "k", 6)
