"""Short runs of a one-chip cell on the card: one through the command the
driver runs, and one a planted fault with the timed path broken
underneath, at the cell's own sizes. Skip without an NVIDIA GPU."""

import json
import subprocess
import sys

import pytest

from portbench import faults, manifest


@pytest.mark.gpu
def test_a_cell_runs_correct_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "resnet50.train",
         "--seed", "3000000001", "--seconds", "3", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=360)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"images_per_s", "step_ms_p95",
                                    "peak_mem_gib", "setup_s"}
    assert list(line)[-1] == "checks"
    tail = res.stderr.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)


@pytest.mark.gpu
@pytest.mark.parametrize("plant", sorted(faults.PLANTS))
def test_a_branch_fault_is_not_correct_on_the_card(plant):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from portbench import run as R

    mf, wl, cell, cfg = R.load_cell("resnet50.train")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = R.Run(mf, wl, cell, cfg, 3000000002, 2.0, False, device,
                plant=faults.PLANTS[plant])
    line, checks = R._combine(run, [R.run_rank(run)])
    print(plant, json.dumps(line["checks"]))
    assert line["correct"] is False
    assert checks["late_change_gap"]["value"] > checks["late_change_gap"]["limit"]
