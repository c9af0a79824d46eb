"""What decides ``correct``: the measure, the control and the faults.

The control (the reference in fp8 in the program's place) and every fault
a training cell can have must come out not correct under the cell's own
limits; a sound run of the program must come out correct. Here at small
sizes on the CPU; the readings the limits were set from are the chip's
(``python3 -m portbench.calibrate``, PERF.md).
"""

import dataclasses
import math
import socket
from datetime import timedelta

import pytest
import torch
import torch.multiprocessing as mp

from portbench import faults, judge, run as R
from portbench.tests.tiny import tiny_run

torch.set_num_threads(2)
ONE_CHIP = ["gpt2-125m.train", "resnet50.train"]


def test_leaf_gap_is_taken_against_the_larger_of_leaf_and_median():
    ref = {"a": 1.0, "b": 2.0, "c": 4.0, "tiny": 1e-9}
    prog = {"a": 1.1, "b": 2.0, "c": 4.0, "tiny": 1e-3}
    # tiny's gap is measured against the median leaf (2.0)
    assert judge.leaf_gap(prog, ref) == pytest.approx(0.1 / 1.5)
    assert judge.leaf_gap({**prog, "a": math.nan}, ref) == math.inf
    assert judge.leaf_gap({"a": 1.0}, {"a": 1.0, "z": 1.0}) == math.inf
    assert judge.leaf_gap({"z": 0.0}, {"z": 0.0}) == 0.0


def test_change_leaves_out_gradients_nought_to_rounding():
    ref = {"losses": [1.0], "grad": {"a": 1.0, "b": 1.0, "k": 1e-6},
           "change": {"a": 1.0, "b": 1.0, "k": 1e-9}, "matrices": ["a"]}
    prog = {"losses": [1.0], "grad": dict(ref["grad"]),
            "change": {"a": 1.0, "b": 1.0, "k": 1.0}}
    assert judge.moved_leaves(ref) == ["a", "b"]
    assert judge.gaps(prog, ref)["change_gap"] == 0.0
    frozen = {**prog, "change": {n: 0.0 for n in prog["change"]}}
    assert judge.gaps(frozen, ref)["change_gap"] == 1.0


def test_late_leaves_are_weights_the_first_step_leaves_still():
    # "w" and "s" get no first gradient (a branch behind a zero scale) and
    # move later, too little for change_gap's filter; "s" is a vector
    ref = {"losses": [1.0],
           "grad": {"a": 1.0, "b": 1.0, "w": 0.0, "s": 0.0, "z": 0.0},
           "grad_max": {"a": 1.0, "b": 1.0, "w": 1e-4, "s": 1e-4, "z": 0.0},
           "change": {"a": 1.0, "b": 1.0, "w": 1e-5, "s": 1e-5, "z": 0.0},
           "matrices": ["a", "w", "z"]}
    assert judge.late_leaves(ref) == ["w"]
    prog = {"losses": [1.0], "grad": dict(ref["grad"]),
            "change": {**ref["change"], "w": 0.5e-5, "s": 0.0}}
    got = judge.gaps(prog, ref)
    assert got["change_gap"] == 0.0
    assert got["late_change_gap"] == pytest.approx(0.5)
    assert judge.gaps(ref, {**ref, "matrices": []})["late_change_gap"] == 0.0


def test_verdict_shows_each_number_beside_its_limit():
    ok, checks = judge.verdict({"loss_gap": 0.1, "grad_gap": 0.3},
                               {"loss_gap": 0.2})
    assert ok and checks == {"loss_gap": {"value": 0.1, "limit": 0.2}}
    assert not judge.verdict({"x": math.nan}, {"x": 1.0})[0]


def _correct(run):
    line, _ = R._combine(run, [R.run_rank(run)])
    return line["correct"]


@pytest.mark.parametrize("name", ONE_CHIP)
def test_a_sound_run_is_correct(name):
    assert _correct(tiny_run(name, seconds=0.2))


@pytest.mark.parametrize("name", ONE_CHIP)
def test_the_control_is_not_correct(name):
    run = tiny_run(name)
    ref = R.reference(run)
    numbers = judge.gaps(R.reference(run, "fp8"), ref)
    assert not judge.verdict(numbers, run.cell["limits"])[0], numbers


def _frozen(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, *a, **k: None)
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, *a, **k: None)


def _half_batch(monkeypatch):
    from pytorch_distributed_tpu_torch.parallel import strategies

    place = strategies.ShardingStrategy.place_batch

    def half(self, batch, accum=1):
        return tuple(x[: x.shape[0] // 2] for x in place(self, batch, accum))

    monkeypatch.setattr(strategies.ShardingStrategy, "place_batch", half)


def _loss_altered(monkeypatch):
    from pytorch_distributed_tpu_torch import trainer

    for name in ("lm_loss", "classification_loss"):
        fn = getattr(trainer, name)

        def altered(model, batch, train, fn=fn):
            loss, metrics = fn(model, batch, train)
            return loss * 1.01, metrics

        monkeypatch.setattr(trainer, name, altered)


@pytest.mark.parametrize("fault", [_frozen, _half_batch, _loss_altered],
                         ids=["state_unchanged", "half_batch", "loss_altered"])
@pytest.mark.parametrize("name", ONE_CHIP)
def test_a_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    assert not _correct(tiny_run(name, seconds=0.2))


@pytest.mark.parametrize("plant", sorted(faults.PLANTS))
def test_a_fault_in_a_branch_backward_is_not_correct(plant):
    # each block's last BatchNorm scale starts at 0, so the branch's
    # backward shows only through the second and third checked steps
    run = dataclasses.replace(tiny_run("resnet50.train", seconds=0.2),
                              plant=faults.PLANTS[plant])
    line, checks = R._combine(run, [R.run_rank(run)])
    assert line["correct"] is False
    late = checks["late_change_gap"]
    assert late["value"] > late["limit"], late


def _ddp_rank(rank, world, port, broken, out):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from portbench import program

    if broken:
        from pytorch_distributed_tpu_torch.parallel import strategies

        sync = strategies._Replicas.sync_params

        def local_only(self, model):
            sync(self, model)
            for m in model.modules():
                if hasattr(m, "stats_group"):
                    m.stats_group = None

        strategies._Replicas.sync_params = local_only
        strategies._Replicas.reduce_grads = lambda self, grads: grads
    store = dist.TCPStore("localhost", port, world, rank == 0,
                          timedelta(seconds=120))
    run = tiny_run("resnet50.ddp4", seconds=0.2, rank=rank, world=world,
                   store=store)
    program.init_group(rank, world, store, torch.device("cpu"))
    try:
        parts = R.gather(run, R.run_rank(run))
    finally:
        program.destroy_group()
    if rank == 0:
        out.put(R._combine(run, parts)[0]["correct"])


@pytest.mark.parametrize("broken", [False, True], ids=["sound", "no_exchange"])
def test_the_exchange_left_out_is_not_correct(broken):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_ddp_rank, args=(r, 2, port, broken, out))
             for r in range(2)]
    for p in procs:
        p.start()
    correct = out.get(timeout=300)
    for p in procs:
        p.join(timeout=60)
        assert p.exitcode == 0
    assert correct is (not broken)
