"""Span marks inside the runner's step (``observability.spans``) and the
collective counters of a replayed step (``parallel.comm``), on the CPU.

* In a GPT-2 step through ``AsyncRunner`` (the fp32 head, the 16-bit
  ``HeadMatmul`` head, the chunked loss, two microbatches) the marks come
  as ``forward`` holding ``lm_head`` and ``lm_loss``, then ``backward``
  holding their backwards, then ``grad_exchange``, then ``update``; the
  four phases never overlap.
* ``bn_group`` runs 2 x (BatchNorm layers) pairs a step on 2 gloo ranks
  whose BatchNorm takes the group's statistics, and none on one rank.
* ``MetricHistory`` holds a ``span_ms.<name>`` row for each span that
  ran; ``Trainer.step``'s metrics are unchanged.
* Under FULL_SHARD with the runner's clock active, autograd keeps the
  head's weight as FSDP's regather recipe on every head path, never as
  the gathered whole.
* ``spans.cu``'s list of spans is ``spans.SPANS``, and no mark kernel's
  name is one the benchmark's kernel families (``portbench/kernels``)
  claim.
* A program that reports ``captured`` counts its recorded collectives at
  each submit without running its body: N submits count N steps, as N
  eager bodies do.
* On the card (skipped here): the ring's ``span_ms.lm_head`` agrees with
  the device trace's reading of the same marks within 2%.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config, resnet18
from pytorch_distributed_tpu_torch.observability import spans
from pytorch_distributed_tpu_torch.parallel import NoShard
from pytorch_distributed_tpu_torch.pipeline_exec import AsyncRunner
from pytorch_distributed_tpu_torch.trainer import (
    Trainer,
    classification_loss,
    lm_loss,
    make_chunked_lm_loss,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=97, n_positions=32, n_embd=48, n_layer=2, n_head=4)
B, T = 4, 32
PHASES = ("forward", "backward", "grad_exchange", "update")


def _lm_batches(n, seed=0, vocab=TINY["vocab_size"], b=B, t=T):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, vocab, (b, t + 1)).astype(np.int32)
        out.append((tok[:, :-1], tok[:, 1:]))
    return out


def _image_batches(n, b=8, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, 16, 16, 3)).astype(np.float32),
             rng.integers(0, 10, b).astype(np.int32)) for _ in range(n)]


def _gpt2(head_in_fp32=True, loss_fn=lm_loss, accum=1, device="cpu",
          **cfg):
    model = GPT2(GPT2Config(**{**TINY, **cfg}, head_in_fp32=head_in_fp32),
                 device=device, seed=3)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.01,
                            eps=1e-8)
    tr = Trainer(model, opt, NoShard(device), loss_fn=loss_fn,
                 clip_norm=1.0, grad_accum_steps=accum)
    return tr, tr.init()


def _resnet(strategy):
    model = resnet18(10, cifar_stem=True, num_filters=8, device="cpu",
                     seed=4)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    tr = Trainer(model, opt, strategy, loss_fn=classification_loss)
    return tr, tr.init()


def _logging(log):
    """A ``SpanClock.mark`` that also appends ``(name, "b"|"e")``."""
    mark = spans.SpanClock.mark

    def logged(self, name, is_end):
        log.append((name, "e" if is_end else "b"))
        mark(self, name, is_end)
    return logged


@pytest.fixture()
def marks(monkeypatch):
    log = []
    monkeypatch.setattr(spans.SpanClock, "mark", _logging(log))
    return log


def _run(trainer, state, batches, drain_every=None):
    runner = AsyncRunner(trainer, depth=2,
                         drain_every=drain_every or len(batches))
    return runner.run(state, batches)


HEAD = [("lm_head", "b"), ("lm_head", "e")]
LOSS = [("lm_loss", "b"), ("lm_loss", "e")]


def _fwd_bwd(chunked):
    """A microbatch's marks: the head's and the loss's forwards inside the
    forward, their backwards (in reverse) inside the backward."""
    fwd = HEAD + ([] if chunked else LOSS)
    bwd = ([] if chunked else LOSS) + HEAD
    return ([("forward", "b")] + fwd + [("forward", "e"), ("backward", "b")]
            + bwd + [("backward", "e")])


CASES = {
    "fp32_head": (dict(head_in_fp32=True), False, 1),
    "headmatmul": (dict(head_in_fp32=False), False, 1),
    "chunked": (dict(loss_fn=make_chunked_lm_loss(4)), True, 1),
    "accum2": (dict(accum=2), False, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_marks_nest_in_step_order(marks, case):
    kw, chunked, accum = CASES[case]
    trainer, state = _gpt2(**kw)
    _run(trainer, state, _lm_batches(3))
    step = (_fwd_bwd(chunked) * accum
            + [("grad_exchange", "b"), ("grad_exchange", "e"),
               ("update", "b"), ("update", "e")])
    # three warm-up steps and three submitted ones, each the same marks
    assert len(marks) == 6 * len(step)
    assert marks[-len(step):] == step
    assert marks[:len(step)] == step
    open_phases = set()
    for name, kind in marks:
        if name in PHASES:
            if kind == "b":
                assert not open_phases, (name, open_phases)
                open_phases.add(name)
            else:
                assert open_phases == {name}
                open_phases.clear()


def test_history_has_span_rows_and_step_metrics_are_unchanged():
    batches = _lm_batches(4, seed=1)
    trainer, state = _gpt2()
    _, step_metrics = trainer.step(state, batches[0])
    assert set(step_metrics) == {"loss", "grad_norm", "all_finite",
                                 "perplexity"}
    trainer, state = _gpt2()
    _, hist = _run(trainer, state, batches, drain_every=3)
    rows = {k for k in hist.keys() if k.startswith("span_ms.")}
    assert rows == {f"span_ms.{n}" for n in PHASES + ("lm_head", "lm_loss")}
    assert set(hist.keys()) - rows == set(step_metrics)
    for k in rows:
        assert hist[k].shape == (4,) and (hist[k] > 0).all(), k
    # the head and the loss run inside the forward and the backward
    assert (hist["span_ms.lm_head"] + hist["span_ms.lm_loss"]
            < hist["span_ms.forward"] + hist["span_ms.backward"]).all()


def test_one_rank_batchnorm_marks_no_group_span(marks):
    trainer, state = _resnet(NoShard("cpu"))
    _, hist = _run(trainer, state, _image_batches(2))
    assert "bn_group" not in {name for name, _ in marks}
    assert "span_ms.bn_group" not in hist
    assert {name for name, _ in marks} == set(PHASES)


def test_span_lists_of_the_kernel_source_and_python_agree():
    src = (ROOT / "pytorch_distributed_tpu_torch" / "ops" / "csrc"
           / "spans.cu").read_text()
    macro = re.search(r"#define PTD_SPANS\(X\)((?:.*\\\n)*.*)", src).group(1)
    assert tuple(re.findall(r"X\((\w+)\)", macro)) == spans.SPANS
    patterns = [p for f in sorted((ROOT / "portbench" / "kernels").glob(
        "*.json")) for p in json.loads(f.read_text())["patterns"]]
    assert patterns
    for name in spans.SPANS:
        for kind in ("begin", "end"):
            kernel = f"ptd_span_{name}_{kind}"
            assert not any(re.search(p, kernel) for p in patterns), kernel


# -- two gloo ranks: BatchNorm over the group, counters of a replay --------
N_STEPS = 3


class _Replay:
    """A program that reports a capture and runs nothing when called: a
    replay as the host sees it."""

    captured = True

    def __call__(self):
        return None


FSDP_HEADS = {
    # the 16-bit head, cast from fp32 parameters inside tied_head
    "headmatmul": dict(head_in_fp32=False, dtype=torch.bfloat16),
    # the fp32 head over 16-bit parameters
    "fp32_head": dict(head_in_fp32=True, dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16),
    # the chunked loss, which applies the head itself
    "chunked": dict(loss_fn=make_chunked_lm_loss(4)),
}


def _fsdp_head_saves(case, log):
    """The kinds of record FULL_SHARD's pack hook keeps for tensors of the
    whole head weight's shape over two runner steps of a GPT-2 under
    ``FullyShardedDataParallel`` (the runner's clock active)."""
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.parallel import (
        FullyShardedDataParallel,
        fsdp,
    )

    whole = {(TINY["vocab_size"], TINY["n_embd"]),
             (TINY["n_embd"], TINY["vocab_size"])}
    saved, pack = [], fsdp._pack

    def logged(t):
        out = pack(t)
        if tuple(t.shape) in whole:
            saved.append(type(out).__name__)
        return out

    kw = dict(FSDP_HEADS[case])
    loss_fn = kw.pop("loss_fn", lm_loss)
    model = GPT2(GPT2Config(**TINY, **kw), device="cpu", seed=3)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    trainer = Trainer(model, opt, FullyShardedDataParallel(
        init_device_mesh((2,), ("fsdp",)), min_shard_size=8),
        loss_fn=loss_fn)
    state = trainer.init()
    log.clear()
    fsdp._pack = logged
    try:
        _run(trainer, state, _lm_batches(2))
    finally:
        fsdp._pack = pack
    return {"saved": saved, "head_marked": ("lm_head", "e") in log,
            "sharded": getattr(model._parameters["wte"], "fsdp",
                               None) is not None}


def group_body(rank, store_dir):
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.parallel import DataParallel, comm

    log = []
    spans.SpanClock.mark = _logging(log)
    trainer, state = _resnet(DataParallel(init_device_mesh((2,), ("dp",))))
    batches = _image_batches(N_STEPS)
    runner = AsyncRunner(trainer, depth=2, drain_every=N_STEPS)
    runner.start(state, batches[0])
    log.clear()
    comm.reset_counts()
    for b in batches:
        runner.submit(b)
    eager = (dict(comm.counts), dict(comm.wire_bytes))
    state, hist = runner.finish()
    bn_marks = [m for m in log if m[0] == "bn_group"]
    # the same steps as replays of a captured program
    key = next(iter(runner.programs))
    inventory = runner.inventories[key]
    runner.programs[key] = _Replay()
    runner.start(state, batches[0])
    comm.reset_counts()
    for b in batches:
        runner.submit(b)
    replayed = (dict(comm.counts), dict(comm.wire_bytes))
    runner.finish()
    # a capture's collectives are recorded, not counted
    comm.reset_counts()
    with comm.recording(counted=False) as rec:
        comm.all_reduce(torch.ones(3), trainer.strategy.group)
    uncounted = (dict(comm.counts), dict(comm.wire_bytes),
                 [(c.name, c.shape, c.wire) for c in rec])
    torch.save({"bn_marks": bn_marks,
                "n_bn": len(trainer.model.batch_norms()),
                "hist": {k: hist[k] for k in hist.keys()},
                "eager": eager, "replayed": replayed,
                "inventory": [(c.name, c.wire) for c in inventory],
                "uncounted": uncounted,
                "fsdp_heads": {case: _fsdp_head_saves(case, log)
                               for case in FSDP_HEADS}},
               f"{store_dir}/spans{rank}.pt")


@pytest.fixture(scope="module")
def group_ranks(tmp_path_factory):
    # imported here: the card's test run does not need the ranks
    from tests import _torch_port_ranks as ranks

    tmp = tmp_path_factory.mktemp("spans_group")
    ranks.finish(ranks.start(group_body, tmp, world=2), timeout=150)
    return [torch.load(tmp / f"spans{r}.pt", weights_only=False)
            for r in range(2)]


def test_bn_group_pairs_per_step_on_two_ranks(group_ranks):
    for r in group_ranks:
        pairs = 2 * r["n_bn"]          # forward and backward, every layer
        assert r["n_bn"] == 20
        assert len(r["bn_marks"]) == 2 * pairs * N_STEPS
        assert r["bn_marks"] == [("bn_group", "b"), ("bn_group", "e")] * (
            pairs * N_STEPS)
        assert (r["hist"]["span_ms.bn_group"] > 0).all()
        # BatchNorm over the group runs inside the forward and backward
        assert (r["hist"]["span_ms.bn_group"]
                < r["hist"]["span_ms.forward"]
                + r["hist"]["span_ms.backward"]).all()


def test_replays_count_the_recorded_collectives(group_ranks):
    for r in group_ranks:
        eager_counts, eager_wire = r["eager"]
        assert r["replayed"] == r["eager"]
        # DataParallel: one fp32 all-reduce of every gradient a step
        (name, wire), = r["inventory"]
        assert name == "all_reduce"
        assert eager_counts["all_reduce"] == N_STEPS
        assert eager_wire == {"all_reduce.float32": N_STEPS * wire}
        assert wire > 0


def test_a_recording_that_is_not_counted(group_ranks):
    for r in group_ranks:
        counts, wire, rec = r["uncounted"]
        assert counts["all_reduce"] == 0 and wire == {}
        assert rec == [("all_reduce", (3,), 12)]


@pytest.mark.parametrize("case", sorted(FSDP_HEADS))
def test_full_shard_keeps_no_gathered_head_weight(group_ranks, case):
    for r in group_ranks:
        got = r["fsdp_heads"][case]
        assert got["sharded"] and got["head_marked"], got
        # autograd kept the head's weight only as the shard and a recipe
        assert got["saved"] and set(got["saved"]) == {"_Regather"}, got


# -- the card --------------------------------------------------------------
@pytest.mark.gpu
def test_ring_and_trace_read_the_same_head_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from portbench import spans as trace_spans
    from portbench import trace

    device = torch.device("cuda", 0)
    steps = 8
    trainer, state = _gpt2(device=device, vocab_size=50257, n_positions=256,
                           n_embd=256, n_layer=2, n_head=4)
    batches = _lm_batches(steps + 1, vocab=50257, b=8, t=256)
    runner = AsyncRunner(trainer, depth=2, drain_every=steps)
    runner.start(state, batches[0])
    runner.submit(batches[0])
    runner.sync()

    def traced():
        for b in batches[1:]:
            runner.submit(b)
        runner.sync()

    tr = trace.record(traced)
    _, hist = runner.finish()
    ring = float(np.mean(hist["span_ms.lm_head"][1:]))
    read = trace_spans.ms_per_step(tr, ("lm_head",), steps)
    assert read is not None
    assert abs(ring - read) <= 0.02 * read, (ring, read)
