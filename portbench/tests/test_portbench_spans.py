"""The span reader (``portbench/spans.py``) and the metrics that read it,
on synthetic traces."""

import pytest

from portbench import manifest, spans, trace


def _mark(name, kind, at):
    # a mark kernel takes 2 ns here
    return (f"ptd_span_{name}_{kind}", at, at + 2)


def _step(t):
    """One GPT-2-like step from ``t`` (ns): the forward holds the head and
    the loss, the backward their backwards; 100 ns a step."""
    return [
        _mark("forward", "begin", t),
        ("sm90_xmma_gemm_bf16bf16", t + 2, t + 10),
        _mark("lm_head", "begin", t + 10),
        ("sm80_xmma_gemm_f32f32_nn", t + 12, t + 20),
        _mark("lm_head", "end", t + 20),
        _mark("lm_loss", "begin", t + 22),
        ("cunn_SoftMaxForward", t + 24, t + 28),
        _mark("lm_loss", "end", t + 28),
        _mark("forward", "end", t + 30),
        _mark("backward", "begin", t + 32),
        _mark("lm_loss", "begin", t + 34),
        ("cunn_SoftMaxBackward", t + 36, t + 40),
        _mark("lm_loss", "end", t + 40),
        _mark("lm_head", "begin", t + 42),
        ("sm80_xmma_gemm_f32f32_tn", t + 44, t + 60),
        _mark("lm_head", "end", t + 60),
        _mark("backward", "end", t + 70),
        _mark("update", "begin", t + 72),
        ("multi_tensor_apply_kernel", t + 74, t + 90),
        _mark("update", "end", t + 90),
    ]


def _steps(n):
    return trace.Trace([op for i in range(n) for op in _step(100 * i)])


def test_nested_spans_read_their_own_kernels():
    t = _steps(3)
    # lm_head: (20 - 12) + (60 - 44) = 24 ns a step; lm_loss 4 + 4
    assert spans.ms_per_step(t, ("lm_head",), 3) == pytest.approx(24e-6)
    assert spans.ms_per_step(t, ("lm_loss",), 3) == pytest.approx(8e-6)
    assert spans.ms_per_step(t, ("lm_head", "lm_loss"), 3) == pytest.approx(
        32e-6)
    # the forward holds both: from 2 to 30
    assert spans.ms_per_step(t, ("forward",), 3) == pytest.approx(28e-6)
    assert len(spans.pairs(t, "lm_head")) == 6


def test_repeated_spans_sum_over_a_step():
    # bn_group opens and closes 53 times a step (2 x 53 pairs with the
    # backward's), 3 ns of work inside each
    ops, t = [], 0
    for _ in range(2):
        for _ in range(2 * 53):
            ops += [_mark("bn_group", "begin", t),
                    ("reduce_kernel", t + 2, t + 5),
                    _mark("bn_group", "end", t + 5)]
            t += 10
    tr = trace.Trace(ops)
    assert len(spans.pairs(tr, "bn_group")) == 4 * 53
    assert spans.ms_per_step(tr, ("bn_group",), 2) == pytest.approx(
        2 * 53 * 3e-6)


@pytest.mark.parametrize("clip", ["first", "last", "both"])
def test_a_clipped_trace_reads_none(clip):
    ops = _steps(3).device_ops
    if clip in ("first", "both"):
        ops = ops[1:]                 # the first forward's begin is lost
    if clip in ("last", "both"):
        ops = [op for op in ops if op != _mark("update", "end", 290)]
    tr = trace.Trace(ops)
    name = "forward" if clip == "first" else "update"
    assert spans.pairs(tr, name) is None
    assert spans.ms_per_step(tr, (name,), 3) is None
    # the untouched spans still read
    assert spans.ms_per_step(tr, ("lm_head",), 3) == pytest.approx(24e-6)


def test_pairs_not_a_multiple_of_the_steps_read_none():
    t = _steps(3)
    assert spans.ms_per_step(t, ("update",), 2) is None
    assert spans.ms_per_step(t, ("update",), 0) is None


def test_a_program_without_marks_reads_none():
    tr = trace.Trace([("sm80_xmma_gemm_f32f32_nn", 0, 10)])
    assert spans.pairs(tr, "lm_head") is None
    assert spans.ms_per_step(tr, ("lm_head", "lm_loss"), 1) is None


def test_span_marks_belong_to_no_kernel_family():
    families = manifest.kernel_families()
    for name in ("forward", "lm_head", "bn_group", "grad_exchange"):
        for kind in ("begin", "end"):
            assert trace.classify(f"ptd_span_{name}_{kind}", families) is None


@pytest.mark.parametrize("metric,names", [
    ("head_ms_per_step.lm", ("lm_head", "lm_loss")),
    ("update_ms_per_step.lm", ("update",)),
    ("update_ms_per_step.cnn", ("update",)),
    ("grad_exchange_ms_per_step.ddp", ("grad_exchange",)),
    ("bn_group_ms_per_step.ddp", ("bn_group",)),
])
def test_metrics_read_their_spans(metric, names):
    ops = []
    for i in range(4):
        for j, name in enumerate(names):
            t = 100 * i + 20 * j
            ops += [_mark(name, "begin", t), _mark(name, "end", t + 12)]
    ctx = {"trace": trace.Trace(ops), "steps": 4}
    reader = manifest.metric_reader(metric)
    assert reader.read(ctx) == pytest.approx(len(names) * 10e-6)
    assert reader.read({"trace": trace.Trace([]), "steps": 4}) is None
    assert reader.ACROSS_RANKS == ("max" if metric.endswith(".ddp")
                                   else "mean")
