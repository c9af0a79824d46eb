"""BatchNorm over a stats group (``models.resnet._GroupBatchNorm`` and the
plain versions of ``ops.batch_norm``'s four kernels) on 2 gloo ranks in
fp64, against autograd of the formula the port ran before the kernels,
kept here as the oracle (:func:`_oracle`): the ranks' ``[Σx, Σx², n]``
all-reduced with autograd, flax's variance ``E[x²] − E[x]²`` clamped at 0,
the normalization through broadcasts.

One parametrised test over the cases (C 64 and 256; an odd row count that
differs between the ranks; ranks holding different values; channels whose
variance clamps at 0):

* the forward: ``y``, ``mean``, ``var`` and both running buffers equal the
  oracle's bit for bit (the plain versions are its arithmetic, op for
  op);
* the backward: ``dx``, ``dweight`` and ``dbias`` within 1e-12 of the
  largest element (fp64; the data gradient is the closed form, autograd
  sums the same terms in another order); ``dweight`` and ``dbias`` are the
  rank's own, not the group's;
* the clamp case: at least 8 channels clamp, and there the closed form's
  last term, which autograd of the clamp drops, would move ``dx`` by more
  than 1e-3 of its largest element;
* CPU tensors take the plain versions: each of the four counts one call a
  forward and backward, and no kernel launch is counted.

A second test takes one ``DataParallel`` step of a narrow ResNet-50 (53
BatchNorms) on the 2 ranks: each plain version counts 53 calls.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

WORLD = 2
EPS = 1e-5
MOMENTUM = 0.9
GRAD_TOL = 1e-12
# (C, rank 0's [N, H, W], rank 1's [N, H, W])
CASES = {
    "c64": (64, (2, 4, 4), (2, 4, 4)),
    "c256": (256, (2, 3, 3), (2, 3, 3)),
    "odd_rows": (64, (1, 3, 5), (2, 1, 7)),
    "clamp": (64, (2, 4, 4), (2, 4, 4)),
}
MIN_CLAMPED = 8


class _OracleAllReduceSum(torch.autograd.Function):
    """Sum over ``group``'s ranks; the gradient of every rank's input is the
    sum of the ranks' output gradients."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _oracle(x, weight, bias, eps, group):
    """The port's grouped BatchNorm before the kernels: ``(y, mean, var,
    raw variance)``, differentiable in x, weight and bias."""
    C = x.shape[1]
    dims = (0, 2, 3)
    count = torch.full((1,), x.numel() // C, dtype=x.dtype, device=x.device)
    stats = _OracleAllReduceSum.apply(
        torch.cat([x.sum(dims), (x * x).sum(dims), count]), group)
    n = stats[-1]
    mean = stats[:C] / n
    raw = stats[C:2 * C] / n - mean * mean
    var = torch.clamp(raw, min=0.0)
    shape = (1, C, 1, 1)
    mul = torch.rsqrt(var + eps) * weight
    y = (x - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    return y, mean.detach(), var.detach(), raw.detach()


def _channels_last(g, nhw, C, scale=1.0, shift=0.0):
    n, h, w = nhw
    x = torch.randn(n, h, w, C, generator=g, dtype=torch.float64)
    return (x * scale + shift).permute(0, 3, 1, 2)


def _inputs(case):
    """Both ranks' x and dy (channels_last), and the shared weight and bias.
    Rank r's values have scale 1 + r and shift r / 2. In the clamp case
    every channel starts at 1e6 with a spread of 3e-3, where E[x²] − E[x]²
    is rounding alone, and the channels whose group variance comes out at
    or above 0 are drawn again as plain normals: the rest clamp."""
    C, *shapes = CASES[case]
    g = torch.Generator().manual_seed(list(CASES).index(case))
    xs = [_channels_last(g, nhw, C, 1.0 + r, 0.5 * r)
          for r, nhw in enumerate(shapes)]
    if case == "clamp":
        xs = [_channels_last(g, nhw, C, 3e-3, 1e6) for nhw in shapes]
        dims = (0, 2, 3)
        # the group's sums as gloo adds them: rank 0's plus rank 1's
        s1 = xs[0].sum(dims) + xs[1].sum(dims)
        s2 = (xs[0] * xs[0]).sum(dims) + (xs[1] * xs[1]).sum(dims)
        n = float(sum(x.numel() // C for x in xs))
        mean = s1 / n
        keep = (s2 / n - mean * mean) < 0
        xs = [torch.where(keep.view(1, C, 1, 1), x,
                          _channels_last(g, nhw, C))
              for x, nhw in zip(xs, shapes)]
    dys = [_channels_last(g, nhw, C) for nhw in shapes]
    weight = torch.rand(C, generator=g, dtype=torch.float64) + 0.5
    bias = torch.randn(C, generator=g, dtype=torch.float64)
    return xs, dys, weight, bias


def _case_on_rank(rank, case, group):
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch.models.resnet import (
        BatchNorm,
        _GroupBatchNorm,
    )
    from pytorch_distributed_tpu_torch.ops import batch_norm as bn

    xs, dys, weight, bias = _inputs(case)
    x0, dy = xs[rank], dys[rank]
    C = x0.shape[1]

    def module():
        m = BatchNorm(C, momentum=MOMENTUM, epsilon=EPS,
                      param_dtype=torch.float64, device="cpu")
        with torch.no_grad():
            m.weight.copy_(weight)
            m.bias.copy_(bias)
            m.running_mean.uniform_(-1, 1, generator=torch.Generator()
                                    .manual_seed(7))
            m.running_var.uniform_(0.5, 2, generator=torch.Generator()
                                   .manual_seed(8))
        return m

    # the module under test: counts, outputs, gradients, buffers
    got_m = module()
    got_m.stats_group = group
    x = x0.clone().requires_grad_()
    plain0, launched0 = dict(bn.plain_calls), dict(bn.launches)
    y = got_m(x)
    (y * dy).sum().backward()
    plain = {k: bn.plain_calls[k] - plain0[k] for k in bn.KERNELS}
    launched = {k: bn.launches[k] - launched0[k] for k in bn.KERNELS}
    _, mean, var = _GroupBatchNorm.apply(x0, weight, bias, EPS, group)

    # the oracle: the same module's buffers and parameters, the old formula
    want_m = module()
    xo = x0.clone().requires_grad_()
    wo = want_m.weight.detach().clone().requires_grad_()
    bo = want_m.bias.detach().clone().requires_grad_()
    yo, mo, vo, raw = _oracle(xo, wo, bo, EPS, group)
    (yo * dy).sum().backward()
    with torch.no_grad():
        want_m.running_mean.lerp_(mo, 1 - MOMENTUM)
        want_m.running_var.lerp_(vo, 1 - MOMENTUM)

    # the group's dbias, against which this rank's own must differ
    group_dbias = bo.grad.clone()
    dist.all_reduce(group_dbias, group=group)
    # the closed form without the clamp's mask (from the group's sums)
    stats = bn.bn_stats_reference(x0)
    dist.all_reduce(stats, group=group)
    _, _, sums = bn.bn_bwd_reduce_reference(dy, x0, stats, EPS)
    dist.all_reduce(sums, group=group)
    n, shape = stats[-1], (1, C, 1, 1)
    invstd = torch.rsqrt(vo + EPS)
    dx_unmasked = (weight * invstd).view(shape) * (
        dy - (sums[:C] / n).view(shape) - (x0 - mo.view(shape))
        * (invstd * invstd * sums[C:] / n).view(shape))
    return {
        "plain": plain, "launched": launched,
        "y": (y.detach(), yo.detach()),
        "mean": (mean, mo), "var": (var, vo),
        "running_mean": (got_m.running_mean, want_m.running_mean),
        "running_var": (got_m.running_var, want_m.running_var),
        "dx": (x.grad, xo.grad), "dweight": (got_m.weight.grad, wo.grad),
        "dbias": (got_m.bias.grad, bo.grad), "group_dbias": group_dbias,
        "clamped": int((raw < 0).sum()), "dx_unmasked": dx_unmasked,
    }


def _resnet50_step_on_rank(rank):
    """Plain-version calls of each kernel in one DataParallel step of a
    narrow ResNet-50 (4 filters in the first stage, 16 px, 2 images a
    rank)."""
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.models import resnet50
    from pytorch_distributed_tpu_torch.ops import batch_norm as bn
    from pytorch_distributed_tpu_torch.parallel import DataParallel
    from pytorch_distributed_tpu_torch.trainer import (
        Trainer,
        classification_loss,
    )

    mesh = init_device_mesh((WORLD,), ("dp",))
    model = resnet50(10, num_filters=4, device="cpu", seed=0)
    trainer = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1),
                      DataParallel(mesh, "dp"),
                      loss_fn=classification_loss)
    state = trainer.init()
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((2 * WORLD, 16, 16, 3)).astype(np.float32),
             rng.integers(0, 10, 2 * WORLD).astype(np.int32))
    before = dict(bn.plain_calls)
    trainer.step(state, batch)
    return {"n_bn": len(model.batch_norms()),
            "plain": {k: bn.plain_calls[k] - before[k] for k in bn.KERNELS}}


def _rank(rank, store_dir):
    import torch.distributed as dist

    group = dist.group.WORLD
    out = {case: _case_on_rank(rank, case, group) for case in CASES}
    out["resnet50"] = _resnet50_step_on_rank(rank)
    torch.save(out, f"{store_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    # imported here: the card's test run does not need the ranks
    from tests import _torch_port_ranks as ranks

    tmp = tmp_path_factory.mktemp("group_bn")
    ranks.finish(ranks.start(_rank, tmp, world=WORLD), timeout=150)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _err(got, want) -> float:
    return float((got - want).abs().max() / max(want.abs().max(), 1e-30))


@pytest.mark.parametrize("case", list(CASES))
def test_group_batch_norm_matches_the_autograd_oracle(rank_results, case):
    for rank, results in enumerate(rank_results):
        r = results[case]
        for key in ("y", "mean", "var", "running_mean", "running_var"):
            got, want = r[key]
            assert torch.equal(got, want), (rank, key, _err(got, want))
        for key in ("dx", "dweight", "dbias"):
            got, want = r[key]
            assert _err(got, want) <= GRAD_TOL, (rank, key, _err(got, want))
        # this rank's own parameter gradients: the ranks hold other rows
        assert _err(r["dbias"][0], r["group_dbias"]) > 1e-3
        assert r["plain"] == {"bn_stats": 1, "bn_fwd_elemt": 1,
                              "bn_bwd_reduce": 1, "bn_bwd_elemt": 1}
        assert not any(r["launched"].values())
        if case == "clamp":
            assert r["clamped"] >= MIN_CLAMPED
            assert _err(r["dx_unmasked"], r["dx"][1]) > 1e-3
        else:
            assert r["clamped"] == 0
    if case == "odd_rows":
        rows = [np.prod(nhw) for nhw in CASES[case][1:]]
        assert sum(rows) % 2 == 1 and rows[0] != rows[1]


def test_resnet50_dp_step_calls_each_plain_version_53_times(rank_results):
    for results in rank_results:
        r = results["resnet50"]
        assert r["n_bn"] == 53
        assert r["plain"] == dict.fromkeys(r["plain"], 53)
        assert len(r["plain"]) == 4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("C", [64, 24])
def test_cuda_kernels_match_plain_versions(dtype, C):
    """Each kernel against its plain version on the card, on the same inputs
    (1 ulp of the output type for y and dx, 3e-5 of the sum of absolute
    terms for the sums: the orders of fp32 sums differ); each reduction
    twice on the same input gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from pytorch_distributed_tpu_torch.ops import batch_norm as bn

    g = torch.Generator().manual_seed(C)
    x = (torch.randn(4, 9, 7, C, generator=g) * 2 + 0.5).permute(0, 3, 1, 2)
    dy = torch.randn(4, 9, 7, C, generator=g).permute(0, 3, 1, 2)
    x, dy = x.to("cuda", dtype), dy.to("cuda", dtype)
    weight = (torch.rand(C, generator=g) + 0.5).cuda()
    bias = torch.randn(C, generator=g).cuda()
    ulp = {torch.bfloat16: 2**-7, torch.float16: 2**-10,
           torch.float32: 1e-5}[dtype]
    dims = (0, 2, 3)
    xf, dyf = x.float(), dy.float()

    stats = bn.bn_stats_reference(x)
    got = bn.bn_stats(x)
    assert torch.equal(got, bn.bn_stats(x))
    scale = torch.cat([xf.abs().sum(dims), (xf * xf).sum(dims), torch.ones(
        1, device="cuda")])
    assert ((got - stats).abs() <= 3e-5 * scale).all()

    y, mean, var = bn.bn_fwd_elemt_reference(x, stats, weight, bias, EPS)
    yk, mk, vk = bn.bn_fwd_elemt(x, stats, weight, bias, EPS)
    assert torch.equal(mk, mean) and torch.equal(vk, var)
    yf = y.float()
    assert ((yk.float() - yf).abs()
            <= ulp * yf.abs() + 1e-5 * yf.abs().max()).all()

    dw, db, sums = bn.bn_bwd_reduce_reference(dy, x, stats, EPS)
    dwk, dbk, sumsk = bn.bn_bwd_reduce(dy, x, stats, EPS)
    assert torch.equal(sumsk, bn.bn_bwd_reduce(dy, x, stats, EPS)[2])
    absdyx = (dyf.abs() * (xf - mean.view(1, C, 1, 1)).abs()).sum(dims)
    assert ((sumsk - sums).abs()
            <= 3e-5 * torch.cat([dyf.abs().sum(dims), absdyx])).all()
    assert ((dbk - db).abs() <= 3e-5 * dyf.abs().sum(dims)).all()
    assert ((dwk - dw).abs()
            <= 3e-5 * absdyx * torch.rsqrt(var + EPS)).all()

    dx = bn.bn_bwd_elemt_reference(dy, x, stats, weight, sums, EPS).float()
    dxk = bn.bn_bwd_elemt(dy, x, stats, weight, sums, EPS).float()
    assert ((dxk - dx).abs() <= ulp * dx.abs() + 1e-5 * dx.abs().max()).all()
    with pytest.raises(ValueError):
        bn.bn_stats(x.contiguous())


@pytest.mark.parametrize("dtype,C,offset", [
    (torch.float16, 20, 0), (torch.bfloat16, 12, 0), (torch.float32, 6, 0),
    (torch.bfloat16, 64, 1)], ids=["float16_C20", "bfloat16_C12",
                                   "float32_C6", "bfloat16_offset"])
def test_kernels_refuse_rows_that_are_not_16_byte_aligned(dtype, C, offset):
    """A thread of the kernels loads 16 bytes of a row, so the wrappers
    refuse a channel count that is no multiple of ``16 / element size``
    and data that does not start 16-byte aligned, before any launch."""
    from pytorch_distributed_tpu_torch.ops import batch_norm as bn

    flat = torch.zeros(2 * 3 * 3 * C + offset, dtype=dtype)
    x = flat[offset:].view(2, 3, 3, C).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    before = dict(bn.launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        bn._plan("bn_stats", x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        bn._plan("bn_bwd_elemt", x.new_zeros(x.shape).contiguous(
            memory_format=torch.channels_last) if offset else x, x)
    assert bn.launches == before


def test_chip_smoke_times_every_batch_norm_shape_of_resnet50():
    """``chip_smoke.py``'s ``RESNET50_BN_SHAPES`` (C, H = W, layers) are the
    shapes the 53 BatchNorms of ResNet-50 see at 224 px."""
    import ast
    import collections
    from pathlib import Path

    from pytorch_distributed_tpu_torch.models import resnet50

    tree = ast.parse((Path(__file__).parents[1] / "chip_smoke.py")
                     .read_text())
    (table,) = [ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "RESNET50_BN_SHAPES"]
    model = resnet50(10, device="cpu")
    seen = collections.Counter()
    for m in model.batch_norms():
        m.register_forward_hook(lambda m, i, o: seen.update(
            [(o.shape[1], o.shape[2])]))
    with torch.no_grad():
        model(torch.zeros(1, 224, 224, 3))
    assert sum(seen.values()) == 53
    assert {(c, hw): n for c, hw, n in table} == dict(seen)
