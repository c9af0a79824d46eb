"""The port's ResNet against the JAX package's flax ResNet, on the CPU.

ResNet-18 with the CIFAR stem (B=16, 32 px) and ResNet-50 with the
ImageNet stem (B=8, 64 px, ``num_filters=16``), 10 classes. flax builds
the weights; every BatchNorm scale and bias and every running statistic is
then drawn at random in the flax tree (a zero last-BN scale makes every
residual branch output 0, which would hide a wrong stride-2 conv), and the
trees are copied into the port by ``models.convert``. Compared: the
train-mode logits and the updated ``batch_stats``, and the eval-mode
logits with the random running statistics.

Tolerances, as ``max |port - flax| / max |flax|`` over each tensor:

* fp32, ResNet-18: 1e-5.
* ResNet-50 is held in fp64 (both sides; flax under ``jax.enable_x64``) at
  1e-10: in fp32 flax's own result is 2.8e-4 away from the fp64 one at
  the logits (its BatchNorm takes the variance as E[x^2] - E[x]^2, which
  loses digits where a channel's mean is large against its spread, and
  50 layers compound it), so an fp32 comparison there would measure flax's
  rounding. The port's fp32 ResNet-50 must end within 1e-4 of the fp64
  result (it is 3.1e-5 away). Both figures: ``tests/_torch_port_resnet_
  precision.py``.

One case pins flax's ``"SAME"`` padding: with the stride-2 3x3 convs padded
symmetrically (torch's ``padding=1``), the comparison must fail.
"""

import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_distributed_tpu.models import resnet18 as jax_resnet18
from pytorch_distributed_tpu.models import resnet50 as jax_resnet50
from pytorch_distributed_tpu_torch.models import (
    load_sgd_state_from_optax,
    resnet18,
    resnet50,
    resnet_flax_from_state_dict,
    resnet_state_dict_from_flax,
)
from pytorch_distributed_tpu_torch.models.resnet import Conv, same_padding

torch.set_num_threads(2)

FP32_TOL = 1e-5
FP64_TOL = 1e-10
FP32_VS_FP64_TOL = 1e-4

# name: (flax constructor, port constructor, keyword args, input shape)
MODELS = {
    "resnet18_cifar": (jax_resnet18, resnet18, dict(cifar_stem=True),
                       (16, 32, 32, 3)),
    "resnet50_64px": (jax_resnet50, resnet50, dict(num_filters=16),
                      (8, 64, 64, 3)),
}
JNP = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _randomize_bn(params, batch_stats, rng, dtype):
    """Every BN scale in [0.5, 1.5], bias ~ 0.1 N(0, 1), running mean ~
    0.1 N(0, 1), running var in [0.5, 1.5], all in ``dtype`` (flax makes
    the running statistics fp32 even under x64)."""
    def param(path, a):
        if path[-1].key == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(dtype)
        if path[-1].key == "bias" and path[-2].key != "fc":
            return (0.1 * rng.standard_normal(a.shape)).astype(dtype)
        return a

    def stat(path, a):
        if path[-1].key == "mean":
            return (0.1 * rng.standard_normal(a.shape)).astype(dtype)
        return rng.uniform(0.5, 1.5, a.shape).astype(dtype)

    return (jax.tree_util.tree_map_with_path(param, params),
            jax.tree_util.tree_map_with_path(stat, batch_stats))


@functools.cache
def _flax_case(name, dtype, seed=0):
    """The flax model's random-BN variables, input, and its train logits,
    updated batch_stats and eval logits (numpy; shared by the tests, which
    do not write to them)."""
    jax_ctor, _, kw, shape = MODELS[name]
    rng = np.random.default_rng(seed)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    x = rng.standard_normal(shape).astype(np_dtype)
    with jax.enable_x64(dtype == torch.float64):
        model = jax_ctor(num_classes=10, dtype=JNP[dtype],
                         param_dtype=JNP[dtype], **kw)
        v = model.init(jax.random.key(seed), x)
        params, stats = _randomize_bn(
            jax.tree_util.tree_map(np.asarray, v["params"]),
            jax.tree_util.tree_map(np.asarray, v["batch_stats"]), rng,
            np_dtype)
        variables = {"params": params, "batch_stats": stats}
        logits, upd = model.apply(variables, x, train=True,
                                  mutable=["batch_stats"])
        eval_logits = model.apply(variables, x, train=False)
        out = jax.tree_util.tree_map(np.asarray, (logits, upd["batch_stats"],
                                                  eval_logits))
    return params, stats, x, out


def _port(name, dtype, params, stats):
    _, ctor, kw, _ = MODELS[name]
    model = ctor(10, dtype=dtype, param_dtype=dtype, device="cpu", **kw)
    model.load_state_dict(resnet_state_dict_from_flax(params, stats))
    return model


def _port_outputs(model, x):
    """Train logits, the updated batch_stats (flax tree) and eval logits;
    the eval pass runs on the running statistics from before the train
    pass, as flax's does."""
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    with torch.no_grad():
        logits = model(torch.tensor(x)).numpy()
    _, stats = resnet_flax_from_state_dict(model.state_dict())
    model.load_state_dict(before)
    model.eval()
    with torch.no_grad():
        eval_logits = model(torch.tensor(x)).numpy()
    return logits, stats, eval_logits


CASES = [("resnet18_cifar", torch.float32, FP32_TOL),
         ("resnet50_64px", torch.float64, FP64_TOL)]


@pytest.mark.parametrize("name,dtype,tol", CASES,
                         ids=[f"{n}-{str(d)[6:]}" for n, d, _ in CASES])
def test_logits_and_batch_stats_match_flax(name, dtype, tol):
    params, stats, x, (logits, new_stats, eval_logits) = _flax_case(name,
                                                                    dtype)
    got_logits, got_stats, got_eval = _port_outputs(
        _port(name, dtype, params, stats), x)
    assert _rel_err(got_logits, logits) <= tol
    assert _rel_err(got_eval, eval_logits) <= tol
    errs = jax.tree_util.tree_map(_rel_err, got_stats, new_stats)
    assert max(jax.tree_util.tree_leaves(errs)) <= tol, errs


def test_resnet50_fp32_within_reach_of_fp64():
    params, stats, x, (logits64, stats64, eval64) = _flax_case(
        "resnet50_64px", torch.float64)
    params32, stats32 = jax.tree_util.tree_map(
        lambda a: a.astype(np.float32), (params, stats))
    got_logits, got_stats, got_eval = _port_outputs(
        _port("resnet50_64px", torch.float32, params32, stats32),
        x.astype(np.float32))
    assert _rel_err(got_logits, logits64) <= FP32_VS_FP64_TOL
    assert _rel_err(got_eval, eval64) <= FP32_VS_FP64_TOL
    errs = jax.tree_util.tree_map(_rel_err, got_stats, stats64)
    assert max(jax.tree_util.tree_leaves(errs)) <= FP32_VS_FP64_TOL


def test_symmetric_padding_fails_the_comparison():
    """The pin: ResNet-18's stride-2 3x3 convs (the first conv of stages
    1-3) padded (1, 1) instead of SAME's (0, 1) on their even inputs."""
    params, stats, x, (logits, _, _) = _flax_case("resnet18_cifar",
                                                  torch.float32)
    model = _port("resnet18_cifar", torch.float32, params, stats)
    assert _rel_err(_port_outputs(model, x)[0], logits) <= FP32_TOL
    strided = [m for m in model.modules()
               if isinstance(m, Conv) and m.stride == 2 and m.kernel == 3]
    assert len(strided) == 3
    for m in strided:
        m.padding = (1, 1)
    assert _rel_err(_port_outputs(model, x)[0], logits) > 100 * FP32_TOL


@pytest.mark.parametrize("size", [7, 8, 32, 33, 56, 224])
@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (1, 2), (7, 2)])
def test_same_padding_is_xlas(size, kernel, stride):
    want = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert same_padding(size, kernel, stride) == tuple(want[0])


@pytest.mark.parametrize("name,dtype", [(n, d) for n, d, _ in CASES],
                         ids=[n for n, _, _ in CASES])
def test_convert_round_trip(name, dtype):
    params, stats, _, _ = _flax_case(name, dtype)
    model = _port(name, dtype, params, stats)
    back_params, back_stats = resnet_flax_from_state_dict(model.state_dict())
    for want, got in ((params, back_params), (stats, back_stats)):
        assert (jax.tree_util.tree_structure(want)
                == jax.tree_util.tree_structure(got))
        jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    again = resnet_state_dict_from_flax(back_params, back_stats)
    for key, t in model.state_dict().items():
        assert torch.equal(again[key], t), key


def test_sgd_state_from_optax_steps_like_optax():
    """optax ``sgd(0.05, momentum=0.9)`` from a nonzero trace and torch SGD
    from the converted ``momentum_buffer``: one step on the same gradients
    gives the same parameters."""
    params, stats, _, _ = _flax_case("resnet18_cifar", torch.float32)
    rng = np.random.default_rng(1)
    trace = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    grads = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    tx = optax.sgd(0.05, momentum=0.9)
    opt_state = tx.init(params)
    opt_state = (opt_state[0]._replace(trace=trace),) + tuple(opt_state[1:])
    updates, _ = tx.update(grads, opt_state, params)
    want = optax.apply_updates(params, updates)

    model = _port("resnet18_cifar", torch.float32, params, stats)
    opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    load_sgd_state_from_optax(opt, model, trace)
    grad_sd = resnet_state_dict_from_flax(grads)
    for name, p in model.named_parameters():
        p.grad = grad_sd[name].clone()
    opt.step()
    got, _ = resnet_flax_from_state_dict(model.state_dict())
    errs = jax.tree_util.tree_map(_rel_err, got, jax.tree_util.tree_map(
        np.asarray, want))
    assert max(jax.tree_util.tree_leaves(errs)) <= 1e-6
