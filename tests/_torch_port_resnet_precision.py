"""How far fp32 ResNet results sit from fp64 ones, for flax and for the
port, on the CPU: the measurement behind the tolerances of
``test_torch_port_resnet.py``, ``test_torch_port_resnet_dp.py`` and
``chip_smoke.py``'s ``resnet_parity`` phase. Not a test; run it as::

    JAX_PLATFORMS=cpu python -m tests._torch_port_resnet_precision

It prints one JSON line per measurement, each error as ``max |x - x64| /
max |x64|`` over a tensor (the worst tensor where there are several):

* ``logits``: ResNet-50 (64 px, B=8, ``num_filters=16``, random BN state),
  train-mode logits of flax and of the port in fp32, against flax in fp64;
* ``grads``: ResNet-18 (CIFAR stem, B=16, random BN state), the step-1
  gradients of ``classification_loss`` in fp32 against fp64, each side
  against its own fp64 run;
* ``steps``: the port's ResNet-50 (ImageNet stem, 64 px, B=8, 10
  classes), 3 ``SGD(0.01, momentum=0.9)`` steps, the fp32 losses against
  fp64 ones, with random BN scales and biases and from flax's BN init
  (random running statistics in both).
"""

import json

import numpy as np
import torch

import jax
import jax.numpy as jnp

from pytorch_distributed_tpu.trainer import (
    classification_loss as jax_classification_loss,
)
from pytorch_distributed_tpu_torch.models import (
    resnet50,
    resnet_state_dict_from_flax,
)
from pytorch_distributed_tpu_torch.parallel import NoShard
from pytorch_distributed_tpu_torch.trainer import Trainer, classification_loss
from tests.test_torch_port_resnet import (
    JNP,
    MODELS,
    _flax_case,
    _port,
    _rel_err,
)


def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), tree)


def logits():
    params, stats, x, (want64, _, _) = _flax_case("resnet50_64px",
                                                  torch.float64)
    jax_ctor, _, kw, _ = MODELS["resnet50_64px"]
    p32, s32, x32 = _cast(params, np.float32), _cast(stats, np.float32), \
        x.astype(np.float32)
    flax32, _ = jax_ctor(num_classes=10, **kw).apply(
        {"params": p32, "batch_stats": s32}, x32, train=True,
        mutable=["batch_stats"])
    port = _port("resnet50_64px", torch.float32, p32, s32).train()
    with torch.no_grad():
        port32 = port(torch.tensor(x32)).numpy()
    return {"flax_fp32": _rel_err(flax32, want64),
            "port_fp32": _rel_err(port32, want64)}


def _flax_grads(params, stats, x, y, dtype):
    jax_ctor, _, kw, _ = MODELS["resnet18_cifar"]
    with jax.enable_x64(dtype == torch.float64):
        model = jax_ctor(num_classes=10, dtype=JNP[dtype],
                         param_dtype=JNP[dtype], **kw)
        npd = np.float64 if dtype == torch.float64 else np.float32

        def loss(p):
            return jax_classification_loss(
                model, {"params": p, "batch_stats": _cast(stats, npd)},
                (x.astype(npd), y), True)[0]

        g = jax.grad(loss)(_cast(params, npd))
        return resnet_state_dict_from_flax(jax.tree_util.tree_map(
            np.asarray, g))


def _port_grads(params, stats, x, y, dtype):
    model = _port("resnet18_cifar", dtype, *(
        _cast(t, np.float64 if dtype == torch.float64 else np.float32)
        for t in (params, stats)))
    loss, _ = classification_loss(
        model, (torch.tensor(x).to(dtype), torch.tensor(y)), True)
    loss.backward()
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


def grads():
    params, stats, x, _ = _flax_case("resnet18_cifar", torch.float32)
    y = np.random.default_rng(1).integers(0, 10, len(x)).astype(np.int32)
    out = {}
    for side, fn in (("flax", _flax_grads), ("port", _port_grads)):
        g32 = fn(params, stats, x, y, torch.float32)
        g64 = fn(params, stats, x, y, torch.float64)
        out[f"{side}_fp32"] = max(_rel_err(g32[n], g64[n]) for n in g64)
    return out


def _port_steps(state_dict, x, y, dtype):
    model = resnet50(10, device="cpu", dtype=dtype, param_dtype=dtype)
    model.load_state_dict({k: v.to(dtype) for k, v in state_dict.items()})
    trainer = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.01,
                                             momentum=0.9),
                      NoShard("cpu"), loss_fn=classification_loss)
    state, losses = trainer.init(), []
    for _ in range(3):
        state, m = trainer.step(state, (x.to(dtype), y))
        losses.append(float(m["loss"]))
    return losses


def steps():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((8, 64, 64, 3), np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 8))
    out = {}
    for scales in (True, False):
        model = resnet50(10, device="cpu", seed=4)
        g = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for m in model.batch_norms():
                if scales:
                    m.weight.uniform_(0.5, 1.5, generator=g)
                    m.bias.normal_(0.0, 0.1, generator=g)
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
        sd = model.state_dict()
        l32 = _port_steps(sd, x, y, torch.float32)
        l64 = _port_steps(sd, x, y, torch.float64)
        key = "random_bn_scales" if scales else "bn_init"
        out[key] = [abs(a - b) / abs(b) for a, b in zip(l32, l64)]
    return out


def main():
    torch.set_num_threads(4)
    for name, fn in (("logits", logits), ("grads", grads), ("steps", steps)):
        print(json.dumps({"measurement": name, **fn()}), flush=True)


if __name__ == "__main__":
    main()
