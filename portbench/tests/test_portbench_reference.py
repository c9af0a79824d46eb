"""The plain references against the port's models at a small width: the
same weights and batch give the same loss and gradients."""

import pytest
import torch

from portbench import generate, manifest, program
from portbench.reference import common, gpt2, resnet
from portbench.tests.tiny import TINY_CFG

torch.set_num_threads(2)
MF = manifest.load()


def _cfg(name, driver):
    cfg = manifest.config_file(MF, name)
    cfg.update(TINY_CFG[driver])
    return cfg


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def test_gpt2_reference_matches_the_port():
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.trainer import lm_loss

    cfg = _cfg("gpt2-125m", "lm_train")
    params = generate.make_params(gpt2.param_specs(cfg), 3, torch.device("cpu"))
    model = GPT2(GPT2Config(vocab_size=cfg["vocab_size"],
                            n_positions=cfg["n_positions"], n_embd=cfg["n_embd"],
                            n_layer=cfg["n_layer"], n_head=cfg["n_head"]),
                 device="cpu")
    program.load_params(model, params)
    g = torch.Generator().manual_seed(0)
    rows = torch.randint(0, cfg["vocab_size"], (3, 33), generator=g)
    tokens, targets = rows[:, :-1], rows[:, 1:]
    loss, _ = lm_loss(model, (tokens, targets), True)
    loss.backward()
    ref_loss, ref_grads = gpt2.loss_and_grads(cfg, common.Precision(), 2)(
        params, (tokens, targets))
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-6)
    for n, p in model.named_parameters():
        assert _rel(p.grad, ref_grads[n]) < 1e-4, n


def test_gpt2_views_split_the_fused_projection():
    cfg = _cfg("gpt2-125m", "lm_train")
    params = generate.make_params(gpt2.param_specs(cfg), 3, torch.device("cpu"))
    v = gpt2.views(params)
    C = cfg["n_embd"]
    assert v["h.0.attn.c_attn.weight[k]"].shape == (C, C)
    assert torch.equal(v["h.0.attn.c_attn.bias[v]"],
                       params["h.0.attn.c_attn.bias"][2 * C:])
    assert "h.0.attn.c_attn.weight" not in v


def test_resnet_reference_matches_the_port():
    # fp64 on both sides: the small net's BatchNorms amplify fp32 rounding
    from pytorch_distributed_tpu_torch.models import resnet50
    from pytorch_distributed_tpu_torch.trainer import classification_loss

    cfg = _cfg("resnet50", "cnn_train")
    dt = torch.float64
    params = {n: t.to(dt) for n, t in generate.make_params(
        resnet.param_specs(cfg), 5, torch.device("cpu")).items()}
    model = resnet50(num_classes=cfg["num_classes"], num_filters=cfg["width"],
                     dtype=dt, param_dtype=dt, device="cpu")
    program.load_params(model, params)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(6, 64, 64, 3, generator=g, dtype=dt)
    y = torch.randint(0, cfg["num_classes"], (6,), generator=g)
    loss, _ = classification_loss(model, (x, y), True)
    loss.backward()
    ref_loss, ref_grads = resnet.loss_and_grads(cfg, common.Precision())(
        params, (x, y))
    # the port's loss takes fp32 logits: agreement to fp32's rounding
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-6)
    for n, p in model.named_parameters():
        assert _rel(p.grad, ref_grads[n]) < 1e-5, n


def test_specs_name_every_port_parameter():
    from pytorch_distributed_tpu_torch.models import resnet50

    cfg = _cfg("resnet50", "cnn_train")
    model = resnet50(num_classes=cfg["num_classes"], num_filters=cfg["width"],
                     device="cpu")
    assert [(n, tuple(p.shape)) for n, p in model.named_parameters()] == [
        (n, s) for n, s, _, _ in resnet.param_specs(cfg)]


def test_optimizers_match_torch():
    g = torch.Generator().manual_seed(2)
    p0 = {"a": torch.randn(5, 3, generator=g), "b": torch.randn(7, generator=g)}
    grads = [{n: torch.randn(t.shape, generator=g) for n, t in p0.items()}
             for _ in range(3)]
    for spec in ({"name": "AdamW", "lr": 3e-4, "weight_decay": 0.01,
                  "betas": [0.9, 0.999], "eps": 1e-8},
                 {"name": "SGD", "lr": 0.1, "momentum": 0.9}):
        mine = {n: t.clone() for n, t in p0.items()}
        theirs = [torch.nn.Parameter(t.clone()) for t in p0.values()]
        opt = common.optimizer(spec)
        topt = program.optimizer(torch.nn.ParameterList(theirs), spec)
        for t, gr in enumerate(grads, 1):
            opt.step(mine, gr, t)
            for p, n in zip(theirs, p0):
                p.grad = gr[n].clone()
            topt.step()
        for p, n in zip(theirs, p0):
            torch.testing.assert_close(mine[n], p.detach(), rtol=1e-6, atol=1e-7)


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(3))
    e8 = _rel(common.rounded(x, "e4m3"), x)
    eb = _rel(common.rounded(x, "bf16"), x)
    assert torch.equal(common.rounded(x, "bf16"), x.bfloat16().float())
    assert 8 * eb < e8 < 0.1
    assert torch.equal(common.rounded(torch.zeros(4), "e5m2"), torch.zeros(4))
