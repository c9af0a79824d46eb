"""The operation and byte counts against hand-worked numbers."""

import pytest

from portbench import counts


def test_gpt2_125m_flops_per_token():
    # 6 (12 L d^2 + V d) + 6 L T d at L 12, d 768, V 50257, T 1024
    weights = 12 * 12 * 768 ** 2 + 50257 * 768          # 123,532,032
    assert counts.lm_train_flops_per_token(12, 768, 50257, 1024) == (
        6 * weights + 6 * 12 * 1024 * 768)
    assert counts.lm_train_flops_per_token(12, 768, 50257, 1024) == 797_815_296


def test_resnet50_forward_is_4_09_giga_multiply_adds():
    # torchvision's "4.09 GFLOPS" for resnet50 counts multiply-adds
    flops = counts.resnet_forward_flops([3, 4, 6, 3], 64, 1000, 224)
    assert flops == 2 * 4_089_184_256
    assert counts.train_flops(flops) == 3 * flops


def test_attention_counts_the_function_not_the_kernels():
    # GPT-2's layer at B 16, T 1024, H 12, D 64 in bf16: 100,761,600
    # visible pairs; the forward is bound by its 101.45 MB (30.3 us), the
    # backward by its 64.5 GFLOP (65.2 us), 95.5 us a layer
    work = counts.causal_attention_work(16, 1024, 12, 64, 2)
    visible = 16 * 12 * 1024 * 1025 // 2
    n = 16 * 1024 * 12 * 64
    stats = 16 * 12 * 1024 * 4
    assert visible == 100_761_600
    assert work["fwd"] == (4 * n * 2 + stats, 4 * 64 * visible)
    assert work["bwd"] == (8 * n * 2 + stats, 10 * 64 * visible)
    assert work["bwd"][1] == 2.5 * work["fwd"][1]
    pk = counts.peaks("NVIDIA H100 80GB HBM3")
    us = {k: 1e6 * counts.roofline_seconds({k: w}, pk["bf16_flops"],
                                           pk["hbm_bytes"])
          for k, w in work.items()}
    assert us["fwd"] == pytest.approx(30.28, abs=0.01)
    assert us["bwd"] == pytest.approx(65.21, abs=0.01)
    assert 1e6 * counts.roofline_seconds(
        work, pk["bf16_flops"], pk["hbm_bytes"]) == pytest.approx(95.49,
                                                                  abs=0.01)


@pytest.mark.parametrize("name,bf16", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 NVL", 835e12), ("NVIDIA A100-SXM4-80GB", None)])
def test_peaks_by_device_name(name, bf16):
    got = counts.peaks(name)
    assert (got and got["bf16_flops"]) == bf16 or (got is None and bf16 is None)
