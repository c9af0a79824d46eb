"""The trace readers on a synthetic trace."""

import pytest

from portbench import manifest, trace

FAMILIES = manifest.kernel_families()


def _trace():
    # ns: attention 0-100, gemm 100-300, nccl 250-400 (50 ns under the
    # gemm), idle 400-500 while the host syncs, nccl 500-600 alone
    return trace.Trace(
        device_ops=[
            ("flash_causal_fwd_kernel_sm90", 0, 100),
            ("sm90_xmma_gemm_bf16bf16", 100, 300),
            ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 250, 400),
            ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 500, 600),
        ],
        host_ops=[("cudaGraphLaunch", 0, 50),
                  ("cudaEventSynchronize", 390, 510),
                  ("aten::copy_", 420, 480)])


def test_classifier_by_family_files():
    assert trace.classify("flash_causal_dkv_kernel_sm90", FAMILIES) == "attention"
    assert trace.classify("flash_masked_dq_kernel_sm90", FAMILIES) == "attention"
    assert trace.classify("ncclDevKernel_AllReduce_Sum_bf16_RING_LL",
                          FAMILIES) == "nccl"
    assert trace.classify("ncclKernel_AllReduce_RING_LL_Sum_float",
                          FAMILIES) == "nccl"
    assert trace.classify("cudnn::bn_fw_tr_1C11_kernel_NCHW", FAMILIES) is None
    assert trace.classify("ampere_sgemm_128x64_nn", FAMILIES) is None


def test_a_kernel_two_families_match_is_an_error():
    overlapping = {**FAMILIES, "comm": ["nccl", "AllReduce"]}
    with pytest.raises(ValueError, match="comm"):
        trace.classify("ncclDevKernel_AllReduce_Sum_bf16_RING_LL", overlapping)
    assert trace.classify("flash_causal_fwd_kernel_sm90",
                          overlapping) == "attention"


def test_busy_idle_and_families():
    t = _trace()
    busy, window = trace.busy_window(t)
    assert (busy, window) == (500e-9, 600e-9)
    assert trace.idle_percent(t) == pytest.approx(100 * (1 - 5 / 6))
    assert trace.family_seconds(t, FAMILIES, "nccl") == 250e-9
    assert trace.family_seconds(t, FAMILIES, "attention") == 100e-9
    assert trace.exposed_seconds(t, FAMILIES, "nccl") == 200e-9
    assert trace.busy_window(trace.Trace([])) is None
    assert trace.idle_percent(trace.Trace([])) is None


def test_breakdown_names_the_host_during_gaps():
    b = trace.breakdown(_trace())
    assert b["device_ops"][0] == ["ncclDevKernel_AllReduce_Sum_f32_RING_LL", 250e-9]
    assert len(b["device_ops"]) == 3
    # the one gap (400-500): its middle (450) is inside the copy, itself
    # inside the sync; the innermost names it
    assert b["idle_gaps"] == [["aten::copy_", 100e-9]]


def test_exposed_with_nothing_else():
    t = trace.Trace([("nccl_x", 0, 10), ("nccl_x", 5, 20)])
    assert trace.exposed_seconds(t, {"nccl": ["^nccl"]}, "nccl") == 20e-9
