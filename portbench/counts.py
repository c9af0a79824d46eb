"""Operation and byte counts from the models' shapes, and the chips' peaks.

The peaks are NVIDIA's published dense rates (data sheets), keyed by a
substring of ``torch.cuda.get_device_name``; the first match wins and
"H100" alone is the SXM part. The attention count is the work of the
function, not of the kernels that compute it: ``chip_smoke.py``'s kernels
phase counts each launch's own operations, the scores that the dq and
dk/dv launches each recompute included, and so reads a higher bound for
the same work. The model counts leave recomputation out.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

#: (bf16 tensor-core FLOP/s, fp32 CUDA-core FLOP/s, HBM bytes/s)
PEAKS: Tuple[Tuple[str, Tuple[float, float, float]], ...] = (
    ("H100 PCIe", (756e12, 51e12, 2.0e12)),
    ("H100 NVL", (835e12, 60e12, 3.9e12)),
    ("H100", (989e12, 67e12, 3.35e12)),
)


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The published peaks of the card named ``device_name``, or None for
    a card the table does not know (no share of a peak is then reported)."""
    for key, (bf16, fp32, hbm) in PEAKS:
        if key in device_name:
            return {"bf16_flops": bf16, "fp32_flops": fp32, "hbm_bytes": hbm}
    return None


def lm_train_flops_per_token(n_layer: int, d: int, vocab: int,
                             seq_len: int) -> float:
    """A GPT-2 training step's model FLOPs per token: 6 (12 L d^2 + V d)
    for the weight products (forward and backward) and 6 L T d for causal
    attention's two products (each query sees T/2 keys on average). Layer
    norms, GELU, softmax and the embedding gather are left out."""
    return 6.0 * (12 * n_layer * d * d + vocab * d) + 6.0 * n_layer * seq_len * d


def causal_attention_work(batch: int, seq_len: int, heads: int,
                          head_dim: int, elt: int
                          ) -> Dict[str, Tuple[float, float]]:
    """``{"fwd": (bytes, flops), "bwd": (bytes, flops)}`` of one causal
    attention layer over ``[B, T, H, D]`` tensors of ``elt`` bytes an
    element, counted as the function's work, whatever the kernels that
    compute it recompute. The forward reads q, k and v once and writes o
    and the fp32 row statistics ``[B, H, T]``: two products over the
    visible pairs, 4 D FLOPs a pair. The backward reads q, k, v, o, dO and
    the statistics once and writes dq, dk and dv: 2.5 times the forward's
    FLOPs (FlashAttention-2's count: the four gradient products and one
    recomputation of the scores)."""
    n = batch * seq_len * heads * head_dim
    visible = batch * heads * seq_len * (seq_len + 1) // 2
    stats = batch * heads * seq_len * 4
    return {
        "fwd": (4 * n * elt + stats, 4 * head_dim * visible),
        "bwd": (8 * n * elt + stats, 10 * head_dim * visible),
    }


def roofline_seconds(work: Dict[str, Tuple[float, float]], flops_peak: float,
                     bytes_peak: float) -> float:
    """The least time the parts of ``work`` can take: each part's larger
    of bytes over bandwidth and operations over peak, summed."""
    return sum(max(b / bytes_peak, f / flops_peak) for b, f in work.values())


def resnet_forward_flops(stage_sizes: Sequence[int], width: int,
                         num_classes: int, image: int) -> float:
    """Forward FLOPs (2 a multiply-add) of a bottleneck ResNet v1.5 on one
    ``image`` x ``image`` picture: every convolution and the classifier.
    Batch norm, ReLU, pooling and the residual adds are left out."""

    def conv(cin, cout, k, h_out):
        return 2.0 * cin * cout * k * k * h_out * h_out

    h = -(-image // 2)                      # the 7x7 stride-2 stem
    total = conv(3, width, 7, h)
    h = -(-h // 2)                          # the 3x3 stride-2 max-pool
    cin = width
    for i, count in enumerate(stage_sizes):
        filters = width * 2 ** i
        for j in range(count):
            stride = 2 if i > 0 and j == 0 else 1
            h_out = -(-h // stride)
            total += conv(cin, filters, 1, h)
            total += conv(filters, filters, 3, h_out)
            total += conv(filters, filters * 4, 1, h_out)
            if stride != 1 or cin != filters * 4:
                total += conv(cin, filters * 4, 1, h_out)
            cin, h = filters * 4, h_out
    return total + 2.0 * cin * num_classes


def train_flops(forward_flops: float) -> float:
    """A training step's FLOPs from the forward's: the backward takes
    twice the forward (the input's and the weights' gradients)."""
    return 3.0 * forward_flops
