"""Data of the port: numpy datasets and the per-rank sampler.

Copies of ``pytorch_distributed_tpu/data/datasets.py`` and ``sampler.py``
(both numpy-only; the port keeps its own copies rather than import the JAX
package). Batching goes through ``torch.utils.data.DataLoader`` with this
sampler; the JAX package's worker-pool loader is ROADMAP A.8.
"""

from pytorch_distributed_tpu_torch.data.datasets import (
    ArrayDataset,
    SyntheticLMDataset,
    make_token_stream,
)
from pytorch_distributed_tpu_torch.data.sampler import DistributedSampler

__all__ = [
    "ArrayDataset",
    "DistributedSampler",
    "SyntheticLMDataset",
    "make_token_stream",
]
