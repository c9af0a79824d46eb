"""Data of the port: numpy datasets, the per-rank sampler, batch
placement and the loader of the training entry points.

Copies of ``pytorch_distributed_tpu/data/datasets.py`` and ``sampler.py``
(both numpy-only; the port keeps its own copies rather than import the JAX
package), the counterpart of its ``sharding.py``, and of its loader the
part the ResNet entry point needs: batching goes through
``torch.utils.data.DataLoader`` with this sampler (``make_loader``), and
``prefetch_to_device`` copies batches ahead on a side stream, and
``pad_batch`` pads an uneven final batch under a validity mask; the
disk datasets (``disk.py``: the JPEG ImageFolder and the memory-mapped
token corpus) are a copy of the JAX package's. Torch's ``DataLoader``
worker processes take the place of the JAX package's own worker pool.
"""

from pytorch_distributed_tpu_torch.data.datasets import (
    ArrayDataset,
    SyntheticCIFAR10,
    SyntheticImageNet,
    SyntheticLMDataset,
    make_token_stream,
)
from pytorch_distributed_tpu_torch.data.disk import (
    ImageFolderDataset,
    TokenBinDataset,
    make_image_transform,
    write_image_folder,
    write_token_bin,
)
from pytorch_distributed_tpu_torch.data.loader import (
    make_loader,
    pad_batch,
    prefetch_to_device,
)
from pytorch_distributed_tpu_torch.data.sampler import DistributedSampler
from pytorch_distributed_tpu_torch.data.sharding import (
    LocalBatch,
    shard_batch_for_mesh,
)

__all__ = [
    "ArrayDataset",
    "DistributedSampler",
    "ImageFolderDataset",
    "LocalBatch",
    "SyntheticCIFAR10",
    "SyntheticImageNet",
    "SyntheticLMDataset",
    "TokenBinDataset",
    "make_image_transform",
    "make_loader",
    "make_token_stream",
    "pad_batch",
    "prefetch_to_device",
    "shard_batch_for_mesh",
    "write_image_folder",
    "write_token_bin",
]
