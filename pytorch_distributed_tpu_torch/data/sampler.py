"""Distributed sampler — per-rank dataset sharding.

Copy of ``pytorch_distributed_tpu/data/sampler.py`` (numpy only).

Capability parity: ``torch.utils.data.distributed.DistributedSampler``
(``utils/data/distributed.py:17`` per SURVEY.md §2.3): each of
``num_replicas`` ranks sees a disjoint 1/num_replicas slice, the dataset is
padded (wrap-around) or truncated to a divisible length, shuffling is seeded
by ``seed + epoch`` so all ranks agree on the permutation, and ``set_epoch``
re-seeds per epoch.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Sized

import numpy as np

__all__ = ["DistributedSampler"]


class DistributedSampler:
    """Restricts data loading to a 1/num_replicas subset of the dataset.

    Args:
      dataset: anything with ``__len__``.
      num_replicas: world size (defaults must be passed explicitly — there is
        no ambient process group requirement; pass ``mesh.size('dp')``).
      rank: this replica's index in [0, num_replicas).
      shuffle: epoch-seeded random permutation when True.
      seed: base seed; actual permutation seed is ``seed + epoch``.
      drop_last: truncate instead of pad to reach divisibility.
    """

    def __init__(
        self,
        dataset: Sized,
        num_replicas: int,
        rank: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if not (0 <= rank < num_replicas):
            raise ValueError(
                f"rank {rank} out of range for num_replicas {num_replicas}"
            )
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

        n = len(dataset)
        if self.drop_last and n % num_replicas:
            self.num_samples = n // num_replicas
        else:
            self.num_samples = math.ceil(n / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        """Re-seed the shuffle for a new epoch (all ranks must call this with
        the same value so the global permutation agrees)."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = rng.permutation(n)
        else:
            indices = np.arange(n)
        if not self.drop_last:
            pad = self.total_size - len(indices)
            if pad > 0:
                # wrap-around padding, repeating the (possibly shuffled) head
                reps = math.ceil(pad / len(indices))
                indices = np.concatenate(
                    [indices, np.tile(indices, reps)[:pad]]
                )
        else:
            indices = indices[: self.total_size]
        assert len(indices) == self.total_size
        # strided subsample: rank, rank+R, rank+2R, ... (torch layout)
        return indices[self.rank : self.total_size : self.num_replicas]

    def __iter__(self) -> Iterator[int]:
        return iter(self._indices().tolist())

    def __len__(self) -> int:
        return self.num_samples
