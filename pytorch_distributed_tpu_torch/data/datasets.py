"""Datasets shaped like the reference workloads (ResNet image
classification, GPT-2 language modelling).

Copy of ``pytorch_distributed_tpu/data/datasets.py``: deterministic
synthetic CIFAR-10-, ImageNet- and WikiText-103-shaped examples, a generic
``ArrayDataset`` over numpy arrays, and ``make_token_stream`` to chunk a
flat corpus. numpy only.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = [
    "ArrayDataset",
    "SyntheticCIFAR10",
    "SyntheticImageNet",
    "SyntheticLMDataset",
    "make_token_stream",
]


class ArrayDataset:
    """Dataset over parallel numpy arrays (first dim indexes examples)."""

    def __init__(self, *arrays: np.ndarray):
        if not arrays:
            raise ValueError("need at least one array")
        n = len(arrays[0])
        for a in arrays:
            if len(a) != n:
                raise ValueError("arrays must have equal first dims")
        self.arrays = arrays

    def __len__(self) -> int:
        return len(self.arrays[0])

    def __getitem__(self, idx) -> Tuple[np.ndarray, ...]:
        out = tuple(a[idx] for a in self.arrays)
        return out if len(out) > 1 else out[0]


class _Synthetic:
    """Deterministic per-index synthetic examples (no O(N) memory)."""

    def __init__(self, size: int, seed: int = 0):
        self._size = size
        self._seed = seed

    def __len__(self) -> int:
        return self._size

    def _rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng((self._seed, int(idx)))


class SyntheticCIFAR10(_Synthetic):
    """CIFAR-10-shaped: 32x32x3 float images (NHWC), 10 classes."""

    num_classes = 10
    image_shape = (32, 32, 3)

    def __init__(self, size: int = 50_000, seed: int = 0):
        super().__init__(size, seed)

    def __getitem__(self, idx):
        rng = self._rng(idx)
        x = rng.standard_normal(self.image_shape, dtype=np.float32)
        y = np.int32(idx % self.num_classes)
        return x, y


class SyntheticImageNet(_Synthetic):
    """ImageNet-shaped: 224x224x3 float images (NHWC), 1000 classes."""

    num_classes = 1000
    image_shape = (224, 224, 3)

    def __init__(self, size: int = 1_281_167, seed: int = 0):
        super().__init__(size, seed)

    def __getitem__(self, idx):
        rng = self._rng(idx)
        x = rng.standard_normal(self.image_shape, dtype=np.float32)
        y = np.int32(idx % self.num_classes)
        return x, y


class SyntheticLMDataset(_Synthetic):
    """WikiText-103-shaped LM chunks: token windows of ``seq_len + 1``; the
    loader slices inputs ``[:-1]`` and targets ``[1:]`` (GPT-2 vocab 50257)."""

    vocab_size = 50257

    def __init__(self, size: int = 100_000, seq_len: int = 1024, seed: int = 0):
        super().__init__(size, seed)
        self.seq_len = seq_len

    def __getitem__(self, idx):
        rng = self._rng(idx)
        tokens = rng.integers(
            0, self.vocab_size, size=(self.seq_len + 1,), dtype=np.int32
        )
        return tokens[:-1], tokens[1:]


def make_token_stream(
    corpus_tokens: Sequence[int], seq_len: int
) -> ArrayDataset:
    """Chunk a flat token stream into (input, target) windows — how the
    reference's WikiText-103 LM pipeline feeds GPT-2."""
    toks = np.asarray(corpus_tokens, dtype=np.int32)
    n_chunks = (len(toks) - 1) // seq_len
    toks = toks[: n_chunks * seq_len + 1]
    x = np.stack([toks[i * seq_len : (i + 1) * seq_len] for i in range(n_chunks)])
    y = np.stack(
        [toks[i * seq_len + 1 : (i + 1) * seq_len + 1] for i in range(n_chunks)]
    )
    return ArrayDataset(x, y)
