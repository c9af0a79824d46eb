"""Disk-backed datasets: JPEG image folders and binary token corpora.

Copy of ``pytorch_distributed_tpu/data/disk.py`` (numpy and PIL only; the
port keeps its own copy rather than import the JAX package):

  * :class:`ImageFolderDataset`: the ``root/<class_name>/*.jpg`` layout
    (torchvision's ImageFolder contract); each ``[idx]`` decodes, crops,
    flips and normalizes in numpy and PIL, in the ``DataLoader`` worker
    that fetches it (``data.make_loader(..., num_workers=N)``).
  * :class:`TokenBinDataset`: a flat binary token file, memory-mapped
    (``np.memmap``); ``[idx]`` returns the ``(input, target)`` window pair
    (the nanoGPT/Megatron ``.bin`` shape for LM corpora).
  * the train transform (``RandomResizedCrop`` + flip + normalize) and the
    eval transform (resize, center crop, normalize) as one picklable
    callable, keyed on ``(seed, epoch, idx)`` so that a worker pool gives
    the same stream as one process.

Every sample is a tuple of numpy arrays, as the synthetic datasets give;
the loader collates them and ``prefetch_to_device`` places them.
``write_image_folder`` and ``write_token_bin`` make files in these formats
(the tests and ``chip_smoke.py`` generate their data with them).
"""

from __future__ import annotations

import io
import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ImageFolderDataset",
    "TokenBinDataset",
    "make_image_transform",
    "write_image_folder",
    "write_token_bin",
]

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


# -- transforms -------------------------------------------------------------

def make_image_transform(
    size: int = 224,
    *,
    train: bool = True,
    mean: Sequence[float] = (0.485, 0.456, 0.406),
    std: Sequence[float] = (0.229, 0.224, 0.225),
    seed: int = 0,
) -> Callable:
    """The reference's torchvision stack as one numpy function:
    RandomResizedCrop(size) + RandomHorizontalFlip + Normalize for train;
    center-crop + Normalize for eval. Input: PIL.Image; output: fp32 NHWC
    CHW-free ``[size, size, 3]``.

    Determinism: augmentation randomness is derived from
    ``(seed, epoch, idx)`` passed at call time, so a worker pool produces
    the same stream as in-process loading, and each epoch draws fresh
    crops and flips: the entry points call
    :meth:`ImageFolderDataset.set_epoch` beside the sampler's, before the
    epoch's workers start (torch's ``DataLoader`` starts them anew each
    epoch unless ``persistent_workers``).

    Returns a picklable callable (a class instance, not a closure), so it
    survives workers started with ``spawn``.
    """
    return _ImageTransform(size, train, mean, std, seed)


class _ImageTransform:
    def __init__(self, size, train, mean, std, seed):
        self.size = size
        self.train = train
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.seed = seed

    def __call__(self, img, idx: int = 0, epoch: int = 0):
        from PIL import Image

        size = self.size
        rng = np.random.default_rng((self.seed, int(epoch), int(idx)))
        w, h = img.size
        if self.train:
            # RandomResizedCrop: area in [0.2, 1.0], ratio in [3/4, 4/3]
            for _ in range(10):
                area = w * h * rng.uniform(0.2, 1.0)
                ratio = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
                cw = int(round(np.sqrt(area * ratio)))
                ch = int(round(np.sqrt(area / ratio)))
                if cw <= w and ch <= h:
                    x0 = int(rng.integers(0, w - cw + 1))
                    y0 = int(rng.integers(0, h - ch + 1))
                    img = img.crop((x0, y0, x0 + cw, y0 + ch))
                    break
            img = img.resize((size, size), Image.BILINEAR)
            arr = np.asarray(img, np.float32) / 255.0
            if rng.uniform() < 0.5:
                arr = arr[:, ::-1]
        else:
            short = min(w, h)
            scale = size / short
            img = img.resize(
                (max(size, int(round(w * scale))),
                 max(size, int(round(h * scale)))),
                Image.BILINEAR,
            )
            w2, h2 = img.size
            x0, y0 = (w2 - size) // 2, (h2 - size) // 2
            img = img.crop((x0, y0, x0 + size, y0 + size))
            arr = np.asarray(img, np.float32) / 255.0
        return (arr - self.mean) / self.std


# -- image folder -----------------------------------------------------------

class ImageFolderDataset:
    """``root/<class>/*.jpg`` dataset (torchvision ImageFolder contract:
    classes are sorted subdirectory names; samples sorted within class).

    ``[idx]`` decodes the JPEG and applies ``transform(img, idx)`` — the
    CPU-heavy part, meant to run in DataLoader workers. The index scan
    happens once in the parent; workers inherit the (path, label) list.
    """

    def __init__(
        self,
        root: str,
        *,
        transform: Optional[Callable] = None,
    ):
        self.root = root
        classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )
        if not classes:
            raise ValueError(f"no class subdirectories under {root!r}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: list = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(_IMG_EXTS):
                    self.samples.append(
                        (os.path.join(cdir, fname), self.class_to_idx[c])
                    )
        if not self.samples:
            raise ValueError(f"no images found under {root!r}")
        self.transform = transform
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Fresh augmentation draws per epoch (called beside the
        sampler's ``set_epoch``)."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.int32]:
        from PIL import Image

        path, label = self.samples[idx]
        with Image.open(path) as img:
            img = img.convert("RGB")
            if self.transform is not None:
                arr = self.transform(img, idx, self._epoch)
            else:
                arr = np.asarray(img, np.float32) / 255.0
        return np.ascontiguousarray(arr, np.float32), np.int32(label)


# -- binary token corpus ----------------------------------------------------

class TokenBinDataset:
    """Memory-mapped flat token corpus -> ``(input, target)`` LM windows.

    File format: raw little-endian tokens (``dtype``, default uint16 — GPT-2
    vocab 50257 fits), no header; window ``i`` covers tokens
    ``[i*seq_len, i*seq_len + seq_len]`` (stride = seq_len, one overlap
    token for the shifted target, as the reference's WikiText pipeline).
    ``np.memmap`` keeps resident memory O(1) regardless of corpus size.
    """

    #: eager range-check budget: prefix tokens scanned at construction
    _EAGER_CHECK_TOKENS = 2_000_000

    def __init__(self, path: str, seq_len: int, *, dtype=np.uint16,
                 vocab_size: Optional[int] = None):
        self.path = path
        self.seq_len = int(seq_len)
        self._dtype = np.dtype(dtype)
        self.vocab_size = vocab_size
        self._tokens = np.memmap(path, dtype=self._dtype, mode="r")
        if vocab_size is not None:
            # an out-of-range id would index past the embedding table; a
            # wrong-tokenizer corpus is caught here. Eagerly scan a bounded
            # prefix (multi-GB corpora on
            # N ranks must not each page the whole file at startup);
            # every window is re-checked cheaply on access.
            self._check_range(
                self._tokens[: self._EAGER_CHECK_TOKENS], "prefix"
            )
        n = (len(self._tokens) - 1) // self.seq_len
        if n <= 0:
            raise ValueError(
                f"{path!r}: {len(self._tokens)} tokens < one "
                f"seq_len+1={self.seq_len + 1} window"
            )
        self._n = n

    def __len__(self) -> int:
        return self._n

    def _check_range(self, tokens, where: str) -> None:
        if self.vocab_size is None or len(tokens) == 0:
            return
        top = int(tokens.max())
        if top >= self.vocab_size:
            raise ValueError(
                f"{self.path!r} ({where}) contains token id {top} >= "
                f"vocab_size {self.vocab_size} — corpus/tokenizer mismatch"
            )

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        lo = idx * self.seq_len
        window = np.asarray(
            self._tokens[lo : lo + self.seq_len + 1], dtype=np.int32
        )
        self._check_range(window, f"window {idx}")
        return window[:-1], window[1:]

    # memmaps fork cleanly, but pickling (spawn ctx) re-opens by path
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_tokens"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._tokens = np.memmap(self.path, dtype=self._dtype, mode="r")


# -- fixture / corpus writers ----------------------------------------------

def write_image_folder(
    root: str,
    *,
    n_classes: int = 2,
    per_class: int = 8,
    size: Tuple[int, int] = (48, 40),
    seed: int = 0,
    fmt: str = "JPEG",
) -> None:
    """Generate a class-per-subdir image tree (test/example fixture)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for c in range(n_classes):
        cdir = os.path.join(root, f"class_{c}")
        os.makedirs(cdir, exist_ok=True)
        for i in range(per_class):
            arr = rng.integers(0, 256, (*size, 3), dtype=np.uint8)
            ext = "jpg" if fmt == "JPEG" else fmt.lower()
            Image.fromarray(arr, "RGB").save(
                os.path.join(cdir, f"img_{i:04d}.{ext}"), fmt
            )


def write_token_bin(
    path: str, tokens: Sequence[int], *, dtype=np.uint16
) -> None:
    """Write a flat token stream in the ``TokenBinDataset`` format."""
    np.asarray(tokens, dtype=dtype).tofile(path)
